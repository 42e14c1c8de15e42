"""CLI with flag-for-flag compatibility with the reference binary
(main.c:5-113) plus the port's own flags (--device, --engine, --devices,
--profile, --save-hits, --load-hits).

    python -m pangene_tpu_torch.cli [options] *.paf.gz > graph.gfa
"""
from __future__ import annotations

import sys
from typing import List, Optional

from . import util
from .io.lists import read_list
from .options import (DEVICE_ENGINES, HOST_ENGINES, PG_F_CHECK_STRAND,
                      PG_F_DROP_SGL_EXON, PG_F_FRAG_MODE,
                      PG_F_NO_JOINT_PSEUDO, PG_F_ORI_FOR_BRANCH,
                      PG_F_WRITE_BED_FLAG, PG_F_WRITE_BED_RAW,
                      PG_F_WRITE_BED_WALK, PG_F_WRITE_NO_WALK,
                      PG_F_WRITE_VTX_SEL, PG_REF_VERSION, PG_VERSION, PgOpt)

ENGINES = DEVICE_ENGINES + HOST_ENGINES


def parse_num(s: str) -> int:
    """Numbers with k/M/G suffixes, +.499 rounded (main.c:45-55)."""
    mult = 1.0
    t = s
    for suf, m in (("G", 1e9), ("g", 1e9), ("M", 1e6), ("m", 1e6),
                   ("K", 1e3), ("k", 1e3)):
        if suf in t:
            idx = t.index(suf)
            t = t[:idx]
            mult = m
            break
    return int(float(t) * mult + 0.499)


USAGE = """Usage: pangene-tpu-torch [options] <in.paf> [...]
Options:
  Input preprocessing:
    -d CHAR       gene-protein delimiter [:]
    -X STR/@FILE  exclude genes in STR list or in @FILE []
    -I STR/@FILE  include genes in the output graph []
    -P STR/@FILE  prioritize genes in the output graph []
    -e FLOAT      drop an alignment if its identity <FLOAT [0.5]
    -l FLOAT      drop an alignment if <FLOAT fraction of the protein aligned [0.5]
    -m FLOAT      score adjustment coefficient [2]
  Graph construction:
    -f FLOAT      min overlap fraction [0.5]
    -J            don't filter pseudogenes across samples
    -E            ignore genes that are single-exon in all genomes
    -p FLOAT      gene considered if dominant in FLOAT fraction of genes [0.05]
    -c INT        drop a gene if average occurrence is >INT [10]
    -g INT        drop a gene if its in- or out-degree >INT [15]
    -r INT        drop a gene if it connects >INT distant loci [3]
    -b FLOAT      demote a branching arc if weaker than the best by FLOAT [0.02]
    -B FLOAT      cut a branching arc if weaker by FLOAT [0.5]
    -y FLOAT      cut a distant branching arc if weaker by FLOAT [0.05]
    -T INT        apply branch cutting for INT times [15]
    -F            don't consider genes on different contigs as distant
    -a INT        prune an arc if it is supported by <INT genomes [1]
  Output:
    -w            Suppress walk lines (W-lines)
    --bed[=STR]   output 12-column BED where STR is walk, raw or flag [walk]
    --version     print version number
  Device:
    --device STR  cuda | cpu: where the card engines run [cuda]
    --engine STR  sharded | device | host | host-vec | host-ref: the pruning
                  rounds as one device-resident loop (PANGENE_DEVICE_LOOP=0:
                  one device step per round), or host rounds with one sweep
                  per genome on the device; or all on the host: native C
                  (host), NumPy (host-vec), scalar oracle (host-ref)
                  [sharded]
    --devices INT shard genomes over INT devices, one rank each (sharded
                  engine; 0 = every rank of a torchrun launch, else one) [0]
    --profile DIR write a torch.profiler chrome trace of the whole run into
                  DIR (the parse workers are other processes: not traced;
                  with several ranks, rank 0 only)
    --save-hits F checkpoint post-ingest hit tensors to F (.npz)
    --load-hits F resume from a checkpoint instead of parsing PAFs
"""


def parse_args(argv: List[str]) -> Optional[tuple]:
    opt = PgOpt()
    files: List[str] = []
    extras = {"save_hits": None, "load_hits": None, "profile": None}
    i = 0

    def need_arg() -> str:
        nonlocal i
        i += 1
        if i >= len(argv):
            raise SystemExit("ERROR: option %s needs an argument" % argv[i - 1])
        return argv[i]

    while i < len(argv):
        a = argv[i]
        if a == "--version":
            print(PG_VERSION + " (parity with pangene " + PG_REF_VERSION + ")")
            return None
        elif a == "--bed" or a.startswith("--bed="):
            arg = a[6:] if a.startswith("--bed=") else ""
            if arg in ("", "walk"):
                opt.flag |= PG_F_WRITE_BED_WALK
            elif arg == "raw":
                opt.flag |= PG_F_WRITE_BED_RAW
            elif arg == "flag":
                opt.flag |= PG_F_WRITE_BED_FLAG
            else:
                sys.stderr.write("ERROR: unrecognized --bed argument. "
                                 "Should be 'raw' or 'walk'.\n")
                raise SystemExit(1)
        elif a == "--ori-sc":
            opt.flag |= PG_F_ORI_FOR_BRANCH
        elif a == "--device":
            opt.device = need_arg()
            if opt.device not in ("cuda", "cpu"):
                raise SystemExit("ERROR: unknown --device %r; expected "
                                 "cuda|cpu" % opt.device)
        elif a == "--engine":
            opt.engine = need_arg()
            if opt.engine not in ENGINES:
                raise SystemExit("ERROR: unknown --engine %r; expected %s"
                                 % (opt.engine, "|".join(ENGINES)))
        elif a == "--devices":
            opt.n_devices = int(need_arg())
        elif a == "--profile":
            extras["profile"] = need_arg()
        elif a == "--save-hits":
            extras["save_hits"] = need_arg()
        elif a == "--load-hits":
            extras["load_hits"] = need_arg()
        elif a.startswith("-") and len(a) >= 2 and a != "-":
            c = a[1]
            inline = a[2:]

            def val() -> str:
                return inline if inline else need_arg()

            if c == "d":
                opt.gene_delim = val()[0]
            elif c == "X":
                opt.excl = read_list(val())
            elif c == "I":
                opt.incl = read_list(val())
            elif c == "P":
                opt.preferred = read_list(val())
            elif c == "e":
                opt.min_prot_iden = float(val())
            elif c == "l":
                opt.min_prot_ratio = float(val())
            elif c == "m":
                opt.score_adj_coef = float(val())
            elif c == "f":
                opt.min_ov_ratio = float(val())
            elif c == "p":
                opt.min_vertex_ratio = float(val())
            elif c == "c":
                opt.max_avg_occ = int(val())
            elif c == "g":
                opt.max_degree = int(val())
            elif c == "r":
                opt.max_dist_loci = int(val())
            elif c == "J":
                opt.flag |= PG_F_NO_JOINT_PSEUDO
            elif c == "E":
                opt.flag |= PG_F_DROP_SGL_EXON
            elif c == "b":
                opt.branch_diff = float(val())
            elif c == "B":
                opt.branch_diff_cut = float(val())
            elif c == "y":
                opt.branch_diff_dist = float(val())
            elif c == "T":
                opt.n_branch_flt = int(float(val()))
            elif c == "a":
                opt.min_arc_cnt = int(val())
            elif c == "F":
                opt.flag |= PG_F_FRAG_MODE
            elif c == "D":
                opt.local_dist = parse_num(val())
            elif c == "C":
                opt.local_count = int(val())
            elif c == "S":
                opt.flag |= PG_F_CHECK_STRAND
            elif c == "w":
                opt.flag |= PG_F_WRITE_NO_WALK
            elif c == "G":
                opt.flag |= PG_F_WRITE_VTX_SEL
            elif c == "v":
                util.verbose = int(val())
            elif c == "O":
                pass   # accepted, no handler — exactly like the reference
                       # (in main.c:70's optstring but never dispatched)
            else:
                sys.stderr.write(USAGE)
                raise SystemExit(1)
        else:
            files.append(a)
        i += 1
    if not files and not extras["load_hits"]:
        sys.stderr.write(USAGE)
        raise SystemExit(1)
    return opt, files, extras


def main(argv: Optional[List[str]] = None) -> int:
    import signal
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):
        pass
    argv = sys.argv[1:] if argv is None else argv
    parsed = parse_args(argv)
    if parsed is None:
        return 0
    opt, files, extras = parsed
    if opt.engine == "sharded" and opt.n_devices > 1 and not util.launched():
        from .parallel.mesh import launch_cli
        return launch_cli(argv, opt.n_devices)
    from . import pipeline
    from .util import cputime, peakrss, realtime
    pipeline.run(opt, files, **extras)
    if opt.engine == "sharded" and util.launched():
        from .parallel.mesh import shutdown
        shutdown()
    if util.verbose >= 3:
        sys.stderr.write("[M::main] Version: %s\n" % PG_VERSION)
        sys.stderr.write("[M::main] CMD: pangene-tpu-torch %s\n"
                         % " ".join(argv))
        sys.stderr.write("[M::main] Real time: %.3f sec; CPU: %.3f sec; "
                         "Peak RSS: %.3f GB\n" % (realtime(), cputime(),
                                                  peakrss() / 1024**3))
    return 0


if __name__ == "__main__":
    sys.exit(main())
