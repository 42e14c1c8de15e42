"""End-to-end pipeline mirroring the reference main flow
(main.c:117-138): read all PAFs (with per-genome filter postpass),
post-process, build graph, emit GFA/BED.

The per-genome shadow and isoform sweeps go through ops/dispatch. Under
engine "device" they run on the torch device named by opt.device (a
hand-written CUDA kernel on "cuda", its plain PyTorch version on "cpu");
under "sharded" they run in C, as in the JAX package, and the pruning
rounds run on that device as batched launches of the same kernel
(graph/build.py). The host engines ("host", "host-vec", "host-ref") run
everything on the host and touch no torch device. The rest is host code:
the native runtime (ops/sweep_native.py) where the JAX package uses it,
else NumPy.
"""
from __future__ import annotations

import sys
from typing import IO, List, Optional

from .core.data import DataSet, Genome
from .graph import build as build_mod
from .graph.graphdata import Graph
from .graph.post import post_process
from .io import bed as bed_mod
from .io import gfa_write
from .io import paf as paf_mod
from .options import (HOST_ENGINES, PG_F_WRITE_BED_FLAG, PG_F_WRITE_BED_RAW,
                      PG_F_WRITE_BED_WALK, PG_F_WRITE_NO_WALK, PgOpt)
from .ops import pseudo as pseudo_ops
from .ops import dispatch as sweep
from .ops.sort import hit_sort
from . import util
from .util import log_msg


def read_postpass(opt: PgOpt, d: DataSet, g: Genome, n_tot: int) -> None:
    """Per-genome filter postpass run right after parsing one PAF
    (reference read.c:243-260)."""
    n_pseudo = pseudo_ops.flag_pseudo(d, g)
    h = g.hits
    h.flt[h.pseudo == 1] = 1
    hit_sort(g, by_cm=False)
    sweep.shadow(opt, d, g, cal_dom_sc=True)
    # snapshot read-time dominators, then reset (read.c:249-253)
    h.set("pid_dom0", h.pid_dom.copy())
    h.pid_dom[:] = -1
    h.shadow[:] = 0
    n_flt_ov_iso = sweep.flt_ov_isoform(opt, d, g)
    n_flt_chain = pseudo_ops.flt_chain_shadow(d, g)
    n_flt_subopt = pseudo_ops.flt_subopt_isoform(d, g)
    log_msg("pg_read_paf", "[%d] %s: %d hits parsed, %d kept and "
            "%d+%d+%d+%d filtered", d.n_genome - 1, g.label or "?",
            n_tot, g.n_hit, n_pseudo, n_flt_ov_iso, n_flt_chain, n_flt_subopt)


def _n_parse_workers(files: List[str]) -> int:
    """Parallel-parse worker count: PANGENE_PARSE_WORKERS, else one per
    available core (capped at 8 and at the file count); 0/1 = sequential.
    The reference is single-threaded — per-genome parsing is the
    embarrassingly parallel axis it never exploits (SURVEY §2.4(1)). Every
    rank of a launch parses every file, so the ranks on one host share its
    cores (util.local_world)."""
    import os
    from . import util
    env = os.environ.get("PANGENE_PARSE_WORKERS")
    if env is not None:
        n = int(env)
    else:
        cores = (len(os.sched_getaffinity(0))
                 if hasattr(os, "sched_getaffinity") else os.cpu_count() or 1)
        n = min(max(cores // util.local_world(), 1), 8)
    return min(n, len(files))


@util.stage_span("parse")
def read_all(opt: PgOpt, files: List[str]) -> DataSet:
    """Every PAF of `files` into one DataSet, with the per-genome filter
    postpass. Its wall is the span "parse", util.stage_stats["parse_s"]."""
    d = DataSet.new()
    n_workers = _n_parse_workers(files)
    if n_workers > 1 and opt.excl is None and "-" not in files:
        from .native import loader
        if loader.get_lib() is not None:
            return _read_all_parallel(opt, files, d, n_workers)
    for fn in files:
        g = paf_mod.read_paf(opt, d, fn)
        if g is None:
            continue
        read_postpass(opt, d, g, getattr(g, "_n_tot_records", g.n_hit))
    return d


def parse_start_method() -> str:
    """The parse pool's start method: "fork", as in the JAX package, so a
    worker starts without importing anything again, unless this process
    has initialised CUDA, which a forked child must not inherit: then
    "spawn". The workers never touch CUDA (the native parser over ctypes,
    and NumPy)."""
    if sys.platform == "win32":
        return "spawn"
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        return "spawn"
    return "fork"


def _read_all_parallel(opt: PgOpt, files: List[str], d: DataSet,
                       n_workers: int) -> DataSet:
    """Process-pool per-genome parsing: workers run the standalone native
    parser (zlib + tokenizing + CIGAR expansion + exact score_adj) with
    file-local ids; the main process merges results IN FILE ORDER so global
    interning order — and thus every downstream id, rank and tie order —
    is byte-identical to the sequential path. The per-genome filter
    postpass stays in the main process; under engine "device" it launches
    CUDA sweeps between files. The pool starts all its workers when it is
    built, before that first launch (parse_start_method)."""
    import multiprocessing as mp
    import os
    from . import util
    args = [(fn, opt.min_prot_ratio, opt.min_prot_iden,
             opt.score_adj_coef, opt.gene_delim) for fn in files
            if fn == "-" or os.path.exists(fn)]
    skipped = [fn for fn in files if fn != "-" and not os.path.exists(fn)]
    for fn in skipped:
        sys.stderr.write("[W::pg_read_paf] failed to open %r; skipped\n" % fn)
    method = parse_start_method()
    util.stage_stats["parse_pool"] = method
    with mp.get_context(method).Pool(n_workers) as pool:
        for (fn, *_), nat in zip(args, pool.imap(paf_mod.parse_worker, args,
                                                 chunksize=1)):
            if nat is None:   # native parser unavailable in the worker
                g = paf_mod.read_paf(opt, d, fn)
            else:
                g = paf_mod.merge_standalone(opt, d, fn, nat)
            if g is None:
                continue
            read_postpass(opt, d, g, getattr(g, "_n_tot_records", g.n_hit))
    return d


TRACE_NAME = "pangene_trace.json"


class _Discard:
    """The output of a rank other than 0."""

    def write(self, s: str) -> int:
        return len(s)


def run(opt: PgOpt, files: List[str], out: Optional[IO[str]] = None,
        save_hits: Optional[str] = None,
        load_hits: Optional[str] = None,
        profile: Optional[str] = None) -> Graph:
    """Full run; returns the final Graph (None graph fields if --bed=raw).

    profile: a directory; the whole run is traced with torch.profiler (CPU
    activity, and CUDA activity when a card engine runs on "cuda") and the
    chrome
    trace is written to <profile>/pangene_trace.json
    (util.trace_device_summary reads the device's busy time from it). The
    parse workers are other processes and are not traced.

    Under a launch of several ranks (parallel/mesh.py) every rank builds
    the graph; only rank 0 writes it (to `out`, default stdout), saves
    save_hits and traces --profile. The other ranks write to `out` only
    when it is given.

    Raises RuntimeError when a card engine runs with opt.device "cuda" and
    no CUDA device exists: the CPU is used only when the caller asks for it,
    by --device cpu or by a host engine (which reads no opt.device).

    save_hits/load_hits checkpoint the post-ingest per-genome hit tensors
    (SURVEY.md §5): a resumed run skips PAF parsing and the per-genome read
    postpass and is byte-identical to a fresh one as long as the
    read-phase options (-d/-e/-l/-m/-S/-X/-I/-P) are unchanged. The file
    format is the JAX package's, so either package resumes the other's.
    """
    from . import util
    on_cuda = False
    if opt.engine not in HOST_ENGINES:
        from .ops.device_engine import resolve_device
        on_cuda = resolve_device(opt.device).type == "cuda"
    rank = util.launch_rank()
    if rank:
        # every rank of a launch builds the same graph; rank 0 writes it
        out = out or _Discard()
        save_hits = None
        if profile:
            log_msg("pg_profile", "rank %d not traced: --profile traces rank "
                    "0 only", rank)
            profile = None
    out = out or sys.stdout
    if not profile:
        return _run_inner(opt, files, out, save_hits, load_hits)
    if util.launched():
        log_msg("pg_profile", "tracing rank 0 only")
    import os
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    acts = [ProfilerActivity.CPU]
    if on_cuda:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile, exist_ok=True)
    with torch_profile(activities=acts) as prof:
        q = _run_inner(opt, files, out, save_hits, load_hits)
    prof.export_chrome_trace(os.path.join(profile, TRACE_NAME))
    log_msg("pg_profile", "trace written to %s", profile)
    return q


def _run_inner(opt, files, out, save_hits, load_hits) -> Graph:
    import time as _time
    util.stage_stats.clear()
    if load_hits:
        from .io.checkpoint import load_dataset
        d = load_dataset(load_hits)
        log_msg("pg_resume", "loaded %d genomes, %d genes, %d proteins from %s",
                d.n_genome, d.n_gene, d.n_prot, load_hits)
    else:
        d = read_all(opt, files)
    if save_hits:
        from .io.checkpoint import save_dataset
        save_dataset(d, save_hits)
        log_msg("pg_checkpoint", "saved post-ingest tensors to %s", save_hits)
    t0 = _time.monotonic()
    post_process(opt, d)
    util.stage_stats["post_s"] = round(_time.monotonic() - t0, 3)
    if opt.flag & PG_F_WRITE_BED_RAW:
        bed_mod.write_bed(d, is_walk=False, out=out)
        return Graph(d)
    q = Graph(d)
    t0 = _time.monotonic()
    build_mod.graph_gen(opt, q)
    util.stage_stats["graph_s"] = round(_time.monotonic() - t0, 3)
    t0 = _time.monotonic()
    if opt.flag & PG_F_WRITE_BED_WALK:
        bed_mod.write_bed(d, is_walk=True, out=out)
    elif opt.flag & PG_F_WRITE_BED_FLAG:
        bed_mod.write_bed(d, is_walk=False, out=out)
    else:
        gfa_write.write_graph(q, out)
        if not (opt.flag & PG_F_WRITE_NO_WALK):
            gfa_write.write_walk(q, out)
    util.stage_stats["emit_s"] = round(_time.monotonic() - t0, 3)
    return q
