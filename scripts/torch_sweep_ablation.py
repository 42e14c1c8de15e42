#!/usr/bin/env python3
"""Ablation of the CUDA sweep kernel, on one NVIDIA GPU. Run from the root
of a checkout:

    python3 scripts/torch_sweep_ablation.py [--rounds 5] [--batched]

Builds pangene_tpu_torch/csrc/shadow_sweep.cu as it is and in variants made
by textual substitution of its source (all built at once into
build/ablation/), holds every variant against the plain PyTorch version,
then times the variants in turns (a, b, c, a, b, c, ...): device time per
launch of 200 launches replayed from one CUDA graph. Without --batched:
the per-genome entry's exon intersection (VARIANTS), on the kernel's edge
cases and on the largest genome of chip_smoke.py's big corpus (every hit
unfiltered), both modes. With --batched: the batched entry's launch shape
(BATCHED_VARIANTS), on the big corpus's device-loop columns (entry state)
and on the per-round path's full stack (every row unfiltered). Prints the
card, each variant's ptxas lines, one JSON line a reading and a summary
line of each variant's readings.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = "t.narrow = exons_staged && !wide;"
REG_INT32 = "if (sizeof(T) == 4 && nb <= kRegExons)"
# name: [(text of the source, its replacement), ...]
VARIANTS = {
    "committed": [],
    # every pair through the int64 loop over shared memory
    "int64_loop": [(NARROW, "t.narrow = false;")],
    # every pair in int64, the shorter list held in registers
    "int64_regs": [(NARROW, "t.narrow = false;"),
                   (REG_INT32, "if (nb <= kRegExons)")],
}
_ROWS = "constexpr int kBatchRows = 256;"
_THREADS = "constexpr int kBatchThreads = 384;"
_PER_SM = "constexpr int kBatchBlocksPerSM = 2;"
_CHUNK = "constexpr int kBatchChunk = 8;"
BATCHED_VARIANTS = {
    "committed": [],
    # half the owned rows a tile, 3 blocks a SM
    "rows128": [(_ROWS, "constexpr int kBatchRows = 128;"),
                (_THREADS, "constexpr int kBatchThreads = 256;"),
                (_PER_SM, "constexpr int kBatchBlocksPerSM = 3;")],
    # the same, 4 blocks a SM (<= 64 registers a thread)
    "rows128_4": [(_ROWS, "constexpr int kBatchRows = 128;"),
                  (_THREADS, "constexpr int kBatchThreads = 256;"),
                  (_PER_SM, "constexpr int kBatchBlocksPerSM = 4;")],
    # the per-genome tile's 64 rows, 192 threads, 5 blocks a SM
    "rows64_5": [(_ROWS, "constexpr int kBatchRows = 64;"),
                 (_THREADS, "constexpr int kBatchThreads = 192;"),
                 (_PER_SM, "constexpr int kBatchBlocksPerSM = 5;")],
    # twice the owned rows, 1 block a SM
    "rows512": [(_ROWS, "constexpr int kBatchRows = 512;"),
                (_THREADS, "constexpr int kBatchThreads = 640;"),
                (_PER_SM, "constexpr int kBatchBlocksPerSM = 1;")],
    # 1 block a SM: no register cap below 168
    "one_block_a_sm": [(_PER_SM, "constexpr int kBatchBlocksPerSM = 1;")],
    # the band in passes of 16 or 32 offsets
    "chunk16": [(_CHUNK, "constexpr int kBatchChunk = 16;")],
    "chunk32": [(_CHUNK, "constexpr int kBatchChunk = 32;")],
}


def build_variants(src_path, out_dir, variants):
    """Build every variant of the CUDA source `src_path` at once; returns
    {name: (library path, ptxas lines)}. Raises when a substitution finds
    no text or nvcc fails."""
    from pangene_tpu_torch.ops.sweep_kernel import nvcc_command
    with open(src_path) as fp:
        src = fp.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError("variant %s: %r found %d times"
                                   % (name, old, text.count(old)))
            text = text.replace(old, new)
        cu = os.path.join(out_dir, name + ".cu")
        with open(cu, "w") as fp:
            fp.write(text)
        so = os.path.join(out_dir, "lib%s.so" % name)
        procs[name] = (so, subprocess.Popen(
            nvcc_command(cu, so), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (so, p) in procs.items():
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError("nvcc %s failed:\n%s%s" % (name, out, err))
        built[name] = (so, [ln.strip() for ln in err.splitlines()
                            if "registers" in ln or "spill" in ln])
    return built


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--batched", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("torch_sweep_ablation: no CUDA device\n")
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pangene_tpu_torch.ops import device_engine as de
    from pangene_tpu_torch.ops import sweep_kernel as sk
    from pangene_tpu_torch.ops.sort import hit_sort
    from pangene_tpu_torch.testing import SWEEP_EDGE_CASES, sweep_edge_case
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("card: %s" % smi, flush=True)

    t0 = time.monotonic()
    built = build_variants(sk._SRC, os.path.join(ROOT, "build", "ablation"),
                           BATCHED_VARIANTS if args.batched else VARIANTS)
    print("build: %d variants in %.1f s" % (len(built),
                                            time.monotonic() - t0))
    for name, (_, ptxas) in built.items():
        for ln in ptxas:
            print("  %s ptxas: %s" % (name, ln))
    libs = {name: sk.load(so) for name, (so, _) in built.items()}
    if args.batched:
        return batched(args, cs, sk, libs, smi, dev)

    _, graph = cs.run_cli(cs.make_corpus("big"))
    g = max(graph.d.genomes, key=lambda x: x.n_hit)
    hit_sort(g, by_cm=False)
    g.hits.flt[:] = 0
    n, E = g.n_hit, len(g.exon_os)
    buf = de.upload(graph.d, g, dev)
    W = sk.band_width(g.hits.cid, g.hits.cs, g.hits.ce)
    edges = []
    for case in SWEEP_EDGE_CASES:
        d, ge = sweep_edge_case(case)
        edges.append((de.upload(d, ge, dev), ge.n_hit, len(ge.exon_os),
                      sk.band_width(ge.hits.cid, ge.hits.cs, ge.hits.ce)))

    for name, lib in libs.items():
        sk._lib = lib
        for mode in sk.MODE_NAMES:
            cs.compare(sk, buf, n, E, W, mode, False, 0.5)
            for eb, en, eE, eW in edges:
                cs.compare(sk, eb, en, eE, eW, mode, False, 0.3)
    print("every variant == plain on the genome (hits %d, W %d) and %d "
          "edge cases, both modes" % (n, W, len(edges)), flush=True)

    readings = {(v, m): [] for v in libs for m in sk.MODE_NAMES}
    for r in range(args.rounds):
        for name, lib in libs.items():
            sk._lib = lib
            for mode in sk.MODE_NAMES:
                ms = cs.graph_ms(lambda: sk.shadow_sweep_packed(
                    buf, n, E, W, mode, False, 0.5), cs.TIMED_LAUNCHES)
                readings[(name, mode)].append(ms)
                print(json.dumps({"round": r, "variant": name,
                                  "mode": sk.MODE_NAMES[mode], "ms": ms}))
    sk._lib = None
    print(smi)
    print(json.dumps({"ablation": [
        {"variant": v, "mode": sk.MODE_NAMES[m], "ms": ms,
         "median_ms": float(np.median(ms)), "min_ms": min(ms),
         "max_ms": max(ms)} for (v, m), ms in readings.items()]}))
    return 0


def batched(args, cs, sk, libs, smi, dev):
    """The batched entry's variants on the big loop's columns (W 8) and the
    per-round path's full stack (W 21)."""
    from pangene_tpu_torch.parallel import device_loop as dl
    from pangene_tpu_torch.parallel import stacked as stk
    files = cs.make_corpus("big")
    kept = {}
    schedule_device = dl.schedule_device

    def keep(*a, **kw):
        kept.update(blocks=a[:5], cfg=kw["cfg"])
        return schedule_device(*a, **kw)

    dl.schedule_device = keep
    try:
        cs.run_cli(files, "sharded")
    finally:
        dl.schedule_device = schedule_device
    cols, bc = dl.unpack_blocks(*kept["blocks"])
    cfg = kept["cfg"]
    os.environ["PANGENE_DEVICE_LOOP"] = "0"
    _, rounds_graph = cs.run_cli(files, "sharded")
    del os.environ["PANGENE_DEVICE_LOOP"]
    cache = rounds_graph._stacked_dev_cache
    sG, sH = cache["G"], cache["H"]
    cases = {
        "loop": (bc, cols["flt"].contiguous(), cols["weak_br"].contiguous(),
                 cfg.W, cfg.check_strand, cfg.min_ov_ratio),
        "full_stack": (cache["cols"].batch,
                       torch.zeros((sG, sH), dtype=torch.uint8, device=dev),
                       torch.from_numpy(stk.stack_mutable(
                           rounds_graph.d, np.zeros((3, sG, sH), np.uint8))
                           [2]).to(dev), cache["W"], False, 0.5)}
    for case, a in cases.items():
        want = sk.shadow_sweep_batched_plain(*a)
        for name, lib in libs.items():
            sk._lib = lib
            got = sk.shadow_sweep_batched(*a)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError("variant %s != plain on %s"
                                     % (name, case))
            print("%s %s: launch %s" % (name, case, json.dumps(
                sk.launch_shape_batched(a[0].cid.shape[0],
                                        a[0].cid.shape[1], a[3]))))
        del want
    print("every variant == plain on the loop's columns and the full stack",
          flush=True)
    readings = {(v, c): [] for v in libs for c in cases}
    for r in range(args.rounds):
        for name, lib in libs.items():
            sk._lib = lib
            for case, a in cases.items():
                ms = cs.graph_ms(lambda: sk.shadow_sweep_batched(*a),
                                 cs.TIMED_LAUNCHES)
                readings[(name, case)].append(ms)
                print(json.dumps({"round": r, "variant": name, "case": case,
                                  "ms": ms}))
    sk._lib = None
    print(smi)
    print(json.dumps({"ablation": [
        {"variant": v, "case": c, "ms": ms,
         "median_ms": float(np.median(ms)), "min_ms": min(ms),
         "max_ms": max(ms)} for (v, c), ms in readings.items()]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
