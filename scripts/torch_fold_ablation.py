#!/usr/bin/env python3
"""Ablation of the device loop's fold and classification kernels
(pangene_tpu_torch/csrc/loop_blocks.cu: merge_fold, branch_classify), on one
NVIDIA GPU. Run from the root of a checkout:

    python3 scripts/torch_fold_ablation.py [--rounds 2]

Builds the source as it is and in variants made by textual substitution
(VARIANTS, all built at once into build/fold_ablation/ by
torch_sweep_ablation.build_variants), holds every variant that computes the
same function against the plain PyTorch versions, then times them in turns
(a, b, c, a, b, c, ...): device time per call of 200 calls replayed from one
CUDA graph (chip_smoke.graph_ms), on inputs of the big default loop's
shapes made from seeded numpy: merge_fold lean (1,310,720 sorted keys with
the row index in their low bits, 94.8% valid, out-groups of ~8 rows over
64 genomes, cap 327,680), merge_fold full (the same keys co-sorted with a
permutation, s2 and dist by origin) and branch_classify (327,680 arcs,
groups of 5-21 members; cls_* vary its block). "no_pair_store" drops the
pair plane's scattered stores, so its outputs differ (timed only). "phases" stamps the card's
global timer at each phase of each tile (ticket, out-head count, gathers +
in-group scan, out-group scan, look-back, writes) and prints their means.
Beside them, yardsticks: the lean case's random accesses alone as PyTorch
calls (each valid row's s1 gathered, its pair slot scattered, by origin)
and one coalesced pass over its keys. Prints the card, each variant's
ptxas lines and one JSON line a reading.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_KEYS = 1310720
CAP = 327680
_STAMP = ("{ if (threadIdx.x == 0) { unsigned long long t_; "
          "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
          "g_phase[tile * 8 + K] = t_; } }\n")
_PHASE_AT = (
    "    if (tile >= p.ntiles) break;\n",
    "    const int before = block_excl_sum(__popc(oh), s_cnt, &heads);\n",
    "    const Seg<InAgg> pin = block_seg_excl<kStats>(ci, cf, s_in, "
    "in_zero());\n",
    "        block_seg_excl<kStats>(co, of, s_out, out_zero());\n",
    "    long long id = s_pre + before - 1;\n",
    "    // the out-group open at the tile's end, its head inside: read on\n")
PHASES = ("count", "gather_in_scan", "out_scan", "look_back", "writes")
MAX_TILES = 1 << 14
# name: [(text of the source, its replacement), ...]
VARIANTS = {
    "committed": [],
    "rows8": [("constexpr int kFoldRows = 4;", "constexpr int kFoldRows = 8;")],
    "rows2": [("constexpr int kFoldRows = 4;", "constexpr int kFoldRows = 2;")],
    "threads128": [("constexpr int kFoldThreads = 256;",
                    "constexpr int kFoldThreads = 128;")],
    "cls_threads128": [("constexpr int kClsThreads = 256;",
                        "constexpr int kClsThreads = 128;")],
    "cls_threads512": [("constexpr int kClsThreads = 256;",
                        "constexpr int kClsThreads = 512;")],
    "no_pair_store": [("      p.pair[src[q]] = static_cast<int32_t>(id);\n",
                       "")],
    "phases": [("namespace {\n\nconstexpr int kBrWarps",
                "__device__ unsigned long long g_phase[%d * 8];\n"
                "extern \"C\" int pg_phases(void* dst, long long n) {\n"
                "  return (int)cudaMemcpyFromSymbol(dst, g_phase, n * 8);\n"
                "}\n"
                "namespace {\n\nconstexpr int kBrWarps" % MAX_TILES)]
    + [(at, at + _STAMP.replace("K", str(k))) if k < 4
       else (at, _STAMP.replace("K", str(k)) + at)
       for k, at in enumerate(_PHASE_AT)],
}
TIMED_ONLY = ("no_pair_store",)


def inputs(dev):
    """(lean args, kw), (full args, kw), (classify args, kw) on `dev`."""
    import pangene_tpu_torch.ops.loop_kernels as lk
    from pangene_tpu_torch.testing import BRANCH_B, fold_inputs
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    shape = dict(n_vw=160000, n_g=64, p_valid=0.948, full=True)
    keys, s1, jb, gb, _, _ = fold_inputs(np.random.default_rng(1), "jb",
                                         N_KEYS, **shape)
    lean = ((on(keys), on(s1)), dict(jb=jb, gb=gb, cap=CAP))
    keys, s1, _, gb, perm, st = fold_inputs(np.random.default_rng(1),
                                            "cosorted", N_KEYS, **shape)
    full = ((on(keys), on(s1)), dict(jb=0, gb=gb, cap=CAP, perm=on(perm),
                                     full=(on(st[0]), on(st[1]))))
    rng = np.random.default_rng(2)
    vw = np.concatenate([np.full(n, (2 * k + 1) << BRANCH_B, np.int64)
                         for k, n in enumerate(rng.integers(5, 22, 19996))])
    vw = np.concatenate([vw, np.full(CAP, lk.SENT_I, np.int64)])[:CAP]
    s1 = rng.integers(0, 3000, CAP).astype(np.int32)
    gs_of, mx, branching, _ = lk.arc_groups(on(vw), on(s1), BRANCH_B)
    bits = torch.from_numpy(rng.random((2, CAP)) < 0.4).to(dev)
    cls = ((on(s1), mx, branching, bits[0], bits[1], gs_of),
           dict(branch_diff=0.02, branch_diff_dist=0.05,
                branch_diff_cut=0.5))
    return {"merge_fold": lean, "merge_fold_full": full,
            "branch_classify": cls}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke as cs
    import pangene_tpu_torch.ops.loop_kernels as lk
    from torch_sweep_ablation import build_variants
    graph_ms = lambda fn: cs.graph_ms(fn, cs.TIMED_LAUNCHES)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs = {name: (lk.load(so), regs) for name, (so, regs) in build_variants(
        lk._SRC, os.path.join(ROOT, "build", "fold_ablation"),
        VARIANTS).items()}
    for name, (_, regs) in libs.items():
        print(name, json.dumps(regs), flush=True)
    dev = torch.device("cuda")
    cases = inputs(dev)
    fn = lambda case: getattr(lk, "merge_fold" if case.startswith(
        "merge_fold") else case)
    for name, (lib, _) in libs.items():
        if name in TIMED_ONLY:
            continue
        lk._lib = lib
        for case, (args, kw) in cases.items():
            got = fn(case)(*args, **kw)
            want = getattr(lk, fn(case).__name__ + "_plain")(*args, **kw)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError("%s %s != plain" % (name, case))
    print("every variant but %s == plain" % (TIMED_ONLY,), flush=True)
    timed = [n for n in libs if n != "phases"]
    ms = {n: {c: [] for c in cases} for n in timed}
    for _ in range(a.rounds):
        for name in timed:
            lk._lib = libs[name][0]
            for case, (args, kw) in cases.items():
                ms[name][case].append(graph_ms(
                    lambda: fn(case)(*args, **kw)))
            print(json.dumps({"variant": name, "ms": {
                c: v[-1] for c, v in ms[name].items()}}), flush=True)
    print(json.dumps({"median_ms": {n: {c: float(np.median(v))
                                        for c, v in m.items()}
                                    for n, m in ms.items()}}))
    # yardsticks on the lean case's rows: their random accesses alone, as
    # PyTorch gather / scatter calls (each valid row's s1 read by origin,
    # its pair slot written by origin), and a coalesced pass over the keys
    keys, s1 = cases["merge_fold"][0]
    jb = cases["merge_fold"][1]["jb"]
    valid = keys != lk.KSENT_I
    src = (keys & ((1 << jb) - 1))[valid]
    vals = torch.arange(src.numel(), dtype=torch.int32, device=dev)
    pair = torch.zeros(N_KEYS, dtype=torch.int32, device=dev)
    print(json.dumps({"yardstick_ms": {
        "gather_s1": graph_ms(lambda: s1.index_select(0, src)),
        "scatter_pair": graph_ms(lambda: pair.index_copy_(0, src, vals)),
        "keys_shift": graph_ms(lambda: keys >> jb)}}), flush=True)
    # each tile's phases in the "phases" variant (its tiles are the
    # committed source's)
    lib = libs["phases"][0]
    lib.pg_phases.restype = ctypes.c_int
    lib.pg_phases.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lk._lib = lib
    nt = int(lib.pg_merge_fold_tiles(N_KEYS))
    for case in ("merge_fold", "merge_fold_full"):
        args, kw = cases[case]
        lk.merge_fold(*args, **kw)
        torch.cuda.synchronize()
        buf = np.zeros(nt * 8, np.uint64)
        if lib.pg_phases(buf.ctypes.data, nt * 8):
            raise RuntimeError("reading the phase stamps failed")
        t = buf.reshape(nt, 8)[:, :6].astype(np.int64)
        d = np.diff(t, axis=1) / 1e3
        print(json.dumps({"phases_us": case, "tiles": nt,
                          "span": float((t[:, 5].max() - t[:, 0].min())
                                        / 1e3),
                          "mean": dict(zip(PHASES, d.mean(0).tolist())),
                          "max": dict(zip(PHASES, d.max(0).tolist()))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
