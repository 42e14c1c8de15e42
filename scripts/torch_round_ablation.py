#!/usr/bin/env python3
"""Ablation of the device loop's scan kernels walk_pairs and branch_prep
(pangene_tpu_torch/csrc/loop_round.cu), on one NVIDIA GPU. Run from the
root of a checkout:

    python3 scripts/torch_round_ablation.py [--rounds 2] [--parent DIR]

Builds the source as it is and in variants made by textual substitution
(VARIANTS, all built at once into build/round_ablation/ by
torch_sweep_ablation.build_variants): the tile's rows a thread and threads
a block; walk_pairs' carry from a thread-block cluster of a genome's tiles
in place of the look-back (with tiles of 2,048 rows, so that a genome fits
a cluster of at most 16; the kernel ships only the look-back, so CLUSTER
holds the cluster form as text); its launch bound capped for 6 or 8 blocks a SM;
its segment counters without the warp's merge of repeated segments, as
plain stores in place of their atomics, or gone (these two timed only:
their outputs differ). Holds every other variant against the plain
PyTorch versions, then times them in turns (a, b, c, a, b, c, ...): device
time a call of 200 calls replayed from one CUDA graph (chip_smoke.graph_ms)
beside the bound chip_smoke.round_bound_ms computes, on states made from
seeded numpy (testing.round_state) at the big and north-star loops'
shapes: G genomes of H rows, about 97% of them valid and 98.5% of those
kept, n_gene genes and segments (each gene once a genome at the north
star, in no order, each with its own segment), groups of 1-39 arcs;
walk_pairs lean (the in-loop key) and full (the tail's), branch_prep with
D 64. "phases" stamps the card's global timer at each phase of each block
(walk_pairs: loads and ballots, publish and look-back, the rows' writes;
branch_prep's tiles: loads and atomics, look-back, words; its
representative blocks: the wait for the tiles, the gathers, the writes;
its arc blocks) and prints their means and spans. With --parent DIR, the
walk_pairs and branch_prep of DIR's pangene_tpu_torch/csrc/loop_round.cu
(a parent commit unpacked there) are checked and timed as one more
variant, "parent", through their own C entry points. Only the source
before the tiled scans is taken there, the one whose walk_pairs is one
block a genome (its C entry points take a [G, H] kept-rank plane and no
scratch of their own size, and it has no pg_walk_pairs_scratch); any other
parent raises. Prints the card, each variant's ptxas lines and one JSON
line a reading.
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
# name: (G, H, genes = segments, arc groups)
SHAPES = {"big": (64, 10240, 10000, 16000),
          "northstar": (100, 18944, 19000, 38000)}
MAX_BLOCKS = 1 << 14
_STAMP = ("{ if (threadIdx.x == 0) { unsigned long long t_; "
          "asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t_)); "
          "g_phase[(%s) * 8 + %d] = t_; } }\n")


def _stamp(at, idx, k, before=False):
    s = _STAMP % (idx, k)
    return (at, s + at) if before else (at, at + s)


_ROWS = "constexpr int kScanRows = 4;"
_THREADS = "constexpr int kScanThreads = 256;"
_WALK_END = ("      if (!(atomicOr(bits + s, bit) & bit)) "
             "atomicAdd(&p.seg_ng[s], 1);\n    }\n  }\n")
_REP_END = "    p.r_rank[o] = s_rank[lane][x];\n  }\n"
# the stamps' block index: the tiles, the arc blocks, the representatives
_ARC = "c + p.n_tile"
_REP = "c + p.n_tile + p.n_arc"
# each kind of block's stamps (of 0-3) and the phases between them
PHASES = {"walk": ((0, 1, 2, 3), ("loads_ballots", "publish_look_back",
                                  "rows_writes")),
          "tile": ((0, 1, 2, 3), ("loads_atomics", "look_back",
                                  "words_done")),
          "reps": ((0, 1, 2, 3), ("wait_tiles", "gathers", "writes")),
          "arcs": ((0, 3), ("all",))}
# walk_pairs' carry from a thread-block cluster in place of the look-back:
# a block a tile in grid order, a cluster a genome's tiles (at most 16:
# tiles of 2,048 rows or more at the north star's 18,944), each block's
# predecessors' last kept rows read through distributed shared memory
CLUSTER = [
    ("#include <cuda_runtime.h>\n",
     "#include <cooperative_groups.h>\n#include <cuda_runtime.h>\n"),
    ("  __shared__ int s_carry;\n", "  __shared__ int s_carry, s_lst, s_fst;\n"),
    ("  if (threadIdx.x == 0)\n"
     "    s_tile = static_cast<long long>(atomicAdd(p.tiles + p.ntiles, "
     "1ull));\n  __syncthreads();\n  const long long tile = s_tile;\n",
     "  const long long tile = blockIdx.x;\n"),
    ("""    unsigned long long* st = p.tiles + tile;
    if (lane == 0)
      tile_store(st, (lst >= 0 || k == 0 ? kTilePre : kTileAgg)
                         | static_cast<unsigned long long>(lst + 1));
    const int carry = static_cast<int>(
        look_back(p.tiles, tile, g * p.T, lane, MaxU64())) - 1;
    if (lane == 0) {
      if (lst < 0 && k > 0)
        tile_store(st, kTilePre | static_cast<unsigned long long>(carry + 1));
""", """    if (lane == 0) {
      s_lst = lst;
      s_fst = fst;
    }
  }
  {
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (threadIdx.x == 0) {
      const int fst = s_fst;
      int carry = -1;
      for (unsigned r = 0; r < cl.block_rank(); ++r)
        carry = max(carry, *cl.map_shared_rank(&s_lst, r));
"""),
    ("      s_carry = carry;\n    }\n  }\n",
     "      s_carry = carry;\n    }\n    cl.sync();\n  }\n"),
    ("inline int err_of(cudaError_t e) { return static_cast<int>(e); }\n",
     """inline int err_of(cudaError_t e) { return static_cast<int>(e); }

template <bool kFullMode>
cudaError_t cluster_launch(const WalkArgs& p, cudaStream_t st) {
  if (p.T > 16) return cudaErrorInvalidValue;
  if (p.T > 8)
    cudaFuncSetAttribute(walk_pairs_kernel<kFullMode>,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.ntiles));
  cfg.blockDim = dim3(kScanThreads);
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.T;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, walk_pairs_kernel<kFullMode>, p);
}
"""),
    ("""  if (s21)
    walk_pairs_kernel<true><<<p.ntiles, kScanThreads, 0, st>>>(p);
  else
    walk_pairs_kernel<false><<<p.ntiles, kScanThreads, 0, st>>>(p);
  return err_of(cudaGetLastError());""",
     "  return err_of(s21 ? cluster_launch<true>(p, st)\n"
     "                    : cluster_launch<false>(p, st));"),
]
# name: [(text of the source, its replacement), ...]
VARIANTS = {
    "committed": [],
    "rows8": [(_ROWS, "constexpr int kScanRows = 8;")],
    "rows2": [(_ROWS, "constexpr int kScanRows = 2;")],
    "threads512": [(_THREADS, "constexpr int kScanThreads = 512;")],
    "threads128": [(_THREADS, "constexpr int kScanThreads = 128;")],
    "cluster_rows8": [(_ROWS, "constexpr int kScanRows = 8;")] + CLUSTER,
    "no_dedupe": [("    const unsigned peers =\n"
                   "        __match_any_sync(kFull, kept[q] ? seg[q] : "
                   "-1 - lane);\n",
                   "    const unsigned peers = 1u << lane;\n")],
    # walk_pairs' registers capped for 6 or 8 blocks of 256 threads a SM
    "walk_blocks6": [("constexpr int kWalkBlocksPerSm = 1;",
                      "constexpr int kWalkBlocksPerSm = 6;")],
    "walk_blocks8": [("constexpr int kWalkBlocksPerSm = 1;",
                      "constexpr int kWalkBlocksPerSm = 8;")],
    "no_counters": [("    if (kept[q] && lane == __ffs(peers) - 1) {",
                     "    if (false) {")],
    # the counters' three atomics as plain stores (timed only)
    "counter_stores": [
        ("      atomicAdd(&p.seg_tot[s], __popc(peers));\n"
         "      if (!(atomicOr(bits + s, bit) & bit)) "
         "atomicAdd(&p.seg_ng[s], 1);\n",
         "      p.seg_tot[s] = __popc(peers);\n      bits[s] = bit;\n"
         "      p.seg_ng[s] = 1;\n")],
    "phases": [
        ("namespace {\n\nconstexpr int kScanThreads",
         "__device__ unsigned long long g_phase[%d * 8];\n"
         "extern \"C\" int pg_phases(void* dst, long long n) {\n"
         "  return (int)cudaMemcpyFromSymbol(dst, g_phase, n * 8);\n"
         "}\n"
         "namespace {\n\nconstexpr int kScanThreads" % MAX_BLOCKS),
        _stamp("  const long long base = g * H, base2 = 2 * base;\n",
               "tile", 0),
        _stamp("  __syncthreads();\n  if (warp == 0) {\n"
               "    // the tile's last and first kept rows", "tile", 1,
               before=True),
        _stamp("  const int carry = s_carry;\n", "tile", 2),
        (_WALK_END, _WALK_END + _STAMP % ("tile", 3)),
        _stamp("  __shared__ int s_cnt[kScanWords];\n", "tile", 0),
        _stamp("    if (lane == 0) s_cnt[q * kScanWarps + warp] = "
               "__popc(m[q]);\n  }\n", "tile", 1),
        _stamp("    if (lane + 32 < kScanWords) s_cnt[lane + 32] = "
               "excl + tot[0] + e[1];\n  }\n  __syncthreads();\n", "tile",
               2),
        _stamp("  if (threadIdx.x == 0) atomicAdd(p.tiles + p.n_tile + 1, "
               "1ull);\n", "tile", 3),
        _stamp("  bool ovf = false;\n", _ARC, 0),
        _stamp("  if (__syncthreads_or(ovf) && threadIdx.x == 0) "
               "*p.overflow = 1;\n", _ARC, 3),
        _stamp("  __shared__ int64_t s_cm[kRepChunk][kRepChunk + 1];\n",
               _REP, 0),
        _stamp("    __threadfence();\n  }\n  __syncthreads();\n"
               "  const int q0", _REP, 1, before=True),
        _stamp("  __syncthreads();\n  // a warp a gene, lanes over the "
               "genomes\n", _REP, 2),
        (_REP_END, _REP_END + _STAMP % (_REP, 3))],
}
TIMED_ONLY = ("no_counters", "counter_stores")
CASES = ("walk_pairs", "walk_pairs_full", "branch_prep")


def states(dev):
    """{shape: {case: make}} on `dev` (testing.round_calls)."""
    from pangene_tpu_torch.testing import round_calls, round_state
    out = {}
    for shape, (G, H, ng, n_groups) in SHAPES.items():
        rng = np.random.default_rng(7)
        st = round_state(rng, G, H, S=ng, n_gene=ng,
                         sizes=tuple(rng.integers(1, 40, n_groups)),
                         n_invalid=4096, p_flt=0.01, p_shadow=0.005,
                         p_dead=0.02, min_valid=int(0.94 * H))
        # each gene once a genome where the genome has no more rows than
        # genes, in no order, each with a segment (the loop filters the
        # hits of genes without one), segments in gene order
        # (graph/vertex.py)
        st["gid"] = np.array([rng.choice(ng, H, replace=H > ng)
                              for _ in range(G)], np.int32)
        st["sid_of"] = np.arange(ng, dtype=np.int32)
        calls = round_calls(st, dev)
        out[shape] = {"walk_pairs": calls["walk_pairs"],
                      "walk_pairs_full": round_calls(
                          st, dev, form="full")["walk_pairs"],
                      "branch_prep": calls["branch_prep"]}
    return out


def parent_calls(lib):
    """{case: fn(*args, **kw)} launching the walk_pairs and branch_prep of
    a parent's csrc/loop_round.cu built as `lib` (the C entry points before
    this source's scans: a memset of nxt, the kept ranks in a [G, H]
    plane), on the arguments of the wrappers in ops/loop_kernels.py."""
    import pangene_tpu_torch.ops.loop_kernels as lk
    if hasattr(lib, "pg_walk_pairs_scratch"):
        raise SystemExit("--parent: the parent's loop_round.cu has the tiled "
                         "scans' C entry points; only the one-block-a-genome "
                         "source is supported")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pg_walk_pairs.restype = lib.pg_branch_prep.restype = i
    lib.pg_walk_pairs.argtypes = ([vp] * 13 + [i] * 6 + [ll, i] + [vp] * 5
                                  + [i, ll] + [vp] * 3)
    lib.pg_branch_prep.argtypes = ([vp] * 6 + [i] * 3 + [vp, ll, vp]
                                   + [i] * 3 + [vp] * 9)
    ptr = lambda t: t.data_ptr()

    def walk(planes, flt, shadow, alive, *, B, GB, jb, rank, use_ori,
             full=False):
        dev, (G, H), S = flt.device, flt.shape, alive.numel()
        new = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
        out = [new((G, 2 * H), torch.int64), new((G, 2 * H), torch.int32),
               new((G, H), torch.bool), new((G, H), torch.int32)]
        words = (G + 31) // 32
        zeroed = new(2 * S + S * words, torch.int32)
        stats = [new((G, 2 * H), torch.int32) for _ in range(2 * full)]
        err = lib.pg_walk_pairs(
            *map(ptr, planes), ptr(flt), ptr(shadow), ptr(alive), G, H, S,
            B, GB, jb, rank, int(use_ori), *map(ptr, out), ptr(zeroed),
            words, 4 * zeroed.numel(), *(list(map(ptr, stats)) or
                                         [None] * 2), lk._stream(dev))
        if err:
            raise RuntimeError("parent walk_pairs: CUDA error %d" % err)
        return tuple(out) + (zeroed[:2 * S].view(2, S),) + tuple(stats)

    def prep(flt, shadow, valid, gid, cid, cm, arc_vw, seg_gid, overflow,
             *, n_gene, B, D):
        dev, (G, H) = flt.device, flt.shape
        new = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
        out = (new((n_gene, G), torch.bool), new((n_gene, G), torch.int32),
               new((n_gene, G), torch.int64), new((n_gene, G), torch.int32),
               new(arc_vw.numel(), torch.int64))
        last, krank = new((n_gene, G), torch.int32), new((G, H), torch.int32)
        err = lib.pg_branch_prep(
            ptr(flt), ptr(shadow), ptr(valid), ptr(gid), ptr(cid), ptr(cm),
            G, H, n_gene, ptr(arc_vw), arc_vw.numel(), ptr(seg_gid),
            seg_gid.numel(), B, int(D), *map(ptr, out), ptr(overflow),
            ptr(last), ptr(krank), lk._stream(dev))
        if err:
            raise RuntimeError("parent branch_prep: CUDA error %d" % err)
        return out

    return {"walk_pairs": walk, "branch_prep": prep}


def phase_summary(buf, kinds):
    """Per kind of block (name: (first block, end), PHASES[name]): the
    mean and largest microseconds of each phase, the kind's span."""
    out = {}
    for kind, (lo, hi) in kinds.items():
        cols, names = PHASES[kind]
        if hi <= lo:
            continue
        t = buf[lo:hi][:, list(cols)].astype(np.int64)
        d = np.diff(t, axis=1) / 1e3
        out[kind] = {"blocks": hi - lo,
                     "span_us": float((t[:, -1].max() - t[:, 0].min())
                                      / 1e3),
                     "mean_us": dict(zip(names, d.mean(0).tolist())),
                     "max_us": dict(zip(names, d.max(0).tolist()))}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--parent", help="a parent checkout whose "
                    "csrc/loop_round.cu is timed beside the variants, "
                    "through its own C entry points (as \"parent\")")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke as cs
    import pangene_tpu_torch.ops.loop_kernels as lk
    from pangene_tpu_torch.testing import round_outputs
    from torch_sweep_ablation import build_variants
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs = {name: (lk.load_round(so), regs) for name, (so, regs) in
            build_variants(lk._SRC_ROUND, os.path.join(
                ROOT, "build", "round_ablation"), VARIANTS).items()}
    fns = {}
    if a.parent:
        so, regs = build_variants(
            os.path.join(a.parent, "pangene_tpu_torch", "csrc",
                         "loop_round.cu"),
            os.path.join(ROOT, "build", "round_ablation_parent"),
            {"parent": []})["parent"]
        fns["parent"] = parent_calls(ctypes.CDLL(so))
        libs["parent"] = (libs["committed"][0], regs)
    for name, (_, regs) in libs.items():
        print(name, json.dumps(regs), flush=True)
    dev = torch.device("cuda")
    cases = states(dev)
    fn = lambda case: case[:10] if case.startswith("walk") else case

    def call(name, case):
        return fns[name][fn(case)] if name in fns else getattr(lk, fn(case))

    for name, (lib, _) in libs.items():
        if name in TIMED_ONLY:
            continue
        lk._round = lib
        for shape, makes in cases.items():
            for case, make in makes.items():
                args, kw = make()
                got = call(name, case)(*args, **kw)
                if fn(case) == "branch_prep":
                    got = tuple(got) + (args[8],)
                args, kw = make()
                want = round_outputs(fn(case), args, kw, plain=True)
                if not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise AssertionError("%s %s %s != plain"
                                         % (name, shape, case))
    print("every variant but %s == plain" % (TIMED_ONLY,), flush=True)
    lk._round = libs["committed"][0]
    for shape, makes in cases.items():
        for case, make in makes.items():
            args, kw = make()
            got = round_outputs(fn(case), args, kw)
            b_ms, nbytes, what = cs.round_bound_ms(lk, fn(case), make, got)
            print(json.dumps({"bound": shape, "case": case, "ms": b_ms,
                              "bytes": nbytes, "shape": what}), flush=True)
    timed = [n for n in libs if n != "phases"]
    ms = {n: {s: {c: [] for c in CASES} for s in cases} for n in timed}
    for _ in range(a.rounds):
        for name in timed:
            lk._round = libs[name][0]
            for shape, makes in cases.items():
                for case, make in makes.items():
                    args, kw = make()
                    f = call(name, case)
                    ms[name][shape][case].append(cs.graph_ms(
                        lambda: f(*args, **kw), cs.TIMED_LAUNCHES))
            print(json.dumps({"variant": name, "ms": {
                s: {c: v[-1] for c, v in m.items()}
                for s, m in ms[name].items()}}), flush=True)
    print(json.dumps({"median_ms": {
        n: {s: {c: float(np.median(v)) for c, v in m.items()}
            for s, m in sm.items()} for n, sm in ms.items()}}), flush=True)
    # the phases of each block of one call (the committed tiles)
    lib = libs["phases"][0]
    lib.pg_phases.restype = ctypes.c_int
    lib.pg_phases.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lk._round = lib
    tile = 4 * 256
    for shape, makes in cases.items():
        G, H, _, _ = SHAPES[shape]
        n_tile = G * -(-H // tile)
        for case, make in makes.items():
            args, kw = make()
            getattr(lk, fn(case))(*args, **kw)
            torch.cuda.synchronize()
            buf = np.zeros(MAX_BLOCKS * 8, np.uint64)
            if lib.pg_phases(buf.ctypes.data, MAX_BLOCKS * 8):
                raise RuntimeError("reading the phase stamps failed")
            buf = buf.reshape(MAX_BLOCKS, 8)
            if case.startswith("walk"):
                kinds = {"walk": (0, n_tile)}
            else:
                A, ng = args[6].numel(), kw["n_gene"]
                n_arc = -(-A // tile)
                n_rep = -(-ng // 32) * -(-G // 32)
                kinds = {"tile": (0, n_tile),
                         "arcs": (n_tile, n_tile + n_arc),
                         "reps": (n_tile + n_arc, n_tile + n_arc + n_rep)}
            print(json.dumps({"phases": shape, "case": case,
                              "kinds": phase_summary(buf, kinds)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
