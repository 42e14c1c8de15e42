#!/usr/bin/env python3
"""Ablation of the device loop's round kernels walk_pairs, branch_prep,
prop_round and occ_round (pangene_tpu_torch/csrc/loop_round.cu), on one
NVIDIA GPU. Run from the root of a checkout:

    python3 scripts/torch_round_ablation.py [--rounds 2] [--parent DIR]
        [--variants NAME,...] [--cases NAME,...]

Builds the source as it is and in variants made by textual substitution
(VARIANTS, all built at once into build/round_ablation/ by
torch_sweep_ablation.build_variants): the tile's rows a thread and threads
a block (the scans' and prop_round's tiles); walk_pairs' carry from a
thread-block cluster of a genome's tiles in place of the look-back (with
tiles of 2,048 rows, so that a genome fits a cluster of at most 16; the
kernel ships only the look-back, so CLUSTER holds the cluster form as
text); its launch bound capped for 6 or 8 blocks a SM; its segment
counters without the warp's merge of repeated segments, as plain stores in
place of their atomics, or gone; prop_round without the nxt lookups, with
its cs rows staged from the tile's own window in shared memory in place
of direct reads (PROP_WINDOW), and at other register caps; occ_round
without its hit blocks, in the atomic form (ATOMIC_OCC: blocks that zero
the degree row and the loci plane, then arc blocks that add the degrees
and loci by atomics, then the segment blocks reading them), as arc tiles
that own their segments in place of segment blocks that search for their
arcs (ARC_TILES), with 32, 128 or 256 segments a block, with its runs
read 2,048 or 512 arcs a step, and at other register caps. The variants named in TIMED_ONLY are timed only (their
outputs differ); every other is held against the plain PyTorch versions,
then all are timed in turns (a, b, c, a, b, c, ...): device time a call of
200 calls replayed from one CUDA graph (chip_smoke.graph_ms) beside the
bound chip_smoke.round_bound_ms computes, on states made from seeded numpy
(testing.round_state) at the big and north-star loops' shapes: G genomes
of H rows, about 97% of them valid and 98.5% of those kept, n_gene genes
and segments (each gene once a genome at the north star, in no order,
each with its own segment), groups of 1-39 arcs; walk_pairs lean (the
in-loop key) and full (the tail's), branch_prep; prop_round and
occ_round on an arc table as the loop's (loop_arcs: 71% of the loop's A
valid, 12-16 arcs a vertex, as chip_smoke.py's 4d lines show it) and a
cm order as local as the loops' (each valid row's cs row its own but for
adjacent swaps of 3.5% of them; the arc rows random, as the loops' are),
prop_round also ("prop_round_scattered") on the first state's own cm
order, random within each contig, occ_round in a branch round with the
cuts. "phases" stamps the card's global timer at each phase of each
block (walk_pairs: loads and ballots, publish and look-back, the rows'
writes; branch_prep's tiles: loads and atomics, look-back, words; its
representative blocks: the wait for the tiles, the gathers, the writes;
its arc blocks; prop_round: loads and gathers, the rows, the count;
occ_round's segment blocks: the lower bounds, the runs, the decisions, the
counts; its hit blocks: loads, the wait, the alive bits, the writes) and
prints their means and spans. With --parent DIR, the kernels of DIR's
pangene_tpu_torch/csrc/loop_round.cu (a parent commit unpacked there) are
checked and timed as one more variant, "parent", through their own C entry
points: prop_round and occ_round from before their redesign (no scratch;
their entry points are the same from the first source to the one before
this redesign), and walk_pairs and branch_prep where the parent's differ
from these (the source before the tiled scans, whose walk_pairs is one
block a genome: a [G, H] kept-rank plane and no pg_walk_pairs_scratch); a
source with pg_round_scratch raises. --variants and --cases pick what it
builds and times. Prints the card, each variant's
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
# name: (G, H, genes = segments, arc groups, the loop's arc table A)
SHAPES = {"big": (64, 10240, 10000, 16000, 327680),
          "northstar": (100, 18944, 19000, 38000, 831488)}
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
          "arcs": ((0, 3), ("all",)),
          "prop": ((0, 1, 2, 3), ("loads_gathers", "compute_writes",
                                  "grid_done")),
          "seg": ((0, 1, 2, 3, 4), ("lower_bounds", "runs", "decide_writes",
                                    "counts_done")),
          "hit": ((0, 1, 2, 3, 4), ("loads", "wait", "alive",
                                    "writes_done"))}
_PROP = "blockIdx.x"
_SEG = "constexpr int kSegBlock = 64;"
_OCC_END = "    atomicExch(p.acc + 5, 0ull);\n  }\n}\n"
_SET_WORD = ("  set_word(p, n_prop, changed);\n}\n\n"
             "// The call without propagation")
_WAIT = ("  if (threadIdx.x == 0) {\n    while ((tile_load(p.acc) >> 48) < "
         "static_cast<unsigned long long>(p.n_seg))")
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
        _stamp("  const int64_t wmask = (int64_t(1) << p.B) - 1;\n", _ARC,
               0),
        _stamp("    p.tgt[a] = tg < 0 ? 0 : (tg > p.ng - 1 ? p.ng - 1 : tg);"
               "\n  }\n", _ARC, 3),
        _stamp("  __shared__ int64_t s_cm[kRepChunk][kRepChunk + 1];\n",
               _REP, 0),
        _stamp("    __threadfence();\n  }\n  __syncthreads();\n"
               "  const int q0", _REP, 1, before=True),
        _stamp("  __syncthreads();\n  // a warp a gene, lanes over the "
               "genomes\n", _REP, 2),
        (_REP_END, _REP_END + _STAMP % (_REP, 3)),
        # prop_round: its loads and gathers, the rows, grid_done
        _stamp("  const int32_t* arc = p.pair_arc + 2 * base;\n", _PROP, 0),
        _stamp("    s_fwd[q * kScanThreads + threadIdx.x] = static_cast<uint8_t>"
               "(mf[q]);\n", _PROP, 1),
        (_SET_WORD, _STAMP % (_PROP, 2) + "  set_word(p, n_prop, changed);\n"
         + _STAMP % (_PROP, 3) + _SET_WORD[_SET_WORD.index("}"):]),
        # occ_round's segment blocks and hit blocks, and every block's end
        _stamp("  const bool mine = static_cast<int>(threadIdx.x) < ns;\n",
               "c", 0),
        _stamp("    block_lower_bounds(p, x, k1, s_b);\n", "c", 1),
        _stamp("    if (mine) {\n      const int xs", "c", 2, before=True),
        _stamp("  p.tot_row[s] = tot;\n", "c", 3),
        _stamp("  int32_t sh[kRowVec];\n", "c + p.n_seg", 0),
        _stamp(_WAIT, "c + p.n_seg", 1, before=True),
        _stamp("  __syncthreads();\n  bool hit = false;\n", "c + p.n_seg", 2),
        _stamp("  if (!hit) return;", "c + p.n_seg", 3, before=True),
        (_OCC_END, _OCC_END[:-2] + _STAMP % ("t", 4) + "}\n")],
}


def _between(first, last):
    """The text of the source from `first` through `last`."""
    with open(os.path.join(ROOT, "pangene_tpu_torch", "csrc",
                           "loop_round.cu")) as fp:
        src = fp.read()
    i = src.index(first)
    return src[i:src.index(last, i) + len(last)]


# prop_round with the tile's own cs rows staged in shared memory (weak,
# flt, valid read with the pair planes, before ordcm is known), a cs row
# outside that window read directly
_IN = "static_cast<unsigned>(r[q] - i0) < static_cast<unsigned>(kScanTile)"
PROP_WINDOW = [
    ("  int r[kScanRows], j[kScanRows], af[kScanRows], ar[kScanRows];\n",
     "  __shared__ uint8_t s_weak[kScanTile], s_flt[kScanTile], "
     "s_valid[kScanTile];\n  uint8_t sw[kScanRows], sf[kScanRows], "
     "sv[kScanRows];\n"
     "  int r[kScanRows], j[kScanRows], af[kScanRows], ar[kScanRows];\n"),
    ("    ok[q] = false;\n", "    ok[q] = false;\n    sw[q] = sf[q] = sv[q] = 0;\n"),
    ("      j[q] = p.nxt[base + i];\n",
     "      j[q] = p.nxt[base + i];\n      sw[q] = p.weak[base + i];\n"
     "      sf[q] = p.flt[base + i];\n      sv[q] = p.valid[base + i];\n"),
    ("    if (row) {\n", "    if (row && !(" + _IN + ")) {\n"),
    ("  for (int q = 0; q < kScanRows; ++q)\n"
     "    s_fwd[q * kScanThreads + threadIdx.x] = static_cast<uint8_t>"
     "(mf[q]);\n",
     "  for (int q = 0; q < kScanRows; ++q) {\n"
     "    const int x = q * kScanThreads + threadIdx.x;\n"
     "    s_fwd[x] = static_cast<uint8_t>(mf[q]);\n"
     "    s_weak[x] = sw[q];\n    s_flt[x] = sf[q];\n    s_valid[x] = sv[q];\n"
     "  }\n"),
    ("    int w = w0[q];\n",
     "    int w = w0[q], fl = f0[q], va = v0[q];\n"
     "    if (" + _IN + ") {\n      w = s_weak[r[q] - i0];\n"
     "      fl = s_flt[r[q] - i0];\n      va = s_valid[r[q] - i0];\n    }\n"),
    ("    if (w == 2 && f0[q] == 0) {", "    if (w == 2 && fl == 0) {"),
    ("    n_prop += (w != 0) & (v0[q] != 0);", "    n_prop += (w != 0) & (va != 0);"),
]
# occ_round's atomic form: blocks that zero the degree row (and the loci
# plane in a branch round), arc blocks that add each vertex's degree (one
# atomic a vertex a warp) and n_grp into the loci by atomics, then the
# segment blocks reading both, each kind waiting for the one before
ATOMIC_OCC = [
    ("  long long n_seg;         // segment blocks (the hit blocks follow)\n",
     "  long long n_seg;         // segment blocks (the hit blocks follow)\n"
     "  long long n_zero, n_arc;\n"),
    (_between("  int d0 = 0, d1 = 0;\n  if (p.n_grp || p.do_occ) {",
              "  bool del = false;\n"),
     """  int d0 = 0, d1 = 0;
  if (threadIdx.x == 0) {
    while ((tile_load(p.acc) >> 48) <
           static_cast<unsigned long long>(p.n_zero + p.n_arc))
      __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
  if (mine) {
    d0 = __ldcg(p.deg_row + 2 * s);
    d1 = __ldcg(p.deg_row + 2 * s + 1);
    if (p.n_grp) {
      l0 = __ldcg(p.loci + 2 * s);
      l1 = __ldcg(p.loci + 2 * s + 1);
    }
  }
  bool del = false;
"""),
    ("    while ((tile_load(p.acc) >> 48) < static_cast<unsigned long long>"
     "(p.n_seg))",
     "    while ((tile_load(p.acc) >> 48) <\n"
     "           static_cast<unsigned long long>(p.n_zero + p.n_arc + "
     "p.n_seg))"),
    ("// One launch: blocks take tickets, the segment blocks first",
     """__device__ void occ_zero(const OccArgs& p, long long c) {
  const long long x0 = (c * kScanThreads + threadIdx.x) * kRowVec;
  for (long long x = x0; x < x0 + kRowVec && x < 2ll * p.S; ++x) {
    p.deg_row[x] = 0;
    if (p.n_grp) p.loci[x] = 0;
  }
  __threadfence();
}

__device__ void occ_arcs(const OccArgs& p, long long c) {
  if (threadIdx.x == 0) {
    while ((tile_load(p.acc) >> 48) <
           static_cast<unsigned long long>(p.n_zero))
      __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
  for (int q = 0; q < kScanRows; ++q) {
    const long long a = (c * kScanRows + q) * kScanThreads + threadIdx.x;
    int key = -1;
    if (a < p.A) {
      const int64_t vw = p.arc_vw[a];
      const int64_t v = vw >> p.B;
      if (p.n_grp) {
        const int n = p.n_grp[a];
        if (n) atomicAdd(&p.loci[clampi(v >> 1, 0, p.S - 1) * 2 + (v & 1)],
                         n);
      }
      if (p.do_occ && vw != kSent) key = clampi(v, 0, 2 * p.S - 1);
    }
    const unsigned peers = __match_any_sync(kFull, key);
    if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&p.deg_row[key], __popc(peers));
  }
  __threadfence();
}

// One launch: blocks take tickets, the segment blocks first"""),
    ("  if (t < p.n_seg) {\n",
     """  if (t < p.n_zero) {
    occ_zero(p, t);
  } else if (t < p.n_zero + p.n_arc) {
    occ_arcs(p, t - p.n_zero);
  } else if (t < p.n_zero + p.n_arc + p.n_seg) {
"""),
    ("    occ_segs(p, t, k1, v, changed);\n",
     "    occ_segs(p, t - p.n_zero - p.n_arc, k1, v, changed);\n"),
    ("    occ_hits<kVec>(p, t - p.n_seg, changed);\n",
     "    occ_hits<kVec>(p, t - p.n_zero - p.n_arc - p.n_seg, changed);\n"),
    ("  const long long blocks = p.n_seg + (do_occ && n > 0 ? row_blocks(n) "
     ": 0);",
     """  p.n_zero = (2ll * S + kScanThreads * kRowVec - 1) /
             (kScanThreads * kRowVec);
  p.n_arc = n_grp || do_occ ? (A + kScanTile - 1) / kScanTile : 0;
  const long long blocks = p.n_zero + p.n_arc + p.n_seg +
                           (do_occ && n > 0 ? row_blocks(n) : 0);"""),
]
# occ_round as arc tiles in place of the segment blocks (head-major): a
# tile of the arc table owns the segments whose first strand's lower bound
# lies in it, reads its vertices and kLook more into shared memory, marks
# the runs' first positions, numbers its segments by a block-wide scan and
# decides them a thread each (no search); the alive bits by atomics
ARC_TILES = [
    (_between("constexpr int kSegBlock = 64;",
              "// Hits of dead genes leave the walk"),
     """constexpr int kArcKeys = 4;                        // occ_round: arcs a thread
constexpr int kArcTile = kScanThreads * kArcKeys;  // arc positions a tile
constexpr int kLook = kScanThreads;                // positions past it read
constexpr int kOccBlocksPerSm = 4;                 // at most 64 registers

struct OccArgs {
  uint8_t* alive;          // [S], in place
  uint8_t* flt;            // [G, H], in place
  const uint8_t* valid;
  const int32_t* gid;
  const int32_t* sid_of;   // [ng]
  int ng;
  long long n;             // G * H
  const int64_t* arc_vw;   // [A]
  long long A;
  int B, S;
  const int32_t* seg_tot;  // [S]
  int32_t* loci;           // [S, 2], in place in a branch round
  const int32_t* n_grp;    // [A] or null
  int do_occ;
  long long occ_cut;
  int deg_cut, loci_cut;
  unsigned long long* log_row;   // logs[r, 3:7]: n_occ n_deg n_loci alive
  uint8_t* mask_row;       // [S]
  int32_t* deg_row;        // [2S]
  int32_t* loci_row;       // [2S]
  int32_t* tot_row;        // [S]
  unsigned long long* word;      // (n_prop, changed): changed OR'd
  // scratch: grid_done's word, the four counts, the ticket
  unsigned long long* acc;
  uint32_t* alive_bits;    // scratch: alive after the deletion, 32 a word
  long long n_tile;        // arc tiles (the hit blocks follow)
};

// The source vertex of arc position a: -1 before the table, 2S for an
// empty slot and past it, so that the keys of the v-sorted table rise.
__device__ __forceinline__ int arc_vertex(const OccArgs& p, long long a) {
  if (a < 0) return -1;
  if (a >= p.A) return 2 * p.S;
  const int64_t vw = p.arc_vw[a];
  if (vw == kSent) return 2 * p.S;
  const int64_t v = vw >> p.B;
  return v < 0 ? 0 : (v > 2 * p.S ? 2 * p.S : static_cast<int>(v));
}

// The first position past `last` (a position of vertex `key`'s run) whose
// vertex differs, galloping then halving: for a run longer than a tile's
// look-ahead.
__device__ long long run_end(const OccArgs& p, long long last, int key) {
  long long lo = last, hi = last + 1, step = 1;
  while (arc_vertex(p, hi) == key) {
    lo = hi;
    hi += step;
    step *= 2;
  }
  while (hi - lo > 1) {
    const long long mid = lo + (hi - lo) / 2;
    if (arc_vertex(p, mid) == key) lo = mid; else hi = mid;
  }
  return hi;
}

// Shared state of an arc tile: the vertices of its positions a0 - 1 ..
// a0 + kSpan - 1, the runs' first positions among them (bits), and the
// segments each position owns, counted before it.
constexpr int kSpan = kArcTile + kLook;
struct TileRuns {
  int key[kSpan + 1];
  unsigned bnd[kSpan / 32];
  int off[kArcTile];
  int warp_sum[kScanWarps];
  int total;
};

// The vertex at tile position y (a0 + y), from shared memory or past it.
__device__ __forceinline__ int key_at(const OccArgs& p, const TileRuns& t,
                                      long long a0, int y) {
  return y < kSpan ? t.key[y + 1] : arc_vertex(p, a0 + y);
}

// The tile position of the first run after the one at tile position y.
__device__ int next_run(const OccArgs& p, const TileRuns& t, long long a0,
                        int y) {
  for (int z = y + 1; z < kSpan;) {
    const unsigned m = t.bnd[z >> 5] >> (z & 31);
    if (m) return z + __ffs(m) - 1;
    z = (z | 31) + 1;
  }
  if (y >= kSpan) return static_cast<int>(run_end(p, a0 + y, key_at(p, t, a0, y)) - a0);
  return static_cast<int>(run_end(p, a0 + kSpan - 1, t.key[y + 1]) - a0);
}

// One segment s, owned by the run boundary at tile position y (vertex x
// there): its strands' degrees and loci, the deletion, the capture rows,
// its alive bit, the counts.
__device__ void occ_segment(const OccArgs& p, const TileRuns& t, long long a0,
                            int y, int x, int s, unsigned (&v)[4],
                            bool& changed) {
  bool al = p.alive[s] != 0;
  const int32_t tot = p.seg_tot[s];
  int32_t l0 = 0, l1 = 0;
  if (!p.n_grp) {
    l0 = p.loci[2 * s];
    l1 = p.loci[2 * s + 1];
  }
  int d0 = 0, d1 = 0, y1 = -1;
  if (x == 2 * s) {
    const int e = next_run(p, t, a0, y);
    d0 = e - y;
    if (p.n_grp) l0 = p.n_grp[a0 + y];
    if (key_at(p, t, a0, e) == 2 * s + 1) y1 = e;
  } else if (x == 2 * s + 1) {
    y1 = y;
  }
  if (y1 >= 0) {
    d1 = next_run(p, t, a0, y1) - y1;
    if (p.n_grp) l1 = p.n_grp[a0 + y1];
  }
  if (p.n_grp) {
    p.loci[2 * s] = l0;
    p.loci[2 * s + 1] = l1;
  }
  bool del = false;
  if (p.do_occ) {
    const bool od = al && static_cast<long long>(tot) > p.occ_cut;
    const bool dd = al && (d0 > p.deg_cut || d1 > p.deg_cut);
    const bool ld = al && (l0 > l1 ? l0 : l1) > p.loci_cut;
    v[0] += od;
    v[1] += dd && !od;
    v[2] += ld && !dd && !od;
    del = od || dd || ld;
    if (del) {
      p.alive[s] = 0;
      al = false;
      changed = true;
    }
  } else {
    d0 = d1 = 0;
  }
  v[3] += al;
  const unsigned bit = 1u << (s & 31);
  if (al)
    atomicOr(p.alive_bits + (s >> 5), bit);
  else
    atomicAnd(p.alive_bits + (s >> 5), ~bit);
  p.mask_row[s] = del;
  p.deg_row[2 * s] = d0;
  p.deg_row[2 * s + 1] = d1;
  p.loci_row[2 * s] = l0;
  p.loci_row[2 * s + 1] = l1;
  p.tot_row[s] = tot;
}

// One tile of kArcTile positions of the v-sorted arc table (valid arcs
// first) and the segments it owns. A vertex's arcs are one run and n_grp
// is non-zero only at a run's first arc, so a vertex's degree is its run's
// length and its loci the n_grp there; the first position whose vertex is
// >= x is a boundary between runs (or a run's start), and segment s is
// the tile's when that position for x = 2s lies in it (position A, past
// the table, in the last tile): the run there is of 2s, of 2s + 1 (2s has
// none) or of a later vertex (s has no arc), and the run of 2s + 1 follows
// the run of 2s. The tile reads its vertices and kLook more into shared
// memory, marks the boundaries, numbers its segments by a block-wide scan
// of each boundary's count and takes them a thread each: no search, no
// atomic but on the alive bits, nothing to zero.
__device__ void occ_tile(const OccArgs& p, long long c, unsigned (&v)[4],
                         bool& changed) {
  __shared__ TileRuns t;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long a0 = c * kArcTile;
  int k[kArcKeys + 1];
#pragma unroll
  for (int q = 0; q <= kArcKeys; ++q)
    k[q] = arc_vertex(p, a0 + q * kScanThreads + threadIdx.x);
  const int k_prev = threadIdx.x == 0 ? arc_vertex(p, a0 - 1) : 0;
#pragma unroll
  for (int q = 0; q <= kArcKeys; ++q) t.key[1 + q * kScanThreads + threadIdx.x] = k[q];
  if (threadIdx.x == 0) t.key[0] = k_prev;
  __syncthreads();
  // the runs' first positions, a word a warp
#pragma unroll
  for (int q = 0; q <= kArcKeys; ++q) {
    const int y = q * kScanThreads + threadIdx.x;
    const unsigned m = __ballot_sync(kFull, k[q] != t.key[y]);
    if (lane == 0) t.bnd[y >> 5] = m;
  }
  // the segments each position owns: kArcKeys positions in a row a thread
  int cnt[kArcKeys], sum = 0;
#pragma unroll
  for (int e = 0; e < kArcKeys; ++e) {
    const int y = threadIdx.x * kArcKeys + e;
    const int u = t.key[y], x = t.key[y + 1];
    int n = 0;
    if (u != x && a0 + y <= p.A) {
      const int hi = (x >> 1) < p.S - 1 ? (x >> 1) : p.S - 1;
      n = hi - ((u + 2) >> 1) + 1;
      n = n > 0 ? n : 0;
    }
    cnt[e] = n;
    sum += n;
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) t.warp_sum[warp] = incl;
  __syncthreads();
  int off = incl - sum;
  for (int w = 0; w < warp; ++w) off += t.warp_sum[w];
#pragma unroll
  for (int e = 0; e < kArcKeys; ++e) {
    t.off[threadIdx.x * kArcKeys + e] = off;
    off += cnt[e];
  }
  if (threadIdx.x == kScanThreads - 1) t.total = off;
  __syncthreads();
  for (int i = threadIdx.x; i < t.total; i += kScanThreads) {
    // the last position whose count starts at or before i
    int lo = 0, hi = kArcTile - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.off[mid] <= i) lo = mid; else hi = mid - 1;
    }
    const int s = ((t.key[lo] + 2) >> 1) + (i - t.off[lo]);
    occ_segment(p, t, a0, lo, t.key[lo + 1], s, v, changed);
  }
}

// Hits of dead genes leave the walk"""),
    ("    while ((tile_load(p.acc) >> 48) < static_cast<unsigned long long>"
     "(p.n_seg))",
     "    while ((tile_load(p.acc) >> 48) < static_cast<unsigned long long>"
     "(p.n_tile))"),
    ("  const long long k1 = p.n_grp || p.do_occ ? first_probe(p) : 0;\n", ""),
    ("  if (t < p.n_seg) {\n", "  if (t < p.n_tile) {\n"),
    ("    occ_segs(p, t, k1, v, changed);\n", "    occ_tile(p, t, v, changed);\n"),
    ("    occ_hits<kVec>(p, t - p.n_seg, changed);\n",
     "    occ_hits<kVec>(p, t - p.n_tile, changed);\n"),
    ("  p.n_seg = (S + kSegBlock - 1) / kSegBlock;\n"
     "  const long long blocks = p.n_seg + (do_occ && n > 0 ? row_blocks(n) "
     ": 0);",
     "  p.n_tile = A / kArcTile + 1;      // position A lies in the last\n"
     "  const long long blocks = p.n_tile + (do_occ && n > 0 ? row_blocks(n) "
     ": 0);"),
]
VARIANTS.update({
    # prop_round: no next pair read (timed only), and its cs rows read
    # directly at ordcm in place of the tile's staged window
    "prop_no_nxt": [("      j[q] = p.nxt[base + i];\n",
                     "      j[q] = -1;\n")],
    "prop_window": PROP_WINDOW,
    # occ_round: no hit blocks (timed only), and the atomic form
    "occ_no_hits": [("  const long long blocks = p.n_seg + (do_occ && n > 0 "
                     "? row_blocks(n) : 0);",
                     "  const long long blocks = p.n_seg;")],
    "occ_atomic": ATOMIC_OCC,
    # registers not capped, or capped for 4 or 6 blocks of 256 threads a
    # SM (the source: 5 for prop_round, 4 for occ_round)
    "prop_blocks1": [("constexpr int kPropBlocksPerSm = 5;",
                      "constexpr int kPropBlocksPerSm = 1;")],
    "prop_blocks4": [("constexpr int kPropBlocksPerSm = 5;",
                      "constexpr int kPropBlocksPerSm = 4;")],
    "prop_blocks6": [("constexpr int kPropBlocksPerSm = 5;",
                      "constexpr int kPropBlocksPerSm = 6;")],
    "occ_blocks1": [("constexpr int kOccBlocksPerSm = 4;",
                     "constexpr int kOccBlocksPerSm = 1;")],
    "occ_blocks6": [("constexpr int kOccBlocksPerSm = 4;",
                     "constexpr int kOccBlocksPerSm = 6;")],
    # segments a segment block (and so arcs a block)
    "occ_seg32": [(_SEG, _SEG.replace("64;", "32;"))],
    "occ_seg128": [(_SEG, _SEG.replace("64;", "128;"))],
    "occ_seg256": [(_SEG, _SEG.replace("64;", "256;"))],
    # arcs a segment block reads a step of its runs
    "occ_runs2048": [("constexpr int kRunKeys = 4;",
                      "constexpr int kRunKeys = 8;")],
    "occ_runs512": [("constexpr int kRunKeys = 4;",
                     "constexpr int kRunKeys = 2;")],
    "occ_arc_tiles": ARC_TILES,
})
SEG_BLOCK = int(_SEG.split("=")[1].strip(" ;"))    # the source's kSegBlock
TIMED_ONLY = ("no_counters", "counter_stores", "prop_no_nxt", "occ_no_hits")
# case: the kernel it times
CASES = {"walk_pairs": "walk_pairs", "walk_pairs_full": "walk_pairs",
         "branch_prep": "branch_prep", "prop_round": "prop_round",
         "prop_round_scattered": "prop_round", "occ_round": "occ_round"}
SCRATCH = ("prop_round", "occ_round")


def states(dev):
    """{shape: {case: make}} on `dev` (testing.round_calls)."""
    from pangene_tpu_torch.testing import round_calls, round_state
    out = {}
    for shape, (G, H, ng, n_groups, A) in SHAPES.items():
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
        # the loop's arc table and a cm order as local as the loops', for
        # prop_round and occ_round (the arc rows stay random: so are the
        # loops', gene ids being in no genome's order)
        lst = dict(st, **loop_arcs(rng, ng, A, st["B"]))
        lst.update(ordcm=local_ordcm(rng, st))
        out[shape] = {"walk_pairs": calls["walk_pairs"],
                      "walk_pairs_full": round_calls(
                          st, dev, form="full")["walk_pairs"],
                      "branch_prep": calls["branch_prep"],
                      "prop_round": round_calls(lst, dev)["prop_round"],
                      "prop_round_scattered": calls["prop_round"],
                      "occ_round": round_calls(lst, dev)["occ_round"]}
    return out


def loop_arcs(rng, S, A, B):
    """An arc table as the loop's (arc_vw, n_grp, arc_weak of A slots), as
    chip_smoke.py's 4d lines show it on the big and north-star loops: 71%
    of the slots valid arcs, 95% of the vertices with out-arcs (1 + a
    Poisson number of them), the rest of the slots empty."""
    from pangene_tpu_torch.ops.loop_kernels import SENT_I
    vs = np.sort(rng.choice(2 * S, int(0.95 * 2 * S), replace=False))
    sizes = 1 + rng.poisson(0.71 * A / len(vs) - 1, len(vs))
    keep = np.cumsum(sizes) <= A
    vs, sizes = vs[keep], sizes[keep]
    v = np.repeat(vs, sizes)
    vw = np.sort((v.astype(np.int64) << B) | rng.integers(0, 2 * S, len(v)))
    heads = np.cumsum(sizes) - sizes
    n_grp = np.zeros(A, np.int32)
    n_grp[heads] = np.where(sizes >= 2, rng.integers(1, 4, len(sizes)), 0)
    arc_vw = np.full(A, SENT_I, np.int64)
    arc_vw[:len(vw)] = vw
    return dict(arc_vw=arc_vw, n_grp=n_grp,
                arc_weak=rng.choice(3, A).astype(np.uint8))


def local_ordcm(rng, st, p_swap=0.035):
    """A cm order as local as the loops' (testing.ordcm_locality on
    their captured calls): each valid row's own cs row, but for a share
    p_swap of them swapped with the next valid row."""
    G, H = st["valid"].shape
    o = np.tile(np.arange(H, dtype=np.int32), (G, 1))
    for g in range(G):
        nk = int(st["valid"][g].sum())
        a = np.flatnonzero(rng.random(max(nk - 1, 0)) < p_swap)
        a = a[np.diff(a, prepend=-2) > 1]       # disjoint pairs
        o[g, a], o[g, a + 1] = o[g, a + 1], o[g, a].copy()
    return o


def parent_calls(lib):
    """{case: fn(*args, **kw)} launching a parent's csrc/loop_round.cu built
    as `lib` on the arguments of the wrappers in ops/loop_kernels.py:
    prop_round and occ_round before their redesign (a memset of the word,
    grid-stride launches, no scratch), and, when the parent's are the ones
    before the tiled scans (no pg_walk_pairs_scratch: a memset of nxt, the
    kept ranks in a [G, H] plane), walk_pairs and branch_prep."""
    import pangene_tpu_torch.ops.loop_kernels as lk
    if hasattr(lib, "pg_round_scratch"):
        raise SystemExit("--parent: the parent's loop_round.cu has this "
                         "source's prop_round and occ_round (a "
                         "pg_round_scratch); give a source from before them")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ptr = lambda t: None if t is None else t.data_ptr()
    lib.pg_prop_round.restype = lib.pg_occ_round.restype = i
    lib.pg_prop_round.argtypes = [vp] * 3 + [ll, i, i] + [vp] * 5 + [ll, vp,
                                                                   vp]
    lib.pg_occ_round.argtypes = ([vp] * 5 + [i, ll, vp, ll, i, i] + [vp] * 3
                                 + [i, ll, i, i] + [vp] * 7)

    def check(name, err):
        if err:
            raise RuntimeError("parent %s: CUDA error %d" % (name, err))

    def prop(weak, flt, valid, ordcm, pair_arc, nxt, pair_ok, arc_weak, word,
             *, propagate):
        G, H = weak.shape
        check("prop_round", lib.pg_prop_round(
            ptr(weak), ptr(flt), ptr(valid), G, H, int(propagate),
            ptr(ordcm), ptr(pair_arc), ptr(nxt), ptr(pair_ok),
            ptr(arc_weak), arc_weak.numel(), ptr(word),
            lk._stream(weak.device)))

    def occ(alive, flt, valid, gid, sid_of, arc_vw, seg_tot, loci, logs,
            dcap_mask, dcap_deg, dcap_loci, dcap_tot, word, *, r, B,
            n_grp=None, cuts=None):
        S = alive.numel()
        c = cuts if cuts is not None else (0, 0, 0)
        check("occ_round", lib.pg_occ_round(
            ptr(alive), ptr(flt), ptr(valid), ptr(gid), ptr(sid_of),
            sid_of.numel(), flt.numel(), ptr(arc_vw), arc_vw.numel(), B, S,
            ptr(seg_tot), ptr(loci), ptr(n_grp), int(cuts is not None),
            int(c[0]), int(c[1]), int(c[2]),
            ptr(logs) + 8 * (10 * r + 3), ptr(dcap_mask) + r * S,
            ptr(dcap_deg) + 8 * r * S, ptr(dcap_loci) + 8 * r * S,
            ptr(dcap_tot) + 4 * r * S, ptr(word), lk._stream(alive.device)))

    out = {"prop_round": prop, "occ_round": occ}
    if hasattr(lib, "pg_walk_pairs_scratch"):
        return out
    lib.pg_walk_pairs.restype = lib.pg_branch_prep.restype = i
    lib.pg_walk_pairs.argtypes = ([vp] * 13 + [i] * 6 + [ll, i] + [vp] * 5
                                  + [i, ll] + [vp] * 3)
    lib.pg_branch_prep.argtypes = ([vp] * 6 + [i] * 3 + [vp, ll, vp]
                                   + [i] * 3 + [vp] * 9)

    def walk(planes, flt, shadow, alive, *, B, GB, jb, rank, use_ori,
             full=False):
        dev, (G, H), S = flt.device, flt.shape, alive.numel()
        new = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
        out = [new((G, 2 * H), torch.int64), new((G, 2 * H), torch.int32),
               new((G, H), torch.bool), new((G, H), torch.int32)]
        words = (G + 31) // 32
        zeroed = new(2 * S + S * words, torch.int32)
        stats = [new((G, 2 * H), torch.int32) for _ in range(2 * full)]
        check("walk_pairs", lib.pg_walk_pairs(
            *map(ptr, planes), ptr(flt), ptr(shadow), ptr(alive), G, H, S,
            B, GB, jb, rank, int(use_ori), *map(ptr, out), ptr(zeroed),
            words, 4 * zeroed.numel(), *(list(map(ptr, stats)) or
                                         [None] * 2), lk._stream(dev)))
        return tuple(out) + (zeroed[:2 * S].view(2, S),) + tuple(stats)

    def prep(flt, shadow, valid, gid, cid, cm, arc_vw, seg_gid, *, n_gene,
             B, D=64):
        # the parent's entry also checks a branch window of D arcs
        dev, (G, H) = flt.device, flt.shape
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        new = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
        out = (new((n_gene, G), torch.bool), new((n_gene, G), torch.int32),
               new((n_gene, G), torch.int64), new((n_gene, G), torch.int32),
               new(arc_vw.numel(), torch.int64))
        last, krank = new((n_gene, G), torch.int32), new((G, H), torch.int32)
        check("branch_prep", lib.pg_branch_prep(
            ptr(flt), ptr(shadow), ptr(valid), ptr(gid), ptr(cid), ptr(cm),
            G, H, n_gene, ptr(arc_vw), arc_vw.numel(), ptr(seg_gid),
            seg_gid.numel(), B, int(D), *map(ptr, out), ptr(overflow),
            ptr(last), ptr(krank), lk._stream(dev)))
        return out

    out.update(walk_pairs=walk, branch_prep=prep)
    return out


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
    ap.add_argument("--variants", help="comma-separated names of VARIANTS "
                    "to build and time (default all; \"committed\" always)")
    ap.add_argument("--cases", help="comma-separated names of CASES to "
                    "check and time (default all)")
    a = ap.parse_args()
    variants = VARIANTS if not a.variants else {
        n: VARIANTS[n] for n in ["committed"] + a.variants.split(",")}
    cases_on = list(CASES) if not a.cases else a.cases.split(",")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke as cs
    import pangene_tpu_torch.ops.loop_kernels as lk
    from pangene_tpu_torch.testing import ROUND_INPLACE, round_outputs
    from torch_sweep_ablation import build_variants
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs = {name: (lk.load_round(so), regs) for name, (so, regs) in
            build_variants(lk._SRC_ROUND, os.path.join(
                ROOT, "build", "round_ablation"), variants).items()}
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
    cases = {shape: {c: m for c, m in makes.items() if c in cases_on}
             for shape, makes in states(dev).items()}

    def call(name, case):
        """The function `name` times `case` with, and its extra keywords
        (the scratch of the redesigned kernels); None where a parent has
        none of its own for the case."""
        kernel = CASES[case]
        if name in fns:
            return fns[name].get(kernel), {}
        S = max(sh[2] for sh in SHAPES.values())
        return getattr(lk, kernel), ({"scratch": lk.round_scratch(dev, S)}
                                     if kernel in SCRATCH else {})

    for name, (lib, _) in libs.items():
        if name in TIMED_ONLY:
            continue
        lk._round = lib
        for shape, makes in cases.items():
            for case, make in makes.items():
                f, extra = call(name, case)
                if f is None:
                    continue
                args, kw = make()
                got = f(*args, **kw, **extra)
                args2, kw2 = make()
                want = round_outputs(CASES[case], args2, kw2, plain=True)
                if CASES[case] != "walk_pairs":
                    got = tuple(got or ()) + tuple(
                        args[i] for i in ROUND_INPLACE[CASES[case]])
                if len(got) != len(want) or not all(
                        torch.equal(x, y) for x, y in zip(got, want)):
                    raise AssertionError("%s %s %s != plain"
                                         % (name, shape, case))
                if extra and bool(extra["scratch"][:16].any()):
                    raise AssertionError("%s %s %s left its scratch dirty"
                                         % (name, shape, case))
    print("every variant but %s == plain" % (TIMED_ONLY,), flush=True)
    lk._round = libs["committed"][0]
    for shape, makes in cases.items():
        for case, make in makes.items():
            args, kw = make()
            got = round_outputs(CASES[case], args, kw)
            b_ms, nbytes, what = cs.round_bound_ms(lk, CASES[case], make,
                                                   got)
            print(json.dumps({"bound": shape, "case": case, "ms": b_ms,
                              "bytes": nbytes, "shape": what}), flush=True)
    timed = [n for n in libs if n != "phases"]
    ms = {n: {s: {c: [] for c in cases_on} for s in cases} for n in timed}
    for _ in range(a.rounds):
        for name in timed:
            lk._round = libs[name][0]
            for shape, makes in cases.items():
                for case, make in makes.items():
                    f, extra = call(name, case)
                    if f is None:
                        continue
                    args, kw = make()
                    kw = dict(kw, **extra)
                    ms[name][shape][case].append(cs.graph_ms(
                        lambda: f(*args, **kw), cs.TIMED_LAUNCHES))
            print(json.dumps({"variant": name, "ms": {
                s: {c: v[-1] for c, v in m.items() if v}
                for s, m in ms[name].items()}}), flush=True)
    print(json.dumps({"median_ms": {
        n: {s: {c: float(np.median(v)) for c, v in m.items() if v}
            for s, m in sm.items()} for n, sm in ms.items()}}), flush=True)
    # the phases of each block of one call (the committed tiles)
    if "phases" not in libs:
        return 0
    lib = libs["phases"][0]
    lib.pg_phases.restype = ctypes.c_int
    lib.pg_phases.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lk._round = lib
    tile = 4 * 256
    for shape, makes in cases.items():
        G, H = SHAPES[shape][:2]
        n_tile = G * -(-H // tile)
        for case, make in makes.items():
            if case == "prop_round_scattered":
                continue
            args, kw = make()
            getattr(lk, CASES[case])(*args, **kw)
            torch.cuda.synchronize()
            buf = np.zeros(MAX_BLOCKS * 8, np.uint64)
            if lib.pg_phases(buf.ctypes.data, MAX_BLOCKS * 8):
                raise RuntimeError("reading the phase stamps failed")
            buf = buf.reshape(MAX_BLOCKS, 8)
            if case.startswith("walk"):
                kinds = {"walk": (0, n_tile)}
            elif case == "prop_round":
                kinds = {"prop": (0, n_tile)}
            elif case == "occ_round":
                n_seg = -(-args[0].numel() // SEG_BLOCK)
                n_hit = -(-G * H // (256 * 16))
                kinds = {"seg": (0, n_seg),
                         "hit": (n_seg, n_seg + n_hit)}
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
