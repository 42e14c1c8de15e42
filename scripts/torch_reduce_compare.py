#!/usr/bin/env python3
"""protein_reduce against its first form (one thread a row, one memset, an
atomicMax at every row with score_ori > 0 and four 64-bit atomicAdds at a
rank-0 unfiltered row, at most 65,535 genomes), in turns on one card, on
the same arguments:

    python3 scripts/torch_reduce_compare.py [--shapes a,b] [--variants a,b]
        [--synthetic] [--turns N]

The shapes (chip_smoke.REDUCE_SHAPES) are those the mesh's main path
launches it at and the whole dataset: rank 0's share at world 4 (its
genomes' rows end to end, as stacked.stack_reductions stacks them) and
every genome's rows end to end (world 1), of chip_smoke.py's big and
north-star corpora, and big's padded [G, H] stack. The corpora are drawn
as chip_smoke.py draws them, or taken from its cache (build/chip_smoke/),
and built once through the user's entry point (the default engine) for
their final rows. With --synthetic the rows are drawn here instead
(SYNTHETIC: the same row and protein counts, the pids laid out as the
corpora's, scores and flags at random; a quick check, not the corpora's
numbers).

Builds (scripts/torch_compare_builds.py: one nvcc a source, all started
together) into build/reduce_compare/<name>/: the first form (FIRST_FORM,
kept here as source text), this checkout's csrc/mesh_round.cu, each of
VARIANTS (textual substitutions of it) and the cluster form (CLUSTER_FORM:
the protein table held in a thread-block cluster's distributed shared
memory, flushed once a cluster by atomics; its modes with and without the
read before atomicMax and with and without the derived rep_cnt). Every
exact build must equal the plain version (ops/mesh_kernels.py) on the
arguments; then they take turns, first, change, the variants, the cluster
modes, and the same again in reverse (--turns 2, the default; 4 runs that
twice), each the device time of 200 launches in one CUDA graph
(chip_smoke.graph_ms). The bound is chip_smoke.reduction_bound_bytes'.
Prints the card first, each build's ptxas lines, a line a shape, and last
REDUCE=<json>.
"""
import argparse
import ctypes
import hashlib
import json
import os
import signal
import sys

from torch_compare_builds import (ROOT, build_all, card_line, chip_smoke,
                                  turns, write_source, write_variants)

# --synthetic: (rows, proteins, genomes) a shape, the corpora's counts
SYNTHETIC = {"big_w4_rank0": (328454, 30000, 16),
             "northstar_w4_rank0": (974596, 57000, 25),
             "big_flat": (1314156, 30000, 64),
             "northstar_flat": (3898385, 57000, 100),
             "big_padded": (1314156, 30000, 64)}
SEED = 19
# The cluster form's modes: name -> mode. Bit 0: no read before atomicMax;
# bit 1: rep_cnt by its own atomic (not cnt0 + cnt1 at the flush).
CLUSTER_MODES = {"cluster": 0, "cluster_no_skip": 1, "cluster_rep_atomic": 2,
                 "cluster_no_skip_rep_atomic": 3}

_MAX = "      if (so > 0) atomicMax(a.max_so + p, so);\n"
_R0 = ("      if (__ldg(a.rank + r) != 0 || __ldg(a.flt + r) != 0) "
       "continue;")
_MULTI = "      const int multi = __ldg(a.n_exon + r) != 1;\n"
_COUNT = ("      atomicAdd(a.sums + static_cast<long long>(multi) * P + p, "
          "1ULL);")
_SA = "      const int sa = __ldg(a.score_adj + r);\n"
_REP = "      atomicAdd(a.sums + 5LL * P + p, 1ULL);\n"
_LAUNCHED = """  protein_reduce_kernel<<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());"""
# a relaxed load at the device's scope: it reads a value in max_so[p]'s
# coherence order, so never one above the maximum now (atomicMax only
# raises it), and skipping the atomicMax where it is >= so is exact
_RELAXED = """// max_so[p] by a relaxed load at device scope
__device__ __forceinline__ int ld_relaxed(const int32_t* q) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(q)
               : "memory");
  return v;
}

struct ReduceArgs {"""
# rep_cnt = cnt0 + cnt1 by a second launch over the proteins
_FINISH_KERNEL = """
__global__ void __launch_bounds__(kThreads)
reduce_finish_kernel(unsigned long long* sums, long long P) {
  const long long q = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (q < P) sums[5 * P + q] = sums[q] + sums[P + q];
}

// ---------------------------------------------------------------------------
// the bucket exchange"""
# this checkout's variants: name -> (exact, substitutions (old, new) of
# csrc/mesh_round.cu, each old found at least once). An exact variant must
# equal the plain version; the others cut a phase out (their outputs are
# wrong) and are timed only. Exact: read_relaxed (the running maximum read
# by a relaxed load before atomicMax, which only a larger score_ori takes),
# rep_derived (rep_cnt by no atomic but as cnt0 + cnt1 in a second
# launch), rows2 (half the grid's columns: two rows a thread), eager_loads
# (rank, flt, n_exon and score_adj read together at every valid row).
# Cuts: empty (the memset and a launch whose blocks return at once),
# memset_only (no launch), loads_only (every load, no atomic), max_only
# (the maximum: its loads and atomicMax), sums_only (the sums, no
# atomicMax). Every build writes the same output buffer.
VARIANTS = {
    "read_relaxed": (True, (
        ("struct ReduceArgs {", _RELAXED),
        (_MAX, "      if (so > 0 && so > ld_relaxed(a.max_so + p))\n"
               "        atomicMax(a.max_so + p, so);\n"))),
    "rep_derived": (True, (
        (_REP, ""),
        ("\n// ---------------------------------------------------------------"
         "------------\n// the bucket exchange", _FINISH_KERNEL),
        (_LAUNCHED, _LAUNCHED.replace("  return", """  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_finish_kernel<<<static_cast<unsigned>(
      (n_prot + kThreads - 1LL) / kThreads), kThreads, 0, st>>>(
      a.sums, n_prot);
  return""")))),
    "rows2": (True, ((
        "  const long long bx = (static_cast<long long>(H) + kThreads - 1) / "
        "kThreads;", "  const long long bx = (static_cast<long long>(H) + 2 * "
        "kThreads - 1) / (2 * kThreads);"),)),
    "eager_loads": (True, (
        (_R0, "      const int rk = __ldg(a.rank + r), fl = __ldg(a.flt + r),"
              "\n          ne = __ldg(a.n_exon + r), sa = __ldg(a.score_adj + "
              "r);\n      if ((rk | fl) != 0) continue;"),
        (_MULTI, "      const int multi = ne != 1;\n"), (_SA, ""))),
    "empty": (False, (("protein_reduce_kernel(ReduceArgs a) {",
                       "protein_reduce_kernel(ReduceArgs a) {\n"
                       "  if (a.H >= 0) return;"),)),
    "memset_only": (False, (("  if (G <= 0 || H <= 0) return 0;",
                             "  return 0;"),)),
    "loads_only": (False, (
        (_MAX, ""),
        (_MULTI + _COUNT, _MULTI + "      const int sa_ = __ldg(a.score_adj + "
         "r);\n      if ((multi ^ sa_ ^ p ^ so) == 0x7fffeeee) a.sums[0] = 1;"
         "\n      continue;"))),
    "max_only": (False, ((_R0, "      continue;"),)),
    "sums_only": (False, ((_MAX, ""),)),
}

# The first form's protein_reduce with its C entry (csrc/mesh_round.cu as
# the kernel was first written): out int64 [7, n_prot].
FIRST_FORM = r"""#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct ReduceArgs {
  const int32_t* pid;
  const int32_t* score_ori;
  const int32_t* score_adj;
  const int32_t* n_exon;
  const int32_t* rank;
  const uint8_t* flt;
  const int32_t* n_rows;
  int H, n_prot;
  int32_t* max_so;                // [n_prot]
  unsigned long long* sums;       // [6, n_prot]: cnt0 cnt1 sum0 sum1 rep_sum rep_cnt
};

__global__ void __launch_bounds__(kThreads)
protein_reduce_kernel(ReduceArgs a) {
  const int g = blockIdx.y;
  int n = a.n_rows[g];
  n = n < 0 ? 0 : (n > a.H ? a.H : n);
  const long long base = static_cast<long long>(g) * a.H;
  const int P = a.n_prot;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const long long r = base + i;
    int p = __ldg(a.pid + r);
    p = p < 0 ? 0 : (p >= P ? P - 1 : p);
    const int so = __ldg(a.score_ori + r);
    if (so > 0) atomicMax(a.max_so + p, so);
    if (__ldg(a.rank + r) != 0 || __ldg(a.flt + r) != 0) continue;
    const int multi = __ldg(a.n_exon + r) != 1;
    atomicAdd(a.sums + static_cast<long long>(multi) * P + p, 1ULL);
    if (so != 0)
      atomicAdd(a.sums + static_cast<long long>(2 + multi) * P + p,
                static_cast<unsigned long long>(static_cast<long long>(so)));
    const int sa = __ldg(a.score_adj + r);
    if (sa != 0)
      atomicAdd(a.sums + 4LL * P + p,
                static_cast<unsigned long long>(static_cast<long long>(sa)));
    atomicAdd(a.sums + 5LL * P + p, 1ULL);
  }
}

}  // namespace

extern "C" int pg_protein_reduce(const void* pid, const void* score_ori,
                                 const void* score_adj, const void* n_exon,
                                 const void* rank, const void* flt,
                                 const void* n_rows, int G, int H,
                                 int n_prot, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_prot < 1 || G > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(out, 0, 56LL * n_prot, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (G <= 0 || H <= 0) return 0;
  ReduceArgs a;
  a.pid = static_cast<const int32_t*>(pid);
  a.score_ori = static_cast<const int32_t*>(score_ori);
  a.score_adj = static_cast<const int32_t*>(score_adj);
  a.n_exon = static_cast<const int32_t*>(n_exon);
  a.rank = static_cast<const int32_t*>(rank);
  a.flt = static_cast<const uint8_t*>(flt);
  a.n_rows = static_cast<const int32_t*>(n_rows);
  a.H = H;
  a.n_prot = n_prot;
  a.max_so = static_cast<int32_t*>(out);
  a.sums = static_cast<unsigned long long*>(out) + n_prot;
  const long long bx = (static_cast<long long>(H) + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(bx < 65535 ? bx : 65535), G);
  protein_reduce_kernel<<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
"""

# The cluster form: each cluster of cs blocks (one a SM) holds the whole
# protein table in its blocks' shared memory, protein p in block p / chunk
# of the cluster; its blocks take row tiles (1,024 rows) by ticket and add
# each row into the owner's table by distributed shared memory atomics;
# then each block adds its part of the table into the zeroed output by
# coalesced global atomics (nonzero entries only). cs is the smallest of 2,
# 4, 8, 16 whose part fits a block's 227 KB.
CLUSTER_FORM = r"""#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;
constexpr int kTile = kThreads * kRows;
// a block's shared memory less its static words and a margin
constexpr long long kSmemMax = 232448 - 1024;

struct Args {
  const int32_t* pid;
  const int32_t* score_ori;
  const int32_t* score_adj;
  const int32_t* n_exon;
  const int32_t* rank;
  const uint8_t* flt;
  const int32_t* n_rows;
  int H, P, tpg, chunk;
  long long n_row;
  int32_t* max_so;
  unsigned long long* sums;
  unsigned* ticket;
};

template <bool kSkip, bool kDerive>
__global__ void __launch_bounds__(kThreads, 1) reduce_cluster(Args a) {
  extern __shared__ unsigned long long sm[];
  constexpr int kSums = kDerive ? 5 : 6;
  __shared__ unsigned tk_sh;
  cg::cluster_group cl = cg::this_cluster();
  const int C = a.chunk;
  unsigned long long* s = sm;
  int* mx = reinterpret_cast<int*>(sm + kSums * C);
  for (int i = threadIdx.x; i < kSums * C; i += kThreads) s[i] = 0;
  for (int i = threadIdx.x; i < C; i += kThreads) mx[i] = 0;
  cl.sync();
  const int P = a.P;
  for (;;) {
    if (threadIdx.x == 0) tk_sh = atomicAdd(a.ticket, 1u);
    __syncthreads();
    const long long t = tk_sh;
    if (t >= a.n_row) break;
    const int g = static_cast<int>(t / a.tpg);
    const int i0 = static_cast<int>(t - static_cast<long long>(g) * a.tpg) *
                   kTile;
    int n = __ldg(a.n_rows + g);
    n = n < 0 ? 0 : (n > a.H ? a.H : n);
    const long long base = static_cast<long long>(g) * a.H;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r * kThreads + threadIdx.x;
      if (i >= n) continue;
      const long long row = base + i;
      int p = __ldg(a.pid + row);
      p = p < 0 ? 0 : (p >= P ? P - 1 : p);
      const int so = __ldg(a.score_ori + row);
      const int owner = p / C, off = p - owner * C;
      if (so > 0) {
        int* m = cl.map_shared_rank(mx, owner) + off;
        if (!kSkip || *reinterpret_cast<volatile int*>(m) < so)
          atomicMax(m, so);
      }
      if (__ldg(a.rank + row) != 0 || __ldg(a.flt + row) != 0) continue;
      const int multi = __ldg(a.n_exon + row) != 1;
      const int sa = __ldg(a.score_adj + row);
      unsigned long long* rs = cl.map_shared_rank(s, owner) + off;
      atomicAdd(rs + multi * C, 1ULL);
      if (so != 0)
        atomicAdd(rs + (2 + multi) * C,
                  static_cast<unsigned long long>(static_cast<long long>(so)));
      if (sa != 0)
        atomicAdd(rs + 4 * C,
                  static_cast<unsigned long long>(static_cast<long long>(sa)));
      if (!kDerive) atomicAdd(rs + 5 * C, 1ULL);
    }
    __syncthreads();
  }
  cl.sync();
  const long long first = static_cast<long long>(cl.block_rank()) * C;
  for (int q = threadIdx.x; q < C; q += kThreads) {
    const long long gq = first + q;
    if (gq >= P) break;
    if (mx[q] > 0) atomicMax(a.max_so + gq, mx[q]);
    for (int k = 0; k < 5; ++k) {
      const unsigned long long v = s[k * C + q];
      if (v) atomicAdd(a.sums + k * static_cast<long long>(P) + gq, v);
    }
    const unsigned long long rc = kDerive ? s[q] + s[C + q] : s[5 * C + q];
    if (rc) atomicAdd(a.sums + 5LL * P + gq, rc);
  }
}

}  // namespace

// Bytes of the output buffer: [7, n_prot] int64, then the ticket.
extern "C" long long pg_cluster_bytes(int n_prot) {
  return 56LL * n_prot + 128;
}

// As pg_protein_reduce, out pg_cluster_bytes(n_prot) bytes; mode bit 0
// reads no maximum before atomicMax, bit 1 gives rep_cnt its own atomic.
// Every resident cluster takes row tiles. shape[4]: cs, chunk, shared
// bytes a block, clusters.
extern "C" int pg_protein_reduce_cluster(
    const void* pid, const void* score_ori, const void* score_adj,
    const void* n_exon, const void* rank, const void* flt,
    const void* n_rows, int G, int H, int n_prot, int mode, void* out,
    long long* shape, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_prot < 1 || G < 0 || H < 0 || mode < 0 || mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(out, 0, pg_cluster_bytes(n_prot), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a;
  a.tpg = (H + kTile - 1) / kTile;
  a.n_row = static_cast<long long>(G) * a.tpg;
  const int n_sums = mode & 2 ? 6 : 5;
  int cs = 2;
  long long chunk = 0, smem = 0;
  for (; cs <= 16; cs *= 2) {
    chunk = (n_prot + cs - 1) / cs;
    smem = chunk * (8LL * n_sums + 4);
    if (smem <= kSmemMax) break;
  }
  if (cs > 16) return static_cast<int>(cudaErrorInvalidValue);
  void (*k)(Args) = mode == 0 ? reduce_cluster<true, true>
                  : mode == 1 ? reduce_cluster<false, true>
                  : mode == 2 ? reduce_cluster<true, false>
                              : reduce_cluster<false, false>;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess && cs > 8)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.gridDim = dim3(cs, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n_cl = 0;
  e = cudaOccupancyMaxActiveClusters(&n_cl, k, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_cl < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (shape) {
    shape[0] = cs;
    shape[1] = chunk;
    shape[2] = smem;
    shape[3] = n_cl;
  }
  if (a.n_row == 0) return 0;
  a.pid = static_cast<const int32_t*>(pid);
  a.score_ori = static_cast<const int32_t*>(score_ori);
  a.score_adj = static_cast<const int32_t*>(score_adj);
  a.n_exon = static_cast<const int32_t*>(n_exon);
  a.rank = static_cast<const int32_t*>(rank);
  a.flt = static_cast<const uint8_t*>(flt);
  a.n_rows = static_cast<const int32_t*>(n_rows);
  a.H = H;
  a.P = n_prot;
  a.chunk = static_cast<int>(chunk);
  a.max_so = static_cast<int32_t*>(out);
  a.sums = static_cast<unsigned long long*>(out) + n_prot;
  a.ticket = reinterpret_cast<unsigned*>(static_cast<char*>(out) +
                                         56LL * n_prot);
  cfg.gridDim = dim3(static_cast<unsigned>(n_cl * cs), 1, 1);
  e = cudaLaunchKernelEx(&cfg, k, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
"""


_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class Build:
    """One built library's protein_reduce on the current stream: `kind`
    first or change (pg_protein_reduce, out [7, n_prot]) or cluster
    (pg_protein_reduce_cluster in `mode`)."""

    def __init__(self, so, kind, mode=0):
        self.lib = ctypes.CDLL(so)
        self.kind, self.mode = kind, mode
        if kind == "cluster":
            fn = self.lib.pg_protein_reduce_cluster
            fn.restype = _I
            fn.argtypes = [_VP] * 7 + [_I] * 4 + [_VP] * 3
            self.lib.pg_cluster_bytes.restype = _LL
            self.lib.pg_cluster_bytes.argtypes = [_I]
        else:
            fn = self.lib.pg_protein_reduce
            fn.restype = _I
            fn.argtypes = [_VP] * 7 + [_I] * 3 + [_VP] * 2
        self.shape = None

    def words(self, P):
        """int64 words of the output buffer at n_prot = P."""
        return (self.lib.pg_cluster_bytes(P) // 8 if self.kind == "cluster"
                else 7 * P)

    def launcher(self, args, P, out):
        """(launch, (max_so, sums)) on the arguments, into `out` (at least
        words(P) int64 words)."""
        import torch
        dev = args[0].device
        G, H = args[0].shape
        ptrs = [t.data_ptr() for t in args]
        shape = (ctypes.c_longlong * 4)()

        def launch():
            stream = torch.cuda.current_stream().cuda_stream
            if self.kind == "cluster":
                err = self.lib.pg_protein_reduce_cluster(
                    *ptrs, G, H, P, self.mode, out.data_ptr(), shape,
                    stream)
                self.shape = list(shape)
            else:
                err = self.lib.pg_protein_reduce(*ptrs, G, H, P,
                                                 out.data_ptr(), stream)
            if err:
                raise RuntimeError("protein_reduce launch: CUDA error %d"
                                   % err)
        launch.tensors = (args, out)
        o = out[:7 * P].view(7, P)
        return launch, (o[0].view(torch.int32)[:P], o[1:])


def synthetic_args(label, padded, dev):
    """SYNTHETIC's rows of `label` as protein_reduce's arguments on `dev`
    (end to end, or `padded` over its genomes), laid out as the corpora's:
    each genome meets its genes in a random order, a gene's rows (1-3, 2.05
    on average) its isoforms' pids 3g, 3g + 1, 3g + 2 one after another;
    94% of the rows of rank 0, half of them filtered."""
    import numpy as np
    import torch
    n, P, G = SYNTHETIC[label]
    rng = np.random.default_rng(SEED)
    n_gene = P // 3
    pids = []
    while sum(map(len, pids)) < n:
        k = rng.choice([1, 2, 3], n_gene, p=[0.3, 0.35, 0.35])
        start = np.repeat(3 * rng.permutation(n_gene), k)
        first = np.cumsum(k) - k
        pids.append(start + np.arange(len(start)) - np.repeat(first, k))
    pid = np.concatenate(pids)[:n]
    cols = [pid, rng.integers(1, 1000, n), rng.integers(-50, 1000, n),
            rng.integers(1, 5, n), (rng.random(n) < 0.06).astype(np.int64)]
    flt = (rng.random(n) < 0.51).astype(np.uint8)
    if padded:
        H = -(-n // G)
        n_rows = np.full(G, H, np.int32)
        n_rows[-1] = n - H * (G - 1)
        pad = lambda a: np.concatenate(
            [a, np.zeros(G * H - n, a.dtype)]).reshape(G, H)
        cols, flt = [pad(c) for c in cols], pad(flt)
    else:
        cols = [np.concatenate([c, [0]])[None, :] for c in cols]
        flt = np.concatenate([flt, [0]]).astype(np.uint8)[None, :]
        n_rows = np.array([n], np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return [t(c.astype(np.int32)) for c in cols] + [t(flt), t(n_rows)], P


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--turns", type=int, default=2,
                    help="timed turns of every build (even: each order "
                    "forwards, then backwards)")
    a = ap.parse_args()
    import torch
    sys.path.insert(0, ROOT)
    smi = card_line()
    print("card: " + smi, flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda")
    cs = chip_smoke("chip_smoke_reduce")
    cs.DEVICE = "cuda"
    shapes = [s for s in (a.shapes or ",".join(cs.REDUCE_SHAPES)).split(",")
              if s]
    # the corpora's draws start first; the builds run beside them
    names = sorted({cs.REDUCE_SHAPES[s][0] for s in shapes})
    draws = {} if a.synthetic else {n: cs.start_draw(n) for n in names}
    try:
        return compare(a, cs, smi, dev, shapes, names, draws)
    finally:
        for p in draws.values():
            if p is not None and p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()


def compare(a, cs, smi, dev, shapes, names, draws):
    """The builds, the checks and the turns (module docstring)."""
    import torch
    from pangene_tpu_torch.ops import mesh_kernels as mk
    variants = [v for v in a.variants.split(",") if v]
    out_root = os.path.join(ROOT, "build", "reduce_compare")
    src = os.path.join(ROOT, "pangene_tpu_torch", "csrc", "mesh_round.cu")
    sources = {"change": src}
    for name, body in (("first", FIRST_FORM), ("cluster", CLUSTER_FORM)):
        sources[name] = write_source(out_root, name, "reduce_%s.cu" % name,
                                     body)
    sources.update(write_variants(
        src, {name: VARIANTS[name][1] for name in variants}, out_root))
    sos = build_all(sources, out_root, "reduce")
    builds = {"first": Build(sos["first"], "first"),
              "change": Build(sos["change"], "change")}
    for name in variants:
        builds[name] = Build(sos[name], "change")
    for name, mode in CLUSTER_MODES.items():
        builds[name] = Build(sos["cluster"], "cluster", mode)
    datas = {}
    if not a.synthetic:
        for name in names:
            files, draw_s, _ = cs.make_corpus(name, draws[name])
            gfa, graph = cs.run_cli(files, "sharded")
            md5 = hashlib.md5(gfa.encode()).hexdigest()
            if md5 != cs.CORPORA[name].md5:
                raise AssertionError("%s: md5 %s" % (name, md5))
            datas[name] = graph.d
            print("corpus %s: %s, md5 %s" % (
                name, "cached" if draw_s is None else "drawn in %.1f s"
                % draw_s, md5), flush=True)
    result = {"card": smi, "source": "synthetic" if a.synthetic
              else "corpora", "shapes": {}}
    from pangene_tpu_torch.parallel import stacked as st
    for label in shapes:
        name, _, padded = cs.REDUCE_SHAPES[label]
        args, P = (synthetic_args(label, padded, dev) if a.synthetic
                   else cs.reduction_args(st, datas[name], label, dev))
        G, H = args[0].shape
        want = mk.protein_reduce_plain(*args, n_prot=P)
        launches, skipped = {}, {}
        # one output buffer for every build: where it lies in memory moves
        # a kernel's atomics' time by several percent
        out = torch.empty(max(b.words(P) for b in builds.values()),
                          dtype=torch.int64, device=dev)
        for who, b in builds.items():
            launch, outs = b.launcher(args, P, out)
            try:
                launch()
            except RuntimeError as e:
                # the cluster form's table may not fit a cluster
                if b.kind != "cluster":
                    raise
                skipped[who] = str(e)
                continue
            torch.cuda.synchronize()
            exact = who not in VARIANTS or VARIANTS[who][0]
            for k, (x, y) in enumerate(zip(outs, want)):
                if exact and (x.dtype != y.dtype or not torch.equal(x, y)):
                    raise AssertionError("%s %s != plain: output %d"
                                         % (who, label, k))
            launches[who] = launch
        ms = turns(cs, launches, a.turns)
        nbytes = cs.reduction_bound_bytes(*args, P)
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        n = int(args[6].clamp(0, H).sum())
        rec = result["shapes"][label] = dict(
            G=G, H=H, rows=n, n_prot=P, ms=ms, bound_ms=bound, bytes=nbytes,
            cluster_shape=builds["cluster"].shape, skipped=skipped)
        print("%s (G %d, H %d, %d rows, %d proteins): %s ms; bound %.6f ms "
              "(%d bytes); cluster shape %s; each exact build == plain%s" % (
                  label, G, H, n, P, json.dumps(ms), bound, nbytes,
                  rec["cluster_shape"], "; skipped %s" % json.dumps(skipped)
                  if skipped else ""), flush=True)
    print("REDUCE=" + json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
