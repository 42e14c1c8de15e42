// Two blocks of the device-resident pruning loop (parallel/device_loop.py),
// for Hopper (sm_90a). Bound to Python with ctypes (ops/loop_kernels.py),
// which also holds the plain PyTorch version each kernel is tested against.
//
// branch_locality replaces the pairwise any-genome locality of the JAX
// branch block (pangene_tpu/parallel/device_loop.py:525 branch_block, its
// loc_chunk loop at :578; reference branch.c:48-106). For every branching
// arc a (valid, in a group of >= 2 arcs of one source vertex) and every
// other branching member p of its group with 0 < |a - p| < D, the pair is
// local when some genome g has both targets' representatives present, on
// the same contig unless frag_mode, with |cm_a - cm_p| <= local_dist or
// |rank_a - rank_p| <= local_count. Then aml[a] |= is_max[p], and he[a] is
// set when p < a. Members of a group are contiguous in the v-sorted arc
// table, so the partners of a are a window of the table around a.
//
// merge_fold replaces the in-loop lean merge after its sort (JAX
// device_loop.py:264 walk_merge, the fold at :436-471, and the bucket
// exchange's fold at :360-391; reference graph.c:87-177). Over sorted keys
// (vw << GB | g) << jb | low bits, an in-group is a run of equal (vw, g), an
// out-group a run of equal vw. Per out-group: the sum over its in-groups of
// the in-group's largest s1, the number of in-groups ng, and the arc row
// (vw, (int)((double)sum / ng + .499)) at the out-group's rank; each valid
// row writes that rank into pair[src], src being the row's origin (the low
// jb key bits, or perm[i] when a permutation is given).
//
// What bounds them on the H100: branch_locality by its bytes (the
// representative planes of the genes its branching arcs target and the [A]
// arc planes: 16 MB, 0.005 ms, on the 64-genome, 10,000-gene synthetic
// corpus) or by the integer operations its data forces (each pair that must
// be found not local in every genome; chip_smoke.py counts them), merge_fold
// by its bytes (8-16 a sorted row read, 4 written: 25 MB, 0.007 ms, on that
// corpus). The plain PyTorch forms (the port before these
// kernels) cost launch latency: the locality was up to ~900 small launches
// a call and two host reads, the fold ~15 launches over every row. So each
// block is here a single pass (three small launches for the fold), with no
// host read and no atomics.
//
// Design:
//  * branch_locality: one warp per arc of the whole [A] table; a warp whose
//    arc does not branch writes zeros and leaves. Lanes cover the genome axis
//    (32 genomes a step); the representative planes are gene-major
//    [n_gene, G], so a step's loads are contiguous. The warp walks the
//    partners in its window, skipping those that cannot change its bits (a
//    later partner that is no max arc, or any partner once both bits are
//    known), and __any_sync gives the any over genomes. Each warp writes only
//    its own arc: deterministic, no atomics.
//  * merge_fold: (1) per row the out-head flag, counted per block with
//    __syncthreads_count, and the pair plane zeroed; (2) one block scans the
//    block counts (exclusive) and writes n_out; (3) each out-head row learns
//    its rank from its block's offset and a ballot prefix, then walks its
//    out-group's contiguous rows alone: running in-group maximum, sum,
//    count, the pair write of each row, and the arc row. The same launch
//    fills the arc rows past n_out (SENT, 0). Sums are int64 in one thread
//    in row order: exact.
//
// Exactness: (double)sum is exact (sum < 2^53), the division and the add are
// IEEE round-to-nearest (__ddiv_rn, __dadd_rn) as in the reference; do not
// build with --use_fast_math. For sum >= 0 (scores are non-negative) this
// is ops/softfloat.py:plus499_trunc bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLocWarps = 8;             // warps (arcs) a block
constexpr int kFoldThreads = 256;        // rows a block in merge_fold
constexpr int kScanThreads = 1024;
constexpr long long kKeySent = 1LL << 62;         // KSENT_I
constexpr long long kArcSent = (1LL << 62) - 1;   // SENT_I

__global__ void __launch_bounds__(kLocWarps * 32)
branch_locality_kernel(const uint8_t* __restrict__ pres,
                       const int32_t* __restrict__ cid,
                       const int64_t* __restrict__ cm,
                       const int32_t* __restrict__ rank, int G,
                       const int64_t* __restrict__ tgt,
                       const int64_t* __restrict__ gs,
                       const uint8_t* __restrict__ branching,
                       const uint8_t* __restrict__ is_max, long long A, int D,
                       int frag, long long local_dist, long long local_count,
                       uint8_t* __restrict__ aml, uint8_t* __restrict__ he) {
  const int lane = threadIdx.x & 31;
  const long long a = static_cast<long long>(blockIdx.x) * kLocWarps
                      + (threadIdx.x >> 5);
  if (a >= A) return;                      // uniform in the warp
  bool am = false, h = false;
  if (branching[a]) {
    const long long ga = gs[a];
    const long long ta = tgt[a] * G;
    long long lo = a - (D - 1);
    long long hi = a + (D - 1);
    if (lo < 0) lo = 0;
    if (hi > A - 1) hi = A - 1;
    for (long long p = lo; p <= hi; ++p) {
      if (p == a || !branching[p] || gs[p] != ga) continue;
      const bool want_am = !am && is_max[p];
      const bool want_he = !h && p < a;
      if (!want_am && !want_he) continue;
      const long long tp = tgt[p] * G;
      bool loc = false;
      for (int g0 = 0; g0 < G && !loc; g0 += 32) {
        const int g = g0 + lane;
        bool l = false;
        if (g < G && pres[ta + g] && pres[tp + g]
            && (frag || cid[ta + g] == cid[tp + g])) {
          long long dm = cm[ta + g] - cm[tp + g];
          long long dr = static_cast<long long>(rank[ta + g]) - rank[tp + g];
          dm = dm < 0 ? -dm : dm;
          dr = dr < 0 ? -dr : dr;
          l = dm <= local_dist || dr <= local_count;
        }
        loc = __any_sync(0xffffffffu, l);
      }
      if (loc) {
        am = am || want_am;
        h = h || want_he;
      }
    }
  }
  if (lane == 0) {
    aml[a] = am;
    he[a] = h;
  }
}

__device__ __forceinline__ long long row_key(const int64_t* keys,
                                             long long i, int jb) {
  return keys[i] >> jb;
}

// out-head flag of sorted row i < N: valid and its vw differs from row i-1's
__device__ __forceinline__ bool out_head(const int64_t* keys, long long i,
                                         int jb, int gb) {
  const long long k = row_key(keys, i, jb);
  if (k == (kKeySent >> jb)) return false;
  return i == 0 || (row_key(keys, i - 1, jb) >> gb) != (k >> gb);
}

__global__ void __launch_bounds__(kFoldThreads)
fold_count_kernel(const int64_t* __restrict__ keys, long long N, int jb,
                  int gb, int32_t* __restrict__ blk_cnt,
                  int32_t* __restrict__ pair) {
  const long long i = static_cast<long long>(blockIdx.x) * kFoldThreads
                      + threadIdx.x;
  bool head = false;
  if (i < N) {
    pair[i] = 0;
    head = out_head(keys, i, jb, gb);
  }
  const int cnt = __syncthreads_count(head);
  if (threadIdx.x == 0) blk_cnt[blockIdx.x] = cnt;
}

// exclusive scan of nblk block counts in one block; n_out = the total
__global__ void __launch_bounds__(kScanThreads)
fold_scan_kernel(const int32_t* __restrict__ blk_cnt, long long nblk,
                 long long* __restrict__ blk_off,
                 int64_t* __restrict__ n_out) {
  __shared__ long long part[kScanThreads];
  const int t = threadIdx.x;
  const long long per = (nblk + kScanThreads - 1) / kScanThreads;
  const long long b0 = t * per;
  long long b1 = b0 + per;
  if (b1 > nblk) b1 = nblk;
  long long s = 0;
  for (long long b = b0; b < b1; ++b) s += blk_cnt[b];
  part[t] = s;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {   // inclusive scan
    const long long v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  long long run = part[t] - s;                          // exclusive
  for (long long b = b0; b < b1; ++b) {
    blk_off[b] = run;
    run += blk_cnt[b];
  }
  if (t == kScanThreads - 1) *n_out = part[t];
}

__device__ __forceinline__ int plus499(long long s, long long n) {
  return static_cast<int>(__dadd_rn(
      __ddiv_rn(static_cast<double>(s), static_cast<double>(n)), 0.499));
}

__global__ void __launch_bounds__(kFoldThreads)
fold_walk_kernel(const int64_t* __restrict__ keys,
                 const int64_t* __restrict__ perm,
                 const int32_t* __restrict__ s1, long long N, int jb, int gb,
                 long long nblk, const long long* __restrict__ blk_off,
                 const int64_t* __restrict__ n_out, long long cap,
                 int64_t* __restrict__ arc_vw, int32_t* __restrict__ arc_s1,
                 int32_t* __restrict__ pair) {
  __shared__ int warp_cnt[kFoldThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i = static_cast<long long>(blockIdx.x) * kFoldThreads
                      + threadIdx.x;
  if (blockIdx.x < nblk) {                 // uniform in the block
    const bool head = i < N && out_head(keys, i, jb, gb);
    const unsigned bal = __ballot_sync(0xffffffffu, head);
    if (lane == 0) warp_cnt[warp] = __popc(bal);
    __syncthreads();
    long long id = blk_off[blockIdx.x] + __popc(bal & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) id += warp_cnt[w];
    if (head) {
      const long long mask = (1LL << jb) - 1;
      const long long sent = kKeySent >> jb;
      const long long k0 = row_key(keys, i, jb);
      const long long vw = k0 >> gb;
      long long cur = k0, sum = 0, ng = 0;
      int mx = INT32_MIN;
      for (long long j = i; j < N; ++j) {
        const long long k = row_key(keys, j, jb);
        if (k == sent || (k >> gb) != vw) break;
        const long long src = perm ? perm[j] : (keys[j] & mask);
        const int v = s1[src];
        pair[src] = static_cast<int32_t>(id);
        if (k != cur) {
          sum += mx;
          ++ng;
          cur = k;
          mx = v;
        } else {
          mx = v > mx ? v : mx;
        }
      }
      sum += mx;
      ++ng;
      if (id < cap) {
        arc_vw[id] = vw;
        arc_s1[id] = plus499(sum, ng);
      }
    }
  }
  if (i < cap && i >= *n_out) {
    arc_vw[i] = kArcSent;
    arc_s1[i] = 0;
  }
}

}  // namespace

extern "C" int pg_branch_locality(const void* pres, const void* cid,
                                  const void* cm, const void* rank, int G,
                                  const void* tgt, const void* gs,
                                  const void* branching, const void* is_max,
                                  long long A, int D, int frag,
                                  long long local_dist, long long local_count,
                                  void* aml, void* he, void* stream) {
  if (A <= 0) return 0;
  const long long blocks = (A + kLocWarps - 1) / kLocWarps;
  branch_locality_kernel<<<static_cast<unsigned>(blocks), kLocWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pres), static_cast<const int32_t*>(cid),
      static_cast<const int64_t*>(cm), static_cast<const int32_t*>(rank), G,
      static_cast<const int64_t*>(tgt), static_cast<const int64_t*>(gs),
      static_cast<const uint8_t*>(branching),
      static_cast<const uint8_t*>(is_max), A, D, frag, local_dist,
      local_count, static_cast<uint8_t*>(aml), static_cast<uint8_t*>(he));
  return static_cast<int>(cudaGetLastError());
}

// Scratch: blk_cnt int32 and blk_off int64, pg_merge_fold_blocks(N) each.
extern "C" long long pg_merge_fold_blocks(long long N) {
  return (N + kFoldThreads - 1) / kFoldThreads;
}

extern "C" int pg_merge_fold(const void* keys, const void* perm,
                             const void* s1, long long N, int jb, int gb,
                             long long cap, void* blk_cnt, void* blk_off,
                             void* arc_vw, void* arc_s1, void* n_out,
                             void* pair, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nblk = pg_merge_fold_blocks(N);
  const int64_t* k = static_cast<const int64_t*>(keys);
  if (nblk > 0)
    fold_count_kernel<<<static_cast<unsigned>(nblk), kFoldThreads, 0, st>>>(
        k, N, jb, gb, static_cast<int32_t*>(blk_cnt),
        static_cast<int32_t*>(pair));
  fold_scan_kernel<<<1, kScanThreads, 0, st>>>(
      static_cast<const int32_t*>(blk_cnt), nblk,
      static_cast<long long*>(blk_off), static_cast<int64_t*>(n_out));
  const long long rows = N > cap ? N : cap;
  const long long grid = (rows + kFoldThreads - 1) / kFoldThreads;
  if (grid > 0)
    fold_walk_kernel<<<static_cast<unsigned>(grid), kFoldThreads, 0, st>>>(
        k, static_cast<const int64_t*>(perm),
        static_cast<const int32_t*>(s1), N, jb, gb, nblk,
        static_cast<const long long*>(blk_off),
        static_cast<const int64_t*>(n_out), cap,
        static_cast<int64_t*>(arc_vw), static_cast<int32_t*>(arc_s1),
        static_cast<int32_t*>(pair));
  return static_cast<int>(cudaGetLastError());
}
