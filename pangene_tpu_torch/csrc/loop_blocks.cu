// Two blocks of the device-resident pruning loop (parallel/device_loop.py),
// for Hopper (sm_90a). Bound to Python with ctypes (ops/loop_kernels.py),
// which also holds the plain PyTorch version each kernel is tested against.
//
// The branch block replaces the JAX branch block
// (pangene_tpu/parallel/device_loop.py:525 branch_block: its loc_chunk loop
// at :578, the deficit at :627-634, n_dist_loci at :636; reference
// branch.c:48-106). The arc table is v-sorted, so the arcs of one source
// vertex (a group) are contiguous; a group of >= 2 valid arcs branches. For
// every branching arc a and every other member p with 0 < |a - p| < D, the
// pair is local when some genome g has both targets' representatives
// present, on the same contig unless frag_mode, with |cm_a - cm_p| <=
// local_dist or |rank_a - rank_p| <= local_count. Then aml[a] |= is_max[p]
// (p's s1 is the group's largest), and he[a] is set when p < a. The
// classification of each branching arc is the reference's double test of
// its deficit RN(1 - RN(s1 / mx)) against branch_diff, branch_diff_dist and
// branch_diff_cut: 0 kept, 1 a weak candidate, 2 cut; n_grp, at a group's
// first arc, counts its members with no earlier local partner. Three
// entries of one kernel: pg_branch_block (one rank: the groups found in the
// arc table, locality and classification in one launch), and for the mesh
// pg_branch_locality (the groups given; its bits are OR'd over the ranks)
// then pg_branch_classify.
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
// What bounds them on the H100: the branch kernels by their bytes (the
// representative planes of the genes the branching arcs target and the [A]
// arc planes: 16 MB, 0.005 ms, on the 64-genome, 10,000-gene synthetic
// corpus) or by the integer operations their data forces (each pair that
// must be found not local in every genome; chip_smoke.py counts them),
// merge_fold by its bytes (8-16 a sorted row read, 4 written: 25 MB, 0.007
// ms, on that corpus). The plain PyTorch forms cost launch latency: the
// locality was up to ~900 small launches a call and two host reads, the
// softfloat deficit ~200 int64 launches over the arc table, the fold ~15
// launches over every row. So each block is here one pass (three small
// launches for the fold), with no host read.
//
// Design:
//  * the branch kernels: each warp owns 32 arcs of the table as group
//    heads (an arc not linked to the one before it) and takes the groups
//    that start there. Groups of one (the table's empty slots among them)
//    leave at once, a lane each. Otherwise one round trip brings the first
//    32 members' targets and s1 (the big corpus's 19,996 groups have 5-37
//    members, 12.9 on average). A group of up to kBrWarpRows members is the
//    warp's: the members' target rows are staged in shared memory kBrChunk
//    genomes at a time (lanes over genomes, four members' loads in flight),
//    then only the pairs (i, j) that can still change a bit are tested
//    (the candidates of i as a bit mask, br_partners), from shared memory,
//    __any_sync over the chunk's genomes; the bits live in two 64-bit
//    masks, and the next chunk is staged only while some tested pair was
//    not local. A group of up to kBrRows members is the whole block's
//    (rows staged by every warp, pairs split by warp, masks in shared
//    memory); a larger one (past the window D, so the loop falls back)
//    walks each member's window through global memory. The epilogue
//    classifies each member in IEEE double (__ddiv_rn, __dsub_rn): (double)
//    of an int32 is exact and each step rounds to nearest, which is
//    ops/softfloat.py:one_minus_div / gt_const bit for bit for 0 <= s1 <=
//    mx; the class counts go to two integer atomics a block. Each group is
//    written by the warp or block that owns its head: deterministic. What
//    is left is latency: each warp's chain of round trips (the members,
//    each chunk's rows) for its ~2.5 groups, at 24 warps a SM.
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

constexpr int kBrWarps = 4;              // warps a block (branch kernels)
constexpr int kBrThreads = kBrWarps * 32;
constexpr int kBrWarpRows = 16;          // members a warp stages
constexpr int kBrRows = kBrWarps * kBrWarpRows;   // members a block stages
constexpr int kBrChunk = 32;             // genomes staged at a time
// groups of more than kBrWarpRows members that start in one block's arcs
// (each spans more than half of a warp's 32)
constexpr int kBrBig = kBrWarps * 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFoldThreads = 256;        // rows a block in merge_fold
constexpr int kScanThreads = 1024;
constexpr long long kKeySent = 1LL << 62;         // KSENT_I
constexpr long long kArcSent = (1LL << 62) - 1;   // SENT_I

// ---------------------------------------------------------------------------
// the branch block
// ---------------------------------------------------------------------------

// The arguments of both branch kernels (one struct, passed by value).
struct BranchArgs {
  // representative planes, gene-major [n_gene, G]
  const uint8_t* pres;
  const int32_t* cid;
  const int64_t* cm;
  const int32_t* rank;
  int G;
  const int64_t* tgt;          // [A] the target's gene of each arc
  // the groups as given (pg_branch_locality) ...
  const int64_t* gs;
  const uint8_t* branching;
  const uint8_t* is_max;
  // ... or found in the arc table (pg_branch_block)
  const int64_t* vw;
  const int32_t* s1;
  int B;
  long long A;
  int D, frag;
  long long local_dist, local_count;
  double diff, diff_dist, diff_cut;
  uint8_t* aml;                // pg_branch_locality's outputs
  uint8_t* he;
  uint8_t* aw;                 // pg_branch_block's outputs
  int32_t* n_grp;
  unsigned long long* counts;
};

// Member rows staged for one chunk of kBrChunk genomes: rows
// [warp * kBrWarpRows, +kBrWarpRows) are a warp's, all kBrRows the block's.
struct BranchStage {
  int64_t cm[kBrRows][kBrChunk];
  int32_t cid[kBrRows][kBrChunk];
  int32_t rank[kBrRows][kBrChunk];
  int64_t tgt[kBrRows];
  uint8_t pres[kBrRows][kBrChunk];
};

// Arc a shares arc a - 1's group: both branching with one group start
// (given), or both valid with one source vertex (found).
template <bool kFound>
__device__ __forceinline__ bool br_link(const BranchArgs& p, long long a) {
  if (a <= 0 || a >= p.A) return false;
  if (kFound) {
    const long long x = p.vw[a - 1], y = p.vw[a];
    return x != kArcSent && y != kArcSent && (x >> p.B) == (y >> p.B);
  }
  return p.branching[a - 1] && p.branching[a] && p.gs[a - 1] == p.gs[a];
}

// The end (exclusive) of the group that starts at h. Warp-uniform.
template <bool kFound>
__device__ long long br_group_end(const BranchArgs& p, long long h,
                                  int lane) {
  long long e = h + 1;
  for (;;) {
    const unsigned l = __ballot_sync(kFull, br_link<kFound>(p, e + lane));
    if (l != kFull) return e + __ffs(~l) - 1;
    e += 32;
  }
}

// The group's largest s1, at least 0 (found groups). Warp-uniform.
__device__ int br_group_max(const BranchArgs& p, long long h, long long n,
                            int lane) {
  int mx = 0;
  for (long long m = lane; m < n; m += 32) mx = max(mx, p.s1[h + m]);
  for (int o = 16; o; o >>= 1) mx = max(mx, __shfl_xor_sync(kFull, mx, o));
  return mx;
}

template <bool kFound>
__device__ __forceinline__ bool br_is_max(const BranchArgs& p, long long a,
                                          int mx) {
  return kFound ? p.s1[a] == mx : p.is_max[a] != 0;
}

// |x - y| with the wrap-around of two's complement (as torch's int64 abs)
__device__ __forceinline__ long long absdiff(long long x, long long y) {
  using u64 = unsigned long long;
  const u64 d = static_cast<u64>(x) - static_cast<u64>(y);
  return static_cast<long long>(static_cast<long long>(d) < 0 ? 0ull - d
                                                             : d);
}

__device__ __forceinline__ bool local_pair(bool pa, bool pb, int32_t ca,
                                           int32_t cb, long long ma,
                                           long long mb, int32_t ra,
                                           int32_t rb, const BranchArgs& p) {
  if (!(pa && pb) || (!p.frag && ca != cb)) return false;
  return absdiff(ma, mb) <= p.local_dist
         || absdiff(ra, rb) <= p.local_count;
}

// Genomes g0 + lane of the target rows of members m = first, first + step,
// ... < n (their genes in st.tgt[row0 + m]) into staged rows row0 + m;
// genomes past G absent. Four members' loads are in flight at once.
__device__ __forceinline__ void br_stage_rows(const BranchArgs& p,
                                              BranchStage& st, int row0,
                                              int first, int step, int n,
                                              int g0, int lane) {
  constexpr int kBatch = 4;
  const int g = g0 + lane;
  const bool in = g < p.G;
  for (int m0 = first; m0 < n; m0 += kBatch * step) {
    uint8_t pr[kBatch];
    int32_t ci[kBatch], rk[kBatch];
    long long c8[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int m = m0 + u * step;
      if (m < n && in) {
        const long long o = st.tgt[row0 + m] * p.G + g;
        pr[u] = p.pres[o];
        ci[u] = p.cid[o];
        c8[u] = p.cm[o];
        rk[u] = p.rank[o];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int m = m0 + u * step;
      if (m < n) {
        const int r = row0 + m;
        st.pres[r][lane] = in && pr[u];
        st.cid[r][lane] = in ? ci[u] : 0;
        st.cm[r][lane] = in ? c8[u] : 0;
        st.rank[r][lane] = in ? rk[u] : 0;
      }
    }
  }
}

// Is the pair of staged rows (i, j) local in some genome of the chunk?
__device__ __forceinline__ bool br_local_staged(const BranchArgs& p,
                                                const BranchStage& st, int i,
                                                int j, int lane) {
  return __any_sync(kFull, local_pair(
      st.pres[i][lane], st.pres[j][lane], st.cid[i][lane], st.cid[j][lane],
      st.cm[i][lane], st.cm[j][lane], st.rank[i][lane], st.rank[j][lane],
      p));
}

// The same for genes ta and tb read from the planes (groups past kBrRows).
__device__ bool br_local_global(const BranchArgs& p, long long ta,
                                long long tb, int lane) {
  bool loc = false;
  for (int g0 = 0; g0 < p.G && !loc; g0 += 32) {
    const int g = g0 + lane;
    bool l = false;
    if (g < p.G) {
      const long long a = ta * p.G + g, b = tb * p.G + g;
      l = local_pair(p.pres[a], p.pres[b], p.cid[a], p.cid[b], p.cm[a],
                     p.cm[b], p.rank[a], p.rank[b], p);
    }
    loc = __any_sync(kFull, l);
  }
  return loc;
}

// Can the pair of members (i, j), i < j, still change a bit?
__device__ __forceinline__ bool br_need(unsigned long long aml,
                                        unsigned long long he,
                                        unsigned long long im, int i, int j) {
  return !((he >> j) & 1)
         || (!((aml >> i) & 1) && ((im >> j) & 1))
         || (!((aml >> j) & 1) && ((im >> i) & 1));
}

// The members j > i inside the window (j - i < D) that may still change a
// bit with i (see br_need), as a mask over the group's n members.
__device__ __forceinline__ unsigned long long br_partners(
    unsigned long long aml, unsigned long long he, unsigned long long im,
    int i, int n, int D) {
  const unsigned long long all = n >= 64 ? ~0ull : (1ull << n) - 1;
  const unsigned long long later = all & ~((2ull << i) - 1);
  const int lim = i + D;
  const unsigned long long win = lim >= 64 ? ~0ull : (1ull << lim) - 1;
  return later & win & (~he | (((aml >> i) & 1) ? 0ull : im)
                        | (((im >> i) & 1) ? ~aml : 0ull));
}

// The reference's deficit test (branch.c:72-78) of one branching arc:
// 0 (kept), 1 (a weak candidate) or 2 (cut). RN(1 - RN(s1 / mx)) in IEEE
// double; exact for 0 <= s1 <= mx (ops/softfloat.py:one_minus_div).
__device__ __forceinline__ int br_classify(const BranchArgs& p, int s1,
                                           int mx, bool aml) {
  const double def = __dsub_rn(
      1.0, __ddiv_rn(static_cast<double>(s1 < 0 ? 0 : s1),
                     static_cast<double>(mx < 1 ? 1 : mx)));
  const bool cand = mx > 0 && def > p.diff;
  const bool cut = cand && ((!aml && def > p.diff_dist) || def > p.diff_cut);
  return static_cast<int>(cand) + static_cast<int>(cut);
}

// Per-thread counts of classes 1 and 2.
struct BranchCounts {
  int n1 = 0, n2 = 0;
  __device__ void add(int w) {
    n1 += w == 1;
    n2 += w == 2;
  }
};

// Member m of the group at h, of score s1, leaves with its bits: (aml, he)
// given, or its class, the group's count of members with no earlier local
// partner at the head (n_grp) and 0 elsewhere.
template <bool kFound>
__device__ __forceinline__ void br_out(const BranchArgs& p, long long h,
                                       long long m, bool am, bool hh, int s1,
                                       int mx, int ngrp, BranchCounts& cnt) {
  const long long a = h + m;
  if (kFound) {
    const int w = br_classify(p, s1, mx, am);
    p.aw[a] = static_cast<uint8_t>(w);
    p.n_grp[a] = m == 0 ? ngrp : 0;
    cnt.add(w);
  } else {
    p.aml[a] = am;
    p.he[a] = hh;
  }
}

// The first 32 arcs from the head h, one a lane, in one round trip: the
// target, the s1 (found groups) or max flag (given), and n, the group's
// size if below 32, else 32.
struct Members {
  long long t;
  int s1;
  bool is_max;
  int n;
};

template <bool kFound>
__device__ __forceinline__ Members br_members(const BranchArgs& p,
                                              long long h, int lane) {
  const long long a = h + lane;
  Members mb = {0, 0, false, 0};
  bool linked = lane == 0;
  if (a < p.A) {
    linked = linked || br_link<kFound>(p, a);
    mb.t = p.tgt[a];
    if (kFound) mb.s1 = p.s1[a];
    else mb.is_max = p.is_max[a] != 0;
  }
  const unsigned run = __ballot_sync(kFull, linked);
  mb.n = run == kFull ? 32 : __ffs(~run) - 1;
  return mb;
}

// A group of 2 <= n <= kBrWarpRows members, by one warp: the members'
// target rows staged kBrChunk genomes at a time, each pair that can still
// change a bit tested once per chunk, lanes over genomes.
template <bool kFound>
__device__ void br_group_warp(const BranchArgs& p, BranchStage& st, int row0,
                              long long h, const Members& mb, int lane,
                              BranchCounts& cnt) {
  const int n = mb.n;
  const bool mem = lane < n;
  int mx = 0;
  if (kFound) {
    mx = mem && mb.s1 > 0 ? mb.s1 : 0;
    for (int o = 16; o; o >>= 1) mx = max(mx, __shfl_xor_sync(kFull, mx, o));
  }
  const unsigned long long im = __ballot_sync(
      kFull, mem && (kFound ? mb.s1 == mx : mb.is_max));
  if (mem) st.tgt[row0 + lane] = mb.t;
  unsigned long long aml = 0, he = 0;
  for (int g0 = 0; g0 < p.G; g0 += kBrChunk) {
    __syncwarp();
    br_stage_rows(p, st, row0, 0, 1, n, g0, lane);
    __syncwarp();
    bool pending = false;
    for (int i = 0; i + 1 < n; ++i) {
      unsigned long long cand = br_partners(aml, he, im, i, n, p.D);
      while (cand) {
        const int j = __ffsll(static_cast<long long>(cand)) - 1;
        cand &= cand - 1;
        if (!br_need(aml, he, im, i, j)) continue;
        if (br_local_staged(p, st, row0 + i, row0 + j, lane)) {
          he |= 1ull << j;
          if ((im >> j) & 1) aml |= 1ull << i;
          if ((im >> i) & 1) aml |= 1ull << j;
        } else {
          pending = true;
        }
      }
    }
    if (!pending) break;
  }
  if (mem)
    br_out<kFound>(p, h, lane, (aml >> lane) & 1, (he >> lane) & 1, mb.s1,
                   mx, n - __popcll(he), cnt);
}

// A group of kBrWarpRows < n <= kBrRows members, by the whole block: rows
// staged by every warp, the pairs (i, j) with i = warp (mod kBrWarps) tested
// by that warp, the bits OR'd into shared masks (a pair tested twice by a
// race only repeats a true fact).
template <bool kFound>
__device__ void br_group_block(const BranchArgs& p, BranchStage& st,
                               long long h, int n, int lane, int warp,
                               unsigned long long* s_bits, int* s_mx,
                               BranchCounts& cnt) {
  if (warp == 0) {
    const int mx = kFound ? br_group_max(p, h, n, lane) : 0;
    unsigned long long im = 0;
    for (int m0 = 0; m0 < n; m0 += 32) {
      const int m = m0 + lane;
      const unsigned b =
          __ballot_sync(kFull, m < n && br_is_max<kFound>(p, h + m, mx));
      im |= static_cast<unsigned long long>(b) << m0;
    }
    if (lane == 0) {
      s_bits[0] = 0;      // aml
      s_bits[1] = 0;      // he
      s_bits[2] = im;
      *s_mx = mx;
    }
  }
  for (int m = threadIdx.x; m < n; m += kBrThreads)
    st.tgt[m] = p.tgt[h + m];
  __syncthreads();
  const unsigned long long im = s_bits[2];
  volatile unsigned long long* vb = s_bits;
  for (int g0 = 0; g0 < p.G; g0 += kBrChunk) {
    br_stage_rows(p, st, 0, warp, kBrWarps, n, g0, lane);
    __syncthreads();
    bool pending = false;
    for (int i = warp; i + 1 < n; i += kBrWarps) {
      unsigned long long cand = br_partners(
          __shfl_sync(kFull, vb[0], 0), __shfl_sync(kFull, vb[1], 0), im, i,
          n, p.D);
      while (cand) {
        const int j = __ffsll(static_cast<long long>(cand)) - 1;
        cand &= cand - 1;
        const unsigned long long aml = __shfl_sync(kFull, vb[0], 0);
        const unsigned long long he = __shfl_sync(kFull, vb[1], 0);
        if (!br_need(aml, he, im, i, j)) continue;
        if (br_local_staged(p, st, i, j, lane)) {
          if (lane == 0) {
            atomicOr(&s_bits[1], 1ull << j);
            if ((im >> j) & 1) atomicOr(&s_bits[0], 1ull << i);
            if ((im >> i) & 1) atomicOr(&s_bits[0], 1ull << j);
          }
          __syncwarp();
        } else {
          pending = true;
        }
      }
    }
    if (!__syncthreads_or(pending)) break;
  }
  __syncthreads();
  const unsigned long long aml = s_bits[0], he = s_bits[1];
  for (int m = threadIdx.x; m < n; m += kBrThreads)
    br_out<kFound>(p, h, m, (aml >> m) & 1, (he >> m) & 1,
                   kFound ? p.s1[h + m] : 0, *s_mx, n - __popcll(he), cnt);
  __syncthreads();
}

// A group of more than kBrRows members (past the window D, so the loop falls
// back; the bits must still be the plain version's): each member walks its
// window |a - p| < D inside the group, the rows read from the planes, one
// member a warp.
template <bool kFound>
__device__ void br_group_walk(const BranchArgs& p, long long h, long long e,
                              int lane, int warp, int* s_cnt,
                              BranchCounts& cnt) {
  const int mx = kFound ? br_group_max(p, h, e - h, lane) : 0;
  if (threadIdx.x == 0) *s_cnt = 0;
  __syncthreads();
  for (long long a = h + warp; a < e; a += kBrWarps) {
    bool am = false, hh = false;
    const long long ta = p.tgt[a];
    const long long lo = a - (p.D - 1) > h ? a - (p.D - 1) : h;
    const long long hi = a + (p.D - 1) < e - 1 ? a + (p.D - 1) : e - 1;
    for (long long q = lo; q <= hi; ++q) {
      if (q == a) continue;
      const bool want_am = !am && br_is_max<kFound>(p, q, mx);
      const bool want_he = !hh && q < a;
      if (!want_am && !want_he) continue;
      if (br_local_global(p, ta, p.tgt[q], lane)) {
        am = am || want_am;
        hh = hh || want_he;
      }
    }
    if (lane == 0) {
      if (!hh) atomicAdd(s_cnt, 1);
      br_out<kFound>(p, h, a - h, am, hh, kFound ? p.s1[a] : 0, mx, 0, cnt);
    }
  }
  __syncthreads();
  if (kFound && threadIdx.x == 0) p.n_grp[h] = *s_cnt;
  __syncthreads();
}

// Each warp owns the 32 arcs [base, base + 32) as group heads (an arc not
// linked to the one before it). Groups of one member leave at once; groups
// of up to kBrWarpRows are the warp's; larger ones wait for the whole block.
template <bool kFound>
__global__ void __launch_bounds__(kBrThreads)
branch_kernel(BranchArgs p) {
  __shared__ BranchStage st;
  __shared__ long long s_big[kBrBig];
  __shared__ unsigned long long s_bits[3];
  __shared__ int s_nbig, s_mx, s_cnt;
  __shared__ int s_sum[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_nbig = 0;
    s_sum[0] = s_sum[1] = 0;
  }
  __syncthreads();
  BranchCounts cnt;
  const long long base =
      (static_cast<long long>(blockIdx.x) * kBrWarps + warp) * 32;
  // a head followed by a head (or the table's end) is a group of one: all
  // of them leave at once (the table's empty slots are such groups)
  const long long a = base + lane;
  const bool head = a < p.A && !br_link<kFound>(p, a);
  const bool one = head && !br_link<kFound>(p, a + 1);
  if (one) br_out<kFound>(p, a, 0, false, false, 0, 0, 0, cnt);
  unsigned heads = __ballot_sync(kFull, head && !one);
  while (heads) {
    const long long h = base + __ffs(heads) - 1;
    heads &= heads - 1;
    const Members mb = br_members<kFound>(p, h, lane);
    if (mb.n <= kBrWarpRows) {
      br_group_warp<kFound>(p, st, warp * kBrWarpRows, h, mb, lane, cnt);
    } else if (lane == 0) {
      s_big[atomicAdd(&s_nbig, 1)] = h;
    }
  }
  __syncthreads();
  for (int k = 0; k < s_nbig; ++k) {
    const long long h = s_big[k];
    const long long n = br_group_end<kFound>(p, h, lane) - h;
    if (n <= kBrRows)
      br_group_block<kFound>(p, st, h, static_cast<int>(n), lane, warp,
                             s_bits, &s_mx, cnt);
    else
      br_group_walk<kFound>(p, h, h + n, lane, warp, &s_cnt, cnt);
  }
  if (kFound) {
    for (int o = 16; o; o >>= 1) {
      cnt.n1 += __shfl_xor_sync(kFull, cnt.n1, o);
      cnt.n2 += __shfl_xor_sync(kFull, cnt.n2, o);
    }
    if (lane == 0) {
      atomicAdd(&s_sum[0], cnt.n1);
      atomicAdd(&s_sum[1], cnt.n2);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicAdd(&p.counts[0], static_cast<unsigned long long>(s_sum[0]));
      atomicAdd(&p.counts[1], static_cast<unsigned long long>(s_sum[1]));
    }
  }
}

// The classification alone, after the locality bits were OR'd over the
// ranks: one thread an arc.
__global__ void __launch_bounds__(kFoldThreads)
branch_classify_kernel(BranchArgs p, const int32_t* __restrict__ mx) {
  __shared__ int s_sum[2];
  if (threadIdx.x == 0) s_sum[0] = s_sum[1] = 0;
  __syncthreads();
  const long long a =
      static_cast<long long>(blockIdx.x) * kFoldThreads + threadIdx.x;
  BranchCounts cnt;
  if (a < p.A) {
    int w = 0;
    if (p.branching[a]) {
      w = br_classify(p, p.s1[a], mx[a], p.aml[a] != 0);
      if (!p.he[a]) atomicAdd(&p.n_grp[p.gs[a]], 1);
    }
    p.aw[a] = static_cast<uint8_t>(w);
    cnt.add(w);
  }
  for (int o = 16; o; o >>= 1) {
    cnt.n1 += __shfl_xor_sync(kFull, cnt.n1, o);
    cnt.n2 += __shfl_xor_sync(kFull, cnt.n2, o);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&s_sum[0], cnt.n1);
    atomicAdd(&s_sum[1], cnt.n2);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(&p.counts[0], static_cast<unsigned long long>(s_sum[0]));
    atomicAdd(&p.counts[1], static_cast<unsigned long long>(s_sum[1]));
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

namespace {

BranchArgs branch_args(const void* pres, const void* cid, const void* cm,
                       const void* rank, int G, const void* tgt, long long A,
                       int D, int frag, long long local_dist,
                       long long local_count) {
  BranchArgs p = {};
  p.pres = static_cast<const uint8_t*>(pres);
  p.cid = static_cast<const int32_t*>(cid);
  p.cm = static_cast<const int64_t*>(cm);
  p.rank = static_cast<const int32_t*>(rank);
  p.G = G;
  p.tgt = static_cast<const int64_t*>(tgt);
  p.A = A;
  p.D = D;
  p.frag = frag;
  p.local_dist = local_dist;
  p.local_count = local_count;
  return p;
}

unsigned branch_blocks(long long A) {
  return static_cast<unsigned>((A + kBrThreads - 1) / kBrThreads);
}

}  // namespace

// (aml, he) [A] of groups given by gs / branching / is_max (one rank's
// genomes; OR'd over the ranks before pg_branch_classify).
extern "C" int pg_branch_locality(const void* pres, const void* cid,
                                  const void* cm, const void* rank, int G,
                                  const void* tgt, const void* gs,
                                  const void* branching, const void* is_max,
                                  long long A, int D, int frag,
                                  long long local_dist, long long local_count,
                                  void* aml, void* he, void* stream) {
  if (A <= 0) return 0;
  BranchArgs p = branch_args(pres, cid, cm, rank, G, tgt, A, D, frag,
                             local_dist, local_count);
  p.gs = static_cast<const int64_t*>(gs);
  p.branching = static_cast<const uint8_t*>(branching);
  p.is_max = static_cast<const uint8_t*>(is_max);
  p.aml = static_cast<uint8_t*>(aml);
  p.he = static_cast<uint8_t*>(he);
  branch_kernel<false><<<branch_blocks(A), kBrThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The whole branch block at one rank: groups found in the arc table
// (vw, s1), locality and classification in one launch. aw uint8 [A],
// n_grp int32 [A], counts uint64 [2] zeroed by the caller.
extern "C" int pg_branch_block(const void* pres, const void* cid,
                               const void* cm, const void* rank, int G,
                               const void* tgt, const void* vw,
                               const void* s1, int B, long long A, int D,
                               int frag, long long local_dist,
                               long long local_count, double diff,
                               double diff_dist, double diff_cut, void* aw,
                               void* n_grp, void* counts, void* stream) {
  if (A <= 0) return 0;
  BranchArgs p = branch_args(pres, cid, cm, rank, G, tgt, A, D, frag,
                             local_dist, local_count);
  p.vw = static_cast<const int64_t*>(vw);
  p.s1 = static_cast<const int32_t*>(s1);
  p.B = B;
  p.diff = diff;
  p.diff_dist = diff_dist;
  p.diff_cut = diff_cut;
  p.aw = static_cast<uint8_t*>(aw);
  p.n_grp = static_cast<int32_t*>(n_grp);
  p.counts = static_cast<unsigned long long*>(counts);
  branch_kernel<true><<<branch_blocks(A), kBrThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The classification of arcs whose (aml, he) are known: aw [A], n_grp [A]
// and counts [2], the last two zeroed by the caller.
extern "C" int pg_branch_classify(const void* s1, const void* mx,
                                  const void* branching, const void* aml,
                                  const void* he, const void* gs,
                                  long long A, double diff, double diff_dist,
                                  double diff_cut, void* aw, void* n_grp,
                                  void* counts, void* stream) {
  if (A <= 0) return 0;
  BranchArgs p = {};
  p.A = A;
  p.s1 = static_cast<const int32_t*>(s1);
  p.branching = static_cast<const uint8_t*>(branching);
  p.aml = static_cast<uint8_t*>(const_cast<void*>(aml));
  p.he = static_cast<uint8_t*>(const_cast<void*>(he));
  p.gs = static_cast<const int64_t*>(gs);
  p.diff = diff;
  p.diff_dist = diff_dist;
  p.diff_cut = diff_cut;
  p.aw = static_cast<uint8_t*>(aw);
  p.n_grp = static_cast<int32_t*>(n_grp);
  p.counts = static_cast<unsigned long long*>(counts);
  const long long blocks = (A + kFoldThreads - 1) / kFoldThreads;
  branch_classify_kernel<<<static_cast<unsigned>(blocks), kFoldThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int32_t*>(mx));
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
