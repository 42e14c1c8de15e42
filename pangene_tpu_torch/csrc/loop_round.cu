// The device loop's per-round blocks around the branch kernels and the
// merge's fold (parallel/device_loop.py), for Hopper (sm_90a). Bound to
// Python with ctypes (ops/loop_kernels.py), which also holds the plain
// PyTorch version each kernel is tested against. Every value is an integer
// or a bit, so each kernel equals its plain version exactly.
//
// walk_pairs replaces the walk and key build of the JAX walk_merge
// (pangene_tpu/parallel/device_loop.py:222 kept_pairs, :264-300; reference
// graph.c:87-120). Over this rank's genomes in cm order: a row is kept when
// it is valid and its cs row (ordcm) is neither filtered nor shadowed; its
// previous kept row prev is a running maximum; the pair (prev, i) is ok on
// one contig. Per pair slot it writes the merge's sort key, forward
// (v << B | w) and reverse ((w ^ 1) << B | v ^ 1), each << GB | the global
// genome, in the lean form also << jb | the global slot, KSENT where the
// pair is not ok; the slot's s1 (the forward slot the earlier hit's score,
// the reverse the later's) and in the full mode the swapped s2 and the
// int32-truncated cm gap; pair_ok; nxt[prev] = i (the kept row whose
// previous row prev is: at most one, since prev is increasing over kept
// rows); and the segment counters of the kept rows, their total and their
// genomes, before the mesh's psum.
//
// branch_prep replaces the JAX branch block's prelude (:512-514 the arc
// groups' window check and targets, :527-537 the representatives): per
// (gene, genome) the last kept hit in cs order (presence, contig, cm and
// kept rank; row 0's when absent, as the plain gather reads), each arc's
// target gene, and the window flag (a group of more than D arcs) OR'd into
// the loop's overflow word.
//
// prop_round replaces weak propagation and the weak == 2 filter (:673-690;
// branch.c:108-145): in gather form, each cm position takes the larger of
// its own pair's reverse mark and the forward mark of the pair whose
// previous hit it is (nxt), and writes its cs row (ordcm is a permutation,
// so every row is written once); then the filter, the reference's n_prop
// count and the round's change bit.
//
// occ_round replaces the annealed high-occurrence filter (:693 occ_block;
// graph.c:237-263) with the convergence count and the #del capture
// (:724-740): in a branch round first the n_dist_loci plane from the
// classification's n_grp; then the out-degrees (the arc table is v-sorted
// with its valid arcs first, so a vertex's group size is its count of valid
// arcs), the segments' deletion (occ, degree, loci; counted into the round's
// log row), the capture rows, and the dead genes' hits filtered.
//
// What bounds them on the H100: their bytes (chip_smoke.py works them out
// per call), a few hundred kilobytes to some ten megabytes a call: a few
// microseconds. The plain PyTorch forms cost launch latency: ~20-70 small
// operations each a round, enqueued one at a time by the host.
//
// Design: a simple kernel for each, no tensor cores and no TMA. The two
// running scans over a genome's rows (walk_pairs' previous kept row,
// branch_prep's kept rank) take one block of 1,024 threads a genome, in
// tiles of 1,024 rows with a carry (a block-wide scan by warp shuffles);
// every other phase is element-wise over rows, arcs or segments, its
// counts reduced in the block before one atomic. Scatters are unique
// (nxt, the capture rows) or integer atomics (segment counters, degrees,
// the representatives' atomicMax), so every output is deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 1024;       // one block a genome: walk, ranks
constexpr int kThreads = 256;            // the element-wise phases
constexpr int kBlocksPerSm = 8;          // grid-stride phases: blocks a SM
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kSent = (int64_t(1) << 62) - 1;    // empty arc slot
constexpr int64_t kKeySent = int64_t(1) << 62;       // invalid sort key

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct AddOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// Exclusive scan of x over the block's threads in thread order (identity
// id); *total gets the block's reduction. Safe to call again at once: the
// warps' totals and their prefixes live in two arrays.
template <class Op>
__device__ int block_exclusive(int x, Op op, int id, int* total) {
  __shared__ int s_warp[32];
  __shared__ int s_pre[33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = op(incl, y);
  }
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = id;
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? s_warp[lane] : id;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, wi, d);
      if (lane >= d) wi = op(wi, y);
    }
    int we = __shfl_up_sync(kFull, wi, 1);
    if (lane == 0) we = id;
    s_pre[lane] = we;
    if (lane == 31) s_pre[32] = wi;
  }
  __syncthreads();
  *total = s_pre[32];
  return op(s_pre[warp], excl);
}

// Adds each thread's v to *dst: the warp's sum, the block's in shared
// memory, one global atomic a block. Every thread of the block calls it.
__device__ void block_add(unsigned long long* dst, unsigned v) {
  __shared__ unsigned s_sum;
  if (threadIdx.x == 0) s_sum = 0;
  __syncthreads();
  const unsigned w = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0 && w) atomicAdd(&s_sum, w);
  __syncthreads();
  if (threadIdx.x == 0 && s_sum) atomicAdd(dst, (unsigned long long)s_sum);
}

__device__ __forceinline__ int clampi(int64_t x, int64_t lo, int64_t hi) {
  return static_cast<int>(x < lo ? lo : (x > hi ? hi : x));
}

// Blocks of a grid-stride phase over n items.
int stride_blocks(long long n) {
  static int cap = 0;
  if (!cap) {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cap = sms * kBlocksPerSm;
  }
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > cap ? cap : b));
}

// ---------------------------------------------------------------------------
// walk_pairs
// ---------------------------------------------------------------------------

struct WalkArgs {
  // cm-order planes [G, H]
  const int32_t* ordcm;
  const uint8_t* valid;
  const int32_t* cid;
  const int64_t* cm;
  const int64_t* w;
  const int32_t* seg;
  const int32_t* so;
  const int32_t* sd;
  const int32_t* dg;
  const int32_t* dsid;
  // the round state: [G, H] in cs order, alive [S]
  const uint8_t* flt;
  const uint8_t* shadow;
  const uint8_t* alive;
  int H, S, B, GB, jb, use_ori;
  long long g0;        // this rank's first genome (rank * G)
  long long slot0;     // this rank's first pair slot (rank * G * 2H)
  int64_t* keys;       // [G, 2H]
  int32_t* s12;        // [G, 2H]
  uint8_t* pair_ok;    // [G, H]
  int32_t* nxt;        // [G, H], -1 where no pair follows
  int32_t* seg_tot;    // [S]
  int32_t* seg_ng;     // [S]
  uint32_t* seen;      // [S, words]: genome bits a segment
  int words;
  int32_t* s21;        // full mode: [G, 2H] or null
  int32_t* dist2;      // full mode: [G, 2H] or null
};

// The score the merge averages for cm row r (the dominant's unless
// use_ori, the original's outranks it, or the dominant's gene is dead).
__device__ __forceinline__ int32_t walk_score(const WalkArgs& p, long long r) {
  const int32_t so = p.so[r], sd = p.sd[r], dg = p.dg[r], ds = p.dsid[r];
  const bool dom_alive =
      dg >= 0 && ds >= 0 && p.alive[clampi(ds, 0, p.S - 1)] != 0;
  return (p.use_ori || so > sd || dg < 0 || dom_alive) ? so : sd;
}

__global__ void __launch_bounds__(kScanThreads)
walk_pairs_kernel(WalkArgs p) {
  const int g = blockIdx.x;
  const int H = p.H;
  const long long base = static_cast<long long>(g) * H;
  const long long base2 = 2 * base;
  const uint64_t jg = static_cast<uint64_t>(p.g0 + g);
  int carry = -1;
  for (int t0 = 0; t0 < H; t0 += blockDim.x) {
    const int i = t0 + threadIdx.x;
    const long long r = base + i;
    bool kept = false;
    if (i < H && p.valid[r]) {
      const long long h = base + p.ordcm[r];
      kept = p.flt[h] == 0 && p.shadow[h] == 0;
    }
    int total;
    const int ex = block_exclusive(kept ? i : -1, MaxOp(), -1, &total);
    const int prev = ex > carry ? ex : carry;
    carry = total > carry ? total : carry;
    if (i >= H) continue;
    const long long rp = base + (prev < 0 ? 0 : prev);
    const bool ok = kept && prev >= 0 && p.cid[rp] == p.cid[r];
    const uint64_t w = static_cast<uint64_t>(p.w[r]);
    const uint64_t v = static_cast<uint64_t>(p.w[rp]);
    uint64_t kf = (((v << p.B) | w) << p.GB) | jg;
    uint64_t kr = ((((w ^ 1) << p.B) | (v ^ 1)) << p.GB) | jg;
    if (p.jb) {
      const uint64_t jo = static_cast<uint64_t>(p.slot0 + base2 + i);
      kf = (kf << p.jb) | jo;
      kr = (kr << p.jb) | (jo + H);
    }
    p.keys[base2 + i] = ok ? static_cast<int64_t>(kf) : kKeySent;
    p.keys[base2 + H + i] = ok ? static_cast<int64_t>(kr) : kKeySent;
    const int32_t s1 = walk_score(p, rp), s2 = walk_score(p, r);
    p.s12[base2 + i] = s1;
    p.s12[base2 + H + i] = s2;
    if (p.s21) {
      // the int32 truncation of the reference's pg_tmparc_t
      const int32_t d = static_cast<int32_t>(static_cast<uint32_t>(
          static_cast<uint64_t>(p.cm[r]) - static_cast<uint64_t>(p.cm[rp])));
      p.s21[base2 + i] = s2;
      p.s21[base2 + H + i] = s1;
      p.dist2[base2 + i] = d;
      p.dist2[base2 + H + i] = d;
    }
    p.pair_ok[r] = ok;
    if (kept && prev >= 0) p.nxt[base + prev] = i;
    if (kept && p.S > 0) {
      const int s = p.seg[r];
      atomicAdd(&p.seg_tot[s], 1);
      const uint32_t bit = 1u << (g & 31);
      const uint32_t old = atomicOr(&p.seen[
          static_cast<long long>(s) * p.words + (g >> 5)], bit);
      if (!(old & bit)) atomicAdd(&p.seg_ng[s], 1);
    }
  }
}

// ---------------------------------------------------------------------------
// branch_prep
// ---------------------------------------------------------------------------

struct PrepArgs {
  const uint8_t* flt;      // [G, H] cs order
  const uint8_t* shadow;
  const uint8_t* valid;
  const int32_t* gid;
  const int32_t* cid;
  const int64_t* cm;
  int G, H, ng;
  const int64_t* arc_vw;   // [A]
  long long A;
  const int64_t* seg_gid;  // [S]
  int S, B, D;
  uint8_t* r_pres;         // [ng, G]
  int32_t* r_cid;
  int64_t* r_cm;
  int32_t* r_rank;
  int64_t* tgt;            // [A]
  uint8_t* overflow;       // one byte, OR'd
  int32_t* last;           // [ng, G] scratch, -1 filled
  int32_t* krank;          // [G, H] scratch
};

// Kept ranks (a running count a genome) and each gene's last kept row.
__global__ void __launch_bounds__(kScanThreads)
prep_rank_kernel(PrepArgs p) {
  const int g = blockIdx.x;
  const long long base = static_cast<long long>(g) * p.H;
  int carry = 0;
  for (int t0 = 0; t0 < p.H; t0 += blockDim.x) {
    const int i = t0 + threadIdx.x;
    const long long r = base + i;
    const bool kept = i < p.H && p.flt[r] == 0 && p.shadow[r] == 0 &&
                      p.valid[r] != 0;
    int total;
    const int ex = block_exclusive(kept ? 1 : 0, AddOp(), 0, &total);
    if (i < p.H && (kept || i == 0)) p.krank[r] = carry + ex + kept - 1;
    carry += total;
    if (kept) {
      const int q = clampi(p.gid[r], 0, p.ng - 1);
      atomicMax(&p.last[static_cast<long long>(q) * p.G + g], i);
    }
  }
}

// The representative planes, then the arcs' targets and window check.
__global__ void __launch_bounds__(kThreads) prep_rep_kernel(PrepArgs p) {
  const long long n_rep = static_cast<long long>(p.ng) * p.G;
  const long long n = n_rep + p.A;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int64_t wmask = (int64_t(1) << p.B) - 1;
  const int win = p.D > 1 ? p.D : 1;
  bool ovf = false;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x; k < n; k += stride) {
    if (k < n_rep) {
      const int g = static_cast<int>(k % p.G);
      const int l = p.last[k];
      const long long b = static_cast<long long>(g) * p.H +
                          (l < 0 ? 0 : (l > p.H - 1 ? p.H - 1 : l));
      p.r_pres[k] = l >= 0;
      p.r_cid[k] = p.cid[b];
      p.r_cm[k] = p.cm[b];
      p.r_rank[k] = p.krank[b];
      continue;
    }
    const long long a = k - n_rep;
    const int64_t vw = p.arc_vw[a];
    const int64_t tg = p.seg_gid[clampi((vw & wmask) >> 1, 0, p.S - 1)];
    p.tgt[a] = tg < 0 ? 0 : (tg > p.ng - 1 ? p.ng - 1 : tg);
    if (vw == kSent) continue;
    const int64_t v = vw >> p.B;
    if (a > 0 && (p.arc_vw[a - 1] >> p.B) == v) continue;   // not a head
    // a group head: more than `win` arcs of its vertex overflow
    int cnt = 1;
    for (long long j = a + 1; j < p.A && cnt <= win; ++j) {
      const int64_t x = p.arc_vw[j];
      if (x == kSent || (x >> p.B) != v) break;
      ++cnt;
    }
    ovf |= cnt > win;
  }
  if (ovf) *p.overflow = 1;
}

// ---------------------------------------------------------------------------
// prop_round
// ---------------------------------------------------------------------------

struct PropArgs {
  uint8_t* weak;           // [G, H] cs order, in place
  uint8_t* flt;
  const uint8_t* valid;
  long long n;             // G * H
  int H;
  int propagate;
  const int32_t* ordcm;    // [G, H] cm order
  const int32_t* pair_arc; // [G, 2H]: each pair slot's arc row
  const int32_t* nxt;      // [G, H]
  const uint8_t* pair_ok;  // [G, H]
  const uint8_t* arc_weak; // [A]
  long long A;
  unsigned long long* word;   // (n_prop, changed)
};

__device__ __forceinline__ int arc_mark(const PropArgs& p, int32_t row) {
  return p.arc_weak[row < 0 ? 0 : (row > p.A - 1 ? p.A - 1 : row)];
}

__global__ void __launch_bounds__(kThreads) prop_round_kernel(PropArgs p) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned n_prop = 0;
  bool changed = false;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x; k < p.n; k += stride) {
    long long r = k;
    int wk;
    if (p.propagate) {
      const long long g = k / p.H, i = k - g * p.H;
      r = g * p.H + p.ordcm[k];
      wk = p.weak[r];
      int m = 0;
      if (p.pair_ok[k]) m = arc_mark(p, p.pair_arc[2 * g * p.H + p.H + i]);
      const int j = p.nxt[k];
      if (j >= 0 && p.pair_ok[g * p.H + j]) {
        const int f = arc_mark(p, p.pair_arc[2 * g * p.H + j]);
        m = f > m ? f : m;
      }
      if (m > wk) {
        p.weak[r] = static_cast<uint8_t>(m);
        wk = m;
        changed = true;
      }
    } else {
      wk = p.weak[r];
    }
    if (wk == 2 && p.flt[r] == 0) {
      p.flt[r] = 1;
      changed = true;
    }
    n_prop += wk != 0 && p.valid[r] != 0;
  }
  block_add(&p.word[0], n_prop);
  if (changed) p.word[1] = 1;
}

// ---------------------------------------------------------------------------
// occ_round
// ---------------------------------------------------------------------------

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
  int32_t* deg_row;        // [2S], zeroed
  int32_t* loci_row;       // [2S]
  int32_t* tot_row;        // [S]
  unsigned long long* word;      // (n_prop, changed)
};

// The loci plane from n_grp and the out-degrees: over the arcs.
__global__ void __launch_bounds__(kThreads) occ_arc_kernel(OccArgs p) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // every thread takes the same number of turns (the warp's match below)
  for (long long b0 = static_cast<long long>(blockIdx.x) * blockDim.x;
       b0 < p.A; b0 += stride) {
    const long long a = b0 + threadIdx.x;
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
    // a vertex's arcs are contiguous: one atomic a vertex a warp
    const unsigned peers = __match_any_sync(kFull, key);
    if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&p.deg_row[key], __popc(peers));
  }
}

// The segments: deletion, the capture rows, the counts.
__global__ void __launch_bounds__(kThreads) occ_seg_kernel(OccArgs p) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned n_occ = 0, n_deg = 0, n_loci = 0, n_alive = 0;
  bool changed = false;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x; s < p.S; s += stride) {
    bool al = p.alive[s] != 0;
    const int32_t l0 = p.loci[2 * s], l1 = p.loci[2 * s + 1];
    bool del = false;
    if (p.do_occ) {
      const bool od = al && static_cast<long long>(p.seg_tot[s]) > p.occ_cut;
      const bool dd = al && (p.deg_row[2 * s] > p.deg_cut ||
                             p.deg_row[2 * s + 1] > p.deg_cut);
      const bool ld = al && (l0 > l1 ? l0 : l1) > p.loci_cut;
      n_occ += od;
      n_deg += dd && !od;
      n_loci += ld && !dd && !od;
      del = od || dd || ld;
      if (del) {
        p.alive[s] = 0;
        al = false;
        changed = true;
      }
    }
    p.mask_row[s] = del;
    p.loci_row[2 * s] = l0;
    p.loci_row[2 * s + 1] = l1;
    p.tot_row[s] = p.seg_tot[s];
    n_alive += al;
  }
  block_add(&p.log_row[0], n_occ);
  block_add(&p.log_row[1], n_deg);
  block_add(&p.log_row[2], n_loci);
  block_add(&p.log_row[3], n_alive);
  if (changed) p.word[1] = 1;
}

// Hits of dead genes leave the walk (PG_SET_FILTER(vtx == 0)).
__global__ void __launch_bounds__(kThreads) occ_hit_kernel(OccArgs p) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  bool changed = false;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x; k < p.n; k += stride) {
    if (!p.valid[k] || p.flt[k]) continue;
    const int32_t sh = p.sid_of[clampi(p.gid[k], 0, p.ng - 1)];
    if (sh < 0 || !p.alive[clampi(sh, 0, p.S - 1)]) {
      p.flt[k] = 1;
      changed = true;
    }
  }
  if (changed) p.word[1] = 1;
}

inline int err_of(cudaError_t e) { return static_cast<int>(e); }

}  // namespace

// The walk of this rank's G genomes (walk_pairs in ops/loop_kernels.py):
// memsets nxt to -1 and the `zero_bytes` from seg (seg_tot, seg_ng, then
// the [S, words] genome bits), then one block a genome. s21 and dist2
// (null or both given) select the full mode.
extern "C" int pg_walk_pairs(
    const void* ordcm, const void* valid, const void* cid, const void* cm,
    const void* w, const void* seg, const void* so, const void* sd,
    const void* dg, const void* dsid, const void* flt, const void* shadow,
    const void* alive, int G, int H, int S, int B, int GB, int jb,
    long long rank, int use_ori, void* keys, void* s12, void* pair_ok,
    void* nxt, void* seg_out, int words, long long zero_bytes, void* s21,
    void* dist2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(seg_out, 0, zero_bytes, st);
  if (e == cudaSuccess && G > 0 && H > 0)
    e = cudaMemsetAsync(nxt, 0xff, static_cast<size_t>(G) * H * 4, st);
  if (e != cudaSuccess) return err_of(e);
  if (G <= 0 || H <= 0) return 0;
  WalkArgs p = {};
  p.ordcm = static_cast<const int32_t*>(ordcm);
  p.valid = static_cast<const uint8_t*>(valid);
  p.cid = static_cast<const int32_t*>(cid);
  p.cm = static_cast<const int64_t*>(cm);
  p.w = static_cast<const int64_t*>(w);
  p.seg = static_cast<const int32_t*>(seg);
  p.so = static_cast<const int32_t*>(so);
  p.sd = static_cast<const int32_t*>(sd);
  p.dg = static_cast<const int32_t*>(dg);
  p.dsid = static_cast<const int32_t*>(dsid);
  p.flt = static_cast<const uint8_t*>(flt);
  p.shadow = static_cast<const uint8_t*>(shadow);
  p.alive = static_cast<const uint8_t*>(alive);
  p.H = H;
  p.S = S;
  p.B = B;
  p.GB = GB;
  p.jb = jb;
  p.use_ori = use_ori;
  p.g0 = rank * G;
  p.slot0 = rank * G * 2LL * H;
  p.keys = static_cast<int64_t*>(keys);
  p.s12 = static_cast<int32_t*>(s12);
  p.pair_ok = static_cast<uint8_t*>(pair_ok);
  p.nxt = static_cast<int32_t*>(nxt);
  p.seg_tot = static_cast<int32_t*>(seg_out);
  p.seg_ng = p.seg_tot + S;
  p.seen = reinterpret_cast<uint32_t*>(p.seg_ng + S);
  p.words = words;
  p.s21 = static_cast<int32_t*>(s21);
  p.dist2 = static_cast<int32_t*>(dist2);
  walk_pairs_kernel<<<G, kScanThreads, 0, st>>>(p);
  return err_of(cudaGetLastError());
}

// The branch block's prelude (branch_prep in ops/loop_kernels.py): two
// launches after a memset of `last` (-1), the [ng, G] scratch; krank is a
// [G, H] scratch. overflow (one byte) is set when a group is past D.
extern "C" int pg_branch_prep(
    const void* flt, const void* shadow, const void* valid, const void* gid,
    const void* cid, const void* cm, int G, int H, int ng,
    const void* arc_vw, long long A, const void* seg_gid, int S, int B,
    int D, void* r_pres, void* r_cid, void* r_cm, void* r_rank, void* tgt,
    void* overflow, void* last, void* krank, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PrepArgs p = {};
  p.flt = static_cast<const uint8_t*>(flt);
  p.shadow = static_cast<const uint8_t*>(shadow);
  p.valid = static_cast<const uint8_t*>(valid);
  p.gid = static_cast<const int32_t*>(gid);
  p.cid = static_cast<const int32_t*>(cid);
  p.cm = static_cast<const int64_t*>(cm);
  p.G = G;
  p.H = H;
  p.ng = ng;
  p.arc_vw = static_cast<const int64_t*>(arc_vw);
  p.A = A;
  p.seg_gid = static_cast<const int64_t*>(seg_gid);
  p.S = S;
  p.B = B;
  p.D = D;
  p.r_pres = static_cast<uint8_t*>(r_pres);
  p.r_cid = static_cast<int32_t*>(r_cid);
  p.r_cm = static_cast<int64_t*>(r_cm);
  p.r_rank = static_cast<int32_t*>(r_rank);
  p.tgt = static_cast<int64_t*>(tgt);
  p.overflow = static_cast<uint8_t*>(overflow);
  p.last = static_cast<int32_t*>(last);
  p.krank = static_cast<int32_t*>(krank);
  const long long n_rep = static_cast<long long>(ng) * G;
  if (n_rep > 0) {
    const cudaError_t e = cudaMemsetAsync(last, 0xff, n_rep * 4, st);
    if (e != cudaSuccess) return err_of(e);
    if (H > 0) prep_rank_kernel<<<G, kScanThreads, 0, st>>>(p);
  }
  if (n_rep + A > 0)
    prep_rep_kernel<<<stride_blocks(n_rep + A), kThreads, 0, st>>>(p);
  return err_of(cudaGetLastError());
}

// Weak propagation and the weak == 2 filter (prop_round in
// ops/loop_kernels.py): zeroes word (n_prop, changed), then one launch.
// Without `propagate` the pair state is not read.
extern "C" int pg_prop_round(void* weak, void* flt, const void* valid,
                             long long G, int H, int propagate,
                             const void* ordcm, const void* pair_arc,
                             const void* nxt, const void* pair_ok,
                             const void* arc_weak, long long A, void* word,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(word, 0, 16, st);
  if (e != cudaSuccess) return err_of(e);
  PropArgs p = {};
  p.weak = static_cast<uint8_t*>(weak);
  p.flt = static_cast<uint8_t*>(flt);
  p.valid = static_cast<const uint8_t*>(valid);
  p.n = G * H;
  p.H = H;
  p.propagate = propagate && A > 0;
  p.ordcm = static_cast<const int32_t*>(ordcm);
  p.pair_arc = static_cast<const int32_t*>(pair_arc);
  p.nxt = static_cast<const int32_t*>(nxt);
  p.pair_ok = static_cast<const uint8_t*>(pair_ok);
  p.arc_weak = static_cast<const uint8_t*>(arc_weak);
  p.A = A;
  p.word = static_cast<unsigned long long*>(word);
  if (p.n > 0)
    prop_round_kernel<<<stride_blocks(p.n), kThreads, 0, st>>>(p);
  return err_of(cudaGetLastError());
}

// The occ block of round r (occ_round in ops/loop_kernels.py): memsets the
// round's log words and degree row, then the arc phase (when n_grp is
// given or do_occ), the segment phase, and the hit phase (do_occ). The
// change bit goes to word[1].
extern "C" int pg_occ_round(
    void* alive, void* flt, const void* valid, const void* gid,
    const void* sid_of, int ng, long long n, const void* arc_vw,
    long long A, int B, int S, const void* seg_tot, void* loci,
    const void* n_grp, int do_occ, long long occ_cut, int deg_cut,
    int loci_cut, void* log_row, void* mask_row, void* deg_row,
    void* loci_row, void* tot_row, void* word, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(log_row, 0, 32, st);
  if (e == cudaSuccess && S > 0)
    e = cudaMemsetAsync(deg_row, 0, 8LL * S, st);
  if (e == cudaSuccess && S > 0 && n_grp)
    e = cudaMemsetAsync(loci, 0, 8LL * S, st);
  if (e != cudaSuccess) return err_of(e);
  OccArgs p = {};
  p.alive = static_cast<uint8_t*>(alive);
  p.flt = static_cast<uint8_t*>(flt);
  p.valid = static_cast<const uint8_t*>(valid);
  p.gid = static_cast<const int32_t*>(gid);
  p.sid_of = static_cast<const int32_t*>(sid_of);
  p.ng = ng;
  p.n = n;
  p.arc_vw = static_cast<const int64_t*>(arc_vw);
  p.A = A;
  p.B = B;
  p.S = S;
  p.seg_tot = static_cast<const int32_t*>(seg_tot);
  p.loci = static_cast<int32_t*>(loci);
  p.n_grp = static_cast<const int32_t*>(n_grp);
  p.do_occ = do_occ;
  p.occ_cut = occ_cut;
  p.deg_cut = deg_cut;
  p.loci_cut = loci_cut;
  p.log_row = static_cast<unsigned long long*>(log_row);
  p.mask_row = static_cast<uint8_t*>(mask_row);
  p.deg_row = static_cast<int32_t*>(deg_row);
  p.loci_row = static_cast<int32_t*>(loci_row);
  p.tot_row = static_cast<int32_t*>(tot_row);
  p.word = static_cast<unsigned long long*>(word);
  if (A > 0 && S > 0 && (n_grp || do_occ))
    occ_arc_kernel<<<stride_blocks(A), kThreads, 0, st>>>(p);
  if (S > 0) occ_seg_kernel<<<stride_blocks(S), kThreads, 0, st>>>(p);
  if (do_occ && n > 0)
    occ_hit_kernel<<<stride_blocks(n), kThreads, 0, st>>>(p);
  return err_of(cudaGetLastError());
}
