// The per-round device step's walk, counters and arc dedupe
// (parallel/stacked.py: round_step), for Hopper (sm_90a). Bound to Python
// with ctypes (ops/step_kernels.py), which also holds the plain PyTorch
// versions these kernels are tested against.
//
// What they replace: the XLA forms of the JAX package's per-genome round,
// pangene_tpu/parallel/stacked.py:54 _genome_round (vmapped by round_step,
// :152): its gene walk (:85-115), its arc dedupe after the sort by key
// (:117-135) and its gene counters (:137-140). No TPU kernel computes
// them; on the card they were about 60 torch operations a step. Both sorts
// of the step stay torch.sort, as JAX sorts with jnp.argsort.
//
// step_walk: one block a genome, over the genome's rows in the stable
// (cid, cm) order `perm` in chunks of kThreads positions. A position is
// kept when its row is unfiltered, not shadowed and below n_rows; its
// previous kept position is the running maximum of kept positions (a
// block-wide scan, the carry held across chunks); a pair is the position
// and that previous one on the same contig. Only a kept row's columns are
// read (dom_gid only where score_ori <= score_dom decides nothing), and
// flt / shadow only below n_rows. Per position p it writes the
// biased keys of the pair's two arcs (forward at p, reverse at H + p:
// ((v << 32 | w) ^ 2^63, ((w ^ 1) << 32 | (v ^ 1)) ^ 2^63, w = sid << 1 |
// rev on all 64 bits, so a non-vertex gene's sid -1 sets the high bits as
// the reference's uint64 does; int64 max where there is no pair), and the
// pair's flag, its int32-truncated cm distance and the two scores (zeros
// without a pair). The previous kept position's columns come from shared
// memory when it lies in the chunk, else from the carry. The gene counters
// ride along: a kept row adds one to tot[clip(sid)] and, the first time
// its genome meets that segment (a bit per gene: in shared memory, or past
// kSmemMax in the genome's words of a global scratch, the same code on a
// generic pointer), one to n_genome[clip(sid)]; global atomics, both
// zeroed by the entry.
//
// step_dedupe: one block a genome over the 2H sorted keys in chunks of
// kThreads. A group is a run of equal keys; its index is the number of
// group starts before it (a block-wide count, carried). Each position's
// pair (aperm's row, and which arc) contributes (valid, dist, a1, a2); runs
// are reduced within a warp by a segmented shuffle tree, each run's first
// lane in the warp adds its partial into the chunk's group slot in shared
// memory (only runs that cross a warp meet there), and a group still open
// at the chunk's end is carried to the next. Per group: cnt, dsum (int64),
// m1 / m2 (the maxima of the valid members' scores, -2^31 + 1 for invalid
// members) and uniq_x (the key's raw bits when a member is valid, else 0),
// at the group's index; rows past the last group read 0, as the plain
// version's segment sums and maxima leave them.
//
// What bounds them on the H100: bytes. The walk reads perm (8 bytes) at
// every position, flt and shadow below n_rows, 21 bytes of columns at a
// kept row (29 with dom_gid and score_dom when use_ori is off), and writes
// 29 bytes a position (the two keys 16, flag 1, dist and scores 12); the
// dedupe reads 16 bytes a key, pair_ok a row and 12 bytes at a pair's row,
// and writes 28 bytes a key. chip_smoke.py: step_bound_bytes counts them
// on the run's data. One block a genome
// leaves most SMs idle (64 genomes on 132 SMs) and runs ~20-40 chunks
// one after another, each a latency chain of gathers and barriers; a tiled
// form with a decoupled look-back (csrc/loop_round.cu: walk_pairs) is the
// later redesign.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr uint64_t kBias = 1ULL << 63;
constexpr int64_t kNoArc = 9223372036854775807LL;   // int64 max: no pair
constexpr int32_t kScoreFloor = -2147483647;        // -2^31 + 1
// step_walk's static shared memory: a chunk's columns and the scan's
constexpr size_t kWalkStatic = 24 * kThreads + 4 * kWarps;
constexpr size_t kSmemMax = 232448;   // a block's, above 48 KB by opt-in

// Block-wide exclusive maximum of v over the threads before this one
// (-1 when none); *total gets the block's maximum. Two barriers; s_warp
// holds kWarps ints.
__device__ __forceinline__ int block_excl_max(int v, int* s_warp,
                                              int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl = max(incl, t);
  }
  if (lane == 31) s_warp[warp] = incl;
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = -1;
  __syncthreads();
  int tot = -1;
#pragma unroll 4
  for (int w = 0; w < kWarps; ++w) {
    const int x = s_warp[w];
    if (w < warp) excl = max(excl, x);
    tot = max(tot, x);
  }
  *total = tot;
  __syncthreads();
  return excl;
}

// Block-wide inclusive count of the flags up to this thread; *total gets
// the block's count. Two barriers; s_warp holds kWarps ints.
__device__ __forceinline__ int block_incl_count(bool flag, int* s_warp,
                                                int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(0xffffffffu, flag);
  int incl = __popc(b & (0xffffffffu >> (31 - lane)));
  if (lane == 0) s_warp[warp] = __popc(b);
  __syncthreads();
  int tot = 0;
#pragma unroll 4
  for (int w = 0; w < kWarps; ++w) {
    const int x = s_warp[w];
    if (w < warp) incl += x;
    tot += x;
  }
  *total = tot;
  __syncthreads();
  return incl;
}

// The columns of a position that a later position's pair reads.
struct Kept {
  int64_t w, cm;
  int32_t sc, cid;
};

__global__ void __launch_bounds__(kThreads)
step_walk_kernel(const int64_t* __restrict__ perm,
                 const uint8_t* __restrict__ flt,
                 const uint8_t* __restrict__ shadow,
                 const int32_t* __restrict__ n_rows,
                 const int32_t* __restrict__ cid,
                 const int32_t* __restrict__ gid,
                 const uint8_t* __restrict__ rev,
                 const int32_t* __restrict__ score_ori,
                 const int32_t* __restrict__ score_dom,
                 const int32_t* __restrict__ dom_gid,
                 const int64_t* __restrict__ cm,
                 const int32_t* __restrict__ g2s, int n_gene, int H,
                 int use_ori, int64_t* __restrict__ akey,
                 uint8_t* __restrict__ pair_ok, int32_t* __restrict__ dist,
                 int32_t* __restrict__ s1, int32_t* __restrict__ s2,
                 int32_t* __restrict__ counts, unsigned* gseen) {
  extern __shared__ unsigned s_seen[];
  __shared__ int64_t s_w[kThreads], s_cm[kThreads];
  __shared__ int32_t s_sc[kThreads], s_cid[kThreads];
  __shared__ int s_warp[kWarps];
  const int g = blockIdx.x, tid = threadIdx.x;
  const size_t ro = (size_t)g * H;
  const int n = min(max(n_rows[g], 0), H);
  const int words = (n_gene + 31) / 32;
  // one bit a gene, met in genome g
  unsigned* seen = gseen != nullptr ? gseen + (size_t)g * words : s_seen;
  for (int k = tid; k < words; k += kThreads) seen[k] = 0;
  __syncthreads();
  Kept carry = {0, 0, 0, 0};
  int last = -1;   // the last kept position of the chunks done
  for (int c0 = 0; c0 < H; c0 += kThreads) {
    const int p = c0 + tid;
    const bool active = p < H;
    bool kept = false;
    Kept me = {0, 0, 0, 0};
    int64_t sid = 0;
    size_t x = 0;
    if (active) {
      const int r = (int)perm[ro + p];
      x = ro + r;
      kept = r < n && flt[x] == 0 && shadow[x] == 0;
    }
    // a later pair reads only kept positions (prev and the carry are kept)
    if (kept) {
      sid = g2s[min(max(gid[x], 0), n_gene - 1)];
      me.w = (int64_t)((uint64_t)sid << 1 | (uint64_t)rev[x]);
      const int32_t so = score_ori[x];
      me.sc = so;
      if (use_ori == 0) {
        const int32_t sd = score_dom[x];
        if (so <= sd) {
          const int32_t dom = dom_gid[x];
          if (dom >= 0 && g2s[min(dom, n_gene - 1)] < 0) me.sc = sd;
        }
      }
      me.cm = cm[x];
      me.cid = cid[x];
      s_w[tid] = me.w;
      s_cm[tid] = me.cm;
      s_sc[tid] = me.sc;
      s_cid[tid] = me.cid;
      const int s = (int)min(max(sid, (int64_t)0), (int64_t)(n_gene - 1));
      atomicAdd(&counts[s], 1);
      const unsigned bit = 1u << (s & 31);
      if (!(atomicOr(&seen[s >> 5], bit) & bit))
        atomicAdd(&counts[n_gene + s], 1);
    }
    int top;
    const int prev = max(block_excl_max(kept ? p : -1, s_warp, &top), last);
    if (active) {
      bool ok = false;
      int64_t kf = kNoArc, kr = kNoArc;
      int32_t d = 0, a = 0, b = 0;
      if (kept && prev >= 0) {
        const Kept q = prev >= c0 ? Kept{s_w[prev - c0], s_cm[prev - c0],
                                         s_sc[prev - c0], s_cid[prev - c0]}
                                  : carry;
        if (q.cid == me.cid) {
          ok = true;
          const uint64_t v = (uint64_t)q.w, w = (uint64_t)me.w;
          kf = (int64_t)(((v << 32) | w) ^ kBias);
          kr = (int64_t)((((w ^ 1) << 32) | (v ^ 1)) ^ kBias);
          // truncated to int32 as the reference's pg_tmparc_t
          d = (int32_t)(uint32_t)(uint64_t)(me.cm - q.cm);
          a = q.sc;
          b = me.sc;
        }
      }
      const size_t ao = 2 * ro;
      akey[ao + p] = kf;
      akey[ao + H + p] = kr;
      pair_ok[ro + p] = ok;
      dist[ro + p] = d;
      s1[ro + p] = a;
      s2[ro + p] = b;
    }
    if (top >= c0) {
      const int k = top - c0;
      carry = Kept{s_w[k], s_cm[k], s_sc[k], s_cid[k]};
    }
    last = max(last, top);
    __syncthreads();   // the chunk's columns are read; the next overwrites
  }
}

// A group's partial fold in a chunk's slot.
struct Fold {
  int64_t dsum;
  int32_t cnt, m1, m2;
};

__global__ void __launch_bounds__(kThreads)
step_dedupe_kernel(const int64_t* __restrict__ xs,
                   const int64_t* __restrict__ aperm,
                   const uint8_t* __restrict__ pair_ok,
                   const int32_t* __restrict__ dist,
                   const int32_t* __restrict__ s1,
                   const int32_t* __restrict__ s2, int H,
                   int64_t* __restrict__ uniq_x, int32_t* __restrict__ cnt,
                   int64_t* __restrict__ dsum, int32_t* __restrict__ m1,
                   int32_t* __restrict__ m2) {
  // slot 0: the group open at the chunk's start; slot j: the j-th group
  // that starts in the chunk
  __shared__ unsigned long long s_dsum[kThreads + 1];
  __shared__ int64_t s_key[kThreads + 1];
  __shared__ int32_t s_cnt[kThreads + 1], s_m1[kThreads + 1],
      s_m2[kThreads + 1];
  __shared__ int s_warp[kWarps];
  const int g = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int A = 2 * H;
  const size_t ao = (size_t)g * A, ro = (size_t)g * H;
  // the open group's fold and key, held by thread 0
  Fold open = {0, 0, kScoreFloor, kScoreFloor};
  int64_t open_key = 0;
  int base = 0;   // groups started before the chunk
  for (int c0 = 0; c0 < A; c0 += kThreads) {
    s_dsum[tid + 1] = 0;
    s_cnt[tid + 1] = 0;
    s_m1[tid + 1] = INT32_MIN;
    s_m2[tid + 1] = INT32_MIN;
    if (tid == 0) {
      s_dsum[0] = (unsigned long long)open.dsum;
      s_cnt[0] = open.cnt;
      s_m1[0] = open.m1;
      s_m2[0] = open.m2;
      s_key[0] = open_key;
    }
    const int p = c0 + tid;
    const bool active = p < A;
    int64_t key = 0;
    bool head = false;
    Fold f = {0, 0, INT32_MIN, INT32_MIN};
    if (active) {
      key = xs[ao + p];
      head = p == 0 || key != xs[ao + p - 1];
      const int64_t a = aperm[ao + p];
      const bool second = a >= H;
      const size_t x = ro + (second ? a - H : a);
      f = Fold{0, 0, kScoreFloor, kScoreFloor};
      if (pair_ok[x] != 0) {   // only a pair's dist and scores are read
        const int32_t sa = s1[x], sb = s2[x];
        f.cnt = 1;
        f.dsum = dist[x];
        f.m1 = second ? sb : sa;
        f.m2 = second ? sa : sb;
      }
    }
    int nh;
    const int slot = block_incl_count(head, s_warp, &nh);   // has barriers
    if (head) s_key[slot] = key;
    // a segmented tree within the warp: after it, each lane holds the fold
    // of its run from itself to the run's end in the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int os = __shfl_down_sync(0xffffffffu, slot, o);
      const int32_t oc = __shfl_down_sync(0xffffffffu, f.cnt, o);
      const int64_t od = __shfl_down_sync(0xffffffffu, f.dsum, o);
      const int32_t o1 = __shfl_down_sync(0xffffffffu, f.m1, o);
      const int32_t o2 = __shfl_down_sync(0xffffffffu, f.m2, o);
      if (lane + o < 32 && os == slot) {
        f.cnt += oc;
        f.dsum += od;
        f.m1 = max(f.m1, o1);
        f.m2 = max(f.m2, o2);
      }
    }
    const int up = __shfl_up_sync(0xffffffffu, slot, 1);
    if (active && (lane == 0 || up != slot)) {
      atomicAdd(&s_cnt[slot], f.cnt);
      atomicAdd(&s_dsum[slot], (unsigned long long)f.dsum);
      atomicMax(&s_m1[slot], f.m1);
      atomicMax(&s_m2[slot], f.m2);
    }
    __syncthreads();
    // the groups closed by this chunk: slots [0, nh) (slot 0 only when a
    // group was open); slot nh stays open
    if (tid < nh && (tid > 0 || base > 0)) {
      const size_t k = ao + base - 1 + tid;
      const int32_t c = s_cnt[tid];
      uniq_x[k] = c > 0 ? (int64_t)((uint64_t)s_key[tid] ^ kBias) : 0;
      cnt[k] = c;
      dsum[k] = (int64_t)s_dsum[tid];
      m1[k] = s_m1[tid];
      m2[k] = s_m2[tid];
    }
    if (tid == 0) {
      open = Fold{(int64_t)s_dsum[nh], s_cnt[nh], s_m1[nh], s_m2[nh]};
      open_key = s_key[nh];
    }
    base += nh;
    __syncthreads();   // the slots are read; the next chunk resets them
  }
  // the last group, then the rows past it
  if (tid == 0 && base > 0) {
    const size_t k = ao + base - 1;
    uniq_x[k] = open.cnt > 0 ? (int64_t)((uint64_t)open_key ^ kBias) : 0;
    cnt[k] = open.cnt;
    dsum[k] = open.dsum;
    m1[k] = open.m1;
    m2[k] = open.m2;
  }
  for (int k = base + tid; k < A; k += kThreads) {
    uniq_x[ao + k] = 0;
    cnt[ao + k] = 0;
    dsum[ao + k] = 0;
    m1[ao + k] = 0;
    m2[ao + k] = 0;
  }
}

// Bytes of step_walk's seen bits for n_gene genes, one genome's.
size_t walk_seen(int n_gene) { return (size_t)((n_gene + 31) / 32) * 4; }

// Whether a genome's seen bits fit in a block's shared memory.
bool seen_in_smem(int n_gene) {
  return kWalkStatic + walk_seen(n_gene) <= kSmemMax;
}

}  // namespace

// The walk of G genomes of H rows on `stream`: [G, H] planes perm int64
// (the stable (cid, cm) order), flt, shadow, rev uint8, cid, gid,
// score_ori, score_dom, dom_gid int32, cm int64; n_rows int32 [G]; g2s
// int32 [n_gene] (n_gene >= 1). Writes akey int64 [G, 2H], pair_ok uint8,
// dist, s1, s2 int32 [G, H] and counts int32 [2, n_gene] (tot, n_genome;
// zeroed here first). seen: pg_step_walk_scratch(G, n_gene) bytes of
// device memory, or null when that is 0 (zeroed by the kernel). Returns
// cudaGetLastError(), or cudaErrorInvalidValue when n_gene < 1 or the
// scratch is missing.
extern "C" int pg_step_walk(const void* perm, const void* flt,
                            const void* shadow, const void* n_rows,
                            const void* cid, const void* gid,
                            const void* rev, const void* score_ori,
                            const void* score_dom, const void* dom_gid,
                            const void* cm, const void* g2s, int G, int H,
                            int n_gene, int use_ori, void* akey,
                            void* pair_ok, void* dist, void* s1, void* s2,
                            void* counts, void* seen, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_gene < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(counts, 0, (size_t)2 * n_gene * 4, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (G <= 0 || H <= 0) return 0;
  const bool in_smem = seen_in_smem(n_gene);
  if (!in_smem && seen == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = in_smem ? walk_seen(n_gene) : 0;
  if (kWalkStatic + smem > 48 * 1024) {
    e = cudaFuncSetAttribute(step_walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  step_walk_kernel<<<G, kThreads, smem, st>>>(
      static_cast<const int64_t*>(perm), static_cast<const uint8_t*>(flt),
      static_cast<const uint8_t*>(shadow),
      static_cast<const int32_t*>(n_rows), static_cast<const int32_t*>(cid),
      static_cast<const int32_t*>(gid), static_cast<const uint8_t*>(rev),
      static_cast<const int32_t*>(score_ori),
      static_cast<const int32_t*>(score_dom),
      static_cast<const int32_t*>(dom_gid), static_cast<const int64_t*>(cm),
      static_cast<const int32_t*>(g2s), n_gene, H, use_ori,
      static_cast<int64_t*>(akey), static_cast<uint8_t*>(pair_ok),
      static_cast<int32_t*>(dist), static_cast<int32_t*>(s1),
      static_cast<int32_t*>(s2), static_cast<int32_t*>(counts),
      in_smem ? nullptr : static_cast<unsigned*>(seen));
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the global scratch pg_step_walk needs for G genomes of n_gene
// genes: 0 while a genome's seen bits fit in shared memory (n_gene up to
// pg_step_walk_smem_genes()), else a genome's bits for each genome.
extern "C" long long pg_step_walk_scratch(int G, int n_gene) {
  if (n_gene < 1 || G < 1 || seen_in_smem(n_gene)) return 0;
  return (long long)G * (long long)walk_seen(n_gene);
}

// The most genes whose seen bits step_walk keeps in shared memory.
extern "C" int pg_step_walk_smem_genes() {
  return (int)((kSmemMax - kWalkStatic) / 4 * 32);
}

// The dedupe of G genomes of 2H sorted arc keys on `stream`: xs int64
// [G, 2H] (each row sorted), aperm int64 [G, 2H] (the sort's indices into
// the walk's [fwd | rev] planes), pair_ok uint8, dist, s1, s2 int32
// [G, H] (the walk's); writes uniq_x int64, cnt int32, dsum int64, m1, m2
// int32 [G, 2H]. Returns cudaGetLastError().
extern "C" int pg_step_dedupe(const void* xs, const void* aperm,
                              const void* pair_ok, const void* dist,
                              const void* s1, const void* s2, int G, int H,
                              void* uniq_x, void* cnt, void* dsum, void* m1,
                              void* m2, void* stream) {
  if (G <= 0 || H <= 0) return 0;
  step_dedupe_kernel<<<G, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(xs), static_cast<const int64_t*>(aperm),
      static_cast<const uint8_t*>(pair_ok),
      static_cast<const int32_t*>(dist), static_cast<const int32_t*>(s1),
      static_cast<const int32_t*>(s2), H, static_cast<int64_t*>(uniq_x),
      static_cast<int32_t*>(cnt), static_cast<int64_t*>(dsum),
      static_cast<int32_t*>(m1), static_cast<int32_t*>(m2));
  return static_cast<int>(cudaGetLastError());
}
