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
// step_walk: over each genome's rows in the stable (cid, cm) order `perm`.
// A position is kept when its row is unfiltered, not shadowed and below
// n_rows; its previous kept position is the running maximum of kept
// positions; a pair is the position and that previous one on the same
// contig. Only a kept row's columns are read (dom_gid only where
// score_ori <= score_dom decides nothing), and flt / shadow only below
// n_rows. Per position p it writes the biased keys of the pair's two arcs
// (forward at p, reverse at H + p: ((v << 32 | w) ^ 2^63, ((w ^ 1) << 32 |
// (v ^ 1)) ^ 2^63, w = sid << 1 | rev on all 64 bits, so a non-vertex
// gene's sid -1 sets the high bits as the reference's uint64 does; int64
// max where there is no pair), and the pair's flag, its int32-truncated
// cm distance and the two scores (zeros without a pair). The gene
// counters ride along: a kept row adds one to tot[clip(sid)] and, the
// first time its genome meets that segment, one to n_genome[clip(sid)].
//
// step_dedupe: over each genome's 2H sorted keys. A group is a run of
// equal keys; its index is the number of group starts before it. Each
// position's pair (aperm's row, and which arc) contributes (valid, dist,
// a1, a2). Per group: cnt, dsum (int64), m1 / m2 (the maxima of the valid
// members' scores, -2^31 + 1 for invalid members) and uniq_x (the key's
// raw bits when a member is valid, else 0), at the group's index; rows
// past the last group read 0, as the plain version's segment sums and
// maxima leave them.
//
// Design. Both kernels cut each genome into tiles of kTile positions, one
// block a tile, each thread kRows positions kThreads apart, so that every
// load of perm / xs and every store of a plane is a warp's 32 consecutive
// positions and all of a thread's loads are in flight at once. Blocks take
// tiles in order from an atomic ticket, never by blockIdx: a tile waits
// only on tiles of earlier tickets, which running blocks hold, so the grid
// cannot deadlock however few blocks are resident. The carry from the
// genome's earlier tiles comes from a decoupled look-back (Merrill and
// Garland 2016) over the tiles' status: one warp reads 32 predecessors at
// once, nearest first, down to the nearest inclusive one.
//  * step_walk's carry is a position: a tile publishes its last kept
//    position + 1 in a 64-bit status word (the state in its top two bits)
//    at once when it holds a kept row (a maximum: its own last row is the
//    inclusive value), else after its look-back. Within the tile the
//    previous kept position comes from a shuffle (in its 32-position
//    word) or from the words' summaries in shared memory; the tile's
//    first kept position alone reads the carry's row from global memory,
//    through perm. The counters: a warp's kept rows of one segment
//    (__match_any_sync) add once to tot and set the genome's bit in a
//    global [(G + 31) / 32, n_gene] plane (a warp's consecutive segments
//    at consecutive words), whose old value says whether to count the
//    genome in n_genome. The bits, the status words and the ticket follow
//    the counts in one buffer that the entry zeroes with one memset.
//  * step_dedupe is a single-pass reduce-by-key. A tile's aggregate is
//    (heads in the tile, fold of the run open at its end: cnt, dsum, m1,
//    m2; the whole tile's fold when it has no head), combined as
//    (h_a, f_a) + (h_b, f_b) = (h_a + h_b, h_b ? f_b : f_a + f_b). The
//    look-back gives a tile the groups that start before it (its index
//    base) and the fold of the group open before it; the tile closes that
//    group at base - 1 when it holds a head and writes the groups that
//    open and close in it directly (the genome's last tile also its last
//    group). A group spanning whole tiles passes through their aggregates
//    (the NO_ARC run at each genome's end does on every real input).
//    Within a tile: a segmented shuffle tree in each warp, then each run's
//    first lane in the warp adds its partial into the tile's group slot in
//    shared memory (only runs that cross a warp meet there). The aggregate
//    is 24 bytes and does not fit one status word, so a tile's state is a
//    32-bit flag with two payloads, CUB's wide tile state: the aggregate
//    and the inclusive value each have their own slot, written once; the
//    writer stores the payload, fences (__threadfence), then stores the
//    flag; a reader that sees the flag fences, then loads the payload the
//    flag names. A payload is never rewritten after its flag is set, so a
//    read cannot tear. The rows past a genome's last group are zeroed by
//    the blocks of the next genome's tickets: ticket j >= T also zeroes
//    chunk j - T (a genome's T chunks of kTile rows, the last genome's by T
//    blocks of their own) once the genome's last tile has published its
//    inclusive heads (an earlier ticket), so that tail is spread over T
//    blocks, not one block's serial loop. The scratch (flags, payloads,
//    ticket) is zeroed by the entry's one memset.
// Every scatter is unique (a group's row, a position's planes) or an
// integer atomic (the counters, the slots' sums and maxima; dsum adds only
// integers), so every output is deterministic whatever the order.
//
// What bounds them on the H100: bytes. The walk reads perm (8 bytes) at
// every position, flt and shadow below n_rows, 21 bytes of columns at a
// kept row (29 with dom_gid and score_dom when use_ori is off), and writes
// 29 bytes a position (the two keys 16, flag 1, dist and scores 12); the
// dedupe reads 16 bytes a key, pair_ok a row and 12 bytes at a pair's row,
// and writes 28 bytes a key. chip_smoke.py: step_bound_bytes counts them
// on the run's data. Each position is a chain of dependent gathers (walk:
// perm, the row, its columns; dedupe: aperm, the row, its pair), so the
// tiles are many and small enough to fill the card at a mesh shard's 16
// genomes; step_walk asks ptxas for 6 resident blocks a SM (kWalkBlocks).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // a tile's block
constexpr int kRows = 4;                  // positions a thread, kThreads apart
constexpr int kTile = kThreads * kRows;   // positions a tile
constexpr int kWarps = kThreads / 32;
constexpr int kWords = kRows * kWarps;    // 32-position words a tile
static_assert(kWords == 32, "a tile's words are one 32-bit mask");
// Resident blocks a SM asked of ptxas: on an H100, step_walk under 6 (40
// registers, a few spilled) ran 7-13% faster than with 64 registers and 4
// blocks; under 8 (32 registers) it ran slower, and so did step_dedupe
// under 6 (scripts/torch_step_compare.py --kernels, its variants).
constexpr int kWalkBlocks = 6;
constexpr int kDedupeBlocks = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kBias = 1ULL << 63;
constexpr int64_t kNoArc = 9223372036854775807LL;   // int64 max: no pair
constexpr int32_t kScoreFloor = -2147483647;        // -2^31 + 1
// step_walk's status word: the state in the top two bits (0: not published
// yet), the last kept position + 1 below (0: none). Aggregate: the tile's
// own; inclusive: over the genome's tiles up to this one.
constexpr unsigned long long kTileAgg = 1ull << 62;
constexpr unsigned long long kTilePre = 2ull << 62;
constexpr unsigned long long kTileValue = (1ull << 62) - 1;
// step_dedupe's flags
constexpr unsigned kFlagAgg = 1, kFlagPre = 2;

__device__ __forceinline__ int clampi(int64_t x, int64_t lo, int64_t hi) {
  return static_cast<int>(x < lo ? lo : (x > hi ? hi : x));
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

// ---------------------------------------------------------------------------
// step_walk
// ---------------------------------------------------------------------------

struct WalkArgs {
  const int64_t* perm;     // [G, H] the stable (cid, cm) order
  const uint8_t* flt;      // [G, H] rows
  const uint8_t* shadow;
  const int32_t* n_rows;   // [G]
  const int32_t* cid;
  const int32_t* gid;
  const uint8_t* rev;
  const int32_t* score_ori;
  const int32_t* score_dom;
  const int32_t* dom_gid;
  const int64_t* cm;
  const int32_t* g2s;      // [n_gene]
  int n_gene, H, T, use_ori;   // T: tiles a genome
  int64_t* akey;           // [G, 2H]
  uint8_t* pair_ok;        // [G, H] positions
  int32_t* dist;
  int32_t* s1;
  int32_t* s2;
  int32_t* tot;            // [n_gene]
  int32_t* n_genome;       // [n_gene]
  uint32_t* seen;          // [(G + 31) / 32, n_gene]: a segment's genome bits
  long long ntiles;        // G * T
  unsigned long long* tiles;   // [ntiles] status words, then the ticket
};

// The columns of a kept position that a later position's pair reads.
struct Kept {
  int64_t w, cm;
  int32_t sc, cid, seg;    // seg: the clipped segment the counters take
};

// A kept row's columns (row x of the [G, H] planes).
__device__ __forceinline__ Kept kept_row(const WalkArgs& p, long long x) {
  Kept k;
  const int64_t sid = p.g2s[clampi(p.gid[x], 0, p.n_gene - 1)];
  k.seg = clampi(sid, 0, p.n_gene - 1);
  k.w = static_cast<int64_t>(static_cast<uint64_t>(sid) << 1 |
                             static_cast<uint64_t>(p.rev[x]));
  const int32_t so = p.score_ori[x];
  k.sc = so;
  if (p.use_ori == 0) {
    const int32_t sd = p.score_dom[x];
    if (so <= sd) {
      const int32_t dom = p.dom_gid[x];
      if (dom >= 0 && p.g2s[min(dom, p.n_gene - 1)] < 0) k.sc = sd;
    }
  }
  k.cm = p.cm[x];
  k.cid = p.cid[x];
  return k;
}

__device__ __forceinline__ void tile_store(unsigned long long* t,
                                           unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(t) = v;
}
__device__ __forceinline__ unsigned long long tile_load(
    const unsigned long long* t) {
  return *reinterpret_cast<const volatile unsigned long long*>(t);
}

// The maximum of the values of the tiles t0 .. t - 1 (t0: the genome's
// first tile), by one warp: windows of 32 predecessors, nearest first,
// down to the nearest inclusive word.
__device__ unsigned long long look_back_max(const unsigned long long* tiles,
                                            long long t, long long t0,
                                            int lane) {
  unsigned long long acc = 0;
  for (long long b = t - 1; b >= t0; b -= 32) {
    const long long j = b - lane;
    unsigned long long s;
    do {
      s = j >= t0 ? tile_load(tiles + j) : kTilePre;
    } while (__any_sync(kFull, s == 0));
    const unsigned pre = __ballot_sync(kFull, (s & ~kTileValue) == kTilePre);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    unsigned long long v = lane <= stop ? (s & kTileValue) : 0;
    for (int o = 16; o; o >>= 1) {
      const unsigned long long x = __shfl_xor_sync(kFull, v, o);
      v = x > v ? x : v;
    }
    acc = v > acc ? v : acc;
    if (pre) break;
  }
  return acc;
}

// One tile of a genome's positions a block, the tile from the ticket: the
// kept positions by ballot, the tile's last kept position published and
// its carry looked back, then every position's planes and the counters.
__global__ void __launch_bounds__(kThreads, kWalkBlocks)
step_walk_kernel(WalkArgs p) {
  // each word's last kept position with its values
  __shared__ int s_last[kWords];
  __shared__ int32_t s_cid[kWords], s_sc[kWords];
  __shared__ int64_t s_w[kWords], s_cm[kWords];
  __shared__ long long s_tile;
  __shared__ int s_carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0)
    s_tile = static_cast<long long>(atomicAdd(p.tiles + p.ntiles, 1ull));
  __syncthreads();
  const long long tile = s_tile;
  const long long g = tile / p.T;
  const int k = static_cast<int>(tile - g * p.T);
  const int H = p.H;
  const int p0 = k * kTile;
  const long long ro = g * H;
  const int n = clampi(p.n_rows[g], 0, H);

  // the rows at the tile's positions, then whether each is kept, then a
  // kept row's columns: three rounds of loads, each all in flight
  int r[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = p0 + q * kThreads + threadIdx.x;
    r[q] = i < H ? static_cast<int>(p.perm[ro + i]) : n;
  }
  bool kept[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q)
    kept[q] = r[q] < n && p.flt[ro + r[q]] == 0 && p.shadow[ro + r[q]] == 0;
  Kept me[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    me[q] = Kept{0, 0, 0, 0, 0};
    if (kept[q]) me[q] = kept_row(p, ro + r[q]);
  }
  // each word's kept lanes; its summary in shared memory
  unsigned km[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const unsigned m = __ballot_sync(kFull, kept[q]);
    const int wd = q * kWarps + warp;
    km[q] = m;
    if (lane == 0)
      s_last[wd] = m ? p0 + q * kThreads + warp * 32 + 31 - __clz(m) : -1;
    if (m && lane == 31 - __clz(m)) {
      s_cid[wd] = me[q].cid;
      s_sc[wd] = me[q].sc;
      s_w[wd] = me[q].w;
      s_cm[wd] = me[q].cm;
    }
  }
  __syncthreads();
  if (warp == 0) {
    // the tile's last kept position; a tile with one publishes its
    // inclusive value at once
    const int lst = __reduce_max_sync(kFull, s_last[lane]);
    unsigned long long* st = p.tiles + tile;
    if (lane == 0)
      tile_store(st, (lst >= 0 || k == 0 ? kTilePre : kTileAgg)
                         | static_cast<unsigned long long>(lst + 1));
    const int carry =
        static_cast<int>(look_back_max(p.tiles, tile, g * p.T, lane)) - 1;
    if (lane == 0) {
      if (lst < 0 && k > 0)
        tile_store(st, kTilePre | static_cast<unsigned long long>(carry + 1));
      s_carry = carry;
    }
  }
  __syncthreads();
  const int carry = s_carry;
  // the tile's words that hold a kept position
  const unsigned has = __ballot_sync(kFull, s_last[lane] >= 0);
  const uint32_t bit = 1u << (g & 31);
  uint32_t* bits = p.seen + (g >> 5) * static_cast<long long>(p.n_gene);
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = p0 + q * kThreads + threadIdx.x;
    const int wd = q * kWarps + warp;
    const unsigned m = km[q];
    // the previous kept position: in the word (by shuffle), in the tile
    // (shared memory), else the carry (its row from global memory)
    const unsigned below = m & ((1u << lane) - 1u);
    const int pl = below ? 31 - __clz(below) : lane;
    Kept pv;
    pv.cid = __shfl_sync(kFull, me[q].cid, pl);
    pv.sc = __shfl_sync(kFull, me[q].sc, pl);
    pv.w = __shfl_sync(kFull, me[q].w, pl);
    pv.cm = __shfl_sync(kFull, me[q].cm, pl);
    int prev = i - lane + pl;
    const unsigned before = has & ((1u << wd) - 1u);
    if (kept[q] && !below) {
      if (before) {
        const int x = 31 - __clz(before);
        prev = s_last[x];
        pv.cid = s_cid[x];
        pv.sc = s_sc[x];
        pv.w = s_w[x];
        pv.cm = s_cm[x];
      } else {
        // the tile's first kept position
        prev = carry;
        if (carry >= 0) pv = kept_row(p, ro + p.perm[ro + carry]);
      }
    }
    const bool ok = kept[q] && prev >= 0 && pv.cid == me[q].cid;
    // a kept row of a segment: the warp's rows of that segment add once
    const unsigned peers =
        __match_any_sync(kFull, kept[q] ? me[q].seg : -1 - lane);
    if (i >= H) continue;
    int64_t kf = kNoArc, kr = kNoArc;
    int32_t d = 0, a = 0, b = 0;
    if (ok) {
      const uint64_t v = static_cast<uint64_t>(pv.w);
      const uint64_t w = static_cast<uint64_t>(me[q].w);
      kf = static_cast<int64_t>(((v << 32) | w) ^ kBias);
      kr = static_cast<int64_t>((((w ^ 1) << 32) | (v ^ 1)) ^ kBias);
      // truncated to int32 as the reference's pg_tmparc_t
      d = static_cast<int32_t>(static_cast<uint32_t>(
          static_cast<uint64_t>(me[q].cm - pv.cm)));
      a = pv.sc;
      b = me[q].sc;
    }
    const long long ao = 2 * ro;
    p.akey[ao + i] = kf;
    p.akey[ao + H + i] = kr;
    p.pair_ok[ro + i] = ok;
    p.dist[ro + i] = d;
    p.s1[ro + i] = a;
    p.s2[ro + i] = b;
    if (kept[q] && lane == __ffs(peers) - 1) {
      const int s = me[q].seg;
      atomicAdd(&p.tot[s], __popc(peers));
      if (!(atomicOr(bits + s, bit) & bit)) atomicAdd(&p.n_genome[s], 1);
    }
  }
}

// ---------------------------------------------------------------------------
// step_dedupe
// ---------------------------------------------------------------------------

// A group's fold: the valid members' count and dist sum, the maxima of
// the members' scores (kScoreFloor for an invalid member; INT32_MIN, the
// identity, for no member).
struct Fold {
  int64_t dsum;
  int32_t cnt, m1, m2;
};

// A tile's aggregate or inclusive value: heads, the fold of the run open
// at its end. 24 bytes.
struct Agg {
  long long dsum;
  int32_t heads, cnt, m1, m2;
};

__device__ __forceinline__ Fold fold_merge(const Fold& a, const Fold& b) {
  return Fold{a.dsum + b.dsum, a.cnt + b.cnt, max(a.m1, b.m1),
              max(a.m2, b.m2)};
}

// (a, then b): the heads add; the open run is b's, or a's and b's when b
// has no head.
__device__ __forceinline__ Agg agg_then(const Agg& a, const Agg& b) {
  if (b.heads > 0) return Agg{b.dsum, a.heads + b.heads, b.cnt, b.m1, b.m2};
  return Agg{a.dsum + b.dsum, a.heads, a.cnt + b.cnt, max(a.m1, b.m1),
             max(a.m2, b.m2)};
}

__device__ __forceinline__ Agg agg_none() {
  return Agg{0, 0, 0, INT32_MIN, INT32_MIN};
}

__device__ __forceinline__ Agg agg_shfl_down(const Agg& v, int o) {
  return Agg{__shfl_down_sync(kFull, v.dsum, o),
             __shfl_down_sync(kFull, v.heads, o),
             __shfl_down_sync(kFull, v.cnt, o),
             __shfl_down_sync(kFull, v.m1, o),
             __shfl_down_sync(kFull, v.m2, o)};
}

// The payload stores and loads go to L2 (cg), around the SM's L1, which
// another SM's stores do not invalidate.
__device__ __forceinline__ void agg_store(Agg* at, const Agg& v) {
  __stcg(&at->dsum, v.dsum);
  __stcg(&at->heads, v.heads);
  __stcg(&at->cnt, v.cnt);
  __stcg(&at->m1, v.m1);
  __stcg(&at->m2, v.m2);
}
__device__ __forceinline__ Agg agg_load(const Agg* at) {
  return Agg{__ldcg(&at->dsum), __ldcg(&at->heads), __ldcg(&at->cnt),
             __ldcg(&at->m1), __ldcg(&at->m2)};
}

struct DedupeArgs {
  const int64_t* xs;       // [G, 2H] each genome's sorted keys
  const int64_t* aperm;    // [G, 2H] into the walk's [fwd | rev] planes
  const uint8_t* pair_ok;  // [G, H]
  const int32_t* dist;
  const int32_t* s1;
  const int32_t* s2;
  int H, A, T;             // A = 2H; T: tiles a genome
  long long ntiles;        // G * T
  int64_t* uniq_x;         // [G, 2H]
  int32_t* cnt;
  int64_t* dsum;
  int32_t* m1;
  int32_t* m2;
  unsigned* flags;         // [ntiles]
  Agg* agg;                // [ntiles] each tile's own aggregate
  Agg* pre;                // [ntiles] its inclusive value
  unsigned long long* ticket;
};

__device__ __forceinline__ void publish(const DedupeArgs& p, long long t,
                                        const Agg& v, unsigned flag) {
  agg_store((flag == kFlagPre ? p.pre : p.agg) + t, v);
  __threadfence();
  *reinterpret_cast<volatile unsigned*>(p.flags + t) = flag;
}

// The combined value of the tiles t0 .. t - 1 (t0: the genome's first
// tile), in order, by one warp: windows of 32 predecessors, nearest in lane
// 0, down to the nearest inclusive value.
__device__ Agg look_back_agg(const DedupeArgs& p, long long t, long long t0,
                             int lane) {
  Agg acc = agg_none();
  for (long long b = t - 1; b >= t0; b -= 32) {
    const long long j = b - lane;
    unsigned s;
    do {
      s = j >= t0 ? *reinterpret_cast<const volatile unsigned*>(p.flags + j)
                  : kFlagPre;
    } while (__any_sync(kFull, s == 0));
    __threadfence();   // the payload after the flag that names it
    Agg v = agg_none();
    if (j >= t0) v = agg_load((s == kFlagPre ? p.pre : p.agg) + j);
    const unsigned inc = __ballot_sync(kFull, s == kFlagPre);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    if (lane > stop) v = agg_none();
    // lane l + o holds earlier tiles than lane l
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Agg x = agg_shfl_down(v, o);
      if (lane + o < 32) v = agg_then(x, v);
    }
    Agg w;
    w.dsum = __shfl_sync(kFull, v.dsum, 0);
    w.heads = __shfl_sync(kFull, v.heads, 0);
    w.cnt = __shfl_sync(kFull, v.cnt, 0);
    w.m1 = __shfl_sync(kFull, v.m1, 0);
    w.m2 = __shfl_sync(kFull, v.m2, 0);
    acc = agg_then(w, acc);
    if (inc) break;
  }
  return acc;
}

// One tile of a genome's sorted keys a block, the tile from the ticket:
// heads and folds, the group slots, the aggregate published and the
// carry looked back, the groups the tile closes written. Then, from the
// second genome's tickets on, the previous genome's rows past its last
// group in one chunk.
__global__ void __launch_bounds__(kThreads, kDedupeBlocks)
step_dedupe_kernel(DedupeArgs p) {
  // slot 0: the group open at the tile's start; slot j: the j-th group
  // that starts in the tile
  __shared__ unsigned long long s_dsum[kTile + 1];
  __shared__ int64_t s_key[kTile + 1];
  __shared__ int32_t s_cnt[kTile + 1], s_m1[kTile + 1], s_m2[kTile + 1];
  __shared__ int s_words[kWords];     // heads in each word, then before it
  __shared__ long long s_tile;
  __shared__ int s_nh;
  __shared__ Agg s_carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<long long>(atomicAdd(p.ticket, 1ull));
  __syncthreads();
  const long long ticket = s_tile;
  const int A = p.A, H = p.H;
  if (ticket < p.ntiles) {
    const long long g = ticket / p.T;
    const int k = static_cast<int>(ticket - g * p.T);
    const int p0 = k * kTile;
    const long long ao = g * A, ro = g * H;
    int64_t key[kRows];
    bool head[kRows];
    Fold f[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = p0 + q * kThreads + tid;
      key[q] = i < A ? p.xs[ao + i] : 0;
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = p0 + q * kThreads + tid;
      int64_t up = __shfl_up_sync(kFull, key[q], 1);
      if (lane == 0 && i > 0 && i < A) up = p.xs[ao + i - 1];
      head[q] = i < A && (i == 0 || key[q] != up);
    }
    int64_t ap[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = p0 + q * kThreads + tid;
      ap[q] = i < A ? p.aperm[ao + i] : 0;
    }
    bool ok[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = p0 + q * kThreads + tid;
      const long long x = ro + (ap[q] >= H ? ap[q] - H : ap[q]);
      ok[q] = i < A && p.pair_ok[x] != 0;
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = p0 + q * kThreads + tid;
      f[q] = i < A ? Fold{0, 0, kScoreFloor, kScoreFloor}
                   : Fold{0, 0, INT32_MIN, INT32_MIN};
      if (ok[q]) {   // only a pair's dist and scores are read
        const bool second = ap[q] >= H;
        const long long x = ro + (second ? ap[q] - H : ap[q]);
        const int32_t sa = p.s1[x], sb = p.s2[x];
        f[q] = Fold{p.dist[x], 1, second ? sb : sa, second ? sa : sb};
      }
    }
    unsigned hm[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      hm[q] = __ballot_sync(kFull, head[q]);
      if (lane == 0) s_words[q * kWarps + warp] = __popc(hm[q]);
    }
    for (int j = tid; j <= kTile; j += kThreads) {
      s_dsum[j] = 0;
      s_cnt[j] = 0;
      s_m1[j] = INT32_MIN;
      s_m2[j] = INT32_MIN;
    }
    __syncthreads();
    if (warp == 0) {
      // heads before each word, and in the tile
      const int c = s_words[lane];
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      s_words[lane] = incl - c;
      if (lane == 31) s_nh = incl;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = p0 + q * kThreads + tid;
      const unsigned m = hm[q];
      const int slot =
          s_words[q * kWarps + warp] + __popc(m & ((2u << lane) - 1u));
      if (head[q]) s_key[slot] = key[q];
      // a segmented tree within the warp: after it, each lane holds the
      // fold of its run from itself to the run's end in the warp
      Fold v = f[q];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int os = __shfl_down_sync(kFull, slot, o);
        const int32_t oc = __shfl_down_sync(kFull, v.cnt, o);
        const int64_t od = __shfl_down_sync(kFull, v.dsum, o);
        const int32_t o1 = __shfl_down_sync(kFull, v.m1, o);
        const int32_t o2 = __shfl_down_sync(kFull, v.m2, o);
        if (lane + o < 32 && os == slot) {
          v.cnt += oc;
          v.dsum += od;
          v.m1 = max(v.m1, o1);
          v.m2 = max(v.m2, o2);
        }
      }
      const int upslot = __shfl_up_sync(kFull, slot, 1);
      if (i < A && (lane == 0 || upslot != slot)) {
        atomicAdd(&s_cnt[slot], v.cnt);
        atomicAdd(&s_dsum[slot], static_cast<unsigned long long>(v.dsum));
        atomicMax(&s_m1[slot], v.m1);
        atomicMax(&s_m2[slot], v.m2);
      }
    }
    __syncthreads();
    const int nh = s_nh;
    if (warp == 0) {
      // the aggregate: the heads and the run open at the tile's end (slot
      // nh: the tile's last group, or slot 0, the whole tile)
      const Agg own = Agg{static_cast<int64_t>(s_dsum[nh]), nh, s_cnt[nh],
                          s_m1[nh], s_m2[nh]};
      Agg carry = agg_none();
      if (k == 0) {
        if (lane == 0) publish(p, ticket, own, kFlagPre);
      } else {
        if (lane == 0) publish(p, ticket, own, kFlagAgg);
        carry = look_back_agg(p, ticket, g * p.T, lane);
        if (lane == 0) publish(p, ticket, agg_then(carry, own), kFlagPre);
      }
      if (lane == 0) s_carry = carry;
    }
    __syncthreads();
    // the groups the tile closes: slot j at row base + j - 1; slot 0 (the
    // group carried in) when the tile has a head, slot nh (still open) in
    // the genome's last tile
    const Agg carry = s_carry;
    const bool last = k == p.T - 1;
    for (int j = tid; j <= nh; j += kThreads) {
      if (j == nh ? !last : (j == 0 && k == 0)) continue;
      Fold v = Fold{static_cast<int64_t>(s_dsum[j]), s_cnt[j], s_m1[j],
                    s_m2[j]};
      int64_t kx;
      if (j == 0) {
        v = fold_merge(Fold{carry.dsum, carry.cnt, carry.m1, carry.m2}, v);
        kx = p.xs[ao + p0 - 1];
      } else {
        kx = s_key[j];
      }
      const long long at = ao + carry.heads + j - 1;
      p.uniq_x[at] =
          v.cnt > 0 ? static_cast<int64_t>(static_cast<uint64_t>(kx) ^ kBias)
                    : 0;
      p.cnt[at] = v.cnt;
      p.dsum[at] = v.dsum;
      p.m1[at] = v.m1;
      p.m2[at] = v.m2;
    }
  }
  // the rows past a genome's last group: ticket j >= T zeroes chunk j - T
  // once that genome's last tile (an earlier ticket) is inclusive
  const long long c = ticket - p.T;
  if (c < 0) return;
  const long long gz = c / p.T;
  const int z = static_cast<int>(c - gz * p.T);
  if (tid == 0) {
    const long long t = gz * p.T + p.T - 1;
    while (*reinterpret_cast<const volatile unsigned*>(p.flags + t) !=
           kFlagPre) {
    }
    __threadfence();
    s_nh = __ldcg(&p.pre[t].heads);
  }
  __syncthreads();
  const int n_groups = s_nh;
  const long long ao = gz * A;
  const int hi = min((z + 1) * kTile, A);
  for (int i = max(z * kTile, n_groups) + tid; i < hi; i += kThreads) {
    p.uniq_x[ao + i] = 0;
    p.cnt[ao + i] = 0;
    p.dsum[ao + i] = 0;
    p.m1[ao + i] = 0;
    p.m2[ao + i] = 0;
  }
}

// Bytes of step_walk's scratch: the genome bits ([(G + 31) / 32, n_gene]
// uint32), then at the next 8 bytes the tiles' status words and the ticket.
long long walk_scratch(long long G, int H, int n_gene) {
  const long long bits = (4LL * n_gene * ((G + 31) / 32) + 7) / 8 * 8;
  return bits + 8 * (G * tiles_of(H) + 1);
}

// Bytes of step_dedupe's scratch: the tiles' aggregates and inclusive
// values (24 bytes each), their flags, then at the next 8 bytes the ticket.
long long dedupe_scratch(long long G, int H) {
  const long long nt = G * tiles_of(2LL * H);
  return 48 * nt + (4 * nt + 7) / 8 * 8 + 8;
}

}  // namespace

// The launch shape of both kernels for G genomes of H rows and n_gene
// genes, into info[6]: threads a block, positions a tile
// (ops/step_kernels.TILE), step_walk's blocks, step_dedupe's blocks, and
// the bytes of their scratch (step_walk's after the counts).
extern "C" void pg_step_shape(int G, int H, int n_gene, long long* info) {
  const long long g = G < 1 ? 0 : G, h = H < 1 ? 0 : H;
  info[0] = kThreads;
  info[1] = kTile;
  info[2] = g * tiles_of(h);
  info[3] = g > 0 && h > 0 ? (g + 1) * tiles_of(2 * h) : 0;
  info[4] = g > 0 && h > 0 && n_gene > 0 ? walk_scratch(g, H, n_gene) : 0;
  info[5] = g > 0 && h > 0 ? dedupe_scratch(g, H) : 0;
}

// Bytes of the scratch pg_step_walk needs after the counts for G genomes
// of H rows and n_gene genes.
extern "C" long long pg_step_walk_scratch(int G, int H, int n_gene) {
  if (G < 1 || H < 1 || n_gene < 1) return 0;
  return walk_scratch(G, H, n_gene);
}

// The walk of G genomes of H rows on `stream`: [G, H] planes perm int64
// (the stable (cid, cm) order), flt, shadow, rev uint8, cid, gid,
// score_ori, score_dom, dom_gid int32, cm int64; n_rows int32 [G]; g2s
// int32 [n_gene] (n_gene >= 1). Writes akey int64 [G, 2H], pair_ok uint8,
// dist, s1, s2 int32 [G, H] and counts int32 [2, n_gene] (tot, n_genome).
// scratch: pg_step_walk_scratch(G, H, n_gene) bytes of device memory that
// follow the counts at once (counts + 8 n_gene bytes); one memset zeroes
// the counts and the scratch, then one block a tile of a genome's
// positions. Returns cudaGetLastError(), or cudaErrorInvalidValue when
// n_gene < 1 or the scratch does not follow the counts.
extern "C" int pg_step_walk(const void* perm, const void* flt,
                            const void* shadow, const void* n_rows,
                            const void* cid, const void* gid,
                            const void* rev, const void* score_ori,
                            const void* score_dom, const void* dom_gid,
                            const void* cm, const void* g2s, int G, int H,
                            int n_gene, int use_ori, void* akey,
                            void* pair_ok, void* dist, void* s1, void* s2,
                            void* counts, void* scratch, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_gene < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = pg_step_walk_scratch(G, H, n_gene);
  if (nb > 0 && scratch != static_cast<char*>(counts) + 8LL * n_gene)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      cudaMemsetAsync(counts, 0, 8LL * n_gene + nb, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (G <= 0 || H <= 0) return 0;
  WalkArgs p;
  p.perm = static_cast<const int64_t*>(perm);
  p.flt = static_cast<const uint8_t*>(flt);
  p.shadow = static_cast<const uint8_t*>(shadow);
  p.n_rows = static_cast<const int32_t*>(n_rows);
  p.cid = static_cast<const int32_t*>(cid);
  p.gid = static_cast<const int32_t*>(gid);
  p.rev = static_cast<const uint8_t*>(rev);
  p.score_ori = static_cast<const int32_t*>(score_ori);
  p.score_dom = static_cast<const int32_t*>(score_dom);
  p.dom_gid = static_cast<const int32_t*>(dom_gid);
  p.cm = static_cast<const int64_t*>(cm);
  p.g2s = static_cast<const int32_t*>(g2s);
  p.n_gene = n_gene;
  p.H = H;
  p.T = static_cast<int>(tiles_of(H));
  p.use_ori = use_ori;
  p.akey = static_cast<int64_t*>(akey);
  p.pair_ok = static_cast<uint8_t*>(pair_ok);
  p.dist = static_cast<int32_t*>(dist);
  p.s1 = static_cast<int32_t*>(s1);
  p.s2 = static_cast<int32_t*>(s2);
  p.tot = static_cast<int32_t*>(counts);
  p.n_genome = p.tot + n_gene;
  p.seen = static_cast<uint32_t*>(scratch);
  p.ntiles = static_cast<long long>(G) * p.T;
  p.tiles = reinterpret_cast<unsigned long long*>(
                static_cast<char*>(scratch) + nb) - (p.ntiles + 1);
  step_walk_kernel<<<p.ntiles, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the scratch pg_step_dedupe needs for G genomes of H rows.
extern "C" long long pg_step_dedupe_scratch(int G, int H) {
  if (G < 1 || H < 1) return 0;
  return dedupe_scratch(G, H);
}

// The dedupe of G genomes of 2H sorted arc keys on `stream`: xs int64
// [G, 2H] (each row sorted), aperm int64 [G, 2H] (the sort's indices into
// the walk's [fwd | rev] planes), pair_ok uint8, dist, s1, s2 int32
// [G, H] (the walk's); writes uniq_x int64, cnt int32, dsum int64, m1, m2
// int32 [G, 2H]. scratch: pg_step_dedupe_scratch(G, H) bytes of device
// memory; one memset zeroes it, then one block a tile of a genome's keys
// and T blocks more for the last genome's rows past its groups. Returns
// cudaGetLastError(), or cudaErrorInvalidValue when 2H does not fit an
// int32 or the scratch is missing.
extern "C" int pg_step_dedupe(const void* xs, const void* aperm,
                              const void* pair_ok, const void* dist,
                              const void* s1, const void* s2, int G, int H,
                              void* uniq_x, void* cnt, void* dsum, void* m1,
                              void* m2, void* scratch, void* stream) {
  if (G <= 0 || H <= 0) return 0;
  if (H > (1 << 30) - kTile || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nb = dedupe_scratch(G, H);
  const cudaError_t e = cudaMemsetAsync(scratch, 0, nb, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  DedupeArgs p;
  p.xs = static_cast<const int64_t*>(xs);
  p.aperm = static_cast<const int64_t*>(aperm);
  p.pair_ok = static_cast<const uint8_t*>(pair_ok);
  p.dist = static_cast<const int32_t*>(dist);
  p.s1 = static_cast<const int32_t*>(s1);
  p.s2 = static_cast<const int32_t*>(s2);
  p.H = H;
  p.A = 2 * H;
  p.T = static_cast<int>(tiles_of(p.A));
  p.ntiles = static_cast<long long>(G) * p.T;
  p.uniq_x = static_cast<int64_t*>(uniq_x);
  p.cnt = static_cast<int32_t*>(cnt);
  p.dsum = static_cast<int64_t*>(dsum);
  p.m1 = static_cast<int32_t*>(m1);
  p.m2 = static_cast<int32_t*>(m2);
  p.agg = static_cast<Agg*>(scratch);
  p.pre = p.agg + p.ntiles;
  p.flags = reinterpret_cast<unsigned*>(p.pre + p.ntiles);
  p.ticket = reinterpret_cast<unsigned long long*>(
                 static_cast<char*>(scratch) + nb) - 1;
  step_dedupe_kernel<<<p.ntiles + p.T, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
