// The genome mesh's last XLA forms (world > 1) for Hopper (sm_90a): the
// protein-keyed reductions of post_process and the bucket exchange around
// the in-loop merge's fold. Bound to Python with ctypes
// (ops/mesh_kernels.py), which also holds the plain PyTorch versions these
// kernels are tested against.
//
// What they replace (no TPU kernel computes them; the JAX package runs them
// as XLA forms inside shard_map):
//  * protein_reduce: pangene_tpu/parallel/stacked.py:428 reduction_step,
//    its per-shard body before the pmax / psum. Per protein: the largest
//    score_ori over the valid rows (0 when none is larger), and over the
//    rank-0 unfiltered valid rows the single- and multi-exon counts and
//    score_ori sums, the score_adj sum and the row count. The pid is
//    clamped to [0, n_prot). The input is [G, H] planes plus n_rows [G]:
//    the padded stack of the JAX package, or one genome row of every
//    genome's rows end to end (G = 1), which the port's
//    post_reductions_sharded uploads.
//  * exchange_pack: pangene_tpu/parallel/device_loop.py:325-348. Over this
//    rank's locally sorted lean keys (KSENT at the end), each destination
//    t's run (dest = clip((key >> shift) * nd // 2S, 0, nd - 1), monotone
//    in the key) is cut at C and written into the [nd, 2, C] send plane:
//    the key, and the s1 of its origin row (the key's low jb bits less
//    this rank's base), KSENT / 0 past the run; the overflow flag is set
//    when a run is longer than C. It also zeroes the pair plane that
//    exchange_finish scatters into, and returns the runs' bounds [nd + 1]
//    (JAX's start, then the count of valid keys).
//  * exchange_window: device_loop.py:377-401. From the all_gather of every
//    rank's (n_out, overflow): this rank's offset (the earlier ranks'
//    out-group counts), n_out (A + 1 on any overflow), and the rank's [2, A]
//    table plane: its fold's rows masked by n_out_l at the window start
//    clamp(off, 0, A) (as dynamic_update_slice clamps it), 0 elsewhere; and
//    the reply, each received slot's global arc row (0 at a sentinel).
//  * exchange_finish: device_loop.py:393-405. The summed table masked by
//    live rows (SENT / 0 past n_out, s1 to int32), and each returned arc
//    row scattered to the pair slot of the key this rank sent there (its
//    origin row, recomputed from the key; only the slots pack's bounds say
//    were sent: c < min(bound[t + 1] - bound[t], C)).
//
// Bounds and design. All four move little data (big at world 4: a few MB)
// and are bound by bytes; none reads a value on the host, so the ranks
// cannot disagree on one.
//  * protein_reduce: bound not by its bytes but by its scattered L2
//    requests: a genome meets each protein about once, so a warp's 32 rows
//    hold ~32 pids (a gene's isoforms side by side at best) and there is
//    nothing to fold before the atomics. Every 64-bit add is two's
//    complement, so every order gives the same bits. One memset and one
//    launch, a thread a row (more rows a thread, persistent blocks taking
//    tiles by ticket, or a protein table in a cluster's shared memory were
//    slower: the many warps of a thread a row hide each row's chain of
//    loads best), the grid's rows striding over the genomes, so any number
//    of them; flt read only at a rank-0 row, n_exon and score_adj only at a
//    rank-0 unfiltered one. Every row with score_ori > 0 takes its
//    atomicMax: a strong read of the running maximum from L2 first costs
//    about what the atomic it would save does. rep_cnt keeps its atomic:
//    deriving it as cnt0 + cnt1 after the rows (a second launch, or the
//    blocks counted last) cost more than the atomics it saves at a rank's
//    share.
//  * exchange_pack: no count pass, no scan and no search (a binary search of
//    the run bounds in every block is a chain of dependent scattered probes
//    before any store): destinations are monotone in the sorted keys and the
//    sentinels come last, so bound[t] (t = 1 .. nd) is the position where D,
//    the destination (nd at a sentinel), steps past t - 1; D comes from nd - 1
//    thresholds on v = key >> shift (no 64-bit division a key). One launch, no
//    memset, a persistent grid (the resident blocks) taking tiles by ticket:
//    the key tiles (1,024 positions, the first tickets) read their keys
//    coalesced, publish the bounds that fall in them (each on a 128-byte line
//    of its own) and write them to the bounds plane, zero the pair plane,
//    gather each valid key's s1, then wait only for the bounds of their own
//    keys' destinations (published by this tile or an earlier ticket) and
//    store each key at slot p - bound[t]; the fill tiles (2,048 slots) wait
//    for the bounds of their destinations and store KSENT / 0 past each run.
//    The tile that publishes bound[nd] sets the overflow flag. The block that
//    takes the launch's last ticket zeroes the scratch (every other block took
//    its last ticket after its last tile), so CUDA-graph replays stay right.
//    The bytes it must move are the keys sent and their s1 (12 bytes a key),
//    the [nd, 2, C] plane, the pair plane and the bounds; at big's world-4
//    shape the launch and the tickets alone take a third of its time.
//  * exchange_finish: a persistent grid over table tiles of 1,024 rows (a live
//    row's two words read, 12 bytes written), then tiles over the sent slots
//    only, numbered t-major from pack's bounds: each reads its key and reply
//    (12 bytes) and raises one 4-byte row of the zeroed pair plane to the
//    reply by atomicMax (a reduction done in L2: the row's store, since each
//    row takes one key and a reply is an arc row >= 0, and the same again on a
//    replay; a random 4-byte store takes twice as long on an H100).
//  * exchange_window: elementwise over the A table rows and the RL
//    received slots, grid-stride; the per-rank sums are made once a block
//    in shared memory.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// blocks a SM the grid-stride kernel asks for at most (132 SMs)
constexpr int kMaxBlocks = 132 * 8;
constexpr int64_t kKSent = int64_t(1) << 62;       // an invalid row's key
constexpr int64_t kSent = (int64_t(1) << 62) - 1;  // an empty table slot

int grid_of(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

// ---------------------------------------------------------------------------
// protein_reduce
// ---------------------------------------------------------------------------

struct ReduceArgs {
  const int32_t* pid;
  const int32_t* score_ori;
  const int32_t* score_adj;
  const int32_t* n_exon;
  const int32_t* rank;
  const uint8_t* flt;
  const int32_t* n_rows;
  int G, H, n_prot;
  int32_t* max_so;                // [n_prot]
  unsigned long long* sums;       // [6, n_prot]: cnt0 cnt1 sum0 sum1 rep_sum rep_cnt
};

// A thread a row, the grid's rows striding over the genomes, its columns
// over a genome's rows. pid and score_ori are read at every valid row,
// rank there too, flt at a rank-0 row, n_exon and score_adj at a rank-0
// unfiltered row. atomicMax at every row with score_ori > 0; then a rank-0
// unfiltered row's four atomicAdds: its count and score_ori sum by its
// exon class, its score_adj sum, the row count.
__global__ void __launch_bounds__(kThreads)
protein_reduce_kernel(ReduceArgs a) {
  const int P = a.n_prot;
  for (int g = blockIdx.y; g < a.G; g += gridDim.y) {
    int n = a.n_rows[g];
    n = n < 0 ? 0 : (n > a.H ? a.H : n);
    const long long base = static_cast<long long>(g) * a.H;
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
}

// ---------------------------------------------------------------------------
// the bucket exchange
// ---------------------------------------------------------------------------

// floor(x / d) for d > 0, as XLA's and torch's integer // of int64
__device__ __forceinline__ long long floor_div(long long x, long long d) {
  const long long q = x / d;
  return (x % d != 0 && x < 0) ? q - 1 : q;
}

__device__ __forceinline__ int dest_of(int64_t key, int shift, int nd,
                                       long long two_s) {
  const long long t = floor_div((key >> shift) * nd, two_s);
  return static_cast<int>(t < 0 ? 0 : (t > nd - 1 ? nd - 1 : t));
}

// exchange_pack's and exchange_finish's tiles: kThreads threads, kExRows
// positions (keys, slots or table rows) a thread, kThreads apart, so that
// each warp's loads and stores are coalesced.
constexpr int kExRows = 4;
constexpr int kExTile = kThreads * kExRows;  // 1,024
// a fill tile of exchange_pack: kFillRows slots a thread (stores only)
constexpr int kFillRows = 8;
constexpr int kFillTile = kThreads * kFillRows;  // 2,048
// the blocks a SM each kernel asks ptxas for; both grids are persistent,
// the blocks that fit on the card at once (at most kPackBlocksPerSm or
// kFinishBlocksPerSm a SM), each block looping over tiles
constexpr int kPackBlocksPerSm = 4;
constexpr int kFinishBlocksPerSm = 8;
// exchange_pack's scratch, in 32-bit words: the ticket (word 0) on the
// first 128-byte line, then bound[t] + 1 (0: not published yet) at the
// first word of line t, t = 1 .. nd, so that a block waiting for one bound
// polls a line of its own and no poll meets the tickets. Zero before a
// launch; the block that takes the launch's last ticket zeroes it.
constexpr int kScLine = 32;

__device__ __forceinline__ void publish_bound(unsigned* sc, int t,
                                              long long p) {
  *reinterpret_cast<volatile unsigned*>(sc + kScLine * t) =
      static_cast<unsigned>(p) + 1u;
}

// bound[t], once a block with an earlier ticket (or this one, before a
// __syncthreads) has published it; the polls back off to 256 ns.
__device__ __forceinline__ int acquire_bound(const unsigned* sc, int t) {
  if (t == 0) return 0;
  const volatile unsigned* w = sc + kScLine * t;
  unsigned v = *w;
  for (unsigned ns = 32; v == 0; ns = ns < 256 ? 2 * ns : ns) {
    __nanosleep(ns);
    v = *w;
  }
  return static_cast<int>(v - 1u);
}

struct PackArgs {
  const int64_t* keys;      // [NL] sorted
  const int32_t* s1;        // [NL] by local row
  int NL, nd, C, jb, shift;
  long long two_s, base;
  long long v_max;          // the largest v whose v * nd is no overflow
  long long n_key;          // key tiles (tickets 0 .. n_key - 1)
  long long n_fill;         // fill tiles (the next tickets)
  int64_t* send;            // [nd, 2, C]
  int64_t* ovf;             // scalar
  int32_t* pair;            // [NL + 1], zeroed here
  int32_t* bounds;          // [nd + 1]
  unsigned* sc;             // the scratch
};

// D: the destination of a key, nd at a sentinel. th[t] (t = 1 .. nd - 1,
// in shared memory) is the least v = key >> shift with floor(v nd / two_s)
// >= t, so dest counts the th[t] <= v: no 64-bit division a key.
__device__ __forceinline__ int dest_at(const PackArgs& a,
                                       const long long* th, int64_t key) {
  if (key >= kKSent) return a.nd;
  const long long v = key >> a.shift;
  if (v > a.v_max || v < -a.v_max)
    return dest_of(key, a.shift, a.nd, a.two_s);
  int lo = 0, hi = a.nd - 1;  // dest in [lo, hi]
  while (lo < hi) {
    const int m = (lo + hi + 1) >> 1;
    if (v >= th[m])
      lo = m;
    else
      hi = m - 1;
  }
  return lo;
}

// The block's shared words of a tile.
struct PackTile {
  unsigned k;       // the ticket
  unsigned lo, hi;  // a key tile's destinations
  int end;          // the key tile publishes bound[nd]
};

// A key tile: positions [p0, p0 + kExTile). bound[t] (t = 1 .. nd) is the
// position p with D(p - 1) < t <= D(p) (D(-1) = 0), or NL when D(NL - 1) <
// t: the tile holding p publishes it (and writes it to the bounds plane),
// before it waits for the bounds of its own keys' destinations (each at or
// before its keys, so published by this tile or an earlier ticket). Each
// valid key's s1 is gathered before the wait; then the key goes to slot
// p - bound[t] of its destination t (dropped past C). The tile that
// publishes bound[nd] sets the overflow flag from every bound.
__device__ void pack_keys(const PackArgs& a, long long p0,
                          const long long* th, int* sb, PackTile& sh) {
  const int lane = threadIdx.x & 31;
  const int64_t mask = (int64_t(1) << a.jb) - 1;
  int64_t key[kExRows];
  int d[kExRows];
  int32_t v1[kExRows];
#pragma unroll
  for (int r = 0; r < kExRows; ++r) {
    const long long p = p0 + r * kThreads + threadIdx.x;
    key[r] = p < a.NL ? __ldg(a.keys + p) : kKSent;
  }
  // the key before each warp's first position
  const long long pw = p0 + (threadIdx.x & ~31);
  int64_t kw[kExRows];
#pragma unroll
  for (int r = 0; r < kExRows; ++r) {
    const long long p = pw + r * kThreads;
    kw[r] = lane == 0 && p > 0 && p <= a.NL ? __ldg(a.keys + p - 1) : 0;
  }
  if (p0 == 0 && threadIdx.x == 0) a.bounds[0] = 0;
  unsigned lo = a.nd, hi = 0;
#pragma unroll
  for (int r = 0; r < kExRows; ++r) {
    const long long p = p0 + r * kThreads + threadIdx.x;
    d[r] = dest_at(a, th, key[r]);
    // D(p - 1): the lane before's, or for a warp's first lane its load
    int dp = __shfl_up_sync(0xffffffffu, d[r], 1);
    if (lane == 0) dp = p == 0 ? 0 : dest_at(a, th, kw[r]);
    v1[r] = 0;
    if (p >= a.NL) continue;
    // the bounds at p, and at NL after the last position
    const int t_end = p == a.NL - 1 ? a.nd : d[r];
    for (int t = dp + 1; t <= t_end; ++t) {
      const long long at = t <= d[r] ? p : a.NL;
      publish_bound(a.sc, t, at);
      a.bounds[t] = static_cast<int32_t>(at);
    }
    if (dp < a.nd && t_end == a.nd) sh.end = 1;
    a.pair[p] = 0;
    if (p == a.NL - 1) a.pair[a.NL] = 0;
    if (d[r] < a.nd) {
      long long row = (key[r] & mask) - a.base;
      row = row < 0 ? 0 : (row > a.NL - 1 ? a.NL - 1 : row);
      v1[r] = __ldg(a.s1 + row);
      lo = min(lo, static_cast<unsigned>(d[r]));
      hi = max(hi, static_cast<unsigned>(d[r]));
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    atomicMin(&sh.lo, lo);
    atomicMax(&sh.hi, hi);
  }
  __syncthreads();
  if (sh.end && threadIdx.x == 0) {
    // every bound is at or before bound[nd]: published by this tile or an
    // earlier ticket
    int64_t over = 0;
    int prev = 0;
    for (int t = 1; t <= a.nd; ++t) {
      const int b = acquire_bound(a.sc, t);
      over |= b - prev > a.C;
      prev = b;
    }
    *a.ovf = over;
  }
  for (int t = static_cast<int>(sh.lo) + threadIdx.x;
       t <= static_cast<int>(sh.hi); t += kThreads)
    sb[t] = acquire_bound(a.sc, t);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kExRows; ++r) {
    const long long p = p0 + r * kThreads + threadIdx.x;
    if (p >= a.NL || d[r] >= a.nd) continue;
    const long long c = p - sb[d[r]];
    if (c >= a.C) continue;
    int64_t* out = a.send + 2LL * d[r] * a.C + c;
    out[0] = key[r];
    out[a.C] = v1[r];
  }
}

// A fill tile: slots [j0, j0 + kFillTile) of the plane, t-major,
// destinations t0 .. t1. Once their bounds (t0 .. t1 + 1) are published,
// each slot (t, c) past its run gets KSENT / 0.
__device__ void pack_fill(const PackArgs& a, long long j0, int* sb) {
  const long long slots = static_cast<long long>(a.nd) * a.C;
  const long long j1 = (j0 + kFillTile < slots ? j0 + kFillTile : slots) - 1;
  const int t0 = static_cast<int>(j0 / a.C);
  const int t1 = static_cast<int>(j1 / a.C);
  for (int t = t0 + threadIdx.x; t <= t1 + 1; t += kThreads)
    sb[t] = acquire_bound(a.sc, t);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kFillRows; ++r) {
    const long long j = j0 + r * kThreads + threadIdx.x;
    if (j > j1) continue;
    int t = t0;
    long long c = j - static_cast<long long>(t0) * a.C;
    while (c >= a.C) {
      c -= a.C;
      ++t;
    }
    if (c < sb[t + 1] - sb[t]) continue;
    int64_t* out = a.send + 2LL * t * a.C + c;
    out[0] = kKSent;
    out[a.C] = 0;
  }
}

// One launch of resident blocks, each taking tiles by ticket until none is
// left: the key tiles first, then the fill tiles (which wait for their
// destinations' bounds: the key tiles hold earlier tickets, so they are
// running or done). A block takes its last ticket (past the tiles) after
// its last tile, so the block that takes the launch's last ticket is the
// only one still to touch the scratch: it zeroes it.
__global__ void __launch_bounds__(kThreads, kPackBlocksPerSm)
exchange_pack_kernel(PackArgs a) {
  extern __shared__ long long th[];  // th[1 .. nd - 1], then bound[0 .. nd]
  int* sb = reinterpret_cast<int*>(th + a.nd);
  __shared__ PackTile sh;
  for (int t = 1 + threadIdx.x; t < a.nd; t += kThreads) {
    const long long n = t * a.two_s;
    th[t] = (n + a.nd - 1) / a.nd;
  }
  const long long n_tiles = a.n_key + a.n_fill;
  for (;;) {
    if (threadIdx.x == 0) {
      sh.k = atomicAdd(a.sc, 1u);
      sh.lo = a.nd;
      sh.hi = 0;
      sh.end = 0;
    }
    __syncthreads();
    const long long tk = sh.k;
    if (tk >= n_tiles) break;
    if (tk < a.n_key)
      pack_keys(a, tk * kExTile, th, sb, sh);
    else
      pack_fill(a, (tk - a.n_key) * kFillTile, sb);
    __syncthreads();  // before the next tile's ticket and bounds
  }
  if (sh.k != n_tiles + gridDim.x - 1) return;
  for (int t = threadIdx.x; t <= a.nd; t += kThreads)
    a.sc[kScLine * t] = 0;
}

struct WindowArgs {
  const int64_t* per_rank;  // [nd, 2]: each rank's (n_out_l, overflow)
  const int64_t* vw;        // [RL] the fold's arc rows
  const int32_t* s1;        // [RL]
  const int32_t* reply_loc; // [RL] each received slot's local out-group row
  const int64_t* got_k;     // [RL] the received keys
  int nd, rank, RL, A;
  int64_t* table;           // [2, A]
  int32_t* reply;           // [RL]
  int64_t* n_out;           // scalar
};

__global__ void __launch_bounds__(kThreads)
exchange_window_kernel(WindowArgs a) {
  __shared__ long long sh[3];  // off, n_out_l, n_out
  if (threadIdx.x == 0) {
    long long off = 0, total = 0, over = 0;
    for (int r = 0; r < a.nd; ++r) {
      const long long n = a.per_rank[2 * r];
      if (r < a.rank) off += n;
      total += n;
      over += a.per_rank[2 * r + 1];
    }
    sh[0] = off;
    sh[1] = a.per_rank[2 * a.rank];
    sh[2] = over > 0 ? static_cast<long long>(a.A) + 1 : total;
    if (blockIdx.x == 0) *a.n_out = sh[2];
  }
  __syncthreads();
  const long long off = sh[0], n_loc = sh[1];
  const long long start = off < 0 ? 0 : (off > a.A ? a.A : off);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  for (long long p = first; p < a.A; p += stride) {
    const long long j = p - start;
    int64_t vw = 0, s1 = 0;
    if (j >= 0 && j < a.RL && j < n_loc) {
      vw = a.vw[j];
      s1 = a.s1[j];
    }
    a.table[p] = vw;
    a.table[a.A + p] = s1;
  }
  for (long long j = first; j < a.RL; j += stride)
    a.reply[j] = a.got_k[j] != kKSent
                     ? static_cast<int32_t>(a.reply_loc[j] + off) : 0;
}

struct FinishArgs {
  const int64_t* table;     // [2, A] summed over the ranks
  const int64_t* n_out;     // scalar
  const int64_t* send;      // [nd, 2, C] this rank's send plane
  const int32_t* reply;     // [nd * C] the arc rows returned to the slots
  const int32_t* bounds;    // [nd + 1] exchange_pack's run bounds
  int A, nd, C, NL, jb;
  long long base;
  long long n_table;        // table tiles (blocks 0 .. n_table - 1)
  int64_t* arc_vw;          // [A]
  int32_t* arc_s1;          // [A]
  int32_t* pair;            // [NL + 1], zeroed by exchange_pack
};

// One launch of resident blocks over tiles w = blockIdx.x, + gridDim.x,
// ...: the table tiles first (rows [p0, p0 + kExTile): a live row's two
// words read, 12 bytes written a row), then the tiles of the sent slots,
// numbered t-major (slot (t, c) was sent iff c < min(bound[t + 1] -
// bound[t], C)): each reads its keys and replies and adds each reply to
// its key's origin row of the zeroed pair plane; an unsent slot is never
// read.
__global__ void __launch_bounds__(kThreads, kFinishBlocksPerSm)
exchange_finish_kernel(FinishArgs a) {
  // pre[t]: the sent slots of the destinations before t
  extern __shared__ long long pre[];  // [nd + 1]
  for (int t = threadIdx.x; t <= a.nd; t += kThreads)
    pre[t] = __ldg(a.bounds + t);
  long long w = blockIdx.x;
  if (w < a.n_table) {
    const long long n_out = __ldg(a.n_out);
    for (; w < a.n_table; w += gridDim.x) {
      const long long p0 = w * kExTile;
      int64_t vw[kExRows], s1[kExRows];
#pragma unroll
      for (int r = 0; r < kExRows; ++r) {
        const long long p = p0 + r * kThreads + threadIdx.x;
        const bool live = p < n_out && p < a.A;
        vw[r] = live ? __ldg(a.table + p) : kSent;
        s1[r] = live ? __ldg(a.table + a.A + p) : 0;
      }
#pragma unroll
      for (int r = 0; r < kExRows; ++r) {
        const long long p = p0 + r * kThreads + threadIdx.x;
        if (p >= a.A) continue;
        a.arc_vw[p] = vw[r];
        a.arc_s1[p] = static_cast<int32_t>(s1[r]);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long acc = 0, prev = pre[0];
    pre[0] = 0;
    for (int t = 1; t <= a.nd; ++t) {
      const long long b = pre[t], n = b - prev;
      acc += n < a.C ? n : a.C;
      prev = b;
      pre[t] = acc;
    }
  }
  __syncthreads();
  const long long total = pre[a.nd];
  const long long n_work = a.n_table + (total + kExTile - 1) / kExTile;
  const int64_t mask = (int64_t(1) << a.jb) - 1;
  for (; w < n_work; w += gridDim.x) {
    const long long i0 = (w - a.n_table) * kExTile;
    int64_t key[kExRows];
    int32_t rep[kExRows];
#pragma unroll
    for (int r = 0; r < kExRows; ++r) {
      const long long i = i0 + r * kThreads + threadIdx.x;
      key[r] = kKSent;
      rep[r] = 0;
      if (i >= total) continue;
      int t = 0;
      while (pre[t + 1] <= i) ++t;
      const long long c = i - pre[t];
      key[r] = __ldg(a.send + 2LL * t * a.C + c);
      rep[r] = __ldg(a.reply + static_cast<long long>(t) * a.C + c);
    }
#pragma unroll
    for (int r = 0; r < kExRows; ++r) {
      const long long i = i0 + r * kThreads + threadIdx.x;
      if (i >= total) continue;
      long long row = (key[r] & mask) - a.base;
      row = row < 0 ? 0 : (row > a.NL - 1 ? a.NL - 1 : row);
      // the plane is zero, a row takes one key and a reply (an arc row)
      // is >= 0: the maximum is the store, done in L2 without a reply and
      // the same again on a replay (a random 4-byte store costs a sector's
      // round trip through L1)
      atomicMax(a.pair + row, rep[r]);
    }
  }
}

}  // namespace

// The reductions of G genomes of H rows on `stream`: [G, H] int32 planes
// pid, score_ori, score_adj, n_exon, rank, uint8 flt; n_rows int32 [G].
// out: int64 [7, n_prot], zeroed here by one memset; row 0 holds the int32
// maxima in its first n_prot words, rows 1-6 cnt0, cnt1, sum0, sum1,
// rep_sum, rep_cnt. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for n_prot < 1.
extern "C" int pg_protein_reduce(const void* pid, const void* score_ori,
                                 const void* score_adj, const void* n_exon,
                                 const void* rank, const void* flt,
                                 const void* n_rows, int G, int H,
                                 int n_prot, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_prot < 1) return static_cast<int>(cudaErrorInvalidValue);
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
  a.G = G;
  a.H = H;
  a.n_prot = n_prot;
  a.max_so = static_cast<int32_t*>(out);
  a.sums = static_cast<unsigned long long*>(out) + n_prot;
  // a block column a kThreads rows of H, a block row a genome (each at
  // most 65,535; the kernel strides over the rest)
  const long long bx = (static_cast<long long>(H) + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(bx < 65535 ? bx : 65535),
                  static_cast<unsigned>(G < 65535 ? G : 65535));
  protein_reduce_kernel<<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of exchange_pack's scratch for nd destinations (zeroed once by
// the caller; each launch leaves it zeroed).
extern "C" long long pg_exchange_scratch(int nd) {
  return nd < 1 ? 0 : (nd + 1LL) * kScLine * 4;
}

// exchange_pack's dynamic shared memory: the thresholds, then the bounds.
inline size_t pack_smem(int nd) {
  return nd * sizeof(long long) + (nd + 1) * sizeof(int);
}

// exchange_finish's: the sent slots before each destination.
inline size_t finish_smem(int nd) { return (nd + 1) * sizeof(long long); }

// The persistent grids on the current device: each kernel's resident
// blocks a SM (its occupancy) and the SMs.
cudaError_t exchange_caps(int nd, int* sms, int* pack_sm, int* finish_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        pack_sm, exchange_pack_kernel, kThreads, pack_smem(nd));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        finish_sm, exchange_finish_kernel, kThreads, finish_smem(nd));
  if (e == cudaSuccess && (*sms < 1 || *pack_sm < 1 || *finish_sm < 1))
    e = cudaErrorInvalidConfiguration;
  return e;
}

inline long long min_ll(long long x, long long y) { return x < y ? x : y; }

// The send plane of NL sorted lean keys (int64, KSENT at the end) and
// their rows' s1 (int32 [NL], by local row) for nd destinations of C
// slots on `stream`: send int64 [nd, 2, C] (keys, s1), ovf int64 scalar,
// pair int32 [NL + 1] zeroed, bounds int32 [nd + 1] (destination t's run
// starts at bounds[t]; bounds[nd] is the first sentinel). dest =
// clip((key >> shift) * nd // two_s, 0, nd - 1); a key's origin row is
// (key & (2^jb - 1)) - base. scratch: pg_exchange_scratch(nd) bytes, zero,
// left zero. Returns cudaGetLastError(), or cudaErrorInvalidValue on a
// bad shape.
extern "C" int pg_exchange_pack(const void* keys, const void* s1, int NL,
                                int nd, int C, int jb, int shift,
                                long long two_s, long long base, void* send,
                                void* ovf, void* pair, void* bounds,
                                void* scratch, void* stream) {
  if (NL < 1 || nd < 1 || C < 1 || two_s < 1 || jb < 1 || jb > 62 ||
      !scratch)
    return static_cast<int>(cudaErrorInvalidValue);
  PackArgs a;
  a.keys = static_cast<const int64_t*>(keys);
  a.s1 = static_cast<const int32_t*>(s1);
  a.NL = NL;
  a.nd = nd;
  a.C = C;
  a.jb = jb;
  a.shift = shift;
  a.two_s = two_s;
  a.base = base;
  a.v_max = 0x7fffffffffffffffLL / nd;
  a.n_key = (NL + kExTile - 1LL) / kExTile;
  a.n_fill = (static_cast<long long>(nd) * C + kFillTile - 1) / kFillTile;
  a.send = static_cast<int64_t*>(send);
  a.ovf = static_cast<int64_t*>(ovf);
  a.pair = static_cast<int32_t*>(pair);
  a.bounds = static_cast<int32_t*>(bounds);
  a.sc = static_cast<unsigned*>(scratch);
  // every block takes one ticket past the last tile
  if (a.n_key + a.n_fill > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, pack_sm = 0, finish_sm = 0;
  const cudaError_t e = exchange_caps(nd, &sms, &pack_sm, &finish_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long grid = min_ll(a.n_key + a.n_fill,
                                static_cast<long long>(sms) * pack_sm);
  exchange_pack_kernel<<<static_cast<unsigned>(grid), kThreads,
                         pack_smem(nd),
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// This rank's table plane and reply on `stream`: per_rank int64 [nd, 2]
// (every rank's n_out_l and overflow flag, the all_gather's), the fold's
// vw int64, s1 int32 and reply_loc int32 [RL], the received keys got_k
// int64 [RL]. Writes table int64 [2, A], reply int32 [RL], n_out int64
// scalar. Returns cudaGetLastError(), or cudaErrorInvalidValue on a bad
// shape.
extern "C" int pg_exchange_window(const void* per_rank, const void* vw,
                                  const void* s1, const void* reply_loc,
                                  const void* got_k, int nd, int rank,
                                  int RL, int A, void* table, void* reply,
                                  void* n_out, void* stream) {
  if (nd < 1 || rank < 0 || rank >= nd || RL < 0 || A < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  WindowArgs a;
  a.per_rank = static_cast<const int64_t*>(per_rank);
  a.vw = static_cast<const int64_t*>(vw);
  a.s1 = static_cast<const int32_t*>(s1);
  a.reply_loc = static_cast<const int32_t*>(reply_loc);
  a.got_k = static_cast<const int64_t*>(got_k);
  a.nd = nd;
  a.rank = rank;
  a.RL = RL;
  a.A = A;
  a.table = static_cast<int64_t*>(table);
  a.reply = static_cast<int32_t*>(reply);
  a.n_out = static_cast<int64_t*>(n_out);
  exchange_window_kernel<<<grid_of(A > RL ? A : RL), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The arc table and the pair slots on `stream`: table int64 [2, A] (summed
// over the ranks), n_out int64 scalar, this rank's send int64 [nd, 2, C],
// the returned reply int32 [nd * C], pg_exchange_pack's bounds int32
// [nd + 1]. Writes arc_vw int64 [A], arc_s1 int32 [A] and pair int32
// [NL + 1] at the origin rows of the keys sent (zeroed before by
// pg_exchange_pack). Returns cudaGetLastError(), or cudaErrorInvalidValue
// on a bad shape.
extern "C" int pg_exchange_finish(const void* table, const void* n_out,
                                  const void* send, const void* reply,
                                  const void* bounds, int A, int nd, int C,
                                  int NL, int jb, long long base,
                                  void* arc_vw, void* arc_s1, void* pair,
                                  void* stream) {
  if (A < 1 || nd < 1 || C < 1 || NL < 1 || jb < 1 || jb > 62)
    return static_cast<int>(cudaErrorInvalidValue);
  FinishArgs a;
  a.table = static_cast<const int64_t*>(table);
  a.n_out = static_cast<const int64_t*>(n_out);
  a.send = static_cast<const int64_t*>(send);
  a.reply = static_cast<const int32_t*>(reply);
  a.bounds = static_cast<const int32_t*>(bounds);
  a.A = A;
  a.nd = nd;
  a.C = C;
  a.NL = NL;
  a.jb = jb;
  a.base = base;
  a.n_table = (A + kExTile - 1LL) / kExTile;
  a.arc_vw = static_cast<int64_t*>(arc_vw);
  a.arc_s1 = static_cast<int32_t*>(arc_s1);
  a.pair = static_cast<int32_t*>(pair);
  const long long n_slot =
      (static_cast<long long>(nd) * C + kExTile - 1) / kExTile;
  int sms = 0, pack_sm = 0, finish_sm = 0;
  const cudaError_t e = exchange_caps(nd, &sms, &pack_sm, &finish_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long grid = min_ll(a.n_table + n_slot,
                                static_cast<long long>(sms) * finish_sm);
  exchange_finish_kernel<<<static_cast<unsigned>(grid), kThreads,
                           finish_smem(nd),
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of exchange_pack and exchange_finish on the current
// device, into out[13]: threads a block, positions a thread in a key,
// table or slot tile, pack's key and fill tiles (kFillRows slots a thread),
// pack's resident blocks a SM, finish's table and slot tiles (the most
// slots; the tiles past the slots sent are skipped), finish's resident
// blocks a SM, the device's SMs, pack's scratch bytes, pack's and finish's
// grids (persistent: at most the resident blocks), slots a thread in a
// fill tile. Returns a CUDA error code.
extern "C" int pg_exchange_shape(int NL, int nd, int C, int A,
                                 long long* out) {
  int sms = 0, pack_sm = 0, finish_sm = 0;
  const cudaError_t e = exchange_caps(nd, &sms, &pack_sm, &finish_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long slots = static_cast<long long>(nd) * C;
  out[0] = kThreads;
  out[1] = kExRows;
  out[2] = (NL + kExTile - 1LL) / kExTile;
  out[3] = (slots + kFillTile - 1) / kFillTile;
  out[4] = pack_sm;
  out[5] = (A + kExTile - 1LL) / kExTile;
  out[6] = (slots + kExTile - 1) / kExTile;
  out[7] = finish_sm;
  out[8] = sms;
  out[9] = pg_exchange_scratch(nd);
  out[10] = min_ll(out[2] + out[3], static_cast<long long>(sms) * pack_sm);
  out[11] = min_ll(out[5] + out[6], static_cast<long long>(sms) * finish_sm);
  out[12] = kFillRows;
  return 0;
}
