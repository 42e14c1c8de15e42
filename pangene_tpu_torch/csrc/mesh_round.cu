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
//    exchange_finish scatters into.
//  * exchange_window: device_loop.py:377-401. From the all_gather of every
//    rank's (n_out, overflow): this rank's offset (the earlier ranks'
//    out-group counts), n_out (A + 1 on any overflow), and the rank's [2, A]
//    table plane: its fold's rows masked by n_out_l at the window start
//    clamp(off, 0, A) (as dynamic_update_slice clamps it), 0 elsewhere; and
//    the reply, each received slot's global arc row (0 at a sentinel).
//  * exchange_finish: device_loop.py:393-405. The summed table masked by
//    live rows (SENT / 0 past n_out, s1 to int32), and each returned arc
//    row scattered to the pair slot of the key this rank sent there (its
//    origin row, recomputed from the key; only slots really sent).
//
// Bounds and design. All four move little data (big at world 4: a few MB)
// and are bound by bytes; none reads a value on the host, so the ranks
// cannot disagree on one.
//  * protein_reduce: one pass over the rows, one block row of the grid per
//    genome (no division), int32 atomicMax (skipped for values <= 0: the
//    output starts at 0) and 64-bit atomicAdd (two's complement: every
//    order gives the same bits). Only rank-0 unfiltered rows touch the
//    sums. The output [7, n_prot] is one int64 buffer, zeroed by one memset:
//    row 0 holds the int32 maxima in its first n_prot words.
//  * exchange_pack: no count pass and no scan. Destinations are monotone in
//    the sorted keys and the sentinels come last, so the nd run boundaries
//    (the first position whose key is KSENT or goes to t or later, t = 1
//    .. nd) come from binary searches; each block makes them itself, one
//    warp a boundary, each step a 32-way probe of the warp (five steps at a
//    million keys). Then every slot of the plane is one coalesced store.
//  * exchange_window and exchange_finish: elementwise over the A table
//    rows and the nd * C slots, grid-stride; the per-rank sums are made
//    once a block in shared memory.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// blocks a SM the grid-stride kernels ask for at most (132 SMs)
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

// The first position in [0, n) whose key is KSENT or goes to destination
// t or later (n when none), by a 32-way search of one warp; every lane
// returns it.
__device__ int run_bound(const int64_t* keys, int n, int t, int shift,
                         int nd, long long two_s) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;  // positions before lo fail; the answer <= hi
  while (lo < hi) {
    const long long len = hi - lo;
    const long long step = len <= 32 ? 1 : (len + 31) / 32;
    const long long p = lo + lane * step;
    bool hit = false;
    if (p < hi) {
      const int64_t k = keys[p];
      hit = k >= kKSent || dest_of(k, shift, nd, two_s) >= t;
    }
    // the ballot is the warp's: every lane takes the same branch
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    if (bal == 0) {
      // every probe failed: the answer is past the last one below hi
      const long long m = (len - 1) / step;
      lo += (m < 31 ? m : 31) * step + 1;
    } else {
      const int f = __ffs(bal) - 1;
      if (f == 0) return static_cast<int>(lo);
      hi = lo + f * step;
      lo += (f - 1) * step + 1;
    }
  }
  return static_cast<int>(lo);
}

struct PackArgs {
  const int64_t* keys;      // [NL] sorted
  const int32_t* s1;        // [NL] by local row
  int NL, nd, C, jb, shift;
  long long two_s, base;
  int64_t* send;            // [nd, 2, C]
  int64_t* ovf;             // scalar
  int32_t* pair;            // [NL + 1], zeroed here
};

__global__ void __launch_bounds__(kThreads) exchange_pack_kernel(PackArgs a) {
  // bound[t]: the start of destination t's run, t = 0 .. nd (bound[nd]:
  // the first sentinel)
  extern __shared__ int bound[];
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) bound[0] = 0;
  for (int t = 1 + warp; t <= a.nd; t += kWarps) {
    const int b = run_bound(a.keys, a.NL, t, a.shift, a.nd, a.two_s);
    if ((threadIdx.x & 31) == 0) bound[t] = b;
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int64_t over = 0;
    for (int t = 0; t < a.nd; ++t)
      over |= bound[t + 1] - bound[t] > a.C;
    *a.ovf = over;
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  const long long slots = static_cast<long long>(a.nd) * a.C;
  const int64_t mask = (int64_t(1) << a.jb) - 1;
  for (long long j = first; j < slots; j += stride) {
    const int t = static_cast<int>(j / a.C);
    const int c = static_cast<int>(j - static_cast<long long>(t) * a.C);
    int64_t key = kKSent, s1 = 0;
    if (c < bound[t + 1] - bound[t]) {
      key = a.keys[bound[t] + c];
      long long row = (key & mask) - a.base;
      row = row < 0 ? 0 : (row > a.NL - 1 ? a.NL - 1 : row);
      s1 = a.s1[row];
    }
    int64_t* out = a.send + 2LL * t * a.C + c;
    out[0] = key;
    out[a.C] = s1;
  }
  for (long long j = first; j <= a.NL; j += stride) a.pair[j] = 0;
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
  int A, nd, C, NL, jb;
  long long base;
  int64_t* arc_vw;          // [A]
  int32_t* arc_s1;          // [A]
  int32_t* pair;            // [NL + 1], zeroed by exchange_pack
};

__global__ void __launch_bounds__(kThreads)
exchange_finish_kernel(FinishArgs a) {
  const long long n_out = *a.n_out;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  for (long long p = first; p < a.A; p += stride) {
    const bool live = p < n_out;
    a.arc_vw[p] = live ? a.table[p] : kSent;
    a.arc_s1[p] = live ? static_cast<int32_t>(a.table[a.A + p]) : 0;
  }
  const long long slots = static_cast<long long>(a.nd) * a.C;
  const int64_t mask = (int64_t(1) << a.jb) - 1;
  for (long long j = first; j < slots; j += stride) {
    const int t = static_cast<int>(j / a.C);
    const int c = static_cast<int>(j - static_cast<long long>(t) * a.C);
    const int64_t key = a.send[2LL * t * a.C + c];
    if (key == kKSent) continue;
    long long row = (key & mask) - a.base;
    row = row < 0 ? 0 : (row > a.NL - 1 ? a.NL - 1 : row);
    a.pair[row] = a.reply[j];
  }
}

}  // namespace

// The reductions of G genomes of H rows on `stream`: [G, H] int32 planes
// pid, score_ori, score_adj, n_exon, rank, uint8 flt; n_rows int32 [G].
// out: int64 [7, n_prot], zeroed here by one memset; row 0 holds the int32
// maxima in its first n_prot words, rows 1-6 cnt0, cnt1, sum0, sum1,
// rep_sum, rep_cnt. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for n_prot < 1 or a grid past 65,535 genomes.
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

// The send plane of NL sorted lean keys (int64, KSENT at the end) and
// their rows' s1 (int32 [NL], by local row) for nd destinations of C
// slots on `stream`: send int64 [nd, 2, C] (keys, s1), ovf int64 scalar,
// pair int32 [NL + 1] zeroed. dest = clip((key >> shift) * nd // two_s, 0,
// nd - 1); a key's origin row is (key & (2^jb - 1)) - base. Returns
// cudaGetLastError(), or cudaErrorInvalidValue on a bad shape.
extern "C" int pg_exchange_pack(const void* keys, const void* s1, int NL,
                                int nd, int C, int jb, int shift,
                                long long two_s, long long base, void* send,
                                void* ovf, void* pair, void* stream) {
  if (NL < 1 || nd < 1 || C < 1 || two_s < 1 || jb < 1 || jb > 62)
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
  a.send = static_cast<int64_t*>(send);
  a.ovf = static_cast<int64_t*>(ovf);
  a.pair = static_cast<int32_t*>(pair);
  const long long n = static_cast<long long>(nd) * C;
  const int grid = grid_of(n > NL + 1LL ? n : NL + 1LL);
  exchange_pack_kernel<<<grid, kThreads, (nd + 1) * sizeof(int),
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
// the returned reply int32 [nd * C]. Writes arc_vw int64 [A], arc_s1 int32
// [A] and pair int32 [NL + 1] at the origin rows of the keys sent (zeroed
// before by pg_exchange_pack). Returns cudaGetLastError(), or
// cudaErrorInvalidValue on a bad shape.
extern "C" int pg_exchange_finish(const void* table, const void* n_out,
                                  const void* send, const void* reply, int A,
                                  int nd, int C, int NL, int jb,
                                  long long base, void* arc_vw, void* arc_s1,
                                  void* pair, void* stream) {
  if (A < 1 || nd < 1 || C < 1 || NL < 1 || jb < 1 || jb > 62)
    return static_cast<int>(cudaErrorInvalidValue);
  FinishArgs a;
  a.table = static_cast<const int64_t*>(table);
  a.n_out = static_cast<const int64_t*>(n_out);
  a.send = static_cast<const int64_t*>(send);
  a.reply = static_cast<const int32_t*>(reply);
  a.A = A;
  a.nd = nd;
  a.C = C;
  a.NL = NL;
  a.jb = jb;
  a.base = base;
  a.arc_vw = static_cast<int64_t*>(arc_vw);
  a.arc_s1 = static_cast<int32_t*>(arc_s1);
  a.pair = static_cast<int32_t*>(pair);
  const long long n = static_cast<long long>(nd) * C;
  exchange_finish_kernel<<<grid_of(n > A ? n : A), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
