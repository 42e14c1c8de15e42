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
// groups' targets, :527-537 the representatives): per (gene, genome) the
// last kept hit in cs order (presence, contig, cm and kept rank; row 0's
// when absent, as the plain gather reads) and each arc's target gene. The
// JAX block's window check is not ported: the branch kernels test every
// pair of a group of any size.
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
// (:724-740): in a branch round the n_dist_loci plane from the
// classification's n_grp; the out-degrees (the arc table is v-sorted with
// its valid arcs first, so a vertex's group size is its count of valid
// arcs), the segments' deletion (occ, degree, loci; counted into the round's
// log row), the capture rows, and the dead genes' hits filtered.
//
// What bounds them on the H100: their bytes (chip_smoke.py works them out
// per call), a few hundred kilobytes to some ten megabytes a call: a few
// microseconds. The plain PyTorch forms cost launch latency: ~20-70 small
// operations each a round, enqueued one at a time by the host.
//
// Design. walk_pairs and branch_prep each run a scan over every genome's
// rows (the previous kept row, a running maximum; the kept rank, a running
// count). Both cut each genome into tiles of kScanTile rows, one block a
// tile (G x tiles blocks: many more than the 132 SMs even at a mesh
// shard's 16 genomes), each thread kScanRows rows kScanThreads apart, so
// every load and store is a warp's 32 consecutive rows and all of a
// thread's loads are in flight at once. The scan stays on the warp: a
// ballot of the kept rows is a 32-row word, the previous and next kept
// lanes are bit scans of it and the row values come by shuffle; the
// words' own summaries (last and first kept row with their values, or
// counts) sit in shared memory for the tile's other warps; the carry from
// the genome's earlier tiles comes from a decoupled look-back (Merrill and
// Garland 2016) over the tiles' status words: blocks take tiles in order
// from an atomic ticket, so a tile only ever waits on tiles that running
// blocks hold, and a walk tile that holds a kept row publishes its
// inclusive value at once (the maximum is its own last row). A carry from
// a thread-block cluster of a genome's tiles through distributed shared
// memory was slower at every shape measured
// (scripts/torch_round_ablation.py's cluster_rows8 rebuilds it).
//  * walk_pairs writes every row's nxt once, in the same pass: a kept row's
//    next kept row in its tile; the tile's last kept row's is written by
//    the genome's next tile that holds a kept row (its carry is that row),
//    or -1 by the genome's last tile; so no memset of the plane. A row's
//    previous kept row's values come from a shuffle (in its word), from
//    shared memory (in its tile) or, for the rows before the tile's first
//    kept row, from global memory. The segment counters: a warp's kept
//    rows of one segment (__match_any_sync) add once to seg_tot and set
//    the genome's bit in a [words, S] plane (a warp's consecutive segments
//    at consecutive words), whose old value says whether to count the
//    genome in seg_ng: three atomics a kept row of a new segment, about
//    half the kernel's time at the north star (1.8 million kept rows;
//    scripts/torch_round_ablation.py's no_counters): on collinear genomes
//    the tiles of every genome in flight hit the same segments at once
//    (a [G, S] count plane summed after the tiles was no faster).
//  * branch_prep is one launch over three kinds of ticket: the genomes'
//    tiles, the arc blocks, the representative blocks. A tile writes its
//    words' kept masks and the kept rows before each word (8 bytes a 32
//    rows; a kept rank is the word's count plus a popcount) and each kept
//    row's last + 1 into the genome-major [G, n_gene] scratch by atomicMax
//    (it does not fit a block's shared memory once a genome's rows span
//    many blocks), then counts itself done. An arc block writes its
//    targets. A representative block (32 genes x 32 genomes)
//    waits until every tile is done (they hold earlier tickets), reads its
//    last rows and gathers their values genome-major, transposes them in
//    shared memory and writes the gene-major planes coalesced.
// prop_round and occ_round run just before the round's one host read, so
// the host waits on their latency: each is one launch and no memset. Their
// counts go through a scratch that every call leaves zeroed: each block
// adds its count, its change bit and one to the blocks done in one 64-bit
// atomic, and the block done last sets the word and the log row and
// zeroes it (grid_done).
//  * prop_round: one block a 1,024-row tile of a genome's cm positions,
//    like the scans. Every load of the tile is issued first (the pair
//    planes at its cm positions), then what they address: the arc marks,
//    weak, flt and valid at the cs rows (read directly: ordcm is nearly
//    the identity, so a warp's 32 cs rows fall in one or two sectors and
//    the reads coalesce; testing.py's ordcm_locality measures it, PERF.md
//    has the shares), each pair slot's forward mark once into shared
//    memory, where a position's next pair (nxt) is read unless it lies
//    past the tile (the tile's last kept row: one global lookup a tile,
//    read ahead with the tile's loads for the next tile's first row).
//    Two dependent reads a row, not four. The call without propagation is
//    a row-wise pass, 16-byte loads.
//  * occ_round: segment blocks, then hit blocks, by ticket. A vertex's
//    arcs are one run of the v-sorted table and n_grp is non-zero only at
//    a run's first arc (csrc/loop_blocks.cu), so a segment block finds its
//    64 segments' arcs by two block-wide lower bounds (128 probes a step;
//    the first step, the same for every block, read before the ticket)
//    and reads each strand's degree (the run's length) and loci (n_grp at
//    its first arc) from the runs it marks in shared memory: no atomic on
//    a degree and no row to zero. A hit block reads its 16 rows (16-byte
//    loads) and their genes' segments, then waits until every segment
//    block is done (they hold earlier tickets, so the wait ends) and reads
//    the segments' alive bits the segment blocks left in the scratch.
// Scatters are unique (nxt, the capture rows, prop_round's cs rows) or
// integer atomics (segment counters, the representatives' atomicMax, the
// counts), so every output is deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 256;        // walk_pairs, branch_prep: a tile
constexpr int kScanRows = 4;             // rows a thread, kScanThreads apart
constexpr int kScanTile = kScanThreads * kScanRows;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanWords = kScanRows * kScanWarps;   // 32-row words a tile
static_assert(kScanWords <= 64, "a tile's words are one 64-bit mask");
constexpr int kWalkBlocksPerSm = 1;      // walk_pairs: no register cap
constexpr int kArcRows = 4;              // branch_prep: arcs a thread
constexpr int kRepChunk = 32;            // branch_prep: genes, genomes a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kSent = (int64_t(1) << 62) - 1;    // empty arc slot
constexpr int64_t kKeySent = int64_t(1) << 62;       // invalid sort key
// a tile's status word: its state in the top two bits (0: not published
// yet), its value below: walk_pairs' last kept row + 1 (0: none), a
// maximum; branch_prep's kept rows, a sum. Aggregate: the tile's own;
// inclusive: over the genome's tiles up to this one.
constexpr unsigned long long kTileAgg = 1ull << 62;
constexpr unsigned long long kTilePre = 2ull << 62;
constexpr unsigned long long kTileValue = (1ull << 62) - 1;

struct MaxU64 {
  __device__ unsigned long long operator()(unsigned long long a,
                                           unsigned long long b) const {
    return a > b ? a : b;
  }
};
struct AddU64 {
  __device__ unsigned long long operator()(unsigned long long a,
                                           unsigned long long b) const {
    return a + b;
  }
};

__device__ __forceinline__ void tile_store(unsigned long long* t,
                                           unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(t) = v;
}
__device__ __forceinline__ unsigned long long tile_load(
    const unsigned long long* t) {
  return *reinterpret_cast<const volatile unsigned long long*>(t);
}

// The reduction (op: a maximum or a sum, identity 0) of the values of the
// tiles t0 .. t - 1 (t0: the genome's first tile), by one warp: windows of
// 32 predecessors, nearest first, down to the nearest inclusive word.
template <class Op>
__device__ unsigned long long look_back(const unsigned long long* tiles,
                                        long long t, long long t0, int lane,
                                        Op op) {
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
    for (int o = 16; o; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
    acc = op(acc, v);
    if (pre) break;
  }
  return acc;
}

__device__ __forceinline__ int clampi(int64_t x, int64_t lo, int64_t hi) {
  return static_cast<int>(x < lo ? lo : (x > hi ? hi : x));
}

// Tiles of the scans over G genomes of H rows.
long long scan_tiles(long long G, int H) {
  return G * ((static_cast<long long>(H) + kScanTile - 1) / kScanTile);
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
  int H, T, S, B, GB, jb, use_ori;   // T: tiles a genome
  long long g0;        // this rank's first genome (rank * G)
  long long slot0;     // this rank's first pair slot (rank * G * 2H)
  int64_t* keys;       // [G, 2H]
  int32_t* s12;        // [G, 2H]
  uint8_t* pair_ok;    // [G, H]
  int32_t* nxt;        // [G, H], -1 where no pair follows
  int32_t* seg_tot;    // [S]
  int32_t* seg_ng;     // [S]
  uint32_t* seen;      // [(G + 31) / 32, S]: a segment's genome bits
  long long ntiles;    // G * T
  unsigned long long* tiles;   // [ntiles] status words, then the ticket
  int32_t* s21;        // full mode: [G, 2H]
  int32_t* dist2;      // full mode: [G, 2H]
};

// The score the merge averages for cm row r (the dominant's unless
// use_ori, the original's outranks it, or the dominant's gene is dead).
__device__ __forceinline__ int32_t walk_score(const WalkArgs& p, long long r) {
  const int32_t so = p.so[r], sd = p.sd[r], dg = p.dg[r], ds = p.dsid[r];
  const bool dom_alive =
      dg >= 0 && ds >= 0 && p.alive[clampi(ds, 0, p.S - 1)] != 0;
  return (p.use_ori || so > sd || dg < 0 || dom_alive) ? so : sd;
}

// One tile of a genome's cm rows a block, the tile from the ticket: the
// kept rows by ballot, the tile's summary published and its carry looked
// back, then every row's pair planes, nxt and counters.
template <bool kFullMode>
__global__ void __launch_bounds__(kScanThreads, kWalkBlocksPerSm)
walk_pairs_kernel(WalkArgs p) {
  // each word's last kept row with its values, and its first kept row
  __shared__ int s_last[kScanWords], s_first[kScanWords];
  __shared__ int32_t s_cid[kScanWords], s_sc[kScanWords];
  __shared__ int64_t s_w[kScanWords], s_cm[kScanWords];
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
  const int i0 = k * kScanTile;
  const long long base = g * H, base2 = 2 * base;

  // the rows: kept or not, the score, cm in the full mode, cid, w and
  // the segment (read at every row, so that no load waits on another but
  // the gathers through ordcm and dsid; nearly every row is kept)
  bool kept[kScanRows];
  int32_t cid[kScanRows], sc[kScanRows], seg[kScanRows];
  int64_t w[kScanRows], cm[kScanRows];
#pragma unroll
  for (int q = 0; q < kScanRows; ++q) {
    const int i = i0 + q * kScanThreads + threadIdx.x;
    const long long r = base + i;
    bool kp = false;
    cid[q] = sc[q] = seg[q] = 0;
    w[q] = cm[q] = 0;
    if (i < H) {
      const bool va = p.valid[r] != 0;
      const long long h = base + p.ordcm[r];   // a permutation of the rows
      kp = va & (p.flt[h] == 0) & (p.shadow[h] == 0);
      sc[q] = walk_score(p, r);
      if (kFullMode) cm[q] = p.cm[r];
      cid[q] = p.cid[r];
      w[q] = p.w[r];
      seg[q] = p.seg[r];
    }
    kept[q] = kp;
  }
  // each word's kept lanes; its summary in shared memory
  unsigned km[kScanRows];
#pragma unroll
  for (int q = 0; q < kScanRows; ++q) {
    const unsigned m = __ballot_sync(kFull, kept[q]);
    const int wd = q * kScanWarps + warp;
    const int row0 = i0 + q * kScanThreads + warp * 32;
    km[q] = m;
    if (lane == 0) {
      s_last[wd] = m ? row0 + 31 - __clz(m) : -1;
      s_first[wd] = m ? row0 + __ffs(m) - 1 : H;
    }
    if (m && lane == 31 - __clz(m)) {
      s_cid[wd] = cid[q];
      s_sc[wd] = sc[q];
      s_w[wd] = w[q];
      s_cm[wd] = cm[q];
    }
  }
  __syncthreads();
  if (warp == 0) {
    // the tile's last and first kept rows; a tile with a kept row
    // publishes its inclusive value at once
    int lst = -1, fst = H;
    for (int x = lane; x < kScanWords; x += 32) {
      lst = max(lst, s_last[x]);
      fst = min(fst, s_first[x]);
    }
    lst = __reduce_max_sync(kFull, lst);
    fst = __reduce_min_sync(kFull, fst);
    unsigned long long* st = p.tiles + tile;
    if (lane == 0)
      tile_store(st, (lst >= 0 || k == 0 ? kTilePre : kTileAgg)
                         | static_cast<unsigned long long>(lst + 1));
    const int carry = static_cast<int>(
        look_back(p.tiles, tile, g * p.T, lane, MaxU64())) - 1;
    if (lane == 0) {
      if (lst < 0 && k > 0)
        tile_store(st, kTilePre | static_cast<unsigned long long>(carry + 1));
      // the carry is the last kept row of an earlier tile: its next kept
      // row is this tile's first, or none when this is the genome's last
      if (carry >= 0 && (fst < H || k == p.T - 1))
        p.nxt[base + carry] = fst < H ? fst : -1;
      s_carry = carry;
    }
  }
  __syncthreads();
  const int carry = s_carry;
  // the tile's words that hold a kept row
  unsigned long long has = __ballot_sync(
      kFull, lane < kScanWords && s_last[lane] >= 0);
  if (kScanWords > 32)
    has |= static_cast<unsigned long long>(__ballot_sync(
               kFull, lane + 32 < kScanWords && s_last[lane + 32] >= 0))
           << 32;
  const uint64_t jg = static_cast<uint64_t>(p.g0 + g);
  const uint32_t bit = 1u << (g & 31);
  uint32_t* bits = p.seen + static_cast<long long>(g >> 5) * p.S;
#pragma unroll
  for (int q = 0; q < kScanRows; ++q) {
    const int i = i0 + q * kScanThreads + threadIdx.x;
    const int wd = q * kScanWarps + warp;
    const unsigned m = km[q];
    // the previous kept row: in the word (by shuffle), in the tile (shared
    // memory), else the carry (global memory; row 0's values without one)
    const unsigned below = m & ((1u << lane) - 1u);
    const int pl = below ? 31 - __clz(below) : lane;
    int32_t pcid = __shfl_sync(kFull, cid[q], pl);
    int32_t psc = __shfl_sync(kFull, sc[q], pl);
    int64_t pw = __shfl_sync(kFull, w[q], pl);
    int64_t pcm = kFullMode ? __shfl_sync(kFull, cm[q], pl) : 0;
    int prev = i - lane + pl;
    const unsigned long long before = has & ((1ull << wd) - 1ull);
    if (!below && before) {
      const int x = 63 - __clzll(static_cast<long long>(before));
      prev = s_last[x];
      pcid = s_cid[x];
      psc = s_sc[x];
      pw = s_w[x];
      pcm = s_cm[x];
    } else if (!below && i < H) {
      prev = carry;
      const long long rp = base + (carry < 0 ? 0 : carry);
      psc = walk_score(p, rp);
      if (kFullMode) pcm = p.cm[rp];
      if (carry >= 0) {
        pcid = p.cid[rp];
        pw = p.w[rp];
      }
    }
    const bool ok = kept[q] && prev >= 0 && pcid == cid[q];
    // a kept row of a segment: the warp's rows of that segment add once
    const unsigned peers =
        __match_any_sync(kFull, kept[q] ? seg[q] : -1 - lane);
    if (i >= H) continue;
    const uint64_t wv = static_cast<uint64_t>(w[q]);
    const uint64_t v = static_cast<uint64_t>(pw);
    uint64_t kf = (((v << p.B) | wv) << p.GB) | jg;
    uint64_t kr = ((((wv ^ 1) << p.B) | (v ^ 1)) << p.GB) | jg;
    if (p.jb) {
      const uint64_t jo = static_cast<uint64_t>(p.slot0 + base2 + i);
      kf = (kf << p.jb) | jo;
      kr = (kr << p.jb) | (jo + H);
    }
    p.keys[base2 + i] = ok ? static_cast<int64_t>(kf) : kKeySent;
    p.keys[base2 + H + i] = ok ? static_cast<int64_t>(kr) : kKeySent;
    p.s12[base2 + i] = psc;
    p.s12[base2 + H + i] = sc[q];
    if (kFullMode) {
      // the int32 truncation of the reference's pg_tmparc_t
      const int32_t d = static_cast<int32_t>(static_cast<uint32_t>(
          static_cast<uint64_t>(cm[q]) - static_cast<uint64_t>(pcm)));
      p.s21[base2 + i] = sc[q];
      p.s21[base2 + H + i] = psc;
      p.dist2[base2 + i] = d;
      p.dist2[base2 + H + i] = d;
    }
    p.pair_ok[base + i] = ok;
    // nxt: -1 off the kept rows; a kept row's next kept row in the word,
    // in the tile, or none in the genome's last tile; else a later tile
    // writes it
    int nx = -1;
    bool write = true;
    if (kept[q]) {
      const unsigned above = m & ~((2u << lane) - 1u);
      const unsigned long long after = has & ~((2ull << wd) - 1ull);
      if (above)
        nx = i - lane + __ffs(above) - 1;
      else if (after)
        nx = s_first[__ffsll(static_cast<long long>(after)) - 1];
      else
        write = k == p.T - 1;
    }
    if (write) p.nxt[base + i] = nx;
    if (kept[q] && lane == __ffs(peers) - 1) {
      const int s = seg[q];
      atomicAdd(&p.seg_tot[s], __popc(peers));
      if (!(atomicOr(bits + s, bit) & bit)) atomicAdd(&p.seg_ng[s], 1);
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
  int S, B;
  uint8_t* r_pres;         // [ng, G]
  int32_t* r_cid;
  int64_t* r_cm;
  int32_t* r_rank;
  int64_t* tgt;            // [A]
  int T, W;                // tiles and 32-row words a genome
  long long n_tile, n_arc; // the ticket: tiles, then arc blocks, then reps
  int rep_gc;              // representative blocks a gene chunk
  unsigned long long* tiles;   // [n_tile] status words, ticket, tiles done
  int32_t* last;           // [G, ng] zeroed: last kept row + 1
  int2* words;             // [G, W]: kept mask, kept rows before the word
};

// A tile of a genome's cs rows: its kept words and the kept rows before
// each (the look-back's sum), each kept row's last + 1 by atomicMax.
__device__ void prep_tile(const PrepArgs& p, long long tile) {
  __shared__ int s_cnt[kScanWords];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g = tile / p.T;
  const int k = static_cast<int>(tile - g * p.T);
  const int i0 = k * kScanTile;
  const long long base = g * p.H;
  unsigned m[kScanRows];
#pragma unroll
  for (int q = 0; q < kScanRows; ++q) {
    const int i = i0 + q * kScanThreads + threadIdx.x;
    const long long r = base + i;
    bool kept = false;
    if (i < p.H) {
      kept = (p.flt[r] == 0) & (p.shadow[r] == 0) & (p.valid[r] != 0);
      const int q = clampi(p.gid[r], 0, p.ng - 1);
      if (kept) atomicMax(&p.last[g * p.ng + q], i + 1);
    }
    m[q] = __ballot_sync(kFull, kept);
    if (lane == 0) s_cnt[q * kScanWarps + warp] = __popc(m[q]);
  }
  __syncthreads();
  if (warp == 0) {
    // the words' exclusive counts: two a lane, a warp scan each
    int c[2], e[2], tot[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = lane + 32 * h;
      c[h] = x < kScanWords ? s_cnt[x] : 0;
      int incl = c[h];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      e[h] = incl - c[h];
      tot[h] = __shfl_sync(kFull, incl, 31);
    }
    const unsigned long long total = tot[0] + tot[1];
    unsigned long long* st = p.tiles + tile;
    if (lane == 0) tile_store(st, (k == 0 ? kTilePre : kTileAgg) | total);
    const int excl = static_cast<int>(
        look_back(p.tiles, tile, g * p.T, lane, AddU64()));
    if (lane == 0 && k > 0) tile_store(st, kTilePre | (excl + total));
    if (lane < kScanWords) s_cnt[lane] = excl + e[0];
    if (lane + 32 < kScanWords) s_cnt[lane + 32] = excl + tot[0] + e[1];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kScanRows; ++q) {
    const int wd = q * kScanWarps + warp;
    const int word = (i0 >> 5) + wd;
    if (lane == 0 && word < p.W)
      p.words[g * p.W + word] = make_int2(static_cast<int>(m[q]), s_cnt[wd]);
  }
  // the representative blocks read last and words once every tile is done
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(p.tiles + p.n_tile + 1, 1ull);
}

// kArcRows x kScanThreads arcs: each target gene.
__device__ void prep_arcs(const PrepArgs& p, long long c) {
  const int64_t wmask = (int64_t(1) << p.B) - 1;
#pragma unroll
  for (int q = 0; q < kArcRows; ++q) {
    const long long a = (c * kArcRows + q) * kScanThreads + threadIdx.x;
    if (a >= p.A) continue;
    const int64_t vw = p.arc_vw[a];
    const int64_t tg = p.seg_gid[clampi((vw & wmask) >> 1, 0, p.S - 1)];
    p.tgt[a] = tg < 0 ? 0 : (tg > p.ng - 1 ? p.ng - 1 : tg);
  }
}

// kRepChunk genes x kRepChunk genomes of the representative planes: the
// last rows read and their values gathered genome-major (a warp a genome,
// lanes over the genes: nearby rows on collinear genomes), transposed in
// shared memory, the planes written gene-major.
__device__ void prep_reps(const PrepArgs& p, long long c) {
  __shared__ int32_t s_l[kRepChunk][kRepChunk + 1];
  __shared__ int32_t s_cid[kRepChunk][kRepChunk + 1];
  __shared__ int32_t s_rank[kRepChunk][kRepChunk + 1];
  __shared__ int64_t s_cm[kRepChunk][kRepChunk + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const unsigned long long* done = p.tiles + p.n_tile + 1;
    while (tile_load(done) < static_cast<unsigned long long>(p.n_tile))
      __nanosleep(128);
    __threadfence();
  }
  __syncthreads();
  const int q0 = static_cast<int>(c / p.rep_gc) * kRepChunk;
  const int g0 = static_cast<int>(c % p.rep_gc) * kRepChunk;
  for (int j = warp; j < kRepChunk; j += kScanWarps) {
    const int g = g0 + j, q = q0 + lane;
    if (g >= p.G || q >= p.ng) continue;
    const int l = __ldcg(p.last + static_cast<long long>(g) * p.ng + q) - 1;
    const int lc = l < 0 ? 0 : l;
    const long long b = static_cast<long long>(g) * p.H + lc;
    const int2 wd = __ldcg(p.words + static_cast<long long>(g) * p.W +
                           (lc >> 5));
    const unsigned mask = static_cast<unsigned>(wd.x);
    const int bit = lc & 31;
    s_l[j][lane] = l;
    s_cid[j][lane] = p.cid[b];
    s_cm[j][lane] = p.cm[b];
    // the kept rows before lc (row 0's rank when absent: -1 unless kept)
    s_rank[j][lane] = wd.y + __popc(mask & ((1u << bit) - 1u)) +
                      static_cast<int>((mask >> bit) & 1u) - 1;
  }
  __syncthreads();
  // a warp a gene, lanes over the genomes
  const int g = g0 + lane;
  for (int x = warp; x < kRepChunk; x += kScanWarps) {
    const int q = q0 + x;
    if (q >= p.ng || g >= p.G) continue;
    const long long o = static_cast<long long>(q) * p.G + g;
    p.r_pres[o] = s_l[lane][x] >= 0;
    p.r_cid[o] = s_cid[lane][x];
    p.r_cm[o] = s_cm[lane][x];
    p.r_rank[o] = s_rank[lane][x];
  }
}

__global__ void __launch_bounds__(kScanThreads)
branch_prep_kernel(PrepArgs p) {
  __shared__ long long s_t;
  if (threadIdx.x == 0)
    s_t = static_cast<long long>(atomicAdd(p.tiles + p.n_tile, 1ull));
  __syncthreads();
  const long long t = s_t;
  if (t < p.n_tile)
    prep_tile(p, t);
  else if (t < p.n_tile + p.n_arc)
    prep_arcs(p, t - p.n_tile);
  else
    prep_reps(p, t - p.n_tile - p.n_arc);
}

// ---------------------------------------------------------------------------
// prop_round and occ_round: the grid's counts without a memset
// ---------------------------------------------------------------------------

// The grid's end without a memset: each block adds, in one 64-bit atomic
// on *done, one to the blocks done (bits 48-63), its change bit (bits
// 32-47) and its count v (bits 0-31, its threads' sum). The block whose
// addition completes the grid has the totals (what the atomic returned
// plus its own) and sets *done back to zero, so the scratch is zeroed
// once, when it is allocated (and again by the wrapper after a failed
// launch), and holds zeros between calls and between a CUDA graph's
// replays. No fence: one address carries it all. Returns true in that
// block's thread 0 alone, with the total count and the change bit. Every
// thread of the block calls it; at most 65,535 blocks (kMaxGrid).
constexpr long long kMaxGrid = 65535;

__device__ bool grid_done(unsigned long long* done, unsigned v, bool changed,
                          unsigned long long& count, bool& any_changed) {
  __shared__ unsigned s_sum;
  __shared__ bool s_last;
  if (threadIdx.x == 0) s_sum = 0;
  __syncthreads();
  const unsigned w = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0 && w) atomicAdd(&s_sum, w);
  const bool ch = __syncthreads_or(changed);
  if (threadIdx.x == 0) {
    const unsigned long long mine =
        (1ull << 48) | (static_cast<unsigned long long>(ch) << 32) | s_sum;
    const unsigned long long old = atomicAdd(done, mine);
    s_last = (old >> 48) == gridDim.x - 1;
    if (s_last) {
      const unsigned long long tot = old + mine;
      count = tot & 0xffffffffull;
      any_changed = ((tot >> 32) & 0xffffull) != 0;
      atomicExch(done, 0ull);
    }
  }
  __syncthreads();
  return threadIdx.x == 0 && s_last;
}

// ---------------------------------------------------------------------------
// prop_round
// ---------------------------------------------------------------------------

constexpr int kRowVec = 16;      // row-wise passes: rows a thread, 16 bytes
constexpr int kPropBlocksPerSm = 5;   // prop_round: 48 registers

struct PropArgs {
  uint8_t* weak;           // [G, H] cs order, in place
  uint8_t* flt;
  const uint8_t* valid;
  long long n;             // G * H
  int H, T;                // T: tiles a genome
  const int32_t* ordcm;    // [G, H] cm order
  const int32_t* pair_arc; // [G, 2H]: each pair slot's arc row
  const int32_t* nxt;      // [G, H]
  const uint8_t* pair_ok;  // [G, H]
  const uint8_t* arc_weak; // [A]
  long long A;
  unsigned long long* word;   // (n_prop, changed), set
  unsigned long long* acc;    // scratch: grid_done's word
};

__device__ __forceinline__ int arc_mark(const PropArgs& p, int32_t row) {
  return p.arc_weak[row < 0 ? 0 : (row > p.A - 1 ? p.A - 1 : row)];
}

__device__ __forceinline__ void set_word(const PropArgs& p, unsigned n_prop,
                                         bool changed) {
  unsigned long long n = 0;
  bool ch = false;
  if (grid_done(p.acc, n_prop, changed, n, ch)) {
    p.word[0] = n;
    p.word[1] = ch;
  }
}

// One tile of a genome's cm positions a block: every load of the tile
// first (the pair planes at its cm positions), then what they address (the
// arc marks, weak, flt and valid at the cs rows: ordcm is nearly the
// identity, so a warp's 32 rows fall in one or two sectors and the reads
// coalesce), each pair slot's forward mark once into shared memory; a
// position's next pair nxt is read there when it falls in the tile (all but
// the tile's last kept row), else from global memory.
__global__ void __launch_bounds__(kScanThreads, kPropBlocksPerSm)
prop_round_kernel(PropArgs p) {
  __shared__ uint8_t s_fwd[kScanTile];
  const long long tile = blockIdx.x;
  const long long g = tile / p.T;
  const int i0 = static_cast<int>(tile - g * p.T) * kScanTile;
  const int H = p.H;
  const long long base = g * H;
  const int32_t* arc = p.pair_arc + 2 * base;
  // the loads of the tile, into registers (none waits on another); the
  // last thread also reads the next tile's first pair slot, the next pair
  // of the tile's last row when that row and the next are kept
  int r[kScanRows], j[kScanRows], af[kScanRows], ar[kScanRows];
  bool ok[kScanRows];
  const int i_next = i0 + kScanTile;
  bool ok_next = false;
  int arc_next = 0;
  if (threadIdx.x == kScanThreads - 1 && i_next < H) {
    ok_next = p.pair_ok[base + i_next] != 0;
    arc_next = arc[i_next];
  }
#pragma unroll
  for (int q = 0; q < kScanRows; ++q) {
    const int i = i0 + q * kScanThreads + static_cast<int>(threadIdx.x);
    r[q] = i;
    j[q] = -1;
    af[q] = ar[q] = 0;
    ok[q] = false;
    if (i < H) {
      r[q] = p.ordcm[base + i];
      ok[q] = p.pair_ok[base + i] != 0;
      af[q] = arc[i];
      ar[q] = arc[H + i];
      j[q] = p.nxt[base + i];
    }
  }
  // what they address: the arc marks, the state at the cs rows, a next
  // pair past the tile
  int mf[kScanRows], m[kScanRows];
  uint8_t w0[kScanRows], f0[kScanRows], v0[kScanRows];
#pragma unroll
  for (int q = 0; q < kScanRows; ++q) {
    const bool row = i0 + q * kScanThreads + static_cast<int>(threadIdx.x) < H;
    mf[q] = ok[q] ? arc_mark(p, af[q]) : 0;
    m[q] = ok[q] ? arc_mark(p, ar[q]) : 0;
    w0[q] = f0[q] = v0[q] = 0;
    if (row) {
      w0[q] = p.weak[base + r[q]];
      f0[q] = p.flt[base + r[q]];
      v0[q] = p.valid[base + r[q]];
    }
    if (j[q] >= 0) {
      const int jc = j[q] < H ? j[q] : H - 1;
      if (static_cast<unsigned>(jc - i0) >= static_cast<unsigned>(kScanTile)) {
        const bool okj = jc == i_next && threadIdx.x == kScanThreads - 1
                             ? ok_next : p.pair_ok[base + jc] != 0;
        const int aj = jc == i_next && threadIdx.x == kScanThreads - 1
                           ? arc_next : arc[jc];
        const int f = okj ? arc_mark(p, aj) : 0;
        m[q] = f > m[q] ? f : m[q];
        j[q] = -1;
      } else {
        j[q] = jc;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kScanRows; ++q)
    s_fwd[q * kScanThreads + threadIdx.x] = static_cast<uint8_t>(mf[q]);
  __syncthreads();
  unsigned n_prop = 0;
  bool changed = false;
#pragma unroll
  for (int q = 0; q < kScanRows; ++q) {
    if (i0 + q * kScanThreads + static_cast<int>(threadIdx.x) >= H) continue;
    int mk = m[q];
    if (j[q] >= 0) {
      const int fj = s_fwd[j[q] - i0];
      mk = fj > mk ? fj : mk;
    }
    int w = w0[q];
    if (mk > w) {
      p.weak[base + r[q]] = static_cast<uint8_t>(mk);
      w = mk;
      changed = true;
    }
    if (w == 2 && f0[q] == 0) {
      p.flt[base + r[q]] = 1;
      changed = true;
    }
    n_prop += (w != 0) & (v0[q] != 0);
  }
  set_word(p, n_prop, changed);
}

// The call without propagation (round 0): the weak == 2 filter and n_prop
// row by row, kRowVec rows a thread, 16-byte loads when kVec.
template <bool kVec>
__global__ void __launch_bounds__(kScanThreads) prop_filter_kernel(PropArgs p) {
  const long long r0 =
      (static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x) *
      kRowVec;
  unsigned n_prop = 0;
  bool changed = false;
  if (kVec && r0 + kRowVec <= p.n) {
    const uint4 w4 = *reinterpret_cast<const uint4*>(p.weak + r0);
    const uint4 v4 = *reinterpret_cast<const uint4*>(p.valid + r0);
    uint4 f4 = *reinterpret_cast<const uint4*>(p.flt + r0);
    const uint8_t* w = reinterpret_cast<const uint8_t*>(&w4);
    const uint8_t* v = reinterpret_cast<const uint8_t*>(&v4);
    uint8_t* f = reinterpret_cast<uint8_t*>(&f4);
#pragma unroll
    for (int b = 0; b < kRowVec; ++b) {
      if (w[b] == 2 && f[b] == 0) {
        f[b] = 1;
        changed = true;
      }
      n_prop += (w[b] != 0) & (v[b] != 0);
    }
    if (changed) *reinterpret_cast<uint4*>(p.flt + r0) = f4;
  } else {
    const long long r1 = r0 + kRowVec < p.n ? r0 + kRowVec : p.n;
    for (long long r = r0; r < r1; ++r) {
      const int w = p.weak[r];
      if (w == 2 && p.flt[r] == 0) {
        p.flt[r] = 1;
        changed = true;
      }
      n_prop += (w != 0) & (p.valid[r] != 0);
    }
  }
  set_word(p, n_prop, changed);
}

// ---------------------------------------------------------------------------
// occ_round
// ---------------------------------------------------------------------------

constexpr int kSegBlock = 64;    // segments a block (a multiple of 32)
constexpr int kRunKeys = 4;      // arcs a thread reads a step of the runs
constexpr int kRunChunk = kScanThreads * kRunKeys;
constexpr int kOccBlocksPerSm = 4;        // occ_round: 64 registers

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
  long long n_seg;         // segment blocks (the hit blocks follow)
};

// The source vertex of arc a, past every vertex for an empty slot.
__device__ __forceinline__ long long arc_key(const OccArgs& p, long long a) {
  const int64_t vw = p.arc_vw[a];
  return vw == kSent ? (1ll << 62) : (vw >> p.B);
}

constexpr int kHalf = kScanThreads / 2;    // a lower bound's probes

// This thread's first probe of block_lower_bounds, the same for every
// block: read before the block has its ticket.
__device__ __forceinline__ long long first_probe(const OccArgs& p) {
  const int t = threadIdx.x % kHalf;
  const long long step = (p.A + kHalf - 1) / kHalf;
  const long long pos = step * t + step - 1;
  return pos < p.A ? arc_key(p, pos) : 0;
}

// The first arcs of the v-sorted table (valid arcs first) whose source
// vertices are >= x[0] and >= x[1] (A when none), into s_b[0], s_b[1]: half
// the block's threads probe each bound, kHalf probes a step, so three
// dependent reads at the north star's 831,488 arcs, the first (k1, this
// thread's first_probe) made before the block's ticket. Every thread calls
// it.
__device__ void block_lower_bounds(const OccArgs& p, const long long (&x)[2],
                                   long long k1, long long (&s_b)[2][2]) {
  constexpr int kWarps = kHalf / 32;
  __shared__ unsigned s_m[2][kWarps];
  const int h = threadIdx.x >= kHalf, t = threadIdx.x - h * kHalf;
  if (t == 0) {
    s_b[h][0] = 0;
    s_b[h][1] = p.A;
  }
  __syncthreads();
  for (bool first = true;; first = false) {
    const long long lo = s_b[h][0], hi = s_b[h][1];
    const long long o_lo = s_b[!h][0], o_hi = s_b[!h][1];
    if (hi <= lo && o_hi <= o_lo) break;    // both found: uniform
    const long long step = (hi - lo + kHalf - 1) / kHalf;
    const long long pos = lo + step * t + step - 1;
    const bool ge = hi <= lo || pos >= hi ||
                    (first ? k1 : arc_key(p, pos)) >= x[h];
    const unsigned m = __ballot_sync(kFull, ge);
    if ((t & 31) == 0) s_m[h][t >> 5] = m;
    __syncthreads();
    if (t == 0 && hi > lo) {
      int f = -1;
      for (int k = 0; k < kWarps && f < 0; ++k)
        if (s_m[h][k]) f = 32 * k + __ffs(s_m[h][k]) - 1;
      if (f < 0) {
        s_b[h][0] = hi;                      // every probe below: hi
      } else {
        const long long pf = lo + step * f + step - 1;
        s_b[h][0] = lo + step * f;
        s_b[h][1] = pf < hi ? pf : hi;
      }
    }
    __syncthreads();
  }
}

// kSegBlock segments: each strand's degree and loci, the deletion, the
// capture rows, the counts. A vertex's arcs are one run of the v-sorted
// table and n_grp is non-zero only at a run's first arc, so its degree is
// the run's length and its loci the n_grp there: the block finds its arcs
// by two lower bounds, reads their vertices kRunChunk at a time into
// shared memory and marks each run's first arc and end; no atomic,
// nothing to zero.
__device__ void occ_segs(const OccArgs& p, long long c, long long k1,
                         unsigned (&v)[4], bool& changed) {
  __shared__ int s_start[2 * kSegBlock], s_stop[2 * kSegBlock];
  __shared__ int s_key[kRunChunk + 1];
  __shared__ long long s_b[2][2];
  const int s0 = static_cast<int>(c * kSegBlock);
  const int ns = p.S - s0 < kSegBlock ? p.S - s0 : kSegBlock;
  const int s = s0 + threadIdx.x;
  const bool mine = static_cast<int>(threadIdx.x) < ns;
  bool al = false;
  int32_t tot = 0, l0 = 0, l1 = 0;
  if (mine) {
    al = p.alive[s] != 0;
    tot = p.seg_tot[s];
    if (!p.n_grp) {
      l0 = p.loci[2 * s];
      l1 = p.loci[2 * s + 1];
    }
  }
  int d0 = 0, d1 = 0;
  if (p.n_grp || p.do_occ) {
    for (int x = threadIdx.x; x < 2 * kSegBlock; x += blockDim.x)
      s_start[x] = s_stop[x] = 0;
    const long long v0 = 2ll * s0, x[2] = {v0, v0 + 2 * ns};
    block_lower_bounds(p, x, k1, s_b);
    const long long lo = s_b[0][0], hi = s_b[1][0];
    // each arc's vertex less v0, or -1 past the block's vertices
    auto rel = [&](long long a) {
      const long long k = a < hi ? arc_key(p, a) - v0 : -1;
      return k >= 0 && k < 2 * ns ? static_cast<int>(k) : -1;
    };
    for (long long c0 = lo; c0 < hi; c0 += kRunChunk) {
      int k[kRunKeys];
#pragma unroll
      for (int q = 0; q < kRunKeys; ++q)
        k[q] = rel(c0 + q * kScanThreads + threadIdx.x);
      const int kl = threadIdx.x == 0 ? rel(c0 + kRunChunk) : -1;
#pragma unroll
      for (int q = 0; q < kRunKeys; ++q)
        s_key[q * kScanThreads + threadIdx.x] = k[q];
      if (threadIdx.x == 0) s_key[kRunChunk] = kl;
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kRunKeys; ++q) {
        const int xi = q * kScanThreads + threadIdx.x;
        const long long a = c0 + xi;
        const int kn = s_key[xi + 1];
        if (a >= hi || k[q] < 0) continue;   // not v-sorted: no run
        if (a == lo) s_start[k[q]] = 0;
        if (kn != k[q]) {
          s_stop[k[q]] = static_cast<int>(a + 1 - lo);
          if (kn >= 0) s_start[kn] = static_cast<int>(a + 1 - lo);
        }
      }
      __syncthreads();
    }
    if (mine) {
      const int xs = 2 * threadIdx.x;
      d0 = s_stop[xs] - s_start[xs];
      d1 = s_stop[xs + 1] - s_start[xs + 1];
      if (p.n_grp) {
        l0 = d0 > 0 ? p.n_grp[lo + s_start[xs]] : 0;
        l1 = d1 > 0 ? p.n_grp[lo + s_start[xs + 1]] : 0;
        p.loci[2 * s] = l0;
        p.loci[2 * s + 1] = l1;
      }
    }
  }
  bool del = false;
  if (mine && p.do_occ) {
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
  } else if (!p.do_occ) {
    d0 = d1 = 0;
  }
  // the block's segments alive after the deletion, a word a warp, for the
  // hit blocks (written once a call, read only after every segment block
  // is done: plain cached reads see them)
  if (static_cast<int>(threadIdx.x) < kSegBlock) {
    const unsigned bits = __ballot_sync(kFull, al);
    if ((threadIdx.x & 31) == 0) p.alive_bits[(s0 + threadIdx.x) >> 5] = bits;
  }
  if (!mine) return;
  v[3] += al;
  p.mask_row[s] = del;
  p.deg_row[2 * s] = d0;
  p.deg_row[2 * s + 1] = d1;
  p.loci_row[2 * s] = l0;
  p.loci_row[2 * s + 1] = l1;
  p.tot_row[s] = tot;
}

// Hits of dead genes leave the walk (PG_SET_FILTER(vtx == 0)): kRowVec
// rows a thread (16-byte loads of valid and flt, int4 of gid when kVec),
// read with their genes' segments before the block waits for the segment
// blocks (earlier tickets, so running or done blocks), then the segments'
// alive bits.
template <bool kVec>
__device__ void occ_hits(const OccArgs& p, long long c, bool& changed) {
  const long long r0 =
      (c * kScanThreads + threadIdx.x) * static_cast<long long>(kRowVec);
  const int nr = p.n - r0 < kRowVec ? static_cast<int>(p.n - r0) : kRowVec;
  uint4 f4 = make_uint4(0, 0, 0, 0), v4 = make_uint4(0, 0, 0, 0);
  int32_t sh[kRowVec];
  uint8_t* f = reinterpret_cast<uint8_t*>(&f4);
  uint8_t* va = reinterpret_cast<uint8_t*>(&v4);
  if (kVec && nr == kRowVec) {
    f4 = *reinterpret_cast<const uint4*>(p.flt + r0);
    v4 = *reinterpret_cast<const uint4*>(p.valid + r0);
#pragma unroll
    for (int b = 0; b < kRowVec / 4; ++b) {
      const int4 g = reinterpret_cast<const int4*>(p.gid + r0)[b];
      sh[4 * b] = g.x;
      sh[4 * b + 1] = g.y;
      sh[4 * b + 2] = g.z;
      sh[4 * b + 3] = g.w;
    }
  } else {
#pragma unroll
    for (int b = 0; b < kRowVec; ++b) {
      const bool in = b < nr;
      f[b] = in ? p.flt[r0 + b] : 1;
      va[b] = in ? p.valid[r0 + b] : 0;
      sh[b] = in ? p.gid[r0 + b] : 0;
    }
  }
  // each live hit's gene's segment
#pragma unroll
  for (int b = 0; b < kRowVec; ++b)
    sh[b] = va[b] && !f[b] ? p.sid_of[clampi(sh[b], 0, p.ng - 1)] : 0;
  if (threadIdx.x == 0) {
    while ((tile_load(p.acc) >> 48) < static_cast<unsigned long long>(p.n_seg))
      __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
  bool hit = false;
#pragma unroll
  for (int b = 0; b < kRowVec; ++b) {
    if (!va[b] || f[b]) continue;
    const int a = clampi(sh[b], 0, p.S - 1);
    if (sh[b] < 0 || !((p.alive_bits[a >> 5] >> (a & 31)) & 1u)) {
      f[b] = 1;
      hit = true;
    }
  }
  if (!hit) return;
  changed = true;
  if (kVec && nr == kRowVec) {
    *reinterpret_cast<uint4*>(p.flt + r0) = f4;
  } else {
    for (int b = 0; b < nr; ++b) p.flt[r0 + b] = f[b];
  }
}

// One launch: blocks take tickets, the segment blocks first, then the hit
// blocks (do_occ), which wait until every segment block is done (grid_done's
// count); a segment block adds its four counts (behind a fence, with its
// stores to alive) before it counts itself done. The block done last sets
// the log row and ORs the change bit into word[1].
template <bool kVec>
__global__ void __launch_bounds__(kScanThreads, kOccBlocksPerSm)
occ_round_kernel(OccArgs p) {
  __shared__ long long s_t;
  if (threadIdx.x == 0)
    s_t = static_cast<long long>(atomicAdd(p.acc + 5, 1ull));
  const long long k1 = p.n_grp || p.do_occ ? first_probe(p) : 0;
  __syncthreads();
  const long long t = s_t;
  unsigned v[4] = {0, 0, 0, 0};
  bool changed = false;
  if (t < p.n_seg) {
    __shared__ unsigned s_v[4];
    if (threadIdx.x < 4) s_v[threadIdx.x] = 0;
    occ_segs(p, t, k1, v, changed);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned w = __reduce_add_sync(kFull, v[q]);
      if ((threadIdx.x & 31) == 0 && w) atomicAdd(&s_v[q], w);
    }
    __syncthreads();
    if (threadIdx.x < 4 && s_v[threadIdx.x])
      atomicAdd(p.acc + 1 + threadIdx.x,
                static_cast<unsigned long long>(s_v[threadIdx.x]));
    // the block's stores and counts, before it counts itself done
    __threadfence();
  } else {
    occ_hits<kVec>(p, t - p.n_seg, changed);
  }
  unsigned long long n = 0;
  bool ch = false;
  if (grid_done(p.acc, 0, changed, n, ch)) {
    __threadfence();
#pragma unroll
    for (int q = 0; q < 4; ++q) p.log_row[q] = atomicExch(p.acc + 1 + q, 0ull);
    if (ch) p.word[1] = 1;
    atomicExch(p.acc + 5, 0ull);
  }
}

inline int err_of(cudaError_t e) { return static_cast<int>(e); }

}  // namespace

// Bytes of walk_pairs' scratch, zeroed by pg_walk_pairs: the segment
// counters (seg_tot, seg_ng [S] int32), the genome bits ([(G + 31) / 32,
// S] uint32: a warp's consecutive segments at consecutive words), then at
// the next 8 bytes the tiles' status words and the ticket.
extern "C" long long pg_walk_pairs_scratch(long long G, int H, int S) {
  const long long seg = (4 * S * (2 + (G + 31) / 32) + 7) / 8 * 8;
  return seg + 8 * (scan_tiles(G, H) + 1);
}

// The walk of this rank's G genomes (walk_pairs in ops/loop_kernels.py):
// one memset of the scratch (pg_walk_pairs_scratch), then one block a tile
// of a genome's rows. s21 and dist2 (null or both given) select the full
// mode.
extern "C" int pg_walk_pairs(
    const void* ordcm, const void* valid, const void* cid, const void* cm,
    const void* w, const void* seg, const void* so, const void* sd,
    const void* dg, const void* dsid, const void* flt, const void* shadow,
    const void* alive, int G, int H, int S, int B, int GB, int jb,
    long long rank, int use_ori, void* keys, void* s12, void* pair_ok,
    void* nxt, void* scratch, void* s21, void* dist2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0, pg_walk_pairs_scratch(G, H, S), st);
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
  p.T = static_cast<int>(scan_tiles(1, H));
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
  p.seg_tot = static_cast<int32_t*>(scratch);
  p.seg_ng = p.seg_tot + S;
  p.seen = reinterpret_cast<uint32_t*>(p.seg_ng + S);
  p.ntiles = scan_tiles(G, H);
  p.tiles = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + pg_walk_pairs_scratch(G, H, S)) -
      (p.ntiles + 1);
  p.s21 = static_cast<int32_t*>(s21);
  p.dist2 = static_cast<int32_t*>(dist2);
  if (s21)
    walk_pairs_kernel<true><<<p.ntiles, kScanThreads, 0, st>>>(p);
  else
    walk_pairs_kernel<false><<<p.ntiles, kScanThreads, 0, st>>>(p);
  return err_of(cudaGetLastError());
}

namespace {

// Bytes of branch_prep's zeroed scratch: the tiles' status words, the
// ticket and the count of tiles done (8 bytes each), then the [G, n_gene]
// last rows (int32).
long long prep_scratch_words(long long G, int H, int ng) {
  return 8 * (scan_tiles(G, H) + 2) + 4 * G * ng;
}

}  // namespace

// Bytes of branch_prep's scratch: what pg_branch_prep zeroes (the status
// words, the ticket, the counts of tiles done, the [G, n_gene] last rows),
// then at the next 8 bytes the [G, (H + 31) / 32] words (mask, count).
extern "C" long long pg_branch_prep_scratch(long long G, int H, int ng) {
  return (prep_scratch_words(G, H, ng) + 7) / 8 * 8 +
         8 * G * ((H + 31LL) / 32);
}

// The branch block's prelude (branch_prep in ops/loop_kernels.py): one
// memset (pg_branch_prep_scratch), then one launch whose blocks take the
// genomes' tiles, the arc blocks and the representative blocks in order
// from a ticket.
extern "C" int pg_branch_prep(
    const void* flt, const void* shadow, const void* valid, const void* gid,
    const void* cid, const void* cm, int G, int H, int ng,
    const void* arc_vw, long long A, const void* seg_gid, int S, int B,
    void* r_pres, void* r_cid, void* r_cm, void* r_rank, void* tgt,
    void* scratch, void* stream) {
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
  p.r_pres = static_cast<uint8_t*>(r_pres);
  p.r_cid = static_cast<int32_t*>(r_cid);
  p.r_cm = static_cast<int64_t*>(r_cm);
  p.r_rank = static_cast<int32_t*>(r_rank);
  p.tgt = static_cast<int64_t*>(tgt);
  p.T = static_cast<int>(scan_tiles(1, H));
  p.W = (H + 31) / 32;
  p.n_tile = scan_tiles(G, H);
  p.n_arc = (A + kArcRows * kScanThreads - 1) / (kArcRows * kScanThreads);
  p.rep_gc = (G + kRepChunk - 1) / kRepChunk;
  char* s = static_cast<char*>(scratch);
  const long long words_at = prep_scratch_words(G, H, ng);
  p.tiles = reinterpret_cast<unsigned long long*>(s);
  p.last = reinterpret_cast<int32_t*>(s + words_at) - 1LL * G * ng;
  p.words = reinterpret_cast<int2*>(s + (words_at + 7) / 8 * 8);
  const cudaError_t e = cudaMemsetAsync(scratch, 0, words_at, st);
  if (e != cudaSuccess) return err_of(e);
  if (G <= 0 || H <= 0) return 0;
  const long long blocks = p.n_tile + p.n_arc +
      static_cast<long long>(p.rep_gc) * ((ng + kRepChunk - 1) / kRepChunk);
  branch_prep_kernel<<<blocks, kScanThreads, 0, st>>>(p);
  return err_of(cudaGetLastError());
}

// Bytes of prop_round's and occ_round's scratch for S segments: zeroed
// when allocated; its counters are left zeroed by every call that
// completes. prop_round's grid_done word first; from the fifth word
// occ_round's: its grid_done word, the four counts of the log row, the
// ticket; from the seventeenth the segments' alive bits (rewritten by
// every call).
extern "C" long long pg_round_scratch(int S) {
  return 16 * 8 + (S > 0 ? (S + 63) / 64 * 8 : 0);
}

namespace {

constexpr int kPropWords = 0, kOccWords = 4;

bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

long long row_blocks(long long n) {
  const long long b = (n + kScanThreads * kRowVec - 1) / (kScanThreads * kRowVec);
  return b < 1 ? 1 : b;
}

}  // namespace

// Weak propagation and the weak == 2 filter (prop_round in
// ops/loop_kernels.py): one launch, no memset; word (n_prop, changed) is
// set by the block done last. Without `propagate` the pair state is not
// read: a row-wise pass.
extern "C" int pg_prop_round(void* weak, void* flt, const void* valid,
                             long long G, int H, int propagate,
                             const void* ordcm, const void* pair_arc,
                             const void* nxt, const void* pair_ok,
                             const void* arc_weak, long long A, void* word,
                             void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PropArgs p = {};
  p.weak = static_cast<uint8_t*>(weak);
  p.flt = static_cast<uint8_t*>(flt);
  p.valid = static_cast<const uint8_t*>(valid);
  p.n = G > 0 && H > 0 ? G * H : 0;
  p.H = H;
  p.T = static_cast<int>(scan_tiles(1, H));
  p.ordcm = static_cast<const int32_t*>(ordcm);
  p.pair_arc = static_cast<const int32_t*>(pair_arc);
  p.nxt = static_cast<const int32_t*>(nxt);
  p.pair_ok = static_cast<const uint8_t*>(pair_ok);
  p.arc_weak = static_cast<const uint8_t*>(arc_weak);
  p.A = A;
  p.word = static_cast<unsigned long long*>(word);
  p.acc = static_cast<unsigned long long*>(scratch) + kPropWords;
  const bool prop = propagate && A > 0 && p.n > 0;
  if ((prop ? G * p.T : row_blocks(p.n)) > kMaxGrid)
    return err_of(cudaErrorInvalidConfiguration);
  if (prop)
    prop_round_kernel<<<G * p.T, kScanThreads, 0, st>>>(p);
  else if (aligned16(weak, flt, valid))
    prop_filter_kernel<true><<<row_blocks(p.n), kScanThreads, 0, st>>>(p);
  else
    prop_filter_kernel<false><<<row_blocks(p.n), kScanThreads, 0, st>>>(p);
  return err_of(cudaGetLastError());
}

// The occ block of round r (occ_round in ops/loop_kernels.py): one launch,
// no memset; the segment blocks (with the loci from n_grp when given, the
// deletion when do_occ), then, when do_occ, the hit blocks. The log row is
// set and the change bit OR'd into word[1] by the block done last.
extern "C" int pg_occ_round(
    void* alive, void* flt, const void* valid, const void* gid,
    const void* sid_of, int ng, long long n, const void* arc_vw,
    long long A, int B, int S, const void* seg_tot, void* loci,
    const void* n_grp, int do_occ, long long occ_cut, int deg_cut,
    int loci_cut, void* log_row, void* mask_row, void* deg_row,
    void* loci_row, void* tot_row, void* word, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
  p.acc = static_cast<unsigned long long*>(scratch) + kOccWords;
  p.alive_bits = reinterpret_cast<uint32_t*>(
      static_cast<unsigned long long*>(scratch) + 16);
  if (S <= 0 || A <= 0) return err_of(cudaErrorInvalidValue);
  p.n_seg = (S + kSegBlock - 1) / kSegBlock;
  const long long blocks = p.n_seg + (do_occ && n > 0 ? row_blocks(n) : 0);
  if (blocks > kMaxGrid) return err_of(cudaErrorInvalidConfiguration);
  if (aligned16(flt, valid, gid))
    occ_round_kernel<true><<<blocks, kScanThreads, 0, st>>>(p);
  else
    occ_round_kernel<false><<<blocks, kScanThreads, 0, st>>>(p);
  return err_of(cudaGetLastError());
}
