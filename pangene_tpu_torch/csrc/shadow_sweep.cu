// Shadow / isoform overlap sweep over the cs-sorted hits of one genome,
// for Hopper (sm_90a). Bound to Python with ctypes (ops/sweep_kernel.py),
// which also holds the plain PyTorch version this kernel is tested against.
//
// What it replaces: the TPU Pallas kernel pangene_tpu/ops/pallas_sweep.py
// (_kernel, the shadow sweep; mode SHADOW) and the XLA sweep
// pangene_tpu/ops/device.py:ov_isoform_kernel (mode ISOFORM); both are held
// against pangene_tpu/ops/device.py:shadow_kernel / ov_isoform_kernel.
//
// Function: for every pair (j, i), i - W <= j < i, that passes the gates
// (same contig, ce_j > cs_i, both unfiltered, optional same strand, exact
// exon intersection ov > 0; SHADOW: same gene or ov/min(len) >= f; ISOFORM:
// same gene) one hit loses. Per loser: a mark and the dominator argmax
// (max winner score, ties to the smallest winner index) with its ov.
//
// What bounds it on the H100: neither bytes nor operations but latency. A
// 20k-hit genome is ~2.3 MB of columns (0.7 us at 3.35 TB/s) and a few
// million integer operations (under 0.5 us on the INT32 lanes), so the
// kernel's time is set by dependent memory round trips, by barriers, and by
// lanes that wait for the slowest lane of their warp. The first version (one
// thread per hit walking its band through global memory) gave less than one
// wave of blocks and 2W dependent pair evaluations per thread, each pair
// evaluated from both ends.
//
// Design:
//  * Tiles. Block p owns the loser rows [r0, r0 + kRows). When W <=
//    kBandTile it stages rows [r0 - W, r0 + kRows + W) (clipped to [0, n))
//    of every column into shared memory, one row a thread (coalesced), and
//    then the exons of those rows, flat over an exclusive prefix of their
//    n_exon (the exon pool is not in hit order), several loads a thread in
//    flight. kRows = 64 and 256 threads give ceil(n / 64) blocks, 322-328
//    for a 20k-hit genome; at most 85 registers a thread keep 3 blocks on
//    each of the 132 SMs, so all of them are resident in one wave.
//  * Each pair once. Phase 1a: the block's threads take the tile's pairs
//    (j, i), 0 < i - j <= W, with at least one row owned, neighbouring
//    threads on neighbouring rows of one band offset, through the cheap
//    gates; the survivors are queued in shared memory (one atomic a warp).
//    Phase 1b: each thread takes a queued pair and intersects its exons, the
//    shorter list held in registers, then __ddiv_rn for cross-gene SHADOW
//    pairs. Without the queue every warp of every round waited for its one
//    lane with exon work; that was most of the time. A pair's outcome goes
//    to the loser's candidate slot in shared memory, [2 * band chunk][kRows]
//    (left winners j = r - d, then right winners i = r + d). Phase 2: one
//    thread per owned row folds its slots. Every candidate of a row has a
//    distinct winner index, so neither the queue's order nor the fold's can
//    change the lexicographic result: no cross-block merge, deterministic. A
//    pair that straddles two tiles is evaluated by both blocks, each keeping
//    only its own loser.
//  * Coordinates. A pair whose two rows' exons are staged, whose tile's
//    exon offsets all lie in (-2^29, 2^29) and whose cs differ by less than
//    2^29 intersects its exons in int32 relative to cs_i (every value stays
//    in (-2^30, 2^30), every difference below 2^31); any other pair takes
//    the int64 loop. Both are exact. scripts/torch_sweep_ablation.py times
//    this path against int64 alone (with and without the register list).
//  * Large W and long exon lists: a second path of the same kernel. A tile
//    whose staged exons exceed kExonsPerRow per staged row reads its exons
//    from the global CSR pool. For W > kBandTile the block stages only its
//    own rows, reads the halo rows from global memory (L2) and walks the
//    band in chunks of kBandTile offsets, folding each chunk's slots into
//    per-row registers, so shared memory stays bounded for any W.
//
// Exactness: the coverage gate is IEEE round-to-nearest f64 division
// (__ddiv_rn), the reference's own arithmetic, so every ratio f is exact.
// Do not build with --use_fast_math. Scores are the biased int64 packed
// scores, compared signed; SCORE_NONE / OTHER_NONE mark "no dominator".
//
// Input and output are one packed buffer each (ops/sweep_kernel.py:
// pack_layout, out_layout): every column at a 16-byte-aligned byte offset.
//
// The batched entry (pg_shadow_sweep_round) runs mode SHADOW over the
// H-padded [G, H] columns that the device-resident pruning loop and the
// per-round step keep on the card (parallel/device_loop.py,
// parallel/stacked.py), all genomes in one launch; genome g's hits are rows
// [0, n_rows[g]) of its plane and its exons row g of the [G, E] pools, so no
// tile crosses a genome; rows past n_rows[g] come back unmarked with no
// dominator. It replaces the XLA pair pangene_tpu/ops/device.py:
// sweep_geo_planes + shadow_round_kernel. The per-genome tile (64 owned
// rows) was shaped for one wave of one genome; on the loop's 64 x 10,240
// columns it made 26 waves of blocks, each a latency chain (stage rows,
// exon prefix, stage exons, four barriers) for about 512 pairs. So the
// batched entry runs the same tile code (sweep_tile) on its own shape:
//  * kBatchRows = 256 owned rows a tile, 384 threads, the band in passes of
//    at most kBatchChunk offsets (the slots stay small): the staging, the
//    prefix and the barriers are paid over four times the pairs;
//  * a persistent grid (the blocks resident at once) loops over the
//    (genome, tile) items; an item past its genome's rows stages nothing;
//  * two row buffers: while one item's band passes run, the next item's
//    rows are copied into the other by cp.async (the byte columns through
//    registers), so its first global round trip is off the chain.
// The pairs, the gates, the int32 / int64 exon paths, the large-W path
// and the argmax are the per-genome tile's, so the exactness argument is
// the same.
//
// The batched entry's epilogue, a compile-time mode of the same kernel
// (the per-genome entry's kEpiNone writes the three planes marks, score,
// other). Where one thread holds a row's final (mark, best score, best
// other), the row's round update is applied there instead of writing three
// [G, H] planes (13 bytes a row) that a chain of about a dozen torch
// operations read back:
//  * LOOP (the device loop's sweep block, JAX
//    pangene_tpu/parallel/device_loop.py:758-775): the stale-flag merge
//    shadow = evaluated ? mark : (shadow != 0) | mark, evaluated = unfiltered
//    & ev1 & r < n, and pid_dom = pid[clamp(other)] where an unfiltered row
//    has a dominator (biased score > kScoreNone, JAX's b_score > 0), -1
//    where an unfiltered row has none, unchanged where it is filtered.
//    Nothing else is written.
//  * STEP (the per-round step, JAX pangene_tpu/parallel/stacked.py:72-75):
//    the same stale-flag merge with evaluated = unfiltered & r >= 1 & r < n,
//    the dominator's score and index (the host reads them), and the step's
//    (cid, cm) sort key: cid << 44 | cm, 2^62 past n (stacked.py:78-79).
// Rows past n (padding) get the update too, with no mark and no dominator,
// as the JAX epilogue gives them. shadow and pid_dom are updated in place:
// the sweep never reads either (its inputs are the columns, flt and weak),
// and each row is read and written by the one thread that owns it. On a
// zeroed shadow plane STEP leaves each row's mark in it (the merge of a 0
// is the mark), so the three planes of the batched sweep are STEP's
// shadow, score and other; there is no entry without an epilogue.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kShadow = 0;
constexpr int kIsoform = 1;
constexpr int kThreads = 256;      // per-genome entry: threads a block
constexpr int kRows = 64;          // owned loser rows per block
constexpr int kBandTile = 32;      // largest W whose halo is staged
constexpr int kExonsPerRow = 12;   // staged-exon room per staged row
constexpr int kRegExons = 8;       // exon lists held in registers
// 3 resident blocks of 256 threads a SM (<= 85 registers a thread): 396
// block slots on 132 SMs, one wave for genomes up to 25k hits.
constexpr int kMinBlocksPerSM = 3;
// The batched entry: a tile of four times the owned rows, band offsets in
// passes of at most kBatchChunk, 2 resident blocks of 384 threads a SM
// (<= 85 registers a thread), each looping over (genome, tile) items.
constexpr int kBatchThreads = 384;
constexpr int kBatchRows = 256;
constexpr int kBatchChunk = 8;
constexpr int kBatchBlocksPerSM = 2;
constexpr int kNarrow = 1 << 29;
constexpr int64_t kScoreNone = -9223372036854775807LL - 1;  // biased raw 0
constexpr int32_t kOtherNone = 2147483647;
// The batched entry's epilogue modes (ops/sweep_kernel.py: EPI_*).
constexpr int kEpiNone = 0;   // the per-genome entry's three planes
constexpr int kEpiLoop = 1;   // the device loop's shadow and pid_dom
constexpr int kEpiStep = 2;   // the per-round step's shadow, score, other
constexpr int kStepKeyBits = 44;                    // cid << 44 | cm
constexpr int64_t kStepKeyPad = 4611686018427387904LL;  // 2^62: past n

// The launch shape of one entry: owned rows of a tile, threads of a block.
template <int kRowsT, int kThreadsT>
struct Shape {
  static constexpr int rows = kRowsT;
  static constexpr int threads = kThreadsT;
  static_assert(kRowsT + 2 * kBandTile < kThreadsT,
                "one staged row per thread in the exon prefix, plus its end");
  static_assert(kRowsT <= kThreadsT, "one thread per owned row in phase 2");
  static_assert(kThreadsT % 32 == 0, "whole warps");
};
using GenomeShape = Shape<kRows, kThreads>;
using BatchShape = Shape<kBatchRows, kBatchThreads>;

// Column order of the packed input (ops/sweep_kernel.py: SweepCols).
enum {
  kCid, kCs, kCe, kFlt, kRev, kGid, kPscore, kRank, kWeak, kCdsLen,
  kOffExon, kNExon, kExonOs, kExonOe, kNumCols
};
enum { kOutMarks, kOutScore, kOutOther, kOutOv, kNumOut };

struct Cols {
  const int32_t* cid;
  const int64_t* cs;
  const int64_t* ce;
  const uint8_t* flt;
  const uint8_t* rev;
  const int32_t* gid;
  const int64_t* pscore;  // uint64 packed score ^ (1 << 63): signed order
  const int32_t* rank;
  const uint8_t* weak;
  const int32_t* cds_len;
  const int32_t* off_exon;
  const int32_t* n_exon;
  const int32_t* exon_os;  // relative to the hit's cs
  const int32_t* exon_oe;
};

// Shared-memory copy of rows [s0, s0 + R). off[] indexes eos/eoe, which
// are the staged exons or, when they did not fit, the global pool.
struct Tile {
  int s0, R;
  const int64_t *cs, *ce, *ps;
  const int32_t *cid, *gid, *rank, *cds, *ne, *off;
  const uint8_t *flt, *rev, *weak;
  const int32_t *eos, *eoe;
  bool narrow;  // exons staged and every staged offset in (-2^29, 2^29)
};

// Where a tile's final rows go, by epilogue mode: NONE marks, score,
// other (and best_ov for the per-genome entry); LOOP shadow and pid_dom in
// place, reading ev1 and pid; STEP shadow in place, score, other and the
// sort key, reading cm. Pointers a mode does not use are null.
struct Epi {
  uint8_t* marks;
  int64_t* score;
  int32_t* other;
  int32_t* ov;
  uint8_t* shadow;
  const uint8_t* ev1;
  const int32_t* pid;
  int32_t* pid_dom;
  const int64_t* cm;
  int64_t* key;
};

// kTile: every row the block touches is staged (W <= kBandTile), so the
// tile is read directly; otherwise rows outside it come from global memory.
template <bool kTile>
__device__ __forceinline__ bool staged(const Tile& t, int r) {
  return kTile || (unsigned)(r - t.s0) < (unsigned)t.R;
}

// Row r's value from the tile when staged, else from global memory.
template <bool kTile, typename T>
__device__ __forceinline__ T ld(const T* tile_col, const T* glob_col,
                                const Tile& t, int r) {
  const int k = r - t.s0;
  return staged<kTile>(t, r) ? tile_col[k] : glob_col[r];
}

template <bool kTile>
__device__ __forceinline__ int exons_of(const Cols& c, const Tile& t, int r,
                                        const int32_t** os,
                                        const int32_t** oe) {
  const int k = r - t.s0;
  if (staged<kTile>(t, r)) {
    *os = t.eos + t.off[k];
    *oe = t.eoe + t.off[k];
    return t.ne[k];
  }
  *os = c.exon_os + c.off_exon[r];
  *oe = c.exon_oe + c.off_exon[r];
  return c.n_exon[r];
}

// Sum over exon pairs of max(min(end) - max(start), 0); row a's exons are
// shifted by ba, row b's by bb. The shorter list, when it has at most
// kRegExons exons, is held in registers and the inner loop is unrolled over
// it: no shared-memory load and no branch inside the inner loop. Padding
// entries are empty intervals [P, -P), P = 2^(bits - 2): every real value
// lies in (-P, P), so hi - lo of a padding entry is -2P, still
// representable. (With +-max, hi - lo overflows; signed overflow is
// undefined and the compiler may then add max(hi - lo, 0) unguarded.)
template <typename T>
__device__ __forceinline__ int64_t exon_overlap(
    const int32_t* osa, const int32_t* oea, int na, T ba,
    const int32_t* osb, const int32_t* oeb, int nb, T bb) {
  if (na < nb) {
    const int32_t* p = osa; osa = osb; osb = p;
    p = oea; oea = oeb; oeb = p;
    const int m = na; na = nb; nb = m;
    const T v = ba; ba = bb; bb = v;
  }
  int64_t ov = 0;
  if (sizeof(T) == 4 && nb <= kRegExons) {  // the int32 path only: registers
    constexpr T kPad = (T)1 << (8 * sizeof(T) - 2);
    T sb[kRegExons], eb[kRegExons];
#pragma unroll
    for (int y = 0; y < kRegExons; ++y) {
      sb[y] = y < nb ? bb + (T)osb[y] : kPad;
      eb[y] = y < nb ? bb + (T)oeb[y] : -kPad;
    }
    for (int x = 0; x < na; ++x) {
      const T sa = ba + (T)osa[x];
      const T ea = ba + (T)oea[x];
#pragma unroll
      for (int y = 0; y < kRegExons; ++y) {
        const T lo = sa > sb[y] ? sa : sb[y];
        const T hi = ea < eb[y] ? ea : eb[y];
        if (hi > lo) ov += (int64_t)(hi - lo);
      }
    }
    return ov;
  }
  for (int x = 0; x < na; ++x) {
    const T sa = ba + (T)osa[x];
    const T ea = ba + (T)oea[x];
    for (int y = 0; y < nb; ++y) {
      const T sb = bb + (T)osb[y];
      const T eb = bb + (T)oeb[y];
      const T lo = sa > sb ? sa : sb;
      const T hi = ea < eb ? ea : eb;
      if (hi > lo) ov += (int64_t)(hi - lo);
    }
  }
  return ov;
}

// The cheap gates of pair (j, i), j < i: both unfiltered, same contig,
// ce_j > cs_i, optionally the same strand; ISOFORM also the same gene. The
// operands are loaded together, then tested.
template <bool kTile>
__device__ __forceinline__ bool cheap_gates(const Cols& c, const Tile& t,
                                            int j, int i, int mode,
                                            bool check_strand) {
  const uint8_t flt_j = ld<kTile>(t.flt, c.flt, t, j);
  const uint8_t flt_i = ld<kTile>(t.flt, c.flt, t, i);
  const int32_t cid_j = ld<kTile>(t.cid, c.cid, t, j);
  const int32_t cid_i = ld<kTile>(t.cid, c.cid, t, i);
  const int64_t ce_j = ld<kTile>(t.ce, c.ce, t, j);
  const int64_t cs_i = ld<kTile>(t.cs, c.cs, t, i);
  if ((flt_j | flt_i) || cid_j != cid_i || ce_j <= cs_i) return false;
  if (check_strand &&
      ld<kTile>(t.rev, c.rev, t, j) != ld<kTile>(t.rev, c.rev, t, i))
    return false;
  return mode != kIsoform ||
         ld<kTile>(t.gid, c.gid, t, j) == ld<kTile>(t.gid, c.gid, t, i);
}

// The rest of the gates of a pair that passed cheap_gates: exact exon
// intersection ov > 0 and, for a cross-gene SHADOW pair, the coverage
// ratio. On success sets ov and whether i loses.
template <bool kTile>
__device__ __forceinline__ bool pair_outcome(const Cols& c, const Tile& t,
                                             int j, int i, int mode,
                                             double f, int64_t* ov,
                                             bool* i_loses) {
  const int32_t *osj, *oej, *osi, *oei;
  const int nj = exons_of<kTile>(c, t, j, &osj, &oej);
  const int ni = exons_of<kTile>(c, t, i, &osi, &oei);
  const int64_t delta =
      ld<kTile>(t.cs, c.cs, t, j) - ld<kTile>(t.cs, c.cs, t, i);
  int64_t o;
  if (t.narrow && staged<kTile>(t, j) && staged<kTile>(t, i) &&
      delta > -kNarrow && delta < kNarrow)
    o = exon_overlap<int32_t>(osj, oej, nj, (int32_t)delta, osi, oei, ni, 0);
  else
    o = exon_overlap<int64_t>(osj, oej, nj, delta, osi, oei, ni, 0);
  if (o <= 0) return false;
  const bool same_gene =
      ld<kTile>(t.gid, c.gid, t, j) == ld<kTile>(t.gid, c.gid, t, i);
  const int64_t pi = ld<kTile>(t.ps, c.pscore, t, i);
  const int64_t pj = ld<kTile>(t.ps, c.pscore, t, j);
  const int32_t ri = ld<kTile>(t.rank, c.rank, t, i);
  const int32_t rj = ld<kTile>(t.rank, c.rank, t, j);
  const bool score_i_loses = pi < pj || (pi == pj && ri > rj);
  if (mode == kShadow) {
    if (!same_gene) {
      const int32_t li = ld<kTile>(t.cds, c.cds_len, t, i);
      const int32_t lj = ld<kTile>(t.cds, c.cds_len, t, j);
      int m = li < lj ? li : lj;
      if (m < 1) m = 1;
      if (__ddiv_rn((double)o, (double)m) < f) return false;
    }
    const uint8_t wi = ld<kTile>(t.weak, c.weak, t, i);
    const uint8_t wj = ld<kTile>(t.weak, c.weak, t, j);
    *i_loses = (same_gene || wi == wj) ? score_i_loses : (wi > wj);
  } else {
    *i_loses = score_i_loses;
  }
  *ov = o;
  return true;
}

// Item `it` of a band chunk (offsets d0 + 1 .. d0 + dn, n0 = dn * kR):
// items [0, n0) are the pairs whose i is owned, the rest those whose j
// alone is owned (j = r0 + kR - 1 - m, i = j + d >= r0 + kR, m < d).
// Sets the pair and its offset index k; false when the item has no pair.
template <int kR>
__device__ __forceinline__ bool item_pair(int it, int n0, int m1, int d0,
                                          int r0, int nown, int n, int* k,
                                          int* j, int* i) {
  if (it < n0) {
    *k = it / kR;
    const int l = it - *k * kR;
    *i = r0 + l;
    *j = *i - (d0 + 1 + *k);
    return l < nown && *j >= 0;
  }
  const int q = it - n0;
  *k = q / m1;
  const int m = q - *k * m1;
  const int d = d0 + 1 + *k;
  *j = r0 + kR - 1 - m;
  *i = *j + d;
  return m < d && *i < n;
}

// Dynamic shared memory of one block, carved in this order, each array at
// a 16-byte boundary: the staged rows (one range, or two for the batched
// entry's prefetch), their exons, the candidate slots and the queue of
// pairs past the cheap gates.
__host__ __device__ constexpr size_t r16(size_t x) {
  return (x + 15) / 16 * 16;
}
constexpr size_t rows_bytes(int rmax) {
  return 3 * r16((size_t)rmax * 8) + 6 * r16((size_t)rmax * 4) +
         3 * r16((size_t)rmax);
}
constexpr size_t scratch_bytes(int rmax, int chunk, int rows) {
  return 2 * r16((size_t)rmax * kExonsPerRow * 4) +
         r16((size_t)2 * chunk * rows * 4) +
         r16((size_t)2 * chunk * rows * 2) + r16((size_t)2 * chunk * rows);
}
template <class S>
constexpr size_t smem_bytes(int halo, int chunk, int nbuf) {
  return nbuf * rows_bytes(S::rows + 2 * halo) +
         scratch_bytes(S::rows + 2 * halo, chunk, S::rows);
}
template <class S>
constexpr size_t static_smem() {
  return (S::threads + 1) * sizeof(int32_t) +
         (S::threads / 32) * sizeof(int64_t) + sizeof(int);
}
static_assert(smem_bytes<GenomeShape>(kBandTile, kBandTile, 1) +
                      static_smem<GenomeShape>() <= 48 * 1024,
              "shared memory beyond 48 KB needs an opt-in per launch");

// One staged row range [s0, s0 + R) in shared memory.
struct RowSmem {
  int64_t *cs, *ce, *ps;
  int32_t *cid, *gid, *rank, *cds, *ne, *off;
  uint8_t *flt, *rev, *weak;
};
// The exons staged for it, the candidate slots [2 * chunk][rows] (ov and
// a flag) and the queue.
struct Scratch {
  int32_t *eos, *eoe, *slot_ov;
  uint16_t* queue;
  uint8_t* slot;
};

struct Carve {
  unsigned char* p;
  template <typename T>
  __device__ T* take(size_t count) {
    T* r = reinterpret_cast<T*>(p);
    p += r16(count * sizeof(T));
    return r;
  }
};

__device__ __forceinline__ RowSmem carve_rows(Carve& cv, int rmax) {
  RowSmem b;
  b.cs = cv.take<int64_t>(rmax);
  b.ce = cv.take<int64_t>(rmax);
  b.ps = cv.take<int64_t>(rmax);
  b.cid = cv.take<int32_t>(rmax);
  b.gid = cv.take<int32_t>(rmax);
  b.rank = cv.take<int32_t>(rmax);
  b.cds = cv.take<int32_t>(rmax);
  b.ne = cv.take<int32_t>(rmax);
  b.off = cv.take<int32_t>(rmax);
  b.flt = cv.take<uint8_t>(rmax);
  b.rev = cv.take<uint8_t>(rmax);
  b.weak = cv.take<uint8_t>(rmax);
  return b;
}

__device__ __forceinline__ Scratch carve_scratch(Carve& cv, int rmax,
                                                 int chunk, int rows) {
  Scratch sc;
  sc.eos = cv.take<int32_t>((size_t)rmax * kExonsPerRow);
  sc.eoe = cv.take<int32_t>((size_t)rmax * kExonsPerRow);
  sc.slot_ov = cv.take<int32_t>((size_t)2 * chunk * rows);
  sc.queue = cv.take<uint16_t>((size_t)2 * chunk * rows);
  sc.slot = cv.take<uint8_t>((size_t)2 * chunk * rows);
  return sc;
}

// The rows a tile stages: [s0, s0 + R) around its owned [r0, r0 + rows)
// of a genome of n hits (R <= 0: the tile owns no row).
struct TileRows {
  int r0, s0, R;
};
__device__ __forceinline__ TileRows tile_rows(int blk, int rows, int n,
                                              int halo) {
  TileRows t;
  t.r0 = blk * rows;
  t.s0 = max(t.r0 - halo, 0);
  t.R = min(t.r0 + rows + halo, n) - t.s0;
  return t;
}

// Row r's final result (mark, best score bs, best other bo, best ov bv)
// of a genome of n hits and nout rows, by epilogue mode (Epi); flt, cid:
// the row's filter flag and contig id.
template <int kEpi>
__device__ __forceinline__ void put_row(const Epi& e, int r, int n,
                                        int nout, uint8_t mark, int64_t bs,
                                        int32_t bo, int32_t bv, uint8_t flt,
                                        int32_t cid) {
  if (kEpi == kEpiNone) {
    e.marks[r] = mark;
    e.score[r] = bs;
    e.other[r] = bo;
    if (e.ov) e.ov[r] = bv;
    return;
  }
  const bool nonflt = flt == 0;
  const bool ev = kEpi == kEpiLoop ? e.ev1[r] != 0 : r >= 1;
  const uint8_t sh = e.shadow[r];
  e.shadow[r] = (nonflt && ev && r < n) ? mark
                                        : (uint8_t)((sh != 0) | mark);
  if (kEpi == kEpiStep) {
    e.score[r] = bs;
    e.other[r] = bo;
    e.key[r] = r < n ? (int64_t)(((uint64_t)(int64_t)cid << kStepKeyBits) |
                                 (uint64_t)e.cm[r])
                     : kStepKeyPad;
  } else if (nonflt) {
    // bo lies within the band of r when there is a dominator; the clamp
    // is the plain version's, for OTHER_NONE
    e.pid_dom[r] = bs > kScoreNone ? e.pid[min(max(bo, 0), nout - 1)] : -1;
  }
}

// One block's work: tile `blk` (S::rows owned rows) of a genome of n hits
// whose output planes have nout >= n rows. Rows [n, nout) of the tile get
// "no candidate"; e.ov may be null. kStaged: the tile's rows are already
// in `rb` (the batched entry's prefetch), else they are staged here.
template <bool kTile, class S, bool kStaged, int kEpi>
__device__ __forceinline__ void sweep_tile(
    const Cols& c, int n, int nout, int blk, int W, int halo, int chunk,
    int mode, int check_strand, double f, const RowSmem& rb,
    const Scratch& sc, const Epi& e) {
  constexpr int kRows = S::rows;
  constexpr int kThreads = S::threads;
  __shared__ int32_t s_pref[kThreads + 1];
  __shared__ int64_t s_warp[kThreads / 32];
  __shared__ int s_qn;

  const int tid = threadIdx.x;
  const int r0 = blk * kRows;
  if (tid < kRows && r0 + tid >= n && r0 + tid < nout) {
    const int r = r0 + tid;
    put_row<kEpi>(e, r, n, nout, 0, kScoreNone, kOtherNone, 0,
                  kEpi == kEpiNone ? 0 : c.flt[r], 0);
  }
  if (r0 >= n) return;  // the whole block: no barrier has been reached
  const int nown = min(kRows, n - r0);
  const int s0 = max(r0 - halo, 0);
  const int R = min(r0 + kRows + halo, n) - s0;
  const int rmax = kRows + 2 * halo;
  const int exon_cap = rmax * kExonsPerRow;

  int64_t* s_cs = rb.cs;
  int64_t* s_ce = rb.ce;
  int64_t* s_ps = rb.ps;
  int32_t* s_cid = rb.cid;
  int32_t* s_gid = rb.gid;
  int32_t* s_rank = rb.rank;
  int32_t* s_cds = rb.cds;
  int32_t* s_ne = rb.ne;
  int32_t* s_off = rb.off;
  int32_t* s_eos = sc.eos;
  int32_t* s_eoe = sc.eoe;
  int32_t* s_slot_ov = sc.slot_ov;        // [2 * chunk][kRows]
  uint16_t* s_queue = sc.queue;           // items past the cheap gates
  uint8_t* s_flt = rb.flt;
  uint8_t* s_rev = rb.rev;
  uint8_t* s_weak = rb.weak;
  uint8_t* s_slot = sc.slot;              // [2 * chunk][kRows], 1 = candidate

  // stage the rows (R <= kThreads: one row a thread)
  int64_t ne = 0;
  if (tid < R) {
    if (kStaged) {
      ne = s_ne[tid];
    } else {
      const int r = s0 + tid;
      s_cs[tid] = c.cs[r];
      s_ce[tid] = c.ce[r];
      s_ps[tid] = c.pscore[r];
      s_cid[tid] = c.cid[r];
      s_gid[tid] = c.gid[r];
      s_rank[tid] = c.rank[r];
      s_cds[tid] = c.cds_len[r];
      s_off[tid] = c.off_exon[r];
      s_flt[tid] = c.flt[r];
      s_rev[tid] = c.rev[r];
      s_weak[tid] = c.weak[r];
      ne = c.n_exon[r];
      s_ne[tid] = (int32_t)ne;
    }
  }
  // exclusive prefix over n_exon of the staged rows
  const int lane = tid & 31, warp = tid >> 5;
  int64_t incl = ne;
  for (int s = 1; s < 32; s <<= 1) {
    const int64_t v = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int64_t base = 0, total = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) base += s_warp[w];
    total += s_warp[w];
  }
  const bool exons_staged = total <= exon_cap;
  // R < kThreads, so thread R writes s_pref[R] = total
  if (exons_staged) s_pref[tid] = (int32_t)(base + incl - ne);
  __syncthreads();
  int wide = 0;
  if (exons_staged) {
    // flat over the staged exons, kGather a thread at a time: each finds its
    // row by binary search over the prefix, then all kGather loads are in
    // flight together
    constexpr int kGather = 4;
    for (int e0 = tid; e0 < (int)total; e0 += kGather * kThreads) {
      int src[kGather];
      int32_t os[kGather], oe[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int e = e0 + u * kThreads;
        int lo = 0, hi = R;  // last row k with s_pref[k] <= e
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (s_pref[mid] <= e) lo = mid; else hi = mid;
        }
        src[u] = e < (int)total ? s_off[lo] + (e - s_pref[lo]) : -1;
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        if (src[u] >= 0) {
          os[u] = c.exon_os[src[u]];
          oe[u] = c.exon_oe[src[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        if (src[u] < 0) continue;
        const int e = e0 + u * kThreads;
        s_eos[e] = os[u];
        s_eoe[e] = oe[u];
        wide |= os[u] <= -kNarrow || os[u] >= kNarrow ||
                oe[u] <= -kNarrow || oe[u] >= kNarrow;
      }
    }
  }
  wide = __syncthreads_or(wide);
  if (exons_staged && tid < R) s_off[tid] = s_pref[tid];
  __syncthreads();

  Tile t;
  t.s0 = s0;
  t.R = R;
  t.cs = s_cs;
  t.ce = s_ce;
  t.ps = s_ps;
  t.cid = s_cid;
  t.gid = s_gid;
  t.rank = s_rank;
  t.cds = s_cds;
  t.ne = s_ne;
  t.off = s_off;
  t.flt = s_flt;
  t.rev = s_rev;
  t.weak = s_weak;
  t.eos = exons_staged ? s_eos : c.exon_os;
  t.eoe = exons_staged ? s_eoe : c.exon_oe;
  t.narrow = exons_staged && !wide;

  uint8_t mark = 0;
  int64_t bs = kScoreNone;
  int32_t bo = kOtherNone, bv = 0;
  const int nslot = 2 * chunk * kRows;
  for (int d0 = 0; d0 < W; d0 += chunk) {
    const int dn = min(chunk, W - d0);  // band offsets d0 + 1 .. d0 + dn
    for (int k = tid; k < nslot; k += kThreads) s_slot[k] = 0;
    if (tid == 0) s_qn = 0;
    __syncthreads();
    // phase 1a: every item through the cheap gates; the survivors go to a
    // queue (one atomic a warp), so that phase 1b gives every thread a pair
    // that needs its exons intersected. The queue's order varies, the slots
    // it fills do not.
    const int n0 = dn * kRows;
    const int m1 = min(d0 + dn, kRows);
    const int n01 = n0 + dn * m1;
    for (int b0 = 0; b0 < n01; b0 += kThreads) {
      const int it = b0 + tid;
      int k, i, j;
      const bool pass =
          it < n01 &&
          item_pair<kRows>(it, n0, m1, d0, r0, nown, n, &k, &j, &i) &&
          cheap_gates<kTile>(c, t, j, i, mode, check_strand);
      const unsigned ballot = __ballot_sync(0xffffffffu, pass);
      int at = 0;
      if (lane == 0 && ballot) at = atomicAdd(&s_qn, __popc(ballot));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (pass) s_queue[at + __popc(ballot & ((1u << lane) - 1))] = it;
    }
    __syncthreads();
    // phase 1b: the queued pairs' outcomes into the losers' slots
    const int qn = s_qn;
    for (int q = tid; q < qn; q += kThreads) {
      int k, i, j;
      item_pair<kRows>(s_queue[q], n0, m1, d0, r0, nown, n, &k, &j, &i);
      int64_t ov;
      bool i_loses;
      if (!pair_outcome<kTile>(c, t, j, i, mode, f, &ov, &i_loses)) continue;
      int slot = -1;
      if (i_loses) {
        if (i - r0 < kRows) slot = k * kRows + (i - r0);
      } else if (j >= r0) {
        slot = (chunk + k) * kRows + (j - r0);
      }
      if (slot >= 0) {
        s_slot_ov[slot] = (int32_t)ov;
        s_slot[slot] = 1;
      }
    }
    __syncthreads();
    // phase 2: one thread per owned row folds its candidates
    if (tid < nown) {
      const int r = r0 + tid;
      for (int side = 0; side < 2; ++side) {
        for (int k = 0; k < dn; ++k) {
          const int slot = (side * chunk + k) * kRows + tid;
          if (!s_slot[slot]) continue;
          const int w = side ? r + d0 + 1 + k : r - d0 - 1 - k;
          const int64_t s = ld<kTile>(t.ps, c.pscore, t, w);
          mark = 1;
          if (s > bs || (s == bs && w < bo)) {
            bs = s;
            bo = w;
            bv = s_slot_ov[slot];
          }
        }
      }
    }
    __syncthreads();  // slots are cleared for the next chunk
  }
  if (tid < nown) {
    const int r = r0 + tid;
    put_row<kEpi>(e, r, n, nout, mark, bs, bo, bv, s_flt[r - s0],
                  s_cid[r - s0]);
  }
}

template <bool kTile>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
shadow_sweep_kernel(Cols c, int n, int W, int halo, int chunk, int mode,
                    int check_strand, double f, uint8_t* marks,
                    int64_t* best_score, int32_t* best_other,
                    int32_t* best_ov) {
  extern __shared__ __align__(16) unsigned char smem[];
  Carve cv{smem};
  const int rmax = kRows + 2 * halo;
  const RowSmem rb = carve_rows(cv, rmax);
  const Scratch sc = carve_scratch(cv, rmax, chunk, kRows);
  Epi e = {};
  e.marks = marks;
  e.score = best_score;
  e.other = best_other;
  e.ov = best_ov;
  sweep_tile<kTile, GenomeShape, false, kEpiNone>(
      c, n, n, blockIdx.x, W, halo, chunk, mode, check_strand, f, rb, sc,
      e);
}

// The columns of genome g: rows [g * H, (g + 1) * H) of every [G, H] plane,
// row g of the [G, E] exon pools.
__device__ __forceinline__ Cols genome_cols(Cols c, int g, int H, int E) {
  const size_t ro = (size_t)g * H, eo = (size_t)g * E;
  c.cid += ro;
  c.cs += ro;
  c.ce += ro;
  c.flt += ro;
  c.rev += ro;
  c.gid += ro;
  c.pscore += ro;
  c.rank += ro;
  c.weak += ro;
  c.cds_len += ro;
  c.off_exon += ro;
  c.n_exon += ro;
  c.exon_os += eo;
  c.exon_oe += eo;
  return c;
}

__device__ __forceinline__ int genome_rows(const int32_t* n_rows, int g,
                                           int H) {
  const int n = n_rows[g];
  return n < 0 ? 0 : (n > H ? H : n);
}

// Start the copy of tile x's staged rows (genome columns c, n hits) into
// b: the 4- and 8-byte columns by cp.async, the three byte columns into
// registers (flt, rev, weak), stored by land_rows once the copy is waited
// for.
__device__ __forceinline__ void prefetch_rows(const Cols& c, int n, int x,
                                              int halo, const RowSmem& b,
                                              uint8_t* bytes) {
  const TileRows t = tile_rows(x, kBatchRows, n, halo);
  const int k = threadIdx.x;
  if (k < t.R) {
    const int r = t.s0 + k;
    __pipeline_memcpy_async(&b.cs[k], &c.cs[r], sizeof(int64_t));
    __pipeline_memcpy_async(&b.ce[k], &c.ce[r], sizeof(int64_t));
    __pipeline_memcpy_async(&b.ps[k], &c.pscore[r], sizeof(int64_t));
    __pipeline_memcpy_async(&b.cid[k], &c.cid[r], sizeof(int32_t));
    __pipeline_memcpy_async(&b.gid[k], &c.gid[r], sizeof(int32_t));
    __pipeline_memcpy_async(&b.rank[k], &c.rank[r], sizeof(int32_t));
    __pipeline_memcpy_async(&b.cds[k], &c.cds_len[r], sizeof(int32_t));
    __pipeline_memcpy_async(&b.ne[k], &c.n_exon[r], sizeof(int32_t));
    __pipeline_memcpy_async(&b.off[k], &c.off_exon[r], sizeof(int32_t));
    bytes[0] = c.flt[r];
    bytes[1] = c.rev[r];
    bytes[2] = c.weak[r];
  }
  __pipeline_commit();
}

template <typename T>
__device__ __forceinline__ T* at_row(T* p, size_t ro) {
  return p ? p + ro : p;
}

// Epi of genome g: every plane offset by its first row.
__device__ __forceinline__ Epi genome_epi(Epi e, size_t ro) {
  e.marks = at_row(e.marks, ro);
  e.score = at_row(e.score, ro);
  e.other = at_row(e.other, ro);
  e.shadow = at_row(e.shadow, ro);
  e.ev1 = at_row(e.ev1, ro);
  e.pid = at_row(e.pid, ro);
  e.pid_dom = at_row(e.pid_dom, ro);
  e.cm = at_row(e.cm, ro);
  e.key = at_row(e.key, ro);
  return e;
}

// The batched entry, persistent: block b takes the (genome, tile) items
// b, b + gridDim.x, ... (genome-major, so neighbouring blocks share halos
// in L2). While an item's band passes run, the next item's rows are on
// their way into the other row buffer. An item past its genome's n_rows
// stages nothing and gives its rows no mark and no dominator (through
// the epilogue of kEpi).
template <bool kTile, int kEpi>
__global__ void __launch_bounds__(kBatchThreads, kBatchBlocksPerSM)
shadow_sweep_batched_kernel(Cols c, const int32_t* __restrict__ n_rows,
                            int G, int H, int E, int W, int halo, int chunk,
                            int check_strand, double f, Epi e) {
  extern __shared__ __align__(16) unsigned char smem[];
  Carve cv{smem};
  const int rmax = kBatchRows + 2 * halo;
  const RowSmem buf0 = carve_rows(cv, rmax);
  const RowSmem buf1 = carve_rows(cv, rmax);
  const Scratch sc = carve_scratch(cv, rmax, chunk, kBatchRows);
  const int tiles = (H + kBatchRows - 1) / kBatchRows;
  const long long items = (long long)G * tiles;
  uint8_t bytes[3] = {0, 0, 0};
  long long it = blockIdx.x;
  if (it < items) {
    const int g = (int)(it / tiles);
    prefetch_rows(genome_cols(c, g, H, E), genome_rows(n_rows, g, H),
                  (int)(it % tiles), halo, buf0, bytes);
  }
  for (int k = 0; it < items; it += gridDim.x, k ^= 1) {
    const int g = (int)(it / tiles), x = (int)(it % tiles);
    const int n = genome_rows(n_rows, g, H);
    const RowSmem rb = k ? buf1 : buf0;
    __pipeline_wait_prior(0);
    if ((int)threadIdx.x < tile_rows(x, kBatchRows, n, halo).R) {
      rb.flt[threadIdx.x] = bytes[0];
      rb.rev[threadIdx.x] = bytes[1];
      rb.weak[threadIdx.x] = bytes[2];
    }
    __syncthreads();
    const long long next = it + gridDim.x;
    if (next < items) {
      const int g2 = (int)(next / tiles);
      prefetch_rows(genome_cols(c, g2, H, E), genome_rows(n_rows, g2, H),
                    (int)(next % tiles), halo, k ? buf0 : buf1, bytes);
    }
    sweep_tile<kTile, BatchShape, true, kEpi>(
        genome_cols(c, g, H, E), n, H, x, W, halo, chunk, kShadow,
        check_strand, f, rb, sc, genome_epi(e, (size_t)g * H));
    __syncthreads();  // rb is the prefetch's after next
  }
}

// Band chunk and staged halo of a launch. W is already clipped to n - 1.
void tile_shape(int W, int* halo, int* chunk) {
  *halo = W <= kBandTile ? W : 0;
  *chunk = W < kBandTile ? W : kBandTile;
}

void batch_tile_shape(int W, int* halo, int* chunk) {
  *halo = W <= kBandTile ? W : 0;
  *chunk = W < kBatchChunk ? W : kBatchChunk;
}

// The batched launch for band W over G genomes of H rows: the kernel, its
// dynamic shared memory (opted in above 48 KB), the (genome, tile) items
// and the persistent grid (the blocks resident on every SM at once).
using BatchKernel = void (*)(Cols, const int32_t*, int, int, int, int, int,
                             int, int, double, Epi);
struct BatchLaunch {
  BatchKernel kernel;
  size_t smem;
  int halo, chunk, per_sm, blocks;
  long long items;
};

template <int kEpi>
BatchKernel batch_kernel(bool tile) {
  return tile ? shadow_sweep_batched_kernel<true, kEpi>
              : shadow_sweep_batched_kernel<false, kEpi>;
}

cudaError_t batch_launch(int G, int H, int W, int epi, BatchLaunch* L) {
  batch_tile_shape(W, &L->halo, &L->chunk);
  const bool tile = L->halo == W;
  if (epi == kEpiLoop)
    L->kernel = batch_kernel<kEpiLoop>(tile);
  else if (epi == kEpiStep)
    L->kernel = batch_kernel<kEpiStep>(tile);
  else
    return cudaErrorInvalidValue;
  L->smem = smem_bytes<BatchShape>(L->halo, L->chunk, 2);
  L->items = (long long)G * ((H + kBatchRows - 1) / kBatchRows);
  cudaError_t e = cudaFuncSetAttribute(
      L->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L->smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&L->per_sm, L->kernel,
                                                    kBatchThreads, L->smem);
  if (e != cudaSuccess) return e;
  const long long slots = (long long)sms * (L->per_sm > 0 ? L->per_sm : 1);
  L->blocks = (int)(L->items < slots ? L->items : slots);
  return cudaSuccess;
}

Cols unpack(const void* in, const long long* in_off) {
  const char* b = static_cast<const char*>(in);
  Cols c;
  c.cid = reinterpret_cast<const int32_t*>(b + in_off[kCid]);
  c.cs = reinterpret_cast<const int64_t*>(b + in_off[kCs]);
  c.ce = reinterpret_cast<const int64_t*>(b + in_off[kCe]);
  c.flt = reinterpret_cast<const uint8_t*>(b + in_off[kFlt]);
  c.rev = reinterpret_cast<const uint8_t*>(b + in_off[kRev]);
  c.gid = reinterpret_cast<const int32_t*>(b + in_off[kGid]);
  c.pscore = reinterpret_cast<const int64_t*>(b + in_off[kPscore]);
  c.rank = reinterpret_cast<const int32_t*>(b + in_off[kRank]);
  c.weak = reinterpret_cast<const uint8_t*>(b + in_off[kWeak]);
  c.cds_len = reinterpret_cast<const int32_t*>(b + in_off[kCdsLen]);
  c.off_exon = reinterpret_cast<const int32_t*>(b + in_off[kOffExon]);
  c.n_exon = reinterpret_cast<const int32_t*>(b + in_off[kNExon]);
  c.exon_os = reinterpret_cast<const int32_t*>(b + in_off[kExonOs]);
  c.exon_oe = reinterpret_cast<const int32_t*>(b + in_off[kExonOe]);
  return c;
}

int clip_band(int n, int W) { return W < n - 1 ? W : (n > 1 ? n - 1 : 1); }

// Cols of the kNumCols device pointers, in the packed input's column order.
Cols cols_of(const void* const* cols) {
  Cols c;
  c.cid = static_cast<const int32_t*>(cols[kCid]);
  c.cs = static_cast<const int64_t*>(cols[kCs]);
  c.ce = static_cast<const int64_t*>(cols[kCe]);
  c.flt = static_cast<const uint8_t*>(cols[kFlt]);
  c.rev = static_cast<const uint8_t*>(cols[kRev]);
  c.gid = static_cast<const int32_t*>(cols[kGid]);
  c.pscore = static_cast<const int64_t*>(cols[kPscore]);
  c.rank = static_cast<const int32_t*>(cols[kRank]);
  c.weak = static_cast<const uint8_t*>(cols[kWeak]);
  c.cds_len = static_cast<const int32_t*>(cols[kCdsLen]);
  c.off_exon = static_cast<const int32_t*>(cols[kOffExon]);
  c.n_exon = static_cast<const int32_t*>(cols[kNExon]);
  c.exon_os = static_cast<const int32_t*>(cols[kExonOs]);
  c.exon_oe = static_cast<const int32_t*>(cols[kExonOe]);
  return c;
}

// One launch of the batched kernel with epilogue mode `epi` on `stream`.
int launch_batched(const void* const* cols, const void* n_rows, int G,
                   int H, int E, int W, int check_strand, double f, int epi,
                   const Epi& e, void* stream) {
  if (G <= 0 || H <= 0) return 0;
  W = clip_band(H, W);
  BatchLaunch L;
  const cudaError_t err = batch_launch(G, H, W, epi, &L);
  if (err != cudaSuccess) return static_cast<int>(err);
  L.kernel<<<L.blocks, kBatchThreads, L.smem,
             static_cast<cudaStream_t>(stream)>>>(
      cols_of(cols), static_cast<const int32_t*>(n_rows), G, H, E, W,
      L.halo, L.chunk, check_strand, f, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on `stream` over the packed input `in` (byte offsets in_off,
// kNumCols of them, host memory) into the packed output `out` (out_off,
// kNumOut). Returns cudaGetLastError() (0 on success).
extern "C" int pg_shadow_sweep(const void* in, const long long* in_off,
                               void* out, const long long* out_off, int n,
                               int W, int mode, int check_strand, double f,
                               void* stream) {
  if (n <= 0) return 0;
  W = clip_band(n, W);
  int halo, chunk;
  tile_shape(W, &halo, &chunk);
  char* o = static_cast<char*>(out);
  const int blocks = (n + kRows - 1) / kRows;
  auto kernel = halo == W ? shadow_sweep_kernel<true>
                          : shadow_sweep_kernel<false>;
  kernel<<<blocks, kThreads, smem_bytes<GenomeShape>(halo, chunk, 1),
           static_cast<cudaStream_t>(stream)>>>(
      unpack(in, in_off), n, W, halo, chunk, mode, check_strand, f,
      reinterpret_cast<uint8_t*>(o + out_off[kOutMarks]),
      reinterpret_cast<int64_t*>(o + out_off[kOutScore]),
      reinterpret_cast<int32_t*>(o + out_off[kOutOther]),
      reinterpret_cast<int32_t*>(o + out_off[kOutOv]));
  return static_cast<int>(cudaGetLastError());
}

// One launch on `stream` of mode SHADOW over G genomes of H-padded columns
// with the round's epilogue fused (mode 1 LOOP, 2 STEP; see the top of
// this file): cols holds the kNumCols device pointers in the packed input's
// column order ([G, H] planes; the two exon pools [G, E]), n_rows the int32
// [G] hit counts on the device; [G, H] planes: shadow uint8 (in place); LOOP:
// ev1 uint8, pid int32, pid_dom int32 (in place); STEP: cm int64 read,
// best_score int64, best_other int32 and key int64 written. The pointers
// of the other mode may be null. Returns cudaGetLastError() (0 on
// success).
extern "C" int pg_shadow_sweep_round(const void* const* cols,
                                     const void* n_rows, int G, int H, int E,
                                     int W, int check_strand, double f,
                                     int epi, void* shadow, const void* ev1,
                                     const void* pid, void* pid_dom,
                                     const void* cm, void* best_score,
                                     void* best_other, void* key,
                                     void* stream) {
  if (epi != kEpiLoop && epi != kEpiStep)
    return static_cast<int>(cudaErrorInvalidValue);
  Epi e = {};
  e.shadow = static_cast<uint8_t*>(shadow);
  if (epi == kEpiLoop) {
    e.ev1 = static_cast<const uint8_t*>(ev1);
    e.pid = static_cast<const int32_t*>(pid);
    e.pid_dom = static_cast<int32_t*>(pid_dom);
  } else {
    e.cm = static_cast<const int64_t*>(cm);
    e.score = static_cast<int64_t*>(best_score);
    e.other = static_cast<int32_t*>(best_other);
    e.key = static_cast<int64_t*>(key);
  }
  return launch_batched(cols, n_rows, G, H, E, W, check_strand, f, epi, e,
                        stream);
}

// Launch shape of the batched entry with epilogue mode epi for G genomes
// of H rows and band W: info = {items, blocks, threads, dynamic shared
// bytes, resident blocks per SM, registers per thread, halo, chunk}.
// Returns a CUDA error code.
extern "C" int pg_shadow_sweep_batched_shape(int G, int H, int W, int epi,
                                             long long* info) {
  BatchLaunch L;
  cudaError_t e = batch_launch(G, H, clip_band(H, W), epi, &L);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, L.kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long v[8] = {L.items, L.blocks, kBatchThreads,
                          (long long)L.smem, L.per_sm, attr.numRegs, L.halo,
                          L.chunk};
  for (int k = 0; k < 8; ++k) info[k] = v[k];
  return 0;
}

// Launch shape for n hits and band W: info = {blocks, threads, dynamic
// shared bytes, resident blocks per SM, registers per thread, halo,
// chunk}. Returns a CUDA error code (0 on success).
extern "C" int pg_shadow_sweep_shape(int n, int W, int* info) {
  W = clip_band(n, W);
  int halo, chunk;
  tile_shape(W, &halo, &chunk);
  const size_t smem = smem_bytes<GenomeShape>(halo, chunk, 1);
  auto kernel = halo == W ? shadow_sweep_kernel<true>
                          : shadow_sweep_kernel<false>;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  info[0] = (n + kRows - 1) / kRows;
  info[1] = kThreads;
  info[2] = static_cast<int>(smem);
  info[3] = per_sm;
  info[4] = attr.numRegs;
  info[5] = halo;
  info[6] = chunk;
  return 0;
}
