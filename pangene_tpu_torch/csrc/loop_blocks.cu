// Two blocks of the device-resident pruning loop (parallel/device_loop.py),
// for Hopper (sm_90a). Bound to Python with ctypes (ops/loop_kernels.py),
// which also holds the plain PyTorch version each kernel is tested against.
//
// The branch block replaces the JAX branch block
// (pangene_tpu/parallel/device_loop.py:525 branch_block: its loc_chunk loop
// at :578, the deficit at :627-634, n_dist_loci at :636; reference
// branch.c:48-106). The arc table is v-sorted, so the arcs of one source
// vertex (a group) are contiguous; a group of >= 2 valid arcs branches. For
// every branching arc a and every other member p of its group, whatever the
// group's size, the pair is local when some genome g has both targets'
// representatives present, on the same contig unless frag_mode, with
// |cm_a - cm_p| <= local_dist or |rank_a - rank_p| <= local_count. Then
// aml[a] |= is_max[p] (p's s1 is the group's largest), and he[a] is set
// when p < a. The classification of each branching arc is the reference's
// double test of its deficit RN(1 - RN(s1 / mx)) against branch_diff,
// branch_diff_dist and branch_diff_cut: 0 kept, 1 a weak candidate, 2 cut;
// n_grp, at a group's first arc, counts its members with no earlier local
// partner. Two entries of one kernel: pg_branch_block (one rank: the groups
// found in the arc table, locality and classification in one launch), and
// for the mesh pg_branch_locality (the groups given; its bits are OR'd over
// the ranks), then pg_branch_classify, a kernel of its own. Both add into a
// tally: valid arcs (the mesh's: branching arcs), branching arcs, groups
// that took the wide path, the widest branching group.
//
// merge_fold replaces the merge's fold after its sort (JAX
// device_loop.py:264 walk_merge: the in-loop fold at :436-471, the bucket
// exchange's at :360-391, and the full=True tail at :410-415 and :471-500;
// reference graph.c:87-177). Over N sorted keys (vw << GB | g) << jb | low
// bits, an in-group is a run of equal (vw, g), an out-group a run of equal
// vw. Per out-group, at its rank: the arc row (vw, (int)((double)S1 / ng +
// .499)), S1 the sum over its ng in-groups of the in-group's largest s1;
// each valid row writes that rank into pair[src], src being the row's
// origin (the low jb key bits, or perm[i] when a permutation is given). The
// full mode (s2 and dist given by origin) adds ng, tot (the rows), the dist
// average plus499(sum of plus499(in-group dist sum, rows) * rows, tot) and
// the s2 average plus499(sum of in-group largest s2, ng).
//
// What bounds them on the H100: the branch kernels by their bytes (the
// representative planes of the genes the branching arcs target and the [A]
// arc planes: 16 MB, 0.005 ms, on the 64-genome, 10,000-gene synthetic
// corpus) or by the integer operations their data forces (each pair that
// must be found not local in every genome; chip_smoke.py counts them);
// branch_classify by its bytes (3 planes of a byte an arc, 16 bytes a
// branching arc read, 5 bytes an arc written: 6.7 MB, 0.002 ms);
// merge_fold by its bytes (8-16 a sorted row read, 4 a valid row's s1, 4
// the pair plane, 12 an arc row written; the full mode 8 more a valid row
// and 16 more an arc row: 25 MB, 0.007 ms). The plain PyTorch forms cost
// launch latency: the locality was up to ~900 small launches a call and two
// host reads, the softfloat deficit ~200 int64 launches over the arc table,
// the fold ~15 launches over every row and the full tail ~20 more. So each
// block is here one launch (merge_fold: after one memset), with no host
// read.
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
//    memory). A larger one takes the wide path: its head's block registers
//    it (one atomic gives the group its slot and its first item), and the
//    launch's last n_wide blocks (a quarter of the SMs: fewer than the
//    device holds at once, so while they wait for the arc-tile blocks to
//    finish, those always have room to run) take its items by ticket, an
//    item a pair of kBrTile-member tiles (ti <= tj): both tiles' target
//    rows staged as above, the pairs of the item that can still change a
//    bit tested, the bits OR'd into global bit planes after each chunk of
//    genomes and re-read before the next (other items' finds end tests
//    early). The block that finishes a group's last item classifies its
//    members and clears its bits. The epilogue classifies each member in IEEE double
//    (__ddiv_rn, __dsub_rn): (double) of an int32 is exact and each step
//    rounds to nearest, which is ops/softfloat.py:one_minus_div / gt_const
//    bit for bit for 0 <= s1 <= mx; the class counts go to two integer
//    atomics a block. Each group is written by the warp or block that owns
//    its head, or the one that finishes its last item: deterministic. The
//    scratch (the counters, the wide groups, their bits) is left zeroed by
//    every launch that completes: the last wide block zeroes the counters
//    and the groups' slots. What is left is latency: each warp's chain of
//    round trips (the members, each chunk's rows) for its ~2.5 groups, at
//    24 warps a SM.
//  * branch_classify (the mesh's classification once the bits are OR'd):
//    kClsArcs arcs a thread, the byte planes read four arcs in one load,
//    s1, mx and the group start read for branching arcs only; n_grp at a
//    group's first arc by a reverse scan over the warp's lanes (no atomic,
//    every n_grp written, 0 off the heads), a group running past the warp's
//    arcs finished by the warp reading on; one atomic a block a count.
//  * merge_fold: one pass. Persistent blocks (as many as are resident) take
//    tiles of kFoldTile sorted rows in order from an atomic ticket, so a
//    tile's decoupled look-back (Merrill and Garland 2016) only ever waits
//    on tiles that running blocks hold. Each thread loads kFoldRows
//    consecutive keys (and perm) with 16-byte loads and gathers its valid
//    rows' s1 (s2, dist) by origin, all loads in flight at once. A row's
//    out-group rank is the tile's look-back prefix plus the block's scan of
//    out-head flags, so every valid row writes its own pair slot. The fold
//    is two block-wide segmented scans (warp shuffles with head flags, then
//    the warps' totals in shared memory): rows into in-groups, then closed
//    in-groups into out-groups; an out-group's last row writes its arc row
//    when its head lies in the tile, and the tile's last warp reads on,
//    coalesced, through an out-group that runs past the tile (its next
//    tile skips those rows: they have no head there). Once every tile is
//    taken, each block waits for the last tile's prefix (n_out) and fills
//    its share of the rows past it with (SENT, 0, ...). Sums are int64:
//    exact and deterministic, whatever order the blocks run in.
//
// Exactness: (double)sum is exact (sum < 2^53), the division and the add are
// IEEE round-to-nearest (__ddiv_rn, __dadd_rn) as in the reference; do not
// build with --use_fast_math. For sum >= 0 (scores are non-negative) this
// is ops/softfloat.py:plus499_trunc bit for bit; a dist sum below 0 (an
// int32 gap that wrapped) takes plus499_trunc's own value there (plus499).
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
// the wide path (groups of more than kBrRows members): items of two tiles
// of kBrTile members, staged in BranchStage's rows; SMs a block of it
constexpr int kBrTile = 32;
static_assert(2 * kBrTile <= kBrRows, "two member tiles fill the stage");
constexpr int kBrSmsPerWide = 4;
// the branch scratch's header: arc-tile blocks done, wide blocks done, wide
// groups << kWideShift | their items, item ticket
constexpr int kScMainDone = 0, kScWideDone = 1, kScWide = 2, kScItem = 3,
              kScWords = 4;
constexpr int kWideShift = 40;
constexpr unsigned long long kWideItems = (1ull << kWideShift) - 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kClsThreads = 256;         // branch_classify
constexpr int kClsArcs = 4;              // arcs a thread (one int4 of n_grp)
static_assert(kClsArcs == 4, "branch_classify stores n_grp as one int4");
constexpr int kFoldThreads = 256;        // merge_fold
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr int kFoldRows = 4;             // sorted rows a thread
constexpr int kFoldTile = kFoldThreads * kFoldRows;
// a tile's look-back word: its state in the top two bits, its count of
// out-group heads below (its own, or all up to its end)
constexpr unsigned long long kTileAgg = 1ull << 62;
constexpr unsigned long long kTilePre = 2ull << 62;
constexpr unsigned long long kTileCount = (1ull << 62) - 1;
constexpr long long kKeySent = 1LL << 62;         // KSENT_I
constexpr long long kArcSent = (1LL << 62) - 1;   // SENT_I

// A 64-bit word other blocks read or write while this one runs.
__device__ __forceinline__ void tile_store(unsigned long long* t,
                                           unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(t) = v;
}
__device__ __forceinline__ unsigned long long tile_load(
    const unsigned long long* t) {
  return *reinterpret_cast<const volatile unsigned long long*>(t);
}

// ---------------------------------------------------------------------------
// the branch block
// ---------------------------------------------------------------------------

// A group of the wide path: its first arc, its first item, its members,
// its largest s1 (found groups), its items done.
struct WideGroup {
  long long h, off;
  int n, mx;
  unsigned done;
  int pad;
};
static_assert(sizeof(WideGroup) == 32, "WideGroup is 32 bytes");

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
  int frag;
  long long local_dist, local_count;
  double diff, diff_dist, diff_cut;
  uint8_t* aml;                // pg_branch_locality's outputs
  uint8_t* he;
  uint8_t* aw;                 // pg_branch_block's outputs
  int32_t* n_grp;
  unsigned long long* counts;
  // the scratch (pg_branch_scratch): the header, the wide groups and
  // their aml and he bits, a bit an arc
  unsigned long long* sc;
  WideGroup* wide;
  unsigned* wbits_aml;
  unsigned* wbits_he;
  long long n_main;            // blocks of kBrThreads arcs
  int n_wide;                  // blocks of the wide path
  unsigned long long* tally;   // [4], added into
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

// Can the pair of members (i, j), i < j, still change a bit?
__device__ __forceinline__ bool br_need(unsigned long long aml,
                                        unsigned long long he,
                                        unsigned long long im, int i, int j) {
  return !((he >> j) & 1)
         || (!((aml >> i) & 1) && ((im >> j) & 1))
         || (!((aml >> j) & 1) && ((im >> i) & 1));
}

// The members j > i that may still change a bit with i (see br_need), as a
// mask over the group's n members.
__device__ __forceinline__ unsigned long long br_partners(
    unsigned long long aml, unsigned long long he, unsigned long long im,
    int i, int n) {
  const unsigned long long all = n >= 64 ? ~0ull : (1ull << n) - 1;
  const unsigned long long later = all & ~((2ull << i) - 1);
  return later & (~he | (((aml >> i) & 1) ? 0ull : im)
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
      unsigned long long cand = br_partners(aml, he, im, i, n);
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
          n);
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

// Bits [a0, a0 + n) of a bit plane (n <= 32), read from L2: other blocks
// set them by atomics.
__device__ __forceinline__ unsigned bits_load(const unsigned* w, long long a0,
                                              int n) {
  const long long q = a0 >> 5;
  const int s = static_cast<int>(a0 & 31);
  const unsigned lo = __ldcg(w + q);
  const unsigned v = s ? __funnelshift_r(lo, __ldcg(w + q + 1), s) : lo;
  return n >= 32 ? v : v & ((1u << n) - 1);
}

// Bits m (of [a0, a0 + 32)) OR'd into a bit plane.
__device__ __forceinline__ void bits_or(unsigned* w, long long a0,
                                        unsigned m) {
  const long long q = a0 >> 5;
  const int s = static_cast<int>(a0 & 31);
  if (m << s) atomicOr(w + q, m << s);
  if (s && (m >> (32 - s))) atomicOr(w + q + 1, m >> (32 - s));
}

// Bits [a0, a0 + n) of a bit plane cleared (n <= 32).
__device__ __forceinline__ void bits_clear(unsigned* w, long long a0, int n) {
  const unsigned m = n >= 32 ? kFull : (1u << n) - 1;
  const long long q = a0 >> 5;
  const int s = static_cast<int>(a0 & 31);
  atomicAnd(w + q, ~(m << s));
  if (s) atomicAnd(w + q + 1, ~(m >> (32 - s)));
}

// A group of n > kBrRows members at h takes the wide path: its slot and its
// first item from one atomic, its items the pairs of kBrTile-member tiles
// ti <= tj. By one warp (its largest s1, found groups).
template <bool kFound>
__device__ void br_wide_put(const BranchArgs& p, long long h, long long n,
                            int lane) {
  const int mx = kFound ? br_group_max(p, h, n, lane) : 0;
  if (lane == 0) {
    const unsigned long long T = (n + kBrTile - 1) / kBrTile;
    const unsigned long long old = atomicAdd(
        p.sc + kScWide, (1ull << kWideShift) | (T * (T + 1) / 2));
    WideGroup* g = p.wide + (old >> kWideShift);
    g->h = h;
    g->off = static_cast<long long>(old & kWideItems);
    g->n = static_cast<int>(n);
    g->mx = mx;
  }
}

// The members j of the tile J that may still change a bit with member i of
// the tile I (br_need over the shared words: m[0] aml of I, m[ja] aml of J,
// m[2] he of J).
__device__ __forceinline__ unsigned br_tile_need(const volatile unsigned* m,
                                                 int ja, unsigned im_i,
                                                 unsigned im_j, int i) {
  const unsigned aml_i = m[0], aml_j = m[ja], he_j = m[2];
  return ~he_j | (((aml_i >> i) & 1) ? 0u : im_j)
         | (((im_i >> i) & 1) ? ~aml_j : 0u);
}

// The group at h finished (every item done): each member classified (found)
// or its bits written (given), n_grp at h, the bits cleared for the next
// launch. By the whole block.
template <bool kFound>
__device__ void br_wide_finish(const BranchArgs& p, long long h, int n,
                               int mx, int* s_cnt, BranchCounts& cnt) {
  __syncthreads();
  if (threadIdx.x == 0) *s_cnt = 0;
  __syncthreads();
  int nz = 0;
  for (int m = threadIdx.x; m < n; m += kBrThreads) {
    const long long a = h + m;
    const bool am = (__ldcg(p.wbits_aml + (a >> 5)) >> (a & 31)) & 1;
    const bool hh = (__ldcg(p.wbits_he + (a >> 5)) >> (a & 31)) & 1;
    nz += !hh;
    br_out<kFound>(p, h, m, am, hh, kFound ? p.s1[a] : 0, mx, 0, cnt);
  }
  for (int o = 16; o; o >>= 1) nz += __shfl_xor_sync(kFull, nz, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(s_cnt, nz);
  __syncthreads();
  for (int m0 = threadIdx.x * kBrTile; m0 < n; m0 += kBrThreads * kBrTile) {
    bits_clear(p.wbits_aml, h + m0, min(kBrTile, n - m0));
    bits_clear(p.wbits_he, h + m0, min(kBrTile, n - m0));
  }
  if (kFound && threadIdx.x == 0) p.n_grp[h] = *s_cnt;
}

// Item `it` of the wide group k: the pairs (i, j), i in tile ti and j in
// tile tj (j > i when ti == tj), that can still change a bit, tested as the
// block path tests them: both tiles' target rows staged kBrChunk genomes at
// a time (I in rows [0, kBrTile), J after it unless I is J), i split by
// warp, the bits in shared words, OR'd into the bit planes after each chunk
// and refreshed from them before the next. The block that completes the
// group's last item finishes the group.
template <bool kFound>
__device__ void br_wide_item(const BranchArgs& p, BranchStage& st,
                             long long k, long long it, int lane, int warp,
                             unsigned* s_m, int* s_flag, BranchCounts& cnt) {
  WideGroup* wg = p.wide + k;
  const long long h = __ldcg(&wg->h);
  const int n = __ldcg(&wg->n), mx = __ldcg(&wg->mx);
  const int T = (n + kBrTile - 1) / kBrTile;
  long long r = it - __ldcg(&wg->off);
  int ti = 0;
  while (r >= T - ti) {
    r -= T - ti;
    ++ti;
  }
  const int tj = ti + static_cast<int>(r);
  const bool diag = ti == tj;
  const int i0 = ti * kBrTile, j0 = tj * kBrTile;
  const int ni = min(kBrTile, n - i0), nj = min(kBrTile, n - j0);
  const int jrow = diag ? 0 : kBrTile;       // J's first staged row
  const int ja = diag ? 0 : 1;               // J's aml word
  if (threadIdx.x < ni) st.tgt[threadIdx.x] = p.tgt[h + i0 + threadIdx.x];
  if (!diag && threadIdx.x >= kBrTile && threadIdx.x - kBrTile < nj)
    st.tgt[threadIdx.x] = p.tgt[h + j0 + threadIdx.x - kBrTile];
  if (warp < 2) {
    const int m0 = warp ? j0 : i0, nm = warp ? nj : ni;
    const unsigned b = __ballot_sync(
        kFull, lane < nm && br_is_max<kFound>(p, h + m0 + lane, mx));
    if (lane == 0) s_m[3 + warp] = b;
  }
  if (threadIdx.x == 0) s_m[0] = s_m[1] = s_m[2] = 0;
  __syncthreads();
  const unsigned im_i = s_m[3], im_j = s_m[4];
  const unsigned all_j = nj >= 32 ? kFull : (1u << nj) - 1;
  volatile unsigned* vm = s_m;
  for (int g0 = 0; g0 < p.G; g0 += kBrChunk) {
    if (threadIdx.x == 0) {
      // what the group's other items have found so far
      s_m[0] |= bits_load(p.wbits_aml, h + i0, ni);
      if (!diag) s_m[1] |= bits_load(p.wbits_aml, h + j0, nj);
      s_m[2] |= bits_load(p.wbits_he, h + j0, nj);
    }
    br_stage_rows(p, st, 0, warp, kBrWarps, ni, g0, lane);
    if (!diag) br_stage_rows(p, st, kBrTile, warp, kBrWarps, nj, g0, lane);
    __syncthreads();
    bool pending = false;
    for (int i = warp; i < ni; i += kBrWarps) {
      const unsigned later = diag ? all_j & ~((2u << i) - 1) : all_j;
      unsigned cand = later & br_tile_need(vm, ja, im_i, im_j, i);
      while (cand) {
        const int j = __ffs(cand) - 1;
        cand &= cand - 1;
        if (!((br_tile_need(vm, ja, im_i, im_j, i) >> j) & 1)) continue;
        if (br_local_staged(p, st, i, jrow + j, lane)) {
          if (lane == 0) {
            atomicOr(&s_m[2], 1u << j);
            if ((im_j >> j) & 1) atomicOr(&s_m[0], 1u << i);
            if ((im_i >> i) & 1) atomicOr(&s_m[ja], 1u << j);
          }
          __syncwarp();
        } else {
          pending = true;
        }
      }
    }
    const bool more = __syncthreads_or(pending);
    if (threadIdx.x == 0) {
      bits_or(p.wbits_aml, h + i0, s_m[0]);
      if (!diag) bits_or(p.wbits_aml, h + j0, s_m[1]);
      bits_or(p.wbits_he, h + j0, s_m[2]);
    }
    if (!more) break;
  }
  if (threadIdx.x == 0) {
    // this item's bits before its count: the finisher reads them all
    __threadfence();
    const unsigned items = static_cast<unsigned>(T) * (T + 1) / 2;
    *s_flag = atomicAdd(&wg->done, 1u) == items - 1;
    if (*s_flag) __threadfence();
  }
  __syncthreads();
  if (*s_flag) br_wide_finish<kFound>(p, h, n, mx, s_flag, cnt);
}

// A block of the wide path: once every arc-tile block is done, items by
// ticket until none is left, each item's group found by a binary search
// over the groups' first items (the groups are in slot order, their first
// items increasing).
template <bool kFound>
__device__ void br_wide(const BranchArgs& p, BranchStage& st, int lane,
                        int warp, BranchCounts& cnt) {
  __shared__ unsigned long long s_w;
  __shared__ long long s_it, s_k;
  __shared__ unsigned s_m[5];
  __shared__ int s_flag;
  if (threadIdx.x == 0) {
    while (tile_load(p.sc + kScMainDone)
           < static_cast<unsigned long long>(p.n_main))
      __nanosleep(64);
    __threadfence();
    s_w = tile_load(p.sc + kScWide);
  }
  __syncthreads();
  const long long n_grp = static_cast<long long>(s_w >> kWideShift);
  const long long n_item = static_cast<long long>(s_w & kWideItems);
  while (n_item) {
    if (threadIdx.x == 0) {
      s_it = static_cast<long long>(atomicAdd(p.sc + kScItem, 1ull));
      long long lo = 0, hi = n_grp - 1;
      while (lo < hi) {
        const long long mid = (lo + hi + 1) >> 1;
        if (__ldcg(&p.wide[mid].off) <= s_it) lo = mid;
        else hi = mid - 1;
      }
      s_k = lo;
    }
    __syncthreads();
    if (s_it >= n_item) break;
    br_wide_item<kFound>(p, st, s_k, s_it, lane, warp, s_m, &s_flag, cnt);
    __syncthreads();
  }
}

// The first n_main blocks own 32 arcs a warp as group heads (an arc not
// linked to the one before it): groups of one member leave at once; groups
// of up to kBrWarpRows are the warp's, of up to kBrRows the whole block's,
// larger ones go to the wide path, the last n_wide blocks. Every block adds
// its class counts and tally; the last wide block to finish zeroes the
// scratch's counters and the groups' slots.
template <bool kFound>
__global__ void __launch_bounds__(kBrThreads)
branch_kernel(BranchArgs p) {
  __shared__ BranchStage st;
  __shared__ long long s_big[kBrBig];
  __shared__ unsigned long long s_bits[3];
  __shared__ int s_nbig, s_mx, s_last;
  __shared__ int s_sum[2];
  __shared__ int s_tally[3];      // valid arcs, branching arcs, widest
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_nbig = 0;
    s_sum[0] = s_sum[1] = 0;
    s_tally[0] = s_tally[1] = s_tally[2] = 0;
  }
  __syncthreads();
  const bool arcs = blockIdx.x < p.n_main;    // an arc-tile block
  BranchCounts cnt;
  if (!arcs) {
    br_wide<kFound>(p, st, lane, warp, cnt);
  } else {
    const long long base =
        (static_cast<long long>(blockIdx.x) * kBrWarps + warp) * 32;
    // a head followed by a head (or the table's end) is a group of one:
    // all of them leave at once (the table's empty slots are such groups)
    const long long a = base + lane;
    const bool head = a < p.A && !br_link<kFound>(p, a);
    const bool one = head && !br_link<kFound>(p, a + 1);
    if (one) br_out<kFound>(p, a, 0, false, false, 0, 0, 0, cnt);
    const bool brn = a < p.A && !one;
    const int nv = __popc(__ballot_sync(
        kFull, kFound ? a < p.A && p.vw[a] != kArcSent : brn));
    const int nb = __popc(__ballot_sync(kFull, brn));
    int widest = 0;
    unsigned heads = __ballot_sync(kFull, head && !one);
    while (heads) {
      const long long h = base + __ffs(heads) - 1;
      heads &= heads - 1;
      const Members mb = br_members<kFound>(p, h, lane);
      if (mb.n <= kBrWarpRows) {
        widest = max(widest, mb.n);
        br_group_warp<kFound>(p, st, warp * kBrWarpRows, h, mb, lane, cnt);
      } else if (lane == 0) {
        s_big[atomicAdd(&s_nbig, 1)] = h;
      }
    }
    __syncthreads();
    for (int k = 0; k < s_nbig; ++k) {
      const long long h = s_big[k];
      const long long n = br_group_end<kFound>(p, h, lane) - h;
      widest = max(widest, static_cast<int>(min(n, 0x7fffffffLL)));
      if (n <= kBrRows)
        br_group_block<kFound>(p, st, h, static_cast<int>(n), lane, warp,
                               s_bits, &s_mx, cnt);
      else if (warp == 0)
        br_wide_put<kFound>(p, h, n, lane);
    }
    if (lane == 0) {
      atomicAdd(&s_tally[0], nv);
      atomicAdd(&s_tally[1], nb);
      atomicMax(&s_tally[2], widest);
    }
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
  }
  __syncthreads();
  using u64 = unsigned long long;
  if (threadIdx.x == 0) {
    if (kFound && s_sum[0])
      atomicAdd(&p.counts[0], static_cast<u64>(s_sum[0]));
    if (kFound && s_sum[1])
      atomicAdd(&p.counts[1], static_cast<u64>(s_sum[1]));
    if (arcs) {
      if (s_tally[0]) atomicAdd(p.tally, static_cast<u64>(s_tally[0]));
      if (s_tally[1]) atomicAdd(p.tally + 1, static_cast<u64>(s_tally[1]));
      if (s_tally[2]) atomicMax(p.tally + 3, static_cast<u64>(s_tally[2]));
    }
    // arc-tile blocks: the wide groups this thread registered, before the
    // count of blocks done that the wide blocks wait for
    __threadfence();
    if (arcs) {
      atomicAdd(p.sc + kScMainDone, 1ull);
      s_last = 0;
    } else {
      s_last = atomicAdd(p.sc + kScWideDone, 1ull)
               == static_cast<u64>(p.n_wide - 1);
    }
  }
  __syncthreads();
  if (!s_last) return;
  // the last wide block, every other block done: the count of wide groups
  // into the tally, the groups' slots and the counters zeroed for the next
  // launch
  const u64 w = tile_load(p.sc + kScWide);
  const long long n_grp = static_cast<long long>(w >> kWideShift);
  for (long long k = threadIdx.x; k < n_grp; k += kBrThreads)
    p.wide[k] = WideGroup{};
  if (threadIdx.x == 0) {
    if (n_grp) atomicAdd(p.tally + 2, static_cast<u64>(n_grp));
    for (int q = 0; q < kScWords; ++q) tile_store(p.sc + q, 0);
  }
}

// ---------------------------------------------------------------------------
// branch_classify: the classification alone, after the locality bits were
// OR'd over the ranks
// ---------------------------------------------------------------------------

// Four consecutive bytes of a plane from arc a: one 32-bit load where they
// lie inside the table on a 4-byte boundary, 0 past A.
__device__ __forceinline__ void cls_load4(const uint8_t* x, long long a,
                                          long long A, uint8_t (&v)[kClsArcs]) {
  if (a + kClsArcs <= A && (reinterpret_cast<uintptr_t>(x + a) & 3) == 0) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(x + a);
#pragma unroll
    for (int q = 0; q < kClsArcs; ++q) v[q] = (w >> (8 * q)) & 0xff;
  } else {
#pragma unroll
    for (int q = 0; q < kClsArcs; ++q) v[q] = a + q < A ? x[a + q] : 0;
  }
}

// Arc a continues a branching group: branching and not the group's first.
__device__ __forceinline__ bool cls_cont(const BranchArgs& p, long long a) {
  return a < p.A && p.branching[a] && p.gs[a] != a;
}

// Each thread classifies kClsArcs consecutive arcs; each warp owns its
// kClsWarpArcs arcs as group heads. n_grp at a head is the number of its
// group's members with no earlier local partner: a reverse scan of that
// 0/1 count, reset where an arc does not continue the group (warp
// shuffles), the group that runs past the warp's arcs finished by the warp
// reading on.
__global__ void __launch_bounds__(kClsThreads)
branch_classify_kernel(BranchArgs p, const int32_t* __restrict__ mx) {
  __shared__ int s_sum[2];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_sum[0] = s_sum[1] = 0;
  const long long a0 =
      (static_cast<long long>(blockIdx.x) * kClsThreads + threadIdx.x)
      * kClsArcs;
  const long long wend = a0 + (32 - lane) * kClsArcs;   // past the warp's
  uint8_t br[kClsArcs], am[kClsArcs], hh[kClsArcs];
  cls_load4(p.branching, a0, p.A, br);
  cls_load4(p.aml, a0, p.A, am);
  cls_load4(p.he, a0, p.A, hh);
  BranchCounts cnt;
  uint8_t aw[kClsArcs];
  int c[kClsArcs];
  bool head[kClsArcs], cont[kClsArcs];
#pragma unroll
  for (int q = 0; q < kClsArcs; ++q) {
    const long long a = a0 + q;
    aw[q] = 0;
    c[q] = 0;
    head[q] = cont[q] = false;
    if (br[q]) {
      head[q] = p.gs[a] == a;
      cont[q] = !head[q];
      aw[q] = static_cast<uint8_t>(br_classify(p, p.s1[a], mx[a], am[q]));
      c[q] = !hh[q];
      cnt.add(aw[q]);
    }
  }
  // the count from each arc to its group's end, as ra + (rb ? x : 0), x
  // being that of the next thread's first arc
  const bool next_cont = __shfl_down_sync(kFull, cont[0], 1);
  const bool gate = lane == 31 ? cls_cont(p, wend) : next_cont;
  int ra[kClsArcs];
  bool rb[kClsArcs];
  int A = 0;
  bool B = true;
#pragma unroll
  for (int q = kClsArcs - 1; q >= 0; --q) {
    const bool g = q == kClsArcs - 1 ? gate : cont[q + 1];
    A = c[q] + (g ? A : 0);
    B = g && B;
    ra[q] = A;
    rb[q] = B;
  }
  // composed over the lanes above: x of this thread's first arc as
  // A + (B ? rest : 0), rest being that of the warp's end
  for (int d = 1; d < 32; d <<= 1) {
    const int A2 = __shfl_down_sync(kFull, A, d);
    const bool B2 = __shfl_down_sync(kFull, B, d);
    if (lane + d < 32) {
      A += B ? A2 : 0;
      B = B && B2;
    }
  }
  int rest = 0;
  if (__shfl_sync(kFull, gate, 31)) {
    // the warp's last group runs on past its arcs
    for (long long b = wend;; b += 32) {
      const long long a = b + lane;
      const unsigned run = __ballot_sync(kFull, cls_cont(p, a));
      const int n = run == kFull ? 32 : __ffs(~run) - 1;
      rest += __popc(__ballot_sync(kFull, lane < n && !p.he[a]));
      if (n < 32) break;
    }
  }
  const int x = A + (B ? rest : 0);
  const int up = __shfl_down_sync(kFull, x, 1);
  const int x_next = lane == 31 ? rest : up;
  int ng[kClsArcs];
#pragma unroll
  for (int q = 0; q < kClsArcs; ++q)
    ng[q] = head[q] ? ra[q] + (rb[q] ? x_next : 0) : 0;
  if (a0 + kClsArcs <= p.A
      && (reinterpret_cast<uintptr_t>(p.aw + a0) & 3) == 0) {
    uint32_t w = 0;
#pragma unroll
    for (int q = 0; q < kClsArcs; ++q)
      w |= static_cast<uint32_t>(aw[q]) << (8 * q);
    *reinterpret_cast<uint32_t*>(p.aw + a0) = w;
    *reinterpret_cast<int4*>(p.n_grp + a0) = make_int4(ng[0], ng[1], ng[2],
                                                       ng[3]);
  } else {
#pragma unroll
    for (int q = 0; q < kClsArcs; ++q)
      if (a0 + q < p.A) {
        p.aw[a0 + q] = aw[q];
        p.n_grp[a0 + q] = ng[q];
      }
  }
  for (int o = 16; o; o >>= 1) {
    cnt.n1 += __shfl_xor_sync(kFull, cnt.n1, o);
    cnt.n2 += __shfl_xor_sync(kFull, cnt.n2, o);
  }
  __syncthreads();
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

// ---------------------------------------------------------------------------
// merge_fold
// ---------------------------------------------------------------------------

// The arguments of merge_fold (one struct, passed by value). s2, dist and
// the four statistics' planes are null in the lean mode.
struct FoldArgs {
  const int64_t* keys;
  const int64_t* perm;
  const int32_t* s1;
  const int32_t* s2;
  const int32_t* dist;
  long long N, cap, ntiles;
  int jb, gb;
  int64_t* arc_vw;
  int32_t* arc_s1;
  int32_t* arc_ng;
  int32_t* arc_tot;
  int32_t* arc_ad;
  int32_t* arc_s2;
  int64_t* n_out;
  int32_t* pair;
  // [ntiles] look-back words, then the tile ticket; zeroed by the caller
  unsigned long long* tiles;
};

// (int64)((double)s / n + .499) as the reference rounds it (IEEE double,
// round-to-nearest: exact for 0 <= s < 2^53, n >= 1). Below 0, the plain
// version's integer form (ops/softfloat.py plus499_trunc, stated for s >= 0)
// gives the low 11 bits of s sign-extended for n == 1 and 0 otherwise;
// the kernel follows it there.
__device__ __forceinline__ long long plus499(long long s, long long n) {
  if (s < 0)
    return n == 1 ? static_cast<long long>(
                        static_cast<unsigned long long>(s) << 53) >> 53
                  : 0;
  return static_cast<long long>(__dadd_rn(
      __ddiv_rn(static_cast<double>(s), static_cast<double>(n)), 0.499));
}

// A run of rows of one in-group (equal (vw, g)): its largest s1 and s2, its
// rows and the sum of their dist.
struct InAgg {
  int m1, m2, cnt;
  long long ds;
};

// In-groups of one out-group (equal vw): their number, rows, and the sums
// of their largest s1 and s2 and of their rounded dist averages times rows.
struct OutAgg {
  int ng, tot;
  long long s1, s2, ad;
};

__device__ __forceinline__ InAgg in_zero() {
  return {INT32_MIN, INT32_MIN, 0, 0};
}
__device__ __forceinline__ OutAgg out_zero() { return {0, 0, 0, 0, 0}; }

__device__ __forceinline__ InAgg add(const InAgg& a, const InAgg& b) {
  return {max(a.m1, b.m1), max(a.m2, b.m2), a.cnt + b.cnt, a.ds + b.ds};
}
__device__ __forceinline__ OutAgg add(const OutAgg& a, const OutAgg& b) {
  return {a.ng + b.ng, a.tot + b.tot, a.s1 + b.s1, a.s2 + b.s2,
          a.ad + b.ad};
}

// Shuffles of the fields the mode uses (kStats: the full=True statistics).
template <bool kStats>
__device__ __forceinline__ InAgg shfl_up(const InAgg& v, int d) {
  InAgg r = v;
  r.m1 = __shfl_up_sync(kFull, v.m1, d);
  if (kStats) {
    r.m2 = __shfl_up_sync(kFull, v.m2, d);
    r.cnt = __shfl_up_sync(kFull, v.cnt, d);
    r.ds = __shfl_up_sync(kFull, v.ds, d);
  }
  return r;
}
template <bool kStats>
__device__ __forceinline__ OutAgg shfl_up(const OutAgg& v, int d) {
  OutAgg r = v;
  r.ng = __shfl_up_sync(kFull, v.ng, d);
  r.s1 = __shfl_up_sync(kFull, v.s1, d);
  if (kStats) {
    r.tot = __shfl_up_sync(kFull, v.tot, d);
    r.s2 = __shfl_up_sync(kFull, v.s2, d);
    r.ad = __shfl_up_sync(kFull, v.ad, d);
  }
  return r;
}
template <bool kStats>
__device__ __forceinline__ InAgg shfl_idx(const InAgg& v, int l) {
  InAgg r = v;
  r.m1 = __shfl_sync(kFull, v.m1, l);
  if (kStats) {
    r.m2 = __shfl_sync(kFull, v.m2, l);
    r.cnt = __shfl_sync(kFull, v.cnt, l);
    r.ds = __shfl_sync(kFull, v.ds, l);
  }
  return r;
}
template <bool kStats>
__device__ __forceinline__ OutAgg shfl_idx(const OutAgg& v, int l) {
  OutAgg r = v;
  r.ng = __shfl_sync(kFull, v.ng, l);
  r.s1 = __shfl_sync(kFull, v.s1, l);
  if (kStats) {
    r.tot = __shfl_sync(kFull, v.tot, l);
    r.s2 = __shfl_sync(kFull, v.s2, l);
    r.ad = __shfl_sync(kFull, v.ad, l);
  }
  return r;
}

// One row of a segmented fold, in row order: a head starts the segment
// anew (f: a head was seen), any other row adds to it.
template <class V>
__device__ __forceinline__ void seg_step(V& v, bool& f, const V& x,
                                         bool head) {
  if (head) {
    v = x;
    f = true;
  } else {
    v = add(v, x);
  }
}

// A segmented scan's element: the value since the last segment start, and
// whether a segment starts inside the range it covers.
template <class V>
struct Seg {
  V v;
  bool f;
};

// Inclusive segmented scan over the warp's lanes, in place.
template <bool kStats, class V>
__device__ __forceinline__ void warp_seg_scan(V& v, bool& f, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const V pv = shfl_up<kStats>(v, d);
    const bool pf = __shfl_up_sync(kFull, f, d);
    if (lane >= d) {
      if (!f) v = add(pv, v);
      f = f || pf;
    }
  }
}

// Exclusive segmented scan over the block's threads (warp shuffles, then
// the warps' totals in shared memory); thread 0 gets (zero, false). One
// barrier: s_warp is written again only after the next tile's ticket
// barrier, which every reader has passed.
template <bool kStats, class V>
__device__ Seg<V> block_seg_excl(V v, bool f, Seg<V>* s_warp,
                                 const V& zero) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_seg_scan<kStats>(v, f, lane);
  if (lane == 31) s_warp[warp] = {v, f};
  V ev = shfl_up<kStats>(v, 1);
  bool ef = __shfl_up_sync(kFull, f, 1);
  if (lane == 0) {
    ev = zero;
    ef = false;
  }
  __syncthreads();
  Seg<V> w = {zero, false};
  for (int k = 0; k < warp; ++k) {
    const Seg<V> s = s_warp[k];
    if (s.f) w = s;
    else w.v = add(w.v, s.v);
  }
  if (!ef) {
    ev = add(w.v, ev);
    ef = w.f;
  }
  return {ev, ef};
}

// Exclusive sum of c over the block's threads, and the block's total (one
// barrier, as block_seg_excl).
__device__ int block_excl_sum(int c, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = c;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  int before = v - c, all = 0;
  for (int k = 0; k < kFoldWarps; ++k) {
    if (k < warp) before += s_warp[k];
    all += s_warp[k];
  }
  *total = all;
  return before;
}

// A closed in-group's share of its out-group.
template <bool kStats>
__device__ __forceinline__ OutAgg out_of(const InAgg& g) {
  OutAgg o = {1, 0, g.m1, 0, 0};
  if (kStats) {
    o.tot = g.cnt;
    o.s2 = g.m2;
    o.ad = plus499(g.ds, g.cnt > 1 ? g.cnt : 1) * g.cnt;
  }
  return o;
}

template <bool kStats>
__device__ __forceinline__ InAgg in_row(const FoldArgs& p, long long src) {
  InAgg r = {p.s1[src], 0, 1, 0};
  if (kStats) {
    r.m2 = p.s2[src];
    r.ds = p.dist[src];
  }
  return r;
}

// The arc row of out-group `id` (dropped past cap).
template <bool kStats>
__device__ void fold_write(const FoldArgs& p, long long id, long long vw,
                           const OutAgg& o) {
  if (id >= p.cap) return;
  p.arc_vw[id] = vw;
  p.arc_s1[id] = static_cast<int32_t>(plus499(o.s1, o.ng));
  if (kStats) {
    p.arc_ng[id] = o.ng;
    p.arc_tot[id] = o.tot;
    p.arc_ad[id] = static_cast<int32_t>(plus499(o.ad, o.tot > 1 ? o.tot : 1));
    p.arc_s2[id] = static_cast<int32_t>(plus499(o.s2, o.ng));
  }
}

// The out-group heads of the tiles before `tile` (one warp): windows of 32
// predecessors, nearest first, their aggregates summed down to the nearest
// inclusive prefix. Tiles are taken in order, so each predecessor is held
// by a running block that publishes its own count before it looks back.
__device__ long long tile_look_back(const unsigned long long* tiles,
                                    long long tile, int lane) {
  long long excl = 0;
  for (long long t = tile - 1; t >= 0; t -= 32) {
    const long long j = t - lane;
    unsigned long long s;
    do {
      s = j >= 0 ? tile_load(tiles + j) : kTilePre;
    } while (__any_sync(kFull, (s & ~kTileCount) == 0));
    const unsigned pre = __ballot_sync(kFull, (s & ~kTileCount) == kTilePre);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    long long v = lane <= stop ? static_cast<long long>(s & kTileCount) : 0;
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    excl += v;
    if (pre) break;
  }
  return excl;
}

// The out-group `id` of vw = klast >> gb ran past its tile, whose last row
// had key klast: one warp reads on from row i0, 32 rows at a time, until vw
// changes, folding the rows' in-groups into co (ci: the in-group open at
// the tile's end when `open`), then writes the arc row.
template <bool kStats>
__device__ void fold_read_on(const FoldArgs& p, long long i0,
                             long long klast, InAgg ci, bool open,
                             OutAgg co, long long id, int lane) {
  const long long sent = kKeySent >> p.jb;
  const long long mask = (1LL << p.jb) - 1;
  const long long vw = klast >> p.gb;
  long long kprev = klast;
  for (long long b = i0;; b += 32) {
    const long long i = b + lane;
    const long long raw = i < p.N ? p.keys[i] : kKeySent;
    const long long k = raw >> p.jb;
    const bool in = k != sent && (k >> p.gb) == vw;
    const unsigned run = __ballot_sync(kFull, in);
    const int n = run == kFull ? 32 : __ffs(~run) - 1;
    // does the chunk's first row continue the open in-group?
    const bool first_cont = n > 0 && __shfl_sync(kFull, k, 0) == kprev;
    if (open && !first_cont) co = add(co, out_of<kStats>(ci));
    const long long up = __shfl_up_sync(kFull, k, 1);
    const long long down = __shfl_down_sync(kFull, k, 1);
    InAgg v = in_zero();
    bool f = false;
    if (lane < n) {
      v = in_row<kStats>(p, p.perm ? p.perm[i] : (raw & mask));
      f = (lane ? up : kprev) != k;
    }
    warp_seg_scan<kStats>(v, f, lane);
    if (!f && first_cont) v = add(ci, v);
    // an in-group closes where the next row's key differs; the chunk's
    // last in-group stays open while the out-group may go on
    const bool closes = lane < n && (lane + 1 < n ? down != k : n < 32);
    OutAgg o = closes ? out_of<kStats>(v) : out_zero();
    for (int d = 16; d; d >>= 1) {
      OutAgg u = o;
      u.ng = __shfl_xor_sync(kFull, o.ng, d);
      u.s1 = __shfl_xor_sync(kFull, o.s1, d);
      if (kStats) {
        u.tot = __shfl_xor_sync(kFull, o.tot, d);
        u.s2 = __shfl_xor_sync(kFull, o.s2, d);
        u.ad = __shfl_xor_sync(kFull, o.ad, d);
      }
      o = add(o, u);
    }
    co = add(co, o);
    if (n < 32) {
      if (lane == 0) fold_write<kStats>(p, id, vw, co);
      return;
    }
    ci = shfl_idx<kStats>(v, 31);
    open = true;
    kprev = __shfl_sync(kFull, k, 31);
  }
}

// One pass over the sorted keys. Persistent blocks take tiles of kFoldTile
// rows in order from a ticket. Each thread holds kFoldRows consecutive rows:
// their keys, origins and values, and their in-/out-group head and last
// flags. The block's scan of out-head counts and the tile's decoupled
// look-back give every row its out-group rank (the pair write); two
// block-wide segmented scans fold the rows into in-groups and the closed
// in-groups into out-groups, whose last row writes the arc row when the
// out-group's head is in the tile. An out-group that runs past the tile is
// finished by the tile's last warp. Once every tile is taken, the blocks
// wait for the last tile's prefix (n_out) and fill the rows past it.
template <bool kStats>
__global__ void __launch_bounds__(kFoldThreads)
merge_fold_kernel(FoldArgs p) {
  __shared__ Seg<InAgg> s_in[kFoldWarps];
  __shared__ Seg<OutAgg> s_out[kFoldWarps];
  __shared__ int s_cnt[kFoldWarps];
  __shared__ long long s_tile, s_pre;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long sent = kKeySent >> p.jb;
  const long long mask = (1LL << p.jb) - 1;
  const bool vec = (reinterpret_cast<uintptr_t>(p.keys) & 15) == 0
                   && (!p.perm
                       || (reinterpret_cast<uintptr_t>(p.perm) & 15) == 0);
  for (;;) {
    if (threadIdx.x == 0)
      s_tile = static_cast<long long>(atomicAdd(p.tiles + p.ntiles, 1ull));
    __syncthreads();
    const long long tile = s_tile;
    if (tile >= p.ntiles) break;
    const long long r0 = tile * kFoldTile
                         + static_cast<long long>(threadIdx.x) * kFoldRows;
    long long k[kFoldRows], src[kFoldRows];
    if (vec && r0 + kFoldRows <= p.N) {
      // 16-byte loads
      const longlong2* kv = reinterpret_cast<const longlong2*>(p.keys + r0);
#pragma unroll
      for (int h = 0; h < kFoldRows / 2; ++h) {
        const longlong2 x = kv[h];
        k[2 * h] = x.x;
        k[2 * h + 1] = x.y;
      }
      if (p.perm) {
        const longlong2* pv =
            reinterpret_cast<const longlong2*>(p.perm + r0);
#pragma unroll
        for (int h = 0; h < kFoldRows / 2; ++h) {
          const longlong2 y = pv[h];
          src[2 * h] = y.x;
          src[2 * h + 1] = y.y;
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < kFoldRows; ++q) {
        const long long i = r0 + q;
        k[q] = i < p.N ? p.keys[i] : kKeySent;
        if (p.perm) src[q] = i < p.N ? p.perm[i] : 0;
      }
    }
#pragma unroll
    for (int q = 0; q < kFoldRows; ++q) {
      if (!p.perm) src[q] = k[q] & mask;
      k[q] >>= p.jb;
    }
    const long long kp = r0 > 0 && r0 - 1 < p.N ? p.keys[r0 - 1] >> p.jb
                                                : sent;
    const long long kn = r0 + kFoldRows < p.N
                             ? p.keys[r0 + kFoldRows] >> p.jb : sent;
    // valid rows, in-/out-group heads and last rows, a bit a row
    unsigned vm = 0, ih = 0, oh = 0, il = 0, ol = 0;
#pragma unroll
    for (int q = 0; q < kFoldRows; ++q) {
      const long long x = k[q];
      const long long pr = q ? k[q - 1] : kp;
      const long long nx = q + 1 < kFoldRows ? k[q + 1] : kn;
      if (x == sent) continue;
      const unsigned bit = 1u << q;
      vm |= bit;
      if (pr != x) ih |= bit;
      if (pr == sent || (pr >> p.gb) != (x >> p.gb)) oh |= bit;
      if (nx != x) il |= bit;
      if (nx == sent || (nx >> p.gb) != (x >> p.gb)) ol |= bit;
    }
    InAgg r[kFoldRows];
#pragma unroll
    for (int q = 0; q < kFoldRows; ++q)
      r[q] = (vm >> q) & 1 ? in_row<kStats>(p, src[q]) : in_zero();

    // the rows' out-group ranks: the block's scan of out-heads, the tile's
    // own count published at once, its look-back after the fold's scans
    int heads;
    const int before = block_excl_sum(__popc(oh), s_cnt, &heads);
    if (threadIdx.x == 0)
      tile_store(p.tiles + tile, (tile ? kTileAgg : kTilePre) | heads);
    // the out-group of the tile's last row runs on past the tile, its head
    // inside: the last warp reads on at the tile's end
    constexpr int kLast = kFoldRows - 1;
    bool read_on = false;
    if (warp == kFoldWarps - 1)
      read_on = heads > 0 && __shfl_sync(kFull, ((vm >> kLast) & 1)
                                                    && !((ol >> kLast) & 1),
                                         31);

    // in-groups: the one open at each thread's start (its head inside the
    // tile when f) ...
    InAgg ci = in_zero();
    bool cf = false;
#pragma unroll
    for (int q = 0; q < kFoldRows; ++q) {
      if (!((vm >> q) & 1)) continue;
      seg_step(ci, cf, r[q], (ih >> q) & 1);
    }
    const Seg<InAgg> pin = block_seg_excl<kStats>(ci, cf, s_in, in_zero());
    // ... then the closed in-groups folded into out-groups
    OutAgg co = out_zero();
    bool of = false;
    ci = pin.v;
    cf = pin.f;
#pragma unroll
    for (int q = 0; q < kFoldRows; ++q) {
      if (!((vm >> q) & 1)) continue;
      seg_step(ci, cf, r[q], (ih >> q) & 1);
      seg_step(co, of,
               (il >> q) & 1 && cf ? out_of<kStats>(ci) : out_zero(),
               (oh >> q) & 1);
    }
    const Seg<OutAgg> pout =
        block_seg_excl<kStats>(co, of, s_out, out_zero());
    if (warp == 0) {
      const long long excl = tile_look_back(p.tiles, tile, lane);
      if (lane == 0) {
        if (tile) tile_store(p.tiles + tile, kTilePre | (excl + heads));
        s_pre = excl;
        if (tile == p.ntiles - 1) *p.n_out = excl + heads;
      }
    }
    __syncthreads();
    // the writes: each valid row's rank at its origin, each out-group
    // whose head is in the tile at its last row
    long long id = s_pre + before - 1;
    ci = pin.v;
    cf = pin.f;
    co = pout.v;
    of = pout.f;
#pragma unroll
    for (int q = 0; q < kFoldRows; ++q) {
      if (!((vm >> q) & 1)) continue;
      if ((oh >> q) & 1) ++id;
      p.pair[src[q]] = static_cast<int32_t>(id);
      seg_step(ci, cf, r[q], (ih >> q) & 1);
      seg_step(co, of,
               (il >> q) & 1 && cf ? out_of<kStats>(ci) : out_zero(),
               (oh >> q) & 1);
      if ((ol >> q) & 1 && of) fold_write<kStats>(p, id, k[q] >> p.gb, co);
    }
    // the out-group open at the tile's end, its head inside: read on
    if (read_on)
      fold_read_on<kStats>(p, (tile + 1) * kFoldTile,
                           __shfl_sync(kFull, k[kLast], 31),
                           shfl_idx<kStats>(ci, 31),
                           __shfl_sync(kFull, !((il >> kLast) & 1), 31),
                           shfl_idx<kStats>(co, 31),
                           __shfl_sync(kFull, id, 31), lane);
  }
  // every tile is taken: the arc rows past n_out once the last tile's
  // prefix is published
  __shared__ long long s_nout;
  if (threadIdx.x == 0) {
    long long n = 0;
    if (p.ntiles > 0) {
      unsigned long long s;
      do {
        s = tile_load(p.tiles + p.ntiles - 1);
      } while ((s & ~kTileCount) != kTilePre);
      n = static_cast<long long>(s & kTileCount);
    } else if (blockIdx.x == 0) {
      *p.n_out = 0;
    }
    s_nout = n;
  }
  __syncthreads();
  const long long step = static_cast<long long>(gridDim.x) * kFoldThreads;
  for (long long i = s_nout + static_cast<long long>(blockIdx.x) * kFoldThreads
                     + threadIdx.x;
       i < p.cap; i += step) {
    p.arc_vw[i] = kArcSent;
    p.arc_s1[i] = 0;
    if (kStats) {
      p.arc_ng[i] = 0;
      p.arc_tot[i] = 0;
      p.arc_ad[i] = 0;
      p.arc_s2[i] = 0;
    }
  }
}

}  // namespace

namespace {

BranchArgs branch_args(const void* pres, const void* cid, const void* cm,
                       const void* rank, int G, const void* tgt, long long A,
                       int frag, long long local_dist,
                       long long local_count) {
  BranchArgs p = {};
  p.pres = static_cast<const uint8_t*>(pres);
  p.cid = static_cast<const int32_t*>(cid);
  p.cm = static_cast<const int64_t*>(cm);
  p.rank = static_cast<const int32_t*>(rank);
  p.G = G;
  p.tgt = static_cast<const int64_t*>(tgt);
  p.A = A;
  p.frag = frag;
  p.local_dist = local_dist;
  p.local_count = local_count;
  return p;
}

// Slots of the wide groups (each of more than kBrRows of the A arcs) and
// words of each bit plane (a bit an arc, a word past the last's).
long long wide_slots(long long A) { return A / (kBrRows + 1) + 1; }
long long wide_words(long long A) { return (A >> 5) + 2; }

// Blocks of the wide path a launch: one every kBrSmsPerWide SMs, cached
// per device. They wait for the arc-tile blocks, so they must be fewer
// than the blocks the device holds at once: a SM holds several.
int wide_blocks() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  int* c = dev >= 0 && dev < 64 ? &cached[dev] : nullptr;
  if (c && *c) return *c;
  int sms = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int g = sms > kBrSmsPerWide ? sms / kBrSmsPerWide : 1;
  if (c) *c = g;
  return g;
}

// The scratch, the tally and the grid of a launch over A arcs; returns its
// blocks.
long long branch_grid(BranchArgs& p, void* scratch, void* tally) {
  char* s = static_cast<char*>(scratch);
  p.sc = reinterpret_cast<unsigned long long*>(s);
  p.wide = reinterpret_cast<WideGroup*>(s + 8 * kScWords);
  p.wbits_aml = reinterpret_cast<unsigned*>(
      s + 8 * kScWords + sizeof(WideGroup) * wide_slots(p.A));
  p.wbits_he = p.wbits_aml + wide_words(p.A);
  p.tally = static_cast<unsigned long long*>(tally);
  p.n_main = (p.A + kBrThreads - 1) / kBrThreads;
  p.n_wide = wide_blocks();
  return p.n_main + p.n_wide;
}

}  // namespace

// Bytes of the branch kernels' scratch over A arcs, zeroed once by the
// caller: every launch that completes leaves it zeroed (its counters, its
// wide groups' item counts and bits), so one serves every launch on one
// stream.
extern "C" long long pg_branch_scratch(long long A) {
  if (A < 1) A = 1;
  return 8LL * kScWords + static_cast<long long>(sizeof(WideGroup))
         * wide_slots(A) + 8LL * wide_words(A);
}

// (aml, he) [A] of groups given by gs / branching / is_max (one rank's
// genomes; OR'd over the ranks before pg_branch_classify). tally uint64
// [4] is added into (the branching arcs stand for the valid ones).
extern "C" int pg_branch_locality(const void* pres, const void* cid,
                                  const void* cm, const void* rank, int G,
                                  const void* tgt, const void* gs,
                                  const void* branching, const void* is_max,
                                  long long A, int frag,
                                  long long local_dist, long long local_count,
                                  void* aml, void* he, void* scratch,
                                  void* tally, void* stream) {
  if (A <= 0) return 0;
  BranchArgs p = branch_args(pres, cid, cm, rank, G, tgt, A, frag,
                             local_dist, local_count);
  p.gs = static_cast<const int64_t*>(gs);
  p.branching = static_cast<const uint8_t*>(branching);
  p.is_max = static_cast<const uint8_t*>(is_max);
  p.aml = static_cast<uint8_t*>(aml);
  p.he = static_cast<uint8_t*>(he);
  const long long blocks = branch_grid(p, scratch, tally);
  branch_kernel<false><<<static_cast<unsigned>(blocks), kBrThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The whole branch block at one rank: groups found in the arc table
// (vw, s1), locality and classification in one launch. aw uint8 [A],
// n_grp int32 [A], counts uint64 [2] zeroed by the caller; tally uint64
// [4] added into.
extern "C" int pg_branch_block(const void* pres, const void* cid,
                               const void* cm, const void* rank, int G,
                               const void* tgt, const void* vw,
                               const void* s1, int B, long long A, int frag,
                               long long local_dist, long long local_count,
                               double diff, double diff_dist,
                               double diff_cut, void* aw, void* n_grp,
                               void* counts, void* scratch, void* tally,
                               void* stream) {
  if (A <= 0) return 0;
  BranchArgs p = branch_args(pres, cid, cm, rank, G, tgt, A, frag,
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
  const long long blocks = branch_grid(p, scratch, tally);
  branch_kernel<true><<<static_cast<unsigned>(blocks), kBrThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The classification of arcs whose (aml, he) are known: aw [A], n_grp [A]
// (0 off the groups' first arcs) and counts [2], zeroed by the caller.
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
  constexpr long long per = static_cast<long long>(kClsThreads) * kClsArcs;
  branch_classify_kernel<<<static_cast<unsigned>((A + per - 1) / per),
                           kClsThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int32_t*>(mx));
  return static_cast<int>(cudaGetLastError());
}

// Tiles of merge_fold's look-back over N keys; its scratch is that many
// 64-bit words and one more (the ticket).
extern "C" long long pg_merge_fold_tiles(long long N) {
  return (N + kFoldTile - 1) / kFoldTile;
}

namespace {

// Blocks of merge_fold a launch: as many as are resident at once on the
// device (each takes tiles until none is left), cached per device and mode.
template <bool kStats>
int fold_grid() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  int* c = dev >= 0 && dev < 64 ? &cached[dev] : nullptr;
  if (c && *c) return *c;
  int sms = 1, per_sm = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, merge_fold_kernel<kStats>, kFoldThreads, 0);
  const int g = sms * (per_sm > 0 ? per_sm : 1);
  if (c) *c = g;
  return g;
}

}  // namespace

// The fold of N sorted keys (merge_fold in ops/loop_kernels.py): one
// launch after one memset of `zero_bytes` from `pair` (the pair plane, then
// the look-back words and the ticket at `tiles`, pg_merge_fold_tiles(N) + 1
// words). s2 and dist (by origin) select the full mode, whose four
// statistics' planes are then written too.
extern "C" int pg_merge_fold(const void* keys, const void* perm,
                             const void* s1, const void* s2,
                             const void* dist, long long N, int jb, int gb,
                             long long cap, void* arc_vw, void* arc_s1,
                             void* arc_ng, void* arc_tot, void* arc_ad,
                             void* arc_s2, void* n_out, void* pair,
                             void* tiles, long long zero_bytes,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(pair, 0, zero_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  FoldArgs p = {};
  p.keys = static_cast<const int64_t*>(keys);
  p.perm = static_cast<const int64_t*>(perm);
  p.s1 = static_cast<const int32_t*>(s1);
  p.s2 = static_cast<const int32_t*>(s2);
  p.dist = static_cast<const int32_t*>(dist);
  p.N = N;
  p.cap = cap;
  p.ntiles = pg_merge_fold_tiles(N);
  p.jb = jb;
  p.gb = gb;
  p.arc_vw = static_cast<int64_t*>(arc_vw);
  p.arc_s1 = static_cast<int32_t*>(arc_s1);
  p.arc_ng = static_cast<int32_t*>(arc_ng);
  p.arc_tot = static_cast<int32_t*>(arc_tot);
  p.arc_ad = static_cast<int32_t*>(arc_ad);
  p.arc_s2 = static_cast<int32_t*>(arc_s2);
  p.n_out = static_cast<int64_t*>(n_out);
  p.pair = static_cast<int32_t*>(pair);
  p.tiles = static_cast<unsigned long long*>(tiles);
  if (s2) {
    merge_fold_kernel<true><<<fold_grid<true>(), kFoldThreads, 0, st>>>(p);
  } else {
    merge_fold_kernel<false><<<fold_grid<false>(), kFoldThreads, 0, st>>>(
        p);
  }
  return static_cast<int>(cudaGetLastError());
}
