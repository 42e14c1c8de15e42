/* Native host sweeps for pangene: cross-gene shadow marking and
 * same-gene overlapping-isoform filtering.
 *
 * Behavior contract is the reference's windowed scans over the cs-sorted
 * hit axis (pg_shadow overlap.c:101-178, pg_flt_ov_isoform overlap.c:58-93)
 * with the exon merge-scan innermost (pg_hit_overlap overlap.c:6-42).
 * These run ~19x per genome over the pruning schedule and dominate the
 * host path; the Python oracles (ops/sweep.py, ops/sweep_vec.py) stay as
 * the differential-test reference for this kernel.
 *
 * All floating-point predicates (cov_short, the score_dom blend) are IEEE
 * double, bit-matching the NumPy f64 host path. Original implementation;
 * no reference code reused.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* Jenkins-style 32-bit integer hash for score tie-breaking; must match
 * ops/sweep.py:hash_uint32 bit-exactly (contract: pgpriv.h:88-97). */
static uint32_t hash_u32(uint32_t k)
{
    k += ~(k << 15);
    k ^= k >> 10;
    k += k << 3;
    k ^= k >> 6;
    k += ~(k << 11);
    k ^= k >> 16;
    return k;
}

/* packed comparison key: score_adj<<33 | preferred<<32 | hash(pid) */
static uint64_t packed_score(int32_t score_adj, uint8_t pref, int32_t pid)
{
    return ((uint64_t)(int64_t)score_adj << 33)
        | ((uint64_t)(pref ? 1 : 0) << 32)
        | (uint64_t)hash_u32((uint32_t)pid);
}

/* CDS intersection of two sorted, non-overlapping exon lists given as
 * offsets relative to each hit's cs. */
static int64_t ov_len(const int32_t *eos, const int32_t *eoe,
                      int64_t cs_a, int32_t off_a, int32_t n_a,
                      int64_t cs_b, int32_t off_b, int32_t n_b)
{
    int32_t a = 0, b = 0;
    int64_t tot = 0;
    while (a < n_a && b < n_b) {
        int64_t s1 = eos[off_a + a] + cs_a, e1 = eoe[off_a + a] + cs_a;
        int64_t s2 = eos[off_b + b] + cs_b, e2 = eoe[off_b + b] + cs_b;
        int64_t lo = s1 > s2 ? s1 : s2, hi = e1 < e2 ? e1 : e2;
        if (hi > lo) tot += hi - lo;
        if (e1 < e2) ++a; else ++b;
    }
    return tot;
}

/* Cross-gene shadow sweep. Arrays are the genome's cs-sorted hit columns;
 * shadow / pid_dom / score_dom are updated in place. Returns the number of
 * unfiltered shadowed hits. Quirks preserved: hit 0 and filtered hits keep
 * their stale shadow flag; the window pointer advances only for unfiltered
 * i; dominators are recorded only when the winner's packed score is > 0;
 * ties keep the first (smallest other-index) dominator. */
/* hot per-hit record for the sweep inner loop: one cacheline instead of
 * ten scattered column reads per j */
typedef struct {
    int64_t cs, ce;
    uint64_t pscore;
    int64_t len;
    int32_t cid, gid, rank, off_exon;
    int32_t n_exon, rev, flt, weak;
} hot_t;

static hot_t *pack_hot(
    int64_t n,
    const int32_t *pid, const int32_t *rank, const int32_t *score_adj,
    const int32_t *n_exon, const int32_t *off_exon,
    const int32_t *cid, const uint8_t *rev, const uint8_t *flt,
    const uint8_t *weak_br,
    const int64_t *cs, const int64_t *ce,
    const int32_t *eos, const int32_t *eoe,
    const int32_t *prot_gid, const uint8_t *gene_pref)
{
    hot_t *h = (hot_t *)malloc((n ? n : 1) * sizeof(hot_t));
    int64_t i;
    for (i = 0; i < n; ++i) {
        int32_t k, e = 0, g = prot_gid[pid[i]];
        for (k = 0; k < n_exon[i]; ++k)
            e += eoe[off_exon[i] + k] - eos[off_exon[i] + k];
        h[i].cs = cs[i];
        h[i].ce = ce[i];
        h[i].pscore = packed_score(score_adj[i], gene_pref[g], pid[i]);
        h[i].len = e;
        h[i].cid = cid[i];
        h[i].gid = g;
        h[i].rank = rank[i];
        h[i].off_exon = off_exon[i];
        h[i].n_exon = n_exon[i];
        h[i].rev = rev[i];
        h[i].flt = flt[i];
        h[i].weak = weak_br ? weak_br[i] : 0;
    }
    return h;
}

int64_t pg_hot_size(void) { return (int64_t)sizeof(hot_t); }

/* refresh only the mutable fields of a previously packed hot table */
void pg_hot_refresh(int64_t n, const uint8_t *flt, const uint8_t *weak_br,
                    hot_t *ht)
{
    int64_t i;
    for (i = 0; i < n; ++i) {
        ht[i].flt = flt[i];
        ht[i].weak = weak_br[i];
    }
}

/* full pack into a caller-provided buffer (for the cached-hot path) */
void pg_hot_pack(
    int64_t n,
    const int32_t *pid, const int32_t *rank, const int32_t *score_adj,
    const int32_t *n_exon, const int32_t *off_exon,
    const int32_t *cid, const uint8_t *rev, const uint8_t *flt,
    const uint8_t *weak_br,
    const int64_t *cs, const int64_t *ce,
    const int32_t *eos, const int32_t *eoe,
    const int32_t *prot_gid, const uint8_t *gene_pref,
    hot_t *ht)
{
    int64_t i;
    for (i = 0; i < n; ++i) {
        int32_t k, e = 0, g = prot_gid[pid[i]];
        for (k = 0; k < n_exon[i]; ++k)
            e += eoe[off_exon[i] + k] - eos[off_exon[i] + k];
        ht[i].cs = cs[i];
        ht[i].ce = ce[i];
        ht[i].pscore = packed_score(score_adj[i], gene_pref[g], pid[i]);
        ht[i].len = e;
        ht[i].cid = cid[i];
        ht[i].gid = g;
        ht[i].rank = rank[i];
        ht[i].off_exon = off_exon[i];
        ht[i].n_exon = n_exon[i];
        ht[i].rev = rev[i];
        ht[i].flt = flt[i];
        ht[i].weak = weak_br ? weak_br[i] : 0;
    }
}

/* core shadow sweep over a pre-packed hot table */
static int64_t sweep_shadow_core(
    int64_t n, const hot_t *ht,
    const int32_t *pid, const int32_t *score_ori,
    const int32_t *eos, const int32_t *eoe,
    const uint8_t *flt, const uint8_t *weak_br,
    int32_t check_strand, double min_ov_ratio, int32_t cal_dom_sc,
    uint8_t *shadow, int32_t *pid_dom, int32_t *score_dom,
    int64_t *geo_off, uint8_t *geo_bytes, int64_t geo_cap,
    int32_t *geo_state);

int64_t pg_sweep_shadow_hot(
    int64_t n, const hot_t *ht,
    const int32_t *pid, const int32_t *score_ori,
    const int32_t *eos, const int32_t *eoe,
    const uint8_t *flt,
    int32_t check_strand, double min_ov_ratio, int32_t cal_dom_sc,
    uint8_t *shadow, int32_t *pid_dom, int32_t *score_dom)
{
    return sweep_shadow_core(n, ht, pid, score_ori, eos, eoe, flt, 0,
                             check_strand, min_ov_ratio, cal_dom_sc,
                             shadow, pid_dom, score_dom, 0, 0, 0, 0);
}

int64_t pg_sweep_shadow(
    int64_t n,
    const int32_t *pid, const int32_t *rank,
    const int32_t *score_adj, const int32_t *score_ori,
    const int32_t *n_exon, const int32_t *off_exon,
    const int32_t *cid, const uint8_t *rev, const uint8_t *flt,
    const uint8_t *weak_br,
    const int64_t *cs, const int64_t *ce,
    const int32_t *eos, const int32_t *eoe,
    const int32_t *prot_gid, const uint8_t *gene_pref,
    int32_t check_strand, double min_ov_ratio, int32_t cal_dom_sc,
    uint8_t *shadow, int32_t *pid_dom, int32_t *score_dom)
{
    hot_t *ht;
    int64_t r;
    if (n == 0) return 0;
    ht = pack_hot(n, pid, rank, score_adj, n_exon, off_exon, cid, rev,
                  flt, weak_br, cs, ce, eos, eoe, prot_gid, gene_pref);
    r = sweep_shadow_core(n, ht, pid, score_ori, eos, eoe, flt, 0,
                          check_strand, min_ov_ratio, cal_dom_sc,
                          shadow, pid_dom, score_dom, 0, 0, 0, 0);
    free(ht);
    return r;
}

/* Round-invariant pair-geometry cache (the host-side analogue of the
 * device schedule's sweep_geo_planes): for each hit i a contiguous window
 * of original indices [i - w_i, i) with one byte per pair:
 *   bit0  pair evaluable at round 1: both ends live at the recording
 *         sweep, cid equal, ce_j > cs_i, strand, exact exon intersection
 *         > 0, and the cov_short gate
 *         same_gene || !((double)ov/min(len) < min_ov_ratio)
 *   bit1  same gene
 *   bit2  i loses on (packed score, rank) — overlap.c:139-142 tie order
 * Recorded as a BYPRODUCT of the first hot-cached sweep (no extra ov_len
 * work); valid for every later round because flt is monotone (only ever
 * set — a pair evaluated in round k was evaluated in round 1) and the
 * physical order is version-keyed. geo_state: 0 = record during this
 * sweep, 1 = valid (byte lookups), -1 = cap overflow (disabled). */
static int64_t sweep_shadow_core(
    int64_t n, const hot_t *ht,
    const int32_t *pid, const int32_t *score_ori,
    const int32_t *eos, const int32_t *eoe,
    const uint8_t *flt, const uint8_t *weak_br,
    int32_t check_strand, double min_ov_ratio, int32_t cal_dom_sc,
    uint8_t *shadow, int32_t *pid_dom, int32_t *score_dom,
    int64_t *geo_off, uint8_t *geo_bytes, int64_t geo_cap,
    int32_t *geo_state)
{
    int32_t geo_use = geo_state && *geo_state == 1 && geo_bytes
        && !cal_dom_sc;
    int32_t geo_rec = geo_state && *geo_state == 0 && geo_bytes
        && !cal_dom_sc;
    int64_t geo_cur = 0;
    int64_t i, a, b0 = 0, nl = 0, n_shadow = 0;
    int64_t *tmp_ov;
    uint64_t *tmp_score;
    int32_t *tmp_aid;
    hot_t *hl;
    int64_t *orig;
    if (n == 0) return 0;
    tmp_ov = (int64_t *)calloc(n, 8);
    tmp_score = (uint64_t *)calloc(n, 8);
    tmp_aid = (int32_t *)calloc(n, 4);
    /* Sweep over the LIVE (unfiltered) sublist only: the reference scans
     * every j and skips flt inside the loop, but flt never changes during
     * a sweep, and the monotone window start restricted to live hits is
     * path-identical (within a cid the predicate ce>cs only hardens as cs
     * grows; a cid change fails every previous-contig hit for both), so
     * the evaluated pair set and order are exactly the reference's. In
     * late pruning rounds a large fraction of hits is filtered and the
     * quadratic window work shrinks accordingly. */
    hl = (hot_t *)malloc((n ? n : 1) * sizeof(hot_t));
    orig = (int64_t *)malloc((n ? n : 1) * 8);
    for (i = 0; i < n; ++i) {
        if (flt[i]) continue;        /* live column, NOT the frozen pack */
        hl[nl] = ht[i];
        hl[nl].flt = 0;
        if (weak_br) hl[nl].weak = weak_br[i];
        orig[nl] = i;
        ++nl;
    }
    if (geo_rec)
        memset(geo_off, 0, (size_t)(n + 1) * 8);  /* widths in [i+1] */
    for (a = 0; a < nl; ++a) {
        int64_t b;
        const hot_t hi_r = hl[a];
        uint64_t si;
        int32_t wi;
        uint8_t *grow = 0;
        int64_t gjlo = 0;
        i = orig[a];
        if (i < 1) continue;   /* hit 0 is never evaluated as i */
        while (b0 < a && !(hl[b0].cid == hi_r.cid && hl[b0].ce > hi_r.cs))
            ++b0;
        shadow[i] = 0;
        si = hi_r.pscore;
        wi = hi_r.weak;
        if (geo_use) {
            /* cached-geometry rounds (cal_dom_sc == 0): the static gates,
             * exon intersections and score tie-orders collapse to one
             * byte per pair; only the weak compare is per-round */
            const int64_t jlo = i - (geo_off[i + 1] - geo_off[i]);
            const uint8_t *row = geo_bytes + geo_off[i];
            for (b = b0; b < a; ++b) {
                int64_t j = orig[b], loser, winner;
                uint8_t byte;
                if (j < jlo) continue;
                byte = row[j - jlo];
                if (!(byte & 1)) continue;
                if ((byte & 2) || wi == hl[b].weak)
                    loser = (byte & 4) ? i : j;
                else
                    loser = wi > hl[b].weak ? i : j;
                winner = loser == i ? j : i;
                shadow[loser] = 1;
                if (tmp_score[loser] < ht[winner].pscore) {
                    tmp_score[loser] = ht[winner].pscore;
                    tmp_aid[loser] = (int32_t)winner;
                }
            }
            continue;
        }
        if (geo_rec) {
            /* record this window as a byproduct: [gjlo, i) in original
             * indices, one byte per pair, non-evaluable pairs stay 0 */
            int64_t w;
            gjlo = b0 < a ? orig[b0] : i;
            w = i - gjlo;
            if (geo_cur + w > geo_cap) {
                geo_rec = 0;
                *geo_state = -1;   /* cap overflow: cache off for good */
            } else {
                grow = geo_bytes + geo_cur;
                memset(grow, 0, (size_t)w);
                geo_off[i + 1] = w;
                geo_cur += w;
            }
        }
        for (b = b0; b < a; ++b) {
            const hot_t *hj = &hl[b];
            int64_t ov, j, loser, winner;
            uint64_t sj;
            int32_t wj;
            if (hj->ce <= hi_r.cs) continue;
            if (hj->cid != hi_r.cid) continue;
            if (check_strand && hi_r.rev != hj->rev) continue;
            ov = ov_len(eos, eoe, hj->cs, hj->off_exon, hj->n_exon,
                        hi_r.cs, hi_r.off_exon, hi_r.n_exon);
            if (ov == 0) continue;
            if (hi_r.gid != hj->gid) {
                int64_t m = hi_r.len < hj->len ? hi_r.len : hj->len;
                if ((double)ov / (double)m < min_ov_ratio) continue;
            }
            j = orig[b];
            sj = hj->pscore;
            wj = hj->weak;
            if (grow) {
                /* pair passed every round-invariant gate: freeze it plus
                 * the same-gene bit and the (pscore, rank) tie order */
                uint8_t by = 1;
                if (hi_r.gid == hj->gid) by |= 2;
                if (si < sj || (si == sj && hi_r.rank > hj->rank)) by |= 4;
                grow[j - gjlo] = by;
            }
            if (hi_r.gid == hj->gid || wi == wj)
                loser = (si < sj || (si == sj && hi_r.rank > hj->rank))
                    ? i : j;
            else
                loser = wi > wj ? i : j;
            winner = loser == i ? j : i;
            shadow[loser] = 1;
            if (tmp_score[loser] < ht[winner].pscore) {
                tmp_score[loser] = ht[winner].pscore;
                tmp_aid[loser] = (int32_t)winner;
                tmp_ov[loser] = ov;
            }
        }
    }
    free(hl); free(orig);
    if (geo_rec) {
        /* widths -> offsets; the cache serves every later round */
        for (i = 0; i < n; ++i) geo_off[i + 1] += geo_off[i];
        *geo_state = 1;
    }
    for (i = 0; i < n; ++i) {
        if (flt[i]) continue;
        pid_dom[i] = -1;
        if (cal_dom_sc) score_dom[i] = -1;
        if (tmp_score[i] > 0) {
            int64_t j = tmp_aid[i];
            pid_dom[i] = pid[j];
            if (cal_dom_sc) {
                double b = (double)score_ori[i]
                    * (1.0 - (double)tmp_ov[i] / (double)ht[i].len)
                    + (double)score_ori[j]
                    * ((double)tmp_ov[i] / (double)ht[j].len) + 0.499;
                score_dom[i] = (int32_t)(int64_t)b;
            }
        }
        if (shadow[i]) ++n_shadow;
    }
    free(tmp_ov); free(tmp_score); free(tmp_aid);
    return n_shadow;
}

/* transposed [gene][genome] representative tables for locality tests */
typedef struct {
    int32_t G;
    uint8_t *pres;
    int32_t *cid, *rank;
    int64_t *cm;
} rep_t;

static void rep_build(rep_t *r, int32_t n_genome, int32_t n_gene,
                      const uint8_t *present, const int32_t *cid,
                      const int32_t *rank, const int64_t *cm)
{
    int32_t g, v;
    r->G = n_genome;
    r->pres = (uint8_t *)malloc((size_t)n_gene * n_genome);
    r->cid = (int32_t *)malloc((size_t)n_gene * n_genome * 4);
    r->rank = (int32_t *)malloc((size_t)n_gene * n_genome * 4);
    r->cm = (int64_t *)malloc((size_t)n_gene * n_genome * 8);
    for (g = 0; g < n_genome; ++g)
        for (v = 0; v < n_gene; ++v) {
            size_t s = (size_t)g * n_gene + v, t = (size_t)v * n_genome + g;
            r->pres[t] = present[s];
            r->cid[t] = cid[s];
            r->rank[t] = rank[s];
            r->cm[t] = cm[s];
        }
}

static void rep_free(rep_t *r)
{
    free(r->pres); free(r->cid); free(r->rank); free(r->cm);
}

/* pg_n_local semantics (branch.c:31-46) for one gene pair */
static int32_t rep_n_local(const rep_t *r, int64_t ga, int64_t gb,
                           int64_t local_dist, int64_t local_count,
                           int32_t frag_mode)
{
    size_t a = (size_t)ga * r->G, b = (size_t)gb * r->G;
    int32_t g, cnt = 0;
    for (g = 0; g < r->G; ++g) {
        int64_t dd, cc;
        if (!(r->pres[a + g] && r->pres[b + g])) continue;
        if (!frag_mode && r->cid[a + g] != r->cid[b + g]) continue;
        dd = r->cm[a + g] - r->cm[b + g];
        if (dd < 0) dd = -dd;
        cc = (int64_t)r->rank[a + g] - r->rank[b + g];
        if (cc < 0) cc = -cc;
        if (dd <= local_dist || cc <= local_count) ++cnt;
    }
    return cnt;
}

/* existence-only variant: callers that only test n_local != 0 can stop at
 * the first local genome */
static int32_t rep_any_local(const rep_t *r, int64_t ga, int64_t gb,
                             int64_t local_dist, int64_t local_count,
                             int32_t frag_mode)
{
    size_t a = (size_t)ga * r->G, b = (size_t)gb * r->G;
    int32_t g;
    for (g = 0; g < r->G; ++g) {
        int64_t dd, cc;
        if (!(r->pres[a + g] && r->pres[b + g])) continue;
        if (!frag_mode && r->cid[a + g] != r->cid[b + g]) continue;
        dd = r->cm[a + g] - r->cm[b + g];
        if (dd < 0) dd = -dd;
        cc = (int64_t)r->rank[a + g] - r->rank[b + g];
        if (cc < 0) cc = -cc;
        if (dd <= local_dist || cc <= local_count) return 1;
    }
    return 0;
}

/* Batched cross-genome locality counts for gene pairs (pg_n_local,
 * branch.c:31-46; semantics of ops/branch.py:n_local_batch). */
void pg_n_local_batch(
    int64_t n_pair, int32_t n_genome, int32_t n_gene,
    const uint8_t *present, const int32_t *cid, const int32_t *rank,
    const int64_t *cm,
    const int64_t *g1, const int64_t *g2,
    int64_t local_dist, int64_t local_count, int32_t frag_mode,
    int32_t *out)
{
    rep_t r;
    int64_t p;
    rep_build(&r, n_genome, n_gene, present, cid, rank, cm);
    for (p = 0; p < n_pair; ++p)
        out[p] = rep_n_local(&r, g1[p], g2[p],
                             local_dist, local_count, frag_mode);
    rep_free(&r);
}

/* Full branching-arc marking pass (reference pg_mark_branch_flt_arc,
 * branch.c:48-106): per x-sorted source-vertex group, arcs with relative
 * score deficit r > branch_diff get weak_br 1 (demote) or 2 (cut, when
 * r > branch_diff_cut or no cross-genome local co-occurrence with any
 * max-score sibling and r > branch_diff_dist); per-vertex distant-loci
 * counts come from greedy locality grouping of the targets. Float
 * predicates are IEEE double, matching the NumPy path including the
 * gmax==0 inf/nan behavior. weak_br and n_dist_loci must arrive zeroed.
 * n_flt[0] += demoted, n_flt[1] += cut. */
void pg_mark_branch(
    int64_t n_arc,
    const uint64_t *x, const int32_t *s1, const int32_t *tgt_gid,
    int32_t n_genome, int32_t n_gene,
    const uint8_t *present, const int32_t *cid, const int32_t *rank,
    const int64_t *cm,
    double branch_diff, double branch_diff_dist, double branch_diff_cut,
    int64_t local_dist, int64_t local_count, int32_t frag_mode,
    uint8_t *weak_br, int32_t *n_dist_loci, int64_t *n_flt)
{
    rep_t r;
    int64_t gs = 0;
    int32_t cap = 16;
    int32_t *grp = (int32_t *)malloc(cap * 4);
    rep_build(&r, n_genome, n_gene, present, cid, rank, cm);
    while (gs < n_arc) {
        uint64_t src = x[gs] >> 32;
        int64_t ge = gs + 1, i, j;
        int64_t gmax = 0;
        int32_t n, n_group = 0;
        while (ge < n_arc && (x[ge] >> 32) == src) ++ge;
        n = (int32_t)(ge - gs);
        if (n < 2) { gs = ge; continue; }
        for (i = gs; i < ge; ++i)
            if (s1[i] > gmax) gmax = s1[i];
        for (i = gs; i < ge; ++i) {
            double rr = 1.0 - (double)s1[i] / (double)gmax;
            int64_t nloc = 0;
            int32_t cut;
            if (!(rr > branch_diff)) continue;
            for (j = gs; j < ge && nloc == 0; ++j)
                if (s1[j] == gmax)   /* only nloc==0 is tested below */
                    nloc = rep_any_local(&r, tgt_gid[j], tgt_gid[i],
                                         local_dist, local_count, frag_mode);
            cut = (nloc == 0 && rr > branch_diff_dist)
                || rr > branch_diff_cut;
            weak_br[i] = cut ? 2 : 1;
            ++n_flt[cut ? 1 : 0];
        }
        /* greedy distant-loci grouping over the group's targets
         * (branch.c:82-90 semantics as in ops/branch.py) */
        if (n > cap) {
            cap = n;
            grp = (int32_t *)realloc(grp, (size_t)cap * 4);
        }
        memset(grp, 0, (size_t)n * 4);
        for (i = 0; i < n; ++i) {
            if (grp[i] == 0) grp[i] = ++n_group;
            for (j = i + 1; j < n; ++j)
                if (grp[j] == 0
                    && rep_any_local(&r, tgt_gid[gs + i], tgt_gid[gs + j],
                                     local_dist, local_count, frag_mode))
                    grp[j] = grp[i];
        }
        n_dist_loci[src] = n_group;
        gs = ge;
    }
    free(grp);
    rep_free(&r);
}

int64_t pg_walk_arcs(
    int64_t n, const int64_t *view,
    const uint8_t *flt, const uint8_t *shadow,
    const int32_t *pid, const uint8_t *rev, const int32_t *cid,
    const int64_t *cm,
    const int32_t *score_ori, const int32_t *score_dom,
    const int32_t *pid_dom0,
    const int32_t *prot_gid, const int32_t *g2s,
    int32_t use_ori, int32_t n_seg, int32_t *seg_cnt,
    uint64_t *out_x, int32_t *out_n, int32_t *out_dist,
    int32_t *out_s1, int32_t *out_s2);

static int64_t walk_cached(
    int64_t n, const int64_t *view,
    const uint8_t *flt, const uint8_t *shadow,
    const int32_t *pid, const uint8_t *rev, const int32_t *cid,
    const int64_t *cm,
    const int32_t *score_ori, const int32_t *score_dom,
    const int32_t *pid_dom0,
    const int32_t *prot_gid, const int32_t *g2s,
    int32_t use_ori, int32_t n_seg, int32_t *seg_cnt,
    uint64_t *out_x, int32_t *out_n, int32_t *out_dist,
    int32_t *out_s1, int32_t *out_s2,
    void *wpack, int32_t wpack_valid, uint8_t *wscratch);

/* Fused per-genome round stage: shadow sweep (cal_dom_sc = 0) followed by
 * walk extraction + dedupe, one crossing of the ctypes boundary per
 * genome per round instead of two. run_shadow = 0 skips the sweep (the
 * Python memo layer proved (flt, weak_br) unchanged since the last one).
 * Returns pg_walk_arcs' result. */
int64_t pg_round_genome(
    int64_t n,
    const int32_t *pid, const int32_t *rank,
    const int32_t *score_adj, const int32_t *score_ori,
    const int32_t *n_exon, const int32_t *off_exon,
    const int32_t *cid, const uint8_t *rev, const uint8_t *flt,
    const uint8_t *weak_br,
    const int64_t *cs, const int64_t *ce,
    const int32_t *eos, const int32_t *eoe,
    const int32_t *prot_gid, const uint8_t *gene_pref,
    int32_t check_strand, double min_ov_ratio,
    uint8_t *shadow, int32_t *pid_dom, int32_t *score_dom,
    int32_t run_shadow,
    const int64_t *view,
    const int64_t *cm,
    const int32_t *pid_dom0,
    const int32_t *g2s,
    int32_t use_ori, int32_t n_seg, int32_t *seg_cnt,
    uint64_t *out_x, int32_t *out_n, int32_t *out_dist,
    int32_t *out_s1, int32_t *out_s2,
    hot_t *hot_buf, int32_t hot_valid,
    int64_t *geo_off, uint8_t *geo_bytes, int64_t geo_cap,
    int32_t *geo_state,
    void *wpack, int32_t wpack_valid, uint8_t *wscratch)
{
    if (run_shadow) {
        if (hot_buf) {
            /* constants (coords, scores, gid, packed keys, CDS lens) are
             * frozen after ingest: pack once per genome, refresh only the
             * two mutable flag fields on later rounds */
            if (!hot_valid)
                pg_hot_pack(n, pid, rank, score_adj, n_exon, off_exon,
                            cid, rev, flt, weak_br, cs, ce, eos, eoe,
                            prot_gid, gene_pref, hot_buf);
            /* the pack is fully frozen: live flt/weak are read from the
             * columns at sublist build, so no per-round refresh pass
             * (it touched every 64B line of the table) */
            /* per-genome pair-geometry cache: recorded as a byproduct of
             * the first sweep (state 0->1), byte lookups thereafter,
             * permanently off on cap overflow (-1); see the cache contract
             * above sweep_shadow_core */
            sweep_shadow_core(n, hot_buf, pid, score_ori, eos, eoe, flt,
                              weak_br, check_strand, min_ov_ratio, 0,
                              shadow, pid_dom, score_dom,
                              geo_off, geo_bytes, geo_cap, geo_state);
        } else {
            pg_sweep_shadow(n, pid, rank, score_adj, score_ori, n_exon,
                            off_exon, cid, rev, flt, weak_br, cs, ce,
                            eos, eoe, prot_gid, gene_pref, check_strand,
                            min_ov_ratio, 0, shadow, pid_dom, score_dom);
        }
    }
    return walk_cached(n, view, flt, shadow, pid, rev, cid, cm,
                       score_ori, score_dom, pid_dom0, prot_gid, g2s,
                       use_ori, n_seg, seg_cnt,
                       out_x, out_n, out_dist, out_s1, out_s2,
                       wpack, wpack_valid, wscratch);
}

/* ---------------- arc extraction / dedupe / merge ---------------- */

typedef struct { uint64_t x; int64_t d; int32_t s1, s2; } tmparc_t;

/* stable LSD radix sort of (key, index) pairs; empty byte passes skipped.
 * kb0/ib0: optional caller scratch of n entries (else malloc'd). */
static void radix_sort_u64_s(uint64_t *keys, uint32_t *idx, int64_t n,
                             uint64_t *kb0, uint32_t *ib0)
{
    uint64_t *ka = keys, *kb = kb0 ? kb0 : (uint64_t *)malloc(n * 8);
    uint32_t *ia = idx, *ib = ib0 ? ib0 : (uint32_t *)malloc(n * 4);
    int64_t cnt[256], pos[256], i;
    int pass;
    for (pass = 0; pass < 8; ++pass) {
        int sh = pass * 8;
        uint64_t *kt; uint32_t *it;
        memset(cnt, 0, sizeof(cnt));
        for (i = 0; i < n; ++i) ++cnt[(ka[i] >> sh) & 0xff];
        if (n && cnt[(ka[0] >> sh) & 0xff] == n) continue;
        pos[0] = 0;
        for (i = 1; i < 256; ++i) pos[i] = pos[i - 1] + cnt[i - 1];
        for (i = 0; i < n; ++i) {
            int b = (ka[i] >> sh) & 0xff;
            kb[pos[b]] = ka[i];
            ib[pos[b]] = ia[i];
            ++pos[b];
        }
        kt = ka; ka = kb; kb = kt;
        it = ia; ia = ib; ib = it;
    }
    if (ka != keys) {
        memcpy(keys, ka, n * 8);
        memcpy(idx, ia, n * 4);
    }
    if (!kb0) { free(ka == keys ? kb : ka); free(ia == idx ? ib : ia); }
}

static void radix_sort_u64(uint64_t *keys, uint32_t *idx, int64_t n)
{
    radix_sort_u64_s(keys, idx, n, 0, 0);
}

/* Walk-constant record, one per cm position: every field of the walk scan
 * that is frozen after ingest (pid/cid/cm/rev/score_ori and the pid_dom0
 * snapshot never change; the view itself is the memoized cm permutation),
 * laid out sequentially in walk order so the per-round scan's only random
 * reads are the live columns (flt/shadow/score_dom via phys) and g2s. */
typedef struct {
    int64_t cm;
    int32_t phys, cid, gid, dom_gid, sc_ori;
    uint8_t rev;
    uint8_t pad[3];
} wrec_t;

int64_t pg_wrec_size(void) { return (int64_t)sizeof(wrec_t); }

void pg_walk_pack(
    int64_t n, const int64_t *view,
    const int32_t *pid, const uint8_t *rev, const int32_t *cid,
    const int64_t *cm, const int32_t *score_ori, const int32_t *pid_dom0,
    const int32_t *prot_gid, wrec_t *wp)
{
    int64_t k;
    for (k = 0; k < n; ++k) {
        int64_t i = view ? view[k] : k;
        wp[k].cm = cm[i];
        wp[k].phys = (int32_t)i;
        wp[k].cid = cid[i];
        wp[k].gid = prot_gid[pid[i]];
        wp[k].dom_gid = pid_dom0[i] < 0 ? -1 : prot_gid[pid_dom0[i]];
        wp[k].sc_ori = score_ori[i];
        wp[k].rev = rev[i];
    }
}

/* scratch for one walk call: 2*(n-1) entries each; caller-reused across
 * rounds to avoid the per-call malloc/mmap churn of ~400KB */
typedef struct {
    tmparc_t *tmp;
    uint64_t *xs, *kb;
    uint32_t *ix, *ib;
} wscratch_t;

static int64_t walk_core(
    int64_t n, const int64_t *view,
    const uint8_t *flt, const uint8_t *shadow,
    const int32_t *pid, const uint8_t *rev, const int32_t *cid,
    const int64_t *cm,
    const int32_t *score_ori, const int32_t *score_dom,
    const int32_t *pid_dom0,
    const int32_t *prot_gid, const int32_t *g2s,
    int32_t use_ori, int32_t n_seg, int32_t *seg_cnt,
    uint64_t *out_x, int32_t *out_n, int32_t *out_dist,
    int32_t *out_s1, int32_t *out_s2,
    const wrec_t *wp, const wscratch_t *ws)
{
    int64_t k, m = 0, prev = -1;
    int64_t prev_w = 0, prev_sc = 0;
    int64_t cap = n > 1 ? 2 * (n - 1) : 1;
    tmparc_t *tmp = ws ? ws->tmp : (tmparc_t *)malloc(cap * sizeof(tmparc_t));
    int64_t n_tmp = 0;
    int64_t prev_cm = 0;
    int32_t prev_cid = -1;
    if (wp) {
        /* packed scan: sequential wrec stream; flt/shadow/score_dom/g2s
         * are the only gathers */
        for (k = 0; k < n; ++k) {
            const wrec_t *r = &wp[k];
            int64_t i = r->phys, sid, w, sc;
            if (flt[i] || shadow[i]) continue;
            sid = g2s[r->gid];
            if (sid < 0) { if (!ws) free(tmp); return -1; }
            if (sid < n_seg) ++seg_cnt[sid];
            w = (sid << 1) | r->rev;
            if (use_ori || r->sc_ori > score_dom[i] || r->dom_gid < 0
                || g2s[r->dom_gid] >= 0)
                sc = r->sc_ori;
            else
                sc = score_dom[i];
            if (prev >= 0 && prev_cid == r->cid) {
                int64_t dist = r->cm - prev_cm;
                tmp[n_tmp].x = ((uint64_t)prev_w << 32) | (uint64_t)w;
                tmp[n_tmp].d = dist;
                tmp[n_tmp].s1 = (int32_t)prev_sc;
                tmp[n_tmp].s2 = (int32_t)sc;
                ++n_tmp;
                tmp[n_tmp].x = ((uint64_t)(w ^ 1) << 32)
                    | (uint64_t)(prev_w ^ 1);
                tmp[n_tmp].d = dist;
                tmp[n_tmp].s1 = (int32_t)sc;
                tmp[n_tmp].s2 = (int32_t)prev_sc;
                ++n_tmp;
            }
            prev = i; prev_w = w; prev_sc = sc;
            prev_cid = r->cid; prev_cm = r->cm;
        }
    } else {
        for (k = 0; k < n; ++k) {
            int64_t i = view ? view[k] : k;
            int64_t sid, w, sc;
            if (flt[i] || shadow[i]) continue;
            sid = g2s[prot_gid[pid[i]]];
            if (sid < 0) { if (!ws) free(tmp); return -1; }
            if (sid < n_seg) ++seg_cnt[sid];
            w = (sid << 1) | rev[i];
            if (use_ori || score_ori[i] > score_dom[i] || pid_dom0[i] < 0
                || g2s[prot_gid[pid_dom0[i]]] >= 0)
                sc = score_ori[i];
            else
                sc = score_dom[i];
            if (prev >= 0 && cid[prev] == cid[i]) {
                int64_t dist = cm[i] - cm[prev];
                tmp[n_tmp].x = ((uint64_t)prev_w << 32) | (uint64_t)w;
                tmp[n_tmp].d = dist;
                tmp[n_tmp].s1 = (int32_t)prev_sc;
                tmp[n_tmp].s2 = (int32_t)sc;
                ++n_tmp;
                tmp[n_tmp].x = ((uint64_t)(w ^ 1) << 32)
                    | (uint64_t)(prev_w ^ 1);
                tmp[n_tmp].d = dist;
                tmp[n_tmp].s1 = (int32_t)sc;
                tmp[n_tmp].s2 = (int32_t)prev_sc;
                ++n_tmp;
            }
            prev = i; prev_w = w; prev_sc = sc;
        }
    }
    {
        uint64_t *xs = ws ? ws->xs : (uint64_t *)malloc((n_tmp ? n_tmp : 1) * 8);
        uint32_t *ix = ws ? ws->ix : (uint32_t *)malloc((n_tmp ? n_tmp : 1) * 4);
        for (k = 0; k < n_tmp; ++k) { xs[k] = tmp[k].x; ix[k] = (uint32_t)k; }
        radix_sort_u64_s(xs, ix, n_tmp, ws ? ws->kb : 0, ws ? ws->ib : 0);
        for (k = 0; k < n_tmp; ) {
            /* group max seeded with 0, matching the NumPy maximum.at-into-
             * zeros dedupe (scores are non-negative in practice) */
            const tmparc_t *t0 = &tmp[ix[k]];
            int64_t e = k + 1, cnt, dsum = t0->d;
            int32_t m1 = t0->s1 > 0 ? t0->s1 : 0;
            int32_t m2 = t0->s2 > 0 ? t0->s2 : 0;
            while (e < n_tmp && xs[e] == xs[k]) {
                const tmparc_t *t = &tmp[ix[e]];
                dsum += t->d;
                if (t->s1 > m1) m1 = t->s1;
                if (t->s2 > m2) m2 = t->s2;
                ++e;
            }
            cnt = e - k;
            out_x[m] = xs[k];
            out_n[m] = (int32_t)cnt;
            out_dist[m] = (int32_t)(int64_t)((double)dsum / (double)cnt + 0.499);
            out_s1[m] = m1;
            out_s2[m] = m2;
            ++m;
            k = e;
        }
        if (!ws) { free(xs); free(ix); }
    }
    if (!ws) free(tmp);
    return m;
}

/* Per-genome gene-walk arc extraction + dedupe (pg_gen_arc per-genome part,
 * graph.c:106-145; semantics of ops/arcs.py walk_extract + dedupe_genome).
 * view (may be NULL) is the cm-order index vector over the cs-physical hit
 * columns. Each adjacent kept pair on one contig emits the arc and its
 * complement; dedupe groups by x with count / +.499-rounded mean distance /
 * max scores. seg_cnt (caller-zeroed, [n_seg]) receives per-segment kept-
 * hit counts. Output buffers must hold 2*(n-1) entries; returns the number
 * of deduped arcs, or -1 when a kept hit maps to a deleted segment. */
int64_t pg_walk_arcs(
    int64_t n, const int64_t *view,
    const uint8_t *flt, const uint8_t *shadow,
    const int32_t *pid, const uint8_t *rev, const int32_t *cid,
    const int64_t *cm,
    const int32_t *score_ori, const int32_t *score_dom,
    const int32_t *pid_dom0,
    const int32_t *prot_gid, const int32_t *g2s,
    int32_t use_ori, int32_t n_seg, int32_t *seg_cnt,
    uint64_t *out_x, int32_t *out_n, int32_t *out_dist,
    int32_t *out_s1, int32_t *out_s2)
{
    return walk_core(n, view, flt, shadow, pid, rev, cid, cm, score_ori,
                     score_dom, pid_dom0, prot_gid, g2s, use_ori, n_seg,
                     seg_cnt, out_x, out_n, out_dist, out_s1, out_s2,
                     0, 0);
}

/* pg_round_genome's walk entry: optional frozen walk-pack (built here on
 * first use, wpack_valid = 0) and a caller-reused scratch blob laid out as
 * tmp[cap] | xs[cap] | kb[cap] | ix[cap] | ib[cap] with cap = 2*(n-1). */
static int64_t walk_cached(
    int64_t n, const int64_t *view,
    const uint8_t *flt, const uint8_t *shadow,
    const int32_t *pid, const uint8_t *rev, const int32_t *cid,
    const int64_t *cm,
    const int32_t *score_ori, const int32_t *score_dom,
    const int32_t *pid_dom0,
    const int32_t *prot_gid, const int32_t *g2s,
    int32_t use_ori, int32_t n_seg, int32_t *seg_cnt,
    uint64_t *out_x, int32_t *out_n, int32_t *out_dist,
    int32_t *out_s1, int32_t *out_s2,
    void *wpack, int32_t wpack_valid, uint8_t *wscratch)
{
    wrec_t *wp = (wrec_t *)wpack;
    wscratch_t ws, *wsp = 0;
    if (wp && !wpack_valid)
        pg_walk_pack(n, view, pid, rev, cid, cm, score_ori, pid_dom0,
                     prot_gid, wp);
    if (wscratch) {
        int64_t cap = n > 1 ? 2 * (n - 1) : 1;
        ws.tmp = (tmparc_t *)wscratch;
        ws.xs = (uint64_t *)(wscratch + cap * (int64_t)sizeof(tmparc_t));
        ws.kb = ws.xs + cap;
        ws.ix = (uint32_t *)(ws.kb + cap);
        ws.ib = ws.ix + cap;
        wsp = &ws;
    }
    return walk_core(n, view, flt, shadow, pid, rev, cid, cm, score_ori,
                     score_dom, pid_dom0, prot_gid, g2s, use_ori, n_seg,
                     seg_cnt, out_x, out_n, out_dist, out_s1, out_s2,
                     wp, wsp);
}

/* Representative positions for one genome (pg_gen_rep_pos, branch.c:6-29):
 * the LAST kept (unfiltered, unshadowed) hit of each gene in cs order,
 * with its contig, kept-rank and cm. Backward scan, first-seen wins.
 * Outputs are compact lists of length = #distinct kept genes. */
int64_t pg_rep_pos(
    int64_t n, const uint8_t *flt, const uint8_t *shadow,
    const int32_t *pid, const int32_t *cid, const int64_t *cm,
    const int32_t *prot_gid, int32_t n_gene,
    int32_t *out_gid, int32_t *out_cid, int32_t *out_rank, int64_t *out_cm)
{
    uint8_t *seen = (uint8_t *)calloc(n_gene ? n_gene : 1, 1);
    int64_t i, m = 0, n_keep = 0;
    int32_t *rank_of = (int32_t *)malloc((n ? n : 1) * 4);
    for (i = 0; i < n; ++i)
        rank_of[i] = !flt[i] && !shadow[i] ? (int32_t)n_keep++ : -1;
    for (i = n - 1; i >= 0; --i) {
        int32_t g;
        if (rank_of[i] < 0) continue;
        g = prot_gid[pid[i]];
        if (seen[g]) continue;
        seen[g] = 1;
        out_gid[m] = g;
        out_cid[m] = cid[i];
        out_rank[m] = rank_of[i];
        out_cm[m] = cm[i];
        ++m;
    }
    free(seen); free(rank_of);
    return m;
}

/* K-way merge of the per-genome deduped arc lists (each already x-sorted
 * by pg_walk_arcs). Same aggregation as pg_merge_arcs but O(N log G)
 * sequential reads instead of a global re-sort — the per-round global
 * merge dominates at scale otherwise. offs[n_src+1] delimits each
 * genome's slice of the concatenated inputs. */
typedef struct { uint64_t key; int32_t src; } kent_t;

static void kheap_down(kent_t *h, int32_t n, int32_t i)
{
    for (;;) {
        int32_t l = 2 * i + 1, r = l + 1, m = i;
        if (l < n && h[l].key < h[m].key) m = l;
        if (r < n && h[r].key < h[m].key) m = r;
        if (m == i) break;
        kent_t t = h[i]; h[i] = h[m]; h[m] = t;
        i = m;
    }
}

int64_t pg_merge_arcs_kway(
    int32_t n_src, const int64_t *offs,
    const uint64_t *x, const int32_t *n,
    const int32_t *dist, const int32_t *s1, const int32_t *s2,
    uint64_t *out_x, int32_t *out_ng, int32_t *out_tot,
    int32_t *out_avg_dist, int32_t *out_s1, int32_t *out_s2)
{
    int64_t *pos = (int64_t *)malloc((n_src ? n_src : 1) * 8);
    kent_t *heap = (kent_t *)malloc((n_src ? n_src : 1) * sizeof(kent_t));
    int32_t hn = 0, s;
    int64_t m = 0;
    for (s = 0; s < n_src; ++s) {
        pos[s] = offs[s];
        if (pos[s] < offs[s + 1]) {
            heap[hn].key = x[pos[s]];
            heap[hn].src = s;
            ++hn;
        }
    }
    for (s = hn / 2 - 1; s >= 0; --s) kheap_down(heap, hn, s);
    while (hn) {
        uint64_t cur = heap[0].key;
        int64_t ng = 0, tot = 0, dsum = 0, s1sum = 0, s2sum = 0;
        while (hn && heap[0].key == cur) {
            int32_t sc = heap[0].src;
            int64_t i = pos[sc];
            ++ng; tot += n[i]; dsum += (int64_t)dist[i] * n[i];
            s1sum += s1[i]; s2sum += s2[i];
            if (++pos[sc] < offs[sc + 1]) {
                heap[0].key = x[pos[sc]];
            } else {
                heap[0] = heap[--hn];
            }
            kheap_down(heap, hn, 0);
        }
        out_x[m] = cur;
        out_ng[m] = (int32_t)ng;
        out_tot[m] = (int32_t)tot;
        out_avg_dist[m] = (int32_t)(int64_t)((double)dsum / (double)tot + 0.499);
        out_s1[m] = (int32_t)(int64_t)((double)s1sum / (double)ng + 0.499);
        out_s2[m] = (int32_t)(int64_t)((double)s2sum / (double)ng + 0.499);
        ++m;
    }
    free(pos); free(heap);
    return m;
}

/* Pairwise-tree merge of the per-genome x-sorted deduped lists with
 * EARLY aggregation: all per-arc statistics (genome count, total count,
 * distance and score sums) are associative integer sums, so equal keys
 * combine at every level and list sizes shrink as the tree ascends.
 * Sequential two-pointer scans replace the k-way heap's per-element
 * random pops — ~2.5x faster at millions of rows. Same output contract
 * as pg_merge_arcs_kway. */
typedef struct {
    uint64_t x;
    int64_t ng, tot, dsum, s1s, s2s;
} agg_t;

static int64_t agg_merge_pair(const agg_t *a, int64_t na,
                              const agg_t *b, int64_t nb, agg_t *out)
{
    int64_t i = 0, j = 0, m = 0;
    while (i < na && j < nb) {
        if (a[i].x < b[j].x) out[m++] = a[i++];
        else if (b[j].x < a[i].x) out[m++] = b[j++];
        else {
            agg_t t = a[i++];
            t.ng += b[j].ng;
            t.tot += b[j].tot;
            t.dsum += b[j].dsum;
            t.s1s += b[j].s1s;
            t.s2s += b[j].s2s;
            ++j;
            out[m++] = t;
        }
    }
    while (i < na) out[m++] = a[i++];
    while (j < nb) out[m++] = b[j++];
    return m;
}

static int64_t merge_tree_core(
    int32_t n_src, const int64_t *offs, agg_t *A, agg_t *B,
    uint64_t *out_x, int32_t *out_ng, int32_t *out_tot,
    int32_t *out_avg_dist, int32_t *out_s1, int32_t *out_s2);

int64_t pg_merge_arcs_tree(
    int32_t n_src, const int64_t *offs,
    const uint64_t *x, const int32_t *n,
    const int32_t *dist, const int32_t *s1, const int32_t *s2,
    uint64_t *out_x, int32_t *out_ng, int32_t *out_tot,
    int32_t *out_avg_dist, int32_t *out_s1, int32_t *out_s2)
{
    int64_t total = n_src ? offs[n_src] : 0;
    size_t capb = (size_t)(total ? total : 1) * sizeof(agg_t);
    agg_t *A = (agg_t *)malloc(capb), *B = (agg_t *)malloc(capb);
    int64_t k, m;
    for (k = 0; k < total; ++k) {
        A[k].x = x[k];
        A[k].ng = 1;
        A[k].tot = n[k];
        A[k].dsum = (int64_t)dist[k] * n[k];
        A[k].s1s = s1[k];
        A[k].s2s = s2[k];
    }
    m = merge_tree_core(n_src, offs, A, B, out_x, out_ng, out_tot,
                        out_avg_dist, out_s1, out_s2);
    free(A); free(B);
    return m;
}

/* Pointer-array variant: per-source slices live in THEIR OWN buffers
 * (the per-genome memo arrays), so the caller skips concatenating ~MBs
 * per round just to satisfy the flat-input API. counts[s] is source s's
 * length; offs are derived here. */
int64_t pg_merge_arcs_tree_p(
    int32_t n_src, const int64_t *counts,
    const uint64_t *const *xs, const int32_t *const *ns,
    const int32_t *const *ds, const int32_t *const *s1s,
    const int32_t *const *s2s,
    uint64_t *out_x, int32_t *out_ng, int32_t *out_tot,
    int32_t *out_avg_dist, int32_t *out_s1, int32_t *out_s2)
{
    int64_t *offs = (int64_t *)malloc(((size_t)n_src + 1) * 8);
    int64_t total = 0, m, k;
    int32_t s;
    agg_t *A, *B;
    size_t capb;
    offs[0] = 0;
    for (s = 0; s < n_src; ++s) { total += counts[s]; offs[s + 1] = total; }
    capb = (size_t)(total ? total : 1) * sizeof(agg_t);
    A = (agg_t *)malloc(capb);
    B = (agg_t *)malloc(capb);
    for (s = 0; s < n_src; ++s) {
        const uint64_t *x = xs[s];
        const int32_t *n = ns[s], *dist = ds[s];
        const int32_t *s1 = s1s[s], *s2 = s2s[s];
        agg_t *a = A + offs[s];
        for (k = 0; k < counts[s]; ++k) {
            a[k].x = x[k];
            a[k].ng = 1;
            a[k].tot = n[k];
            a[k].dsum = (int64_t)dist[k] * n[k];
            a[k].s1s = s1[k];
            a[k].s2s = s2[k];
        }
    }
    m = merge_tree_core(n_src, offs, A, B, out_x, out_ng, out_tot,
                        out_avg_dist, out_s1, out_s2);
    free(A); free(B); free(offs);
    return m;
}

/* Reduce n_src x-sorted agg runs (concatenated in A, delimited by offs)
 * to one run; returns its length and points *res at it (inside A or B —
 * both remain caller-owned). */
static int64_t tree_reduce(int32_t n_src, const int64_t *offs,
                           agg_t *A, agg_t *B, agg_t **res)
{
    int64_t *lo = (int64_t *)malloc(((size_t)n_src + 2) * 8);
    int64_t *lo2 = (int64_t *)malloc(((size_t)n_src + 2) * 8);
    agg_t *T;
    int64_t m;
    int32_t L = n_src, s;
    for (s = 0; s <= n_src; ++s) lo[s] = offs[s];
    while (L > 1) {
        int32_t M = 0;
        int64_t w = 0;
        lo2[0] = 0;
        for (s = 0; s + 1 < L; s += 2) {
            w += agg_merge_pair(A + lo[s], lo[s + 1] - lo[s],
                                A + lo[s + 1], lo[s + 2] - lo[s + 1],
                                B + w);
            lo2[++M] = w;
        }
        if (s < L) {
            memcpy(B + w, A + lo[s], (size_t)(lo[s + 1] - lo[s])
                   * sizeof(agg_t));
            w += lo[s + 1] - lo[s];
            lo2[++M] = w;
        }
        T = A; A = B; B = T;
        T = (agg_t *)lo; lo = lo2; lo2 = (int64_t *)T;
        L = M;
    }
    m = L ? lo[1] : 0;
    *res = A;   /* the buffer (original A or B) holding the final run */
    free(lo); free(lo2);
    return m;
}

static int64_t merge_tree_core(
    int32_t n_src, const int64_t *offs, agg_t *A, agg_t *B,
    uint64_t *out_x, int32_t *out_ng, int32_t *out_tot,
    int32_t *out_avg_dist, int32_t *out_s1, int32_t *out_s2)
{
    agg_t *R;
    int64_t k, m = tree_reduce(n_src, offs, A, B, &R);
    A = R;
    for (k = 0; k < m; ++k) {
        out_x[k] = A[k].x;
        out_ng[k] = (int32_t)A[k].ng;
        out_tot[k] = (int32_t)A[k].tot;
        out_avg_dist[k] = (int32_t)(int64_t)(
            (double)A[k].dsum / (double)A[k].tot + 0.499);
        out_s1[k] = (int32_t)(int64_t)(
            (double)A[k].s1s / (double)A[k].ng + 0.499);
        out_s2[k] = (int32_t)(int64_t)(
            (double)A[k].s2s / (double)A[k].ng + 0.499);
    }
    return m;   /* A/B are the callers' to free */
}

/* Cross-genome arc merge (graph.c:151-175; ops/arcs.py merge_arcs).
 * Inputs are the concatenated per-genome deduped lists. Averages use
 * exact integer sums with one double +.499 rounding, so the result is
 * independent of genome order and shard count. Returns #unique arcs. */
int64_t pg_merge_arcs(
    int64_t n_in, const uint64_t *x, const int32_t *n,
    const int32_t *dist, const int32_t *s1, const int32_t *s2,
    uint64_t *out_x, int32_t *out_ng, int32_t *out_tot,
    int32_t *out_avg_dist, int32_t *out_s1, int32_t *out_s2)
{
    uint64_t *xs = (uint64_t *)malloc((n_in ? n_in : 1) * 8);
    uint32_t *ix = (uint32_t *)malloc((n_in ? n_in : 1) * 4);
    int64_t k, m = 0;
    for (k = 0; k < n_in; ++k) { xs[k] = x[k]; ix[k] = (uint32_t)k; }
    radix_sort_u64(xs, ix, n_in);
    for (k = 0; k < n_in; ) {
        int64_t e = k, ng = 0, tot = 0, dsum = 0, s1sum = 0, s2sum = 0;
        while (e < n_in && xs[e] == xs[k]) {
            uint32_t i = ix[e];
            ++ng; tot += n[i]; dsum += (int64_t)dist[i] * n[i];
            s1sum += s1[i]; s2sum += s2[i];
            ++e;
        }
        out_x[m] = xs[k];
        out_ng[m] = (int32_t)ng;
        out_tot[m] = (int32_t)tot;
        out_avg_dist[m] = (int32_t)(int64_t)((double)dsum / (double)tot + 0.499);
        out_s1[m] = (int32_t)(int64_t)((double)s1sum / (double)ng + 0.499);
        out_s2[m] = (int32_t)(int64_t)((double)s2sum / (double)ng + 0.499);
        ++m;
        k = e;
    }
    free(xs); free(ix);
    return m;
}

/* open-addressing u64->u8 table for marked-arc lookups; size is a power
 * of two >= 2x entries so probes are short */
static uint64_t mix64(uint64_t x)
{
    x ^= x >> 33; x *= 0xff51afd7ed558ccdull;
    x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ull;
    x ^= x >> 33;
    return x;
}

/* keys/vals are caller-allocated with n_slots = next_pow2(2*n) entries;
 * keys must be pre-filled with the sentinel (all ones: never a valid arc
 * because segment ids are small). Returns nothing. */
void pg_weak_hash_build(
    int64_t n, const uint64_t *arc_x, const uint8_t *arc_w,
    int64_t n_slots, uint64_t *keys, uint8_t *vals)
{
    int64_t i;
    uint64_t mask = (uint64_t)n_slots - 1;
    for (i = 0; i < n; ++i) {
        uint64_t j = mix64(arc_x[i]) & mask;
        while (keys[j] != 0xFFFFFFFFFFFFFFFFull && keys[j] != arc_x[i])
            j = (j + 1) & mask;
        keys[j] = arc_x[i];
        vals[j] = arc_w[i];
    }
}

static uint8_t weak_hash_get(const uint64_t *keys, const uint8_t *vals,
                             uint64_t mask, uint64_t key)
{
    uint64_t j = mix64(key) & mask;
    while (keys[j] != 0xFFFFFFFFFFFFFFFFull) {
        if (keys[j] == key) return vals[j];
        j = (j + 1) & mask;
    }
    return 0;
}

/* hash-probing variant of the weak propagation: the marked-arc table is
 * built once per round (pg_weak_hash_build) and shared by all genomes */
void pg_propagate_weak_hash(
    int64_t n, const int64_t *view,
    const uint8_t *flt, const uint8_t *shadow,
    const int32_t *pid, const uint8_t *rev, const int32_t *cid,
    const int32_t *prot_gid, const int32_t *g2s,
    int64_t n_slots, const uint64_t *tab_keys, const uint8_t *tab_vals,
    uint8_t *weak_br)
{
    int64_t k, prev = -1;
    uint64_t prev_w = 0, mask = (uint64_t)n_slots - 1;
    for (k = 0; k < n; ++k) {
        int64_t i = view ? view[k] : k;
        uint64_t w;
        if (flt[i] || shadow[i]) continue;
        w = ((uint64_t)g2s[prot_gid[pid[i]]] << 1) | rev[i];
        if (prev >= 0 && cid[prev] == cid[i]) {
            uint8_t wk;
            wk = weak_hash_get(tab_keys, tab_vals, mask,
                               (prev_w << 32) | w);
            if (wk > weak_br[prev]) weak_br[prev] = wk;
            wk = weak_hash_get(tab_keys, tab_vals, mask,
                               ((w ^ 1) << 32) | (prev_w ^ 1));
            if (wk > weak_br[i]) weak_br[i] = wk;
        }
        prev = i; prev_w = w;
    }
}

/* Arc weak_br -> incident-hit propagation for one genome
 * (pg_mark_branch_flt_hit, branch.c:108-145; ops/branch.py semantics).
 * The kept walk is built inline from flt/shadow through the cm-order view
 * (NULL = already cm-physical); arc_x is the x-sorted (typically
 * marked-only) arc table searched in both walk directions. */
void pg_propagate_weak(
    int64_t n, const int64_t *view,
    const uint8_t *flt, const uint8_t *shadow,
    const int32_t *pid, const uint8_t *rev, const int32_t *cid,
    const int32_t *prot_gid, const int32_t *g2s,
    int64_t n_arc, const uint64_t *arc_x, const uint8_t *arc_w,
    uint8_t *weak_br)
{
    int64_t k, prev = -1;
    uint64_t prev_w = 0;
    for (k = 0; k < n; ++k) {
        int64_t i = view ? view[k] : k;
        uint64_t w, key;
        int d;
        if (flt[i] || shadow[i]) continue;
        w = ((uint64_t)g2s[prot_gid[pid[i]]] << 1) | rev[i];
        if (prev >= 0 && cid[prev] == cid[i]) {
            for (d = 0; d < 2; ++d) {
                int64_t lo = 0, hi = n_arc;
                int64_t tgt = d == 0 ? prev : i;
                key = d == 0 ? (prev_w << 32) | w
                             : ((w ^ 1) << 32) | (prev_w ^ 1);
                while (lo < hi) {
                    int64_t mid = (lo + hi) >> 1;
                    if (arc_x[mid] < key) lo = mid + 1; else hi = mid;
                }
                if (lo < n_arc && arc_x[lo] == key
                    && arc_w[lo] > weak_br[tgt])
                    weak_br[tgt] = arc_w[lo];
            }
        }
        prev = i; prev_w = w;
    }
}

/* Greedy vertex selection scan (pg_gen_vtx, vertex.c:60-80; semantics of
 * graph/vertex.py): genes in descending packed-score order; a gene is
 * selected when included or (n_dom >= thresh and not fully explained by
 * already-consumed dominators); selecting it consumes its dominator in
 * every genome where it is shadowed-only. aux is gene-major [ng, G]:
 * (ng+1)<<1 = unseen, ng<<1 = dominant, dom_gid<<1 = shadowed with
 * dominator, low bit = consumed. Returns the selection count. */
int64_t pg_gen_vtx_greedy(
    int32_t ng, int32_t G,
    const int64_t *order, const uint64_t *x, const uint64_t *y,
    uint32_t *aux, const uint8_t *included, double vtx_thresh,
    int32_t *sel, int32_t *sel_dom, int32_t *sel_sub)
{
    int64_t i, m = 0;
    uint32_t dom_tag = (uint32_t)ng << 1;
    for (i = ng - 1; i >= 0; --i) {
        uint64_t xi = x[order[i]], yi = y[order[i]];
        int32_t n_dom = (int32_t)((xi >> 32) & 0x7FFFFFFFu);
        int32_t n_sub = (int32_t)(yi >> 32);
        int32_t gid = (int32_t)(yi & 0xFFFFFFFFu);
        uint32_t *col = aux + (size_t)gid * G;
        int32_t g, xx = 0, yy = 0;
        for (g = 0; g < G; ++g)
            if ((col[g] >> 1) == (uint32_t)ng) {
                ++xx;
                yy += col[g] & 1;
            }
        if (included[gid] || ((double)n_dom >= vtx_thresh && yy < xx)) {
            sel[m] = gid;
            sel_dom[m] = n_dom;
            sel_sub[m] = n_sub;
            ++m;
            if (xx > 0)
                for (g = 0; g < G; ++g)
                    if (col[g] < dom_tag)  /* shadowed: dom_gid<<1 < ng<<1 */
                        aux[(size_t)(col[g] >> 1) * G + g] |= 1;
        }
    }
    return m;
}

/* ---------------- GFA L-line formatting ---------------- */

static char *fmt_i32(char *p, int64_t v)
{
    char tmp[24];
    int k = 0;
    if (v < 0) { *p++ = '-'; v = -v; }
    do { tmp[k++] = (char)('0' + v % 10); v /= 10; } while (v);
    while (k) *p++ = tmp[--k];
    return p;
}

/* Render all L lines (format.c:146-147 layout) into one malloc'd text
 * buffer; caller frees with pg_free_text. Gene names arrive as a
 * NUL-separated blob + offsets + lengths. Returns the byte length. */
int64_t pg_format_arcs(
    int64_t n_arc, const uint64_t *x, const int32_t *seg_gid,
    const char *blob, const int64_t *offs, const int32_t *lens,
    const int32_t *ng, const int32_t *tot, const int32_t *ad,
    const int32_t *s1, const int32_t *s2,
    char **out_ptr)
{
    size_t cap = (size_t)(n_arc ? n_arc : 1) * 96 + 1024, used = 0;
    char *out = (char *)malloc(cap);
    int64_t i;
    for (i = 0; i < n_arc; ++i) {
        uint64_t v = x[i] >> 32, w = x[i] & 0xFFFFFFFFu;
        int32_t gv = seg_gid[v >> 1], gw = seg_gid[w >> 1];
        size_t need = (size_t)lens[gv] + lens[gw] + 96;
        char *p;
        if (used + need > cap) {
            while (used + need > cap) cap <<= 1;
            out = (char *)realloc(out, cap);
        }
        p = out + used;
        *p++ = 'L'; *p++ = '\t';
        memcpy(p, blob + offs[gv], lens[gv]); p += lens[gv];
        *p++ = '\t'; *p++ = (v & 1) ? '-' : '+'; *p++ = '\t';
        memcpy(p, blob + offs[gw], lens[gw]); p += lens[gw];
        *p++ = '\t'; *p++ = (w & 1) ? '-' : '+';
        memcpy(p, "\t0M\tng:i:", 9); p += 9;
        p = fmt_i32(p, ng[i]);
        memcpy(p, "\tnc:i:", 6); p += 6;
        p = fmt_i32(p, tot[i]);
        memcpy(p, "\tad:i:", 6); p += 6;
        p = fmt_i32(p, ad[i]);
        memcpy(p, "\ts1:i:", 6); p += 6;
        p = fmt_i32(p, s1[i]);
        memcpy(p, "\ts2:i:", 6); p += 6;
        p = fmt_i32(p, s2[i]);
        *p++ = '\n';
        used = p - out;
    }
    *out_ptr = out;
    return (int64_t)used;
}

void pg_free_text(char *p) { free(p); }

/* Same-gene overlapping-isoform filter; flt_iso_ov and flt updated in
 * place. Returns the count of hits with flt_iso_ov set (including ones set
 * by earlier invocations, matching the Python oracle's mask count). */
int64_t pg_sweep_ov_isoform(
    int64_t n,
    const int32_t *pid, const int32_t *rank,
    const int32_t *score_adj,
    const int32_t *n_exon, const int32_t *off_exon,
    const int32_t *cid, const uint8_t *rev,
    const int64_t *cs, const int64_t *ce,
    const int32_t *eos, const int32_t *eoe,
    const int32_t *prot_gid, const uint8_t *gene_pref,
    int32_t check_strand,
    uint8_t *flt_iso_ov, uint8_t *flt)
{
    int64_t i, i0 = 0, cnt = 0;
    uint64_t *pscore;
    int32_t *gid;
    if (n == 0) return 0;
    pscore = (uint64_t *)malloc(n * 8);
    gid = (int32_t *)malloc(n * 4);
    for (i = 0; i < n; ++i) {
        gid[i] = prot_gid[pid[i]];
        pscore[i] = packed_score(score_adj[i], gene_pref[gid[i]], pid[i]);
    }
    for (i = 1; i < n; ++i) {
        int64_t j;
        if (flt[i]) continue;
        while (i0 < i && !(cid[i0] == cid[i] && ce[i0] > cs[i])) ++i0;
        for (j = i0; j < i; ++j) {
            int64_t ov;
            if (flt[j] || ce[j] <= cs[i]) continue;
            if (gid[i] != gid[j]) continue;
            if (cid[j] != cid[i]) continue;
            if (check_strand && rev[i] != rev[j]) continue;
            ov = ov_len(eos, eoe, cs[j], off_exon[j], n_exon[j],
                        cs[i], off_exon[i], n_exon[i]);
            if (ov == 0) continue;
            if (pscore[i] < pscore[j]
                || (pscore[i] == pscore[j] && rank[i] > rank[j]))
                flt_iso_ov[i] = 1;
            else
                flt_iso_ov[j] = 1;
        }
    }
    for (i = 0; i < n; ++i)
        if (flt_iso_ov[i]) { flt[i] = 1; ++cnt; }
    free(pscore); free(gid);
    return cnt;
}
