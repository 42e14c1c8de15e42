"""Per-genome gene-walk arc extraction and the cross-genome arc merge.

Reference: pg_gen_arc (graph.c:87-177). Per genome, consecutive unfiltered
unshadowed hits on the same contig (in CDS-midpoint order) yield an arc
v->w plus its complement w^1->v^1; arcs are deduped per genome, then merged
across genomes with count / distance / score averaging.

The per-genome walk is a segmented shift-compare over the cm-sorted hits;
the per-genome dedupe and the global merge are sort + segment-reduce. All
averaging uses exact integer sums, with the reference's +.499 double
rounding applied once at the end (graph.c:141, 170-172).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .data import Genome
from .graphdata import ArcTable, Graph
from .options import PgOpt
from . import sweep_vec as sweep
from .sort import hit_sort


def walk_extract(g: Graph, gen: Genome, use_ori: bool
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Adjacency pairs from one genome's cm-sorted kept hits
    (graph.c:106-122). Returns (x, dist, s1, s2, sid_counts-compatible sids)."""
    h = gen.hits
    prot_gid = np.asarray(g.d.prot_gid, np.int32)
    ki = np.flatnonzero((h.flt == 0) & (h.shadow == 0))
    sid = g.g2s[prot_gid[h.pid[ki]]].astype(np.int64)
    assert (sid >= 0).all(), "kept hit maps to deleted segment"
    w = (sid << 1) | h.rev[ki].astype(np.int64)
    # scores (vectorized pg_get_score)
    dom_gid = prot_gid[np.clip(h.pid_dom0[ki], 0, None)]
    use_ori_vec = (use_ori
                   | (h.score_ori[ki] > h.score_dom[ki])
                   | (h.pid_dom0[ki] < 0)
                   | (g.g2s[dom_gid] >= 0))
    sc = np.where(use_ori_vec, h.score_ori[ki], h.score_dom[ki]).astype(np.int64)
    # adjacency: consecutive kept hits on the same contig
    if len(ki) == 0:
        z = np.zeros(0, np.uint64)
        zi = np.zeros(0, np.int32)
        return z, zi, zi, zi, sid
    same = h.cid[ki[1:]] == h.cid[ki[:-1]]
    v = w[:-1][same]
    ww = w[1:][same]
    dist = (h.cm[ki[1:]][same] - h.cm[ki[:-1]][same]).astype(np.int32)
    s1 = sc[:-1][same].astype(np.int32)
    s2 = sc[1:][same].astype(np.int32)
    # forward arc and its complement, interleaved like the reference append
    x_fwd = (v.astype(np.uint64) << np.uint64(32)) | ww.astype(np.uint64)
    x_rev = ((ww ^ 1).astype(np.uint64) << np.uint64(32)) | (v ^ 1).astype(np.uint64)
    x = np.empty(2 * len(v), np.uint64)
    x[0::2] = x_fwd
    x[1::2] = x_rev
    dist2 = np.repeat(dist, 2)
    s1_2 = np.empty(2 * len(v), np.int32)
    s2_2 = np.empty(2 * len(v), np.int32)
    s1_2[0::2] = s1
    s2_2[0::2] = s2
    s1_2[1::2] = s2
    s2_2[1::2] = s1
    return x, dist2, s1_2, s2_2, sid


def dedupe_genome(x: np.ndarray, dist: np.ndarray, s1: np.ndarray,
                  s2: np.ndarray, ftype=np.float64) -> Tuple[np.ndarray, ...]:
    """Per-genome arc dedupe: group by x; n=count, dist=avg+.499, s=max
    (graph.c:127-145)."""
    if len(x) == 0:
        zi = np.zeros(0, np.int32)
        return x, zi, zi, zi, zi
    order = np.argsort(x, kind="stable")
    xs = x[order]
    uniq, start, cnt = np.unique(xs, return_index=True, return_counts=True)
    gidx = np.searchsorted(uniq, xs)
    dsum = np.zeros(len(uniq), np.uint64)
    np.add.at(dsum, gidx, dist[order].astype(np.int64).astype(np.uint64))
    m1 = np.zeros(len(uniq), np.int32)
    m2 = np.zeros(len(uniq), np.int32)
    np.maximum.at(m1, gidx, s1[order])
    np.maximum.at(m2, gidx, s2[order])
    avg = (dsum.astype(ftype) / cnt.astype(ftype) + ftype(0.499)).astype(np.int64).astype(np.int32)
    return uniq, cnt.astype(np.int32), avg, m1, m2


def merge_arcs(per_genome: list, ftype=np.float64) -> ArcTable:
    """Merge per-genome deduped arc lists (graph.c:151-175).

    Exact integer sums make the result order independent; the
    genome-major concatenation order only matters for the stable sort, and
    groups are fully reduced so it does not affect output.
    """
    if not per_genome:
        return ArcTable.empty()
    x = np.concatenate([p[0] for p in per_genome])
    n = np.concatenate([p[1] for p in per_genome]).astype(np.int64)
    dist = np.concatenate([p[2] for p in per_genome]).astype(np.int64)
    s1 = np.concatenate([p[3] for p in per_genome]).astype(np.int64)
    s2 = np.concatenate([p[4] for p in per_genome]).astype(np.int64)
    if len(x) == 0:
        return ArcTable.empty()
    order = np.argsort(x, kind="stable")
    xs = x[order]
    uniq, start, cnt = np.unique(xs, return_index=True, return_counts=True)
    gidx = np.searchsorted(uniq, xs)
    nsum = np.zeros(len(uniq), np.int64)
    # (uint64)dist * n sign-extends int32 dist in the reference; real dists
    # are non-negative so plain int64 products are identical
    dsum = np.zeros(len(uniq), np.int64)
    s1sum = np.zeros(len(uniq), np.int64)
    s2sum = np.zeros(len(uniq), np.int64)
    np.add.at(nsum, gidx, n[order])
    np.add.at(dsum, gidx, dist[order] * n[order])
    np.add.at(s1sum, gidx, s1[order])
    np.add.at(s2sum, gidx, s2[order])
    out = ArcTable.empty(len(uniq))
    out.x = uniq
    out.n_genome = cnt.astype(np.int32)
    out.tot_cnt = nsum.astype(np.int32)
    half = ftype(0.499)
    out.avg_dist = (dsum.astype(ftype) / nsum.astype(ftype) + half).astype(np.int64).astype(np.int32)
    out.s1 = (s1sum.astype(ftype) / cnt.astype(ftype) + half).astype(np.int64).astype(np.int32)
    out.s2 = (s2sum.astype(ftype) / cnt.astype(ftype) + half).astype(np.int64).astype(np.int32)
    return out


def gen_arc(opt: PgOpt, g: Graph) -> None:
    """Full arc (re)generation pass over all genomes (pg_gen_arc,
    graph.c:87-177): per genome re-shadow, walk in cm order, dedupe; then
    the global merge. Segment n_genome/tot_cnt counters are refreshed here.
    Every genome is swept, sorted and walked at every call."""
    d = g.d
    use_ori = opt.use_ori_for_branch

    def one(gen):
        sweep.shadow(opt, d, gen, cal_dom_sc=False)
        hit_sort(gen, by_cm=True)
        x, dist, s1, s2, sids = walk_extract(g, gen, use_ori)
        hit_sort(gen, by_cm=False)
        return (dedupe_genome(x, dist, s1, s2, opt.ftype),
                np.bincount(sids, minlength=g.n_seg))

    per_genome = [one(gen) for gen in d.genomes]
    g.seg_n_genome = np.zeros(g.n_seg, np.int32)
    g.seg_tot_cnt = np.zeros(g.n_seg, np.int32)
    if g.n_seg:
        for _, cnts in per_genome:
            g.seg_n_genome += (cnts > 0).astype(np.int32)
            g.seg_tot_cnt += cnts.astype(np.int32)
    g.arcs = merge_arcs([dd for dd, _ in per_genome], opt.ftype)
