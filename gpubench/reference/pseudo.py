"""Pseudogene flagging, isoform selection and protein-level reductions: a
frozen copy of the port's host implementations, exact reference semantics. The cross-genome
stages (joint pseudo, representative, score cap) are elementwise integer
reductions keyed by protein id.
"""
from __future__ import annotations

import numpy as np

from .data import DataSet, Genome
from .options import PG_F_DROP_SGL_EXON, PgOpt

U64 = np.uint64
MASK32 = (1 << 32) - 1


def flag_pseudo(d: DataSet, g: Genome) -> int:
    """Per-genome single-vs-multi-exon pseudogene flagging
    (reference pg_flag_pseudo, hit.c:66-105).

    Hits of one protein are grouped; if the group mixes multi-exon hits with
    single-exon (or <= half the exon count) hits, the latter are flagged and
    the first surviving multi-exon hit is promoted to rank 0.
    """
    h = g.hits
    n = len(h)
    if n == 0:
        return 0
    # stable (pid, rank) order, same permutation as the reference radix sort
    order = np.lexsort((h.rank, h.pid))
    pid_s = h.pid[order]
    ne = h.n_exon[order].astype(np.int64)
    starts = np.flatnonzero(np.concatenate(([True], pid_s[1:] != pid_s[:-1])))
    gidx = np.cumsum(np.concatenate(([False], pid_s[1:] != pid_s[:-1])))
    within = np.arange(n) - starts[gidx]
    max_n = np.maximum.reduceat(ne, starts)
    min_n = np.minimum.reduceat(ne, starts)
    cond_g = (max_n > 1) & ((min_n == 1) | (min_n * 2 <= max_n))
    is_p = cond_g[gidx] & ((ne == 1) | (ne * 2 <= max_n[gidx]))
    h.pseudo[order[is_p]] = 1
    n_pseudo = int(is_p.sum())
    # promote the first surviving multi-exon hit of each flagged group to
    # rank 0, bumping the flagged hits before it (hit.c:94-98)
    BIG = n + 1
    pos = np.where(cond_g[gidx] & ~is_p, within, BIG)
    j1 = np.minimum.reduceat(pos, starts)
    j1_abs = starts + np.where(j1 < BIG, j1, 0)
    promote = cond_g & (j1 < BIG) & (h.rank[order[j1_abs]] > 0)
    bump = promote[gidx] & (within < j1[gidx])
    h.rank[order[bump]] += 1
    h.rank[order[j1_abs[promote]]] = 0
    return n_pseudo


def flt_subopt_isoform(d: DataSet, g: Genome) -> int:
    """Keep only the best-scoring rank-0 isoform per gene
    (reference pg_flt_subopt_isoform, hit.c:107-128).

    best[gid] packs (score_adj << 32 | pid); strictly-greater updates mean the
    first hit in current table order wins ties.
    """
    h = g.hits
    n = len(h)
    prot_gid = np.asarray(d.prot_gid, np.int64)
    gid_all = prot_gid[h.pid]
    # winner per gene = first (table-order) hit achieving the max score_adj
    # among rank-0 unfiltered hits; genes with no such hit keep the 0 default
    # (so only pid 0 survives there — reference quirk, best[gid]==0)
    best_pid = np.zeros(d.n_gene, np.int64)
    # score_adj must beat the 0-initialized accumulator strictly (hit.c:116),
    # so a gene whose eligible hits all score 0 keeps best_pid == 0
    elig = np.flatnonzero((h.flt == 0) & (h.rank == 0) & (h.score_adj > 0))
    if len(elig):
        order = np.lexsort((elig, -h.score_adj[elig].astype(np.int64),
                            gid_all[elig]))
        e = elig[order]
        ge = gid_all[e]
        first = np.flatnonzero(np.concatenate(([True], ge[1:] != ge[:-1])))
        best_pid[ge[first]] = h.pid[e[first]]
    lose = (h.flt == 0) & (h.pid != best_pid[gid_all])
    h.flt[lose] = 1
    h.flt_iso_sub_self[lose] = 1
    return int(lose.sum())


def flt_chain_shadow(d: DataSet, g: Genome) -> int:
    """Drop hits whose read-time dominator protein was itself fully removed by
    the overlap-isoform filter (reference pg_flt_chain_shadow, hit.c:130-146)."""
    h = g.hits
    removed = np.ones(d.n_prot, bool)
    keep_pids = h.pid[h.flt_iso_ov == 0]
    removed[keep_pids] = False
    dom = h.pid_dom0
    mask = (dom >= 0) & removed[np.clip(dom, 0, d.n_prot - 1)]
    h.flt[mask] = 1
    h.flt_chain[mask] = 1
    return int(mask.sum())


def joint_counts(d: DataSet):
    """Per protein (count, score_ori sum) of the rank-0 unfiltered hits of
    all genomes, split by single / multi-exon: (c, s), int64 [n_prot, 2]."""
    c = np.zeros((d.n_prot, 2), np.int64)
    s = np.zeros((d.n_prot, 2), np.int64)
    for g in d.genomes:
        h = g.hits
        m = (h.flt == 0) & (h.rank == 0)
        w = (h.n_exon[m] != 1).astype(np.int64)
        np.add.at(c, (h.pid[m], w), 1)
        np.add.at(s, (h.pid[m], w), h.score_ori[m].astype(np.int64))
    return c, s


def flag_pseudo_joint(opt: PgOpt, d: DataSet, acc=None) -> int:
    """Cross-genome pseudogene flagging (pg_flag_pseudo_joint, hit.c:148-187).

    From joint_counts (or `acc`, the same pair precomputed by
    parallel/stacked.post_reductions_sharded), flags single-exon hits of
    proteins that are dominantly multi-exon.
    """
    c, s = joint_counts(d) if acc is None else acc
    thresh = d.n_genome * opt.min_vertex_ratio
    drop_sgl = bool(opt.flag & PG_F_DROP_SGL_EXON)
    with np.errstate(divide="ignore", invalid="ignore"):
        avg1 = s[:, 1].astype(np.float64) / c[:, 1]
        avg0 = s[:, 0].astype(np.float64) / c[:, 0]
        ratio = avg1 / avg0
    n_pseudo = 0
    for g in d.genomes:
        h = g.hits
        base = (h.flt == 0) & (h.pseudo == 0) & (h.n_exon == 1)
        c1 = c[h.pid, 1]
        cond1 = base & (c1 > 0) & (c1 >= thresh) & (ratio[h.pid] >= 0.99)
        cond2 = np.zeros_like(cond1)
        if drop_sgl:
            cond2 = base & ~cond1 & ((c1 == 0) | (c1 <= thresh))
        mark = cond1 | cond2
        h.pseudo[mark] = 1
        n_pseudo += int(mark.sum())
    return n_pseudo


def representative_sums(d: DataSet) -> np.ndarray:
    """Per protein sum(score_adj) << 32 | count over the rank-0 unfiltered
    hits of all genomes, uint64 with C wraparound."""
    z = np.zeros(d.n_prot, np.uint64)
    for g in d.genomes:
        h = g.hits
        m = (h.rank == 0) & (h.flt == 0)
        add = h.score_adj[m].astype(np.int64).astype(np.uint64)
        np.add.at(z, h.pid[m], (add << U64(32)) + U64(1))
    return z


def max_score_ori(d: DataSet) -> np.ndarray:
    """Per protein the largest score_ori of any hit of any genome (at
    least 0), int32."""
    mx = np.zeros(d.n_prot, np.int32)
    for g in d.genomes:
        np.maximum.at(mx, g.hits.pid, g.hits.score_ori)
    return mx


def flag_representative(d: DataSet, z=None) -> None:
    """Pick each gene's representative isoform by average rank-0 adjusted
    score across genomes (reference pg_flag_representative, hit.c:189-225).
    `z` is representative_sums(d), or the same precomputed by
    post_reductions_sharded: modular uint64 arithmetic makes (sum << 32) +
    cnt identical to the per-hit accumulation."""
    n_prot = d.n_prot
    if z is None:
        z = representative_sums(d)
    for g in d.genomes:
        g.hits.rep[:] = 0
    cnt = (z & U64(MASK32)).astype(np.int64)
    ssum = (z >> U64(32)).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        avg = np.where(cnt > 0, (ssum / np.maximum(cnt, 1) + 0.499), 0.0)
    d.prot_n = cnt
    d.prot_avg_score_adj = avg.astype(np.int64).astype(np.int32) \
        .astype(np.int64)
    # stable ascending sort by z, consumed in DESCENDING order => among
    # equal z the highest pid wins (vertex.c counterpart relies on this);
    # first-seen gid in that order takes the gene's representative
    order = np.argsort(z, kind="stable")
    rev = order[::-1].astype(np.int64)
    gids_desc = np.asarray(d.prot_gid, np.int64)[rev]
    ug, first = np.unique(gids_desc, return_index=True)
    rep_pid = np.full(d.n_gene, -1, np.int64)
    rep_pid[ug] = rev[first]
    d.gene_rep_pid = rep_pid
    prot_rep = np.zeros(n_prot, np.uint8)
    prot_rep[rev[first]] = 1
    d.prot_rep = prot_rep
    for g in d.genomes:
        h = g.hits
        h.rep[:] = prot_rep[h.pid]


def cap_score_dom(d: DataSet, mx=None) -> None:
    """Cap score_dom at the protein's max score_ori across genomes
    (reference pg_cap_score_dom, hit.c:227-247). `mx` is max_score_ori(d),
    or the same precomputed by post_reductions_sharded."""
    if mx is None:
        mx = max_score_ori(d)
    d.prot_max_score_ori = mx
    for g in d.genomes:
        h = g.hits
        h.set("score_dom", np.minimum(h.score_dom, mx[h.pid]))
