"""Branching-arc demotion/cutting and weak-branch propagation onto hits.

Reference: branch.c. A vertex with >=2 out-arcs has its weaker arcs demoted
(weak_br=1) or cut (weak_br=2) based on relative score deficit and a
cross-genome locality test (pg_n_local): two genes are "local" in a genome
if their representative positions are on the same contig within local_dist
bp or local_count kept-hit ranks.

Representative positions form a [n_genome, n_gene] table; n_local for a
batch of gene pairs is an elementwise test summed over the genome axis. The
per-vertex greedy loci grouping (branch.c:82-90) is O(degree^2) on a
~20k-arc graph and stays on the host. A frozen copy of the port's NumPy
branches (its C runtime is not copied), with nothing kept from one round to
the next: every round works its result out anew.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .data import DataSet
from .graphdata import Graph
from .options import PgOpt
from .util import log_msg
from .sort import hit_sort

PAIR_CHUNK = 4096


def gen_rep_pos(d: DataSet) -> Tuple[np.ndarray, ...]:
    """Per genome, per gene: (present, cid, kept-rank, cm) of its last kept
    hit in cs-order (reference pg_gen_rep_pos, branch.c:6-29), as
    [n_genome, n_gene] planes built anew at every call."""
    G = d.n_genome
    ng = d.n_gene
    prot_gid = np.asarray(d.prot_gid, np.int32)
    present = np.zeros((G, ng), bool)
    cid = np.zeros((G, ng), np.int32)
    rank = np.zeros((G, ng), np.int32)
    cm = np.zeros((G, ng), np.int64)
    for j, gen in enumerate(d.genomes):
        h = gen.hits
        keep = np.flatnonzero((h.shadow == 0) & (h.flt == 0))
        if not len(keep):
            continue
        gids = prot_gid[h.pid[keep]]
        ranks = np.arange(len(keep), dtype=np.int32)
        # last kept hit of each gene wins: final element of each stable
        # gid group (deterministic)
        order = np.argsort(gids, kind="stable")
        gs = gids[order]
        last = order[np.flatnonzero(
            np.concatenate((gs[1:] != gs[:-1], [True])))]
        gl = gids[last]
        present[j, gl] = True
        cid[j, gl] = h.cid[keep[last]]
        rank[j, gl] = ranks[last]
        cm[j, gl] = h.cm[keep[last]]
    return present, cid, rank, cm


def n_local_batch(opt: PgOpt, rep_pos, g1: np.ndarray,
                  g2: np.ndarray) -> np.ndarray:
    """Vectorized pg_n_local (branch.c:31-46) for gene-pair batches.

    Locality is symmetric, so pairs are canonicalized and deduped before the
    [n_genome, n_pairs] broadcast — vertices share many pairs and the raw
    pair count grows with sum(degree^2). Sums over the genome axis.
    """
    # rep_pos: the planes gene-major ([n_gene, n_genome], see
    # mark_branch_flt_arc), so that a pair's genomes are two row reads
    present, cid, rank, cm = rep_pos
    ng = present.shape[0]
    a = np.minimum(g1, g2)
    b = np.maximum(g1, g2)
    keys = a * np.int64(ng) + b
    uniq, inv = np.unique(keys, return_inverse=True)
    ua = (uniq // ng).astype(np.int64)
    ub = (uniq % ng).astype(np.int64)
    out = np.empty(len(uniq), np.int32)
    for s in range(0, len(uniq), PAIR_CHUNK):   # [chunk, G] planes in cache
        a, b = ua[s:s + PAIR_CHUNK], ub[s:s + PAIR_CHUNK]
        ok = present[a] & present[b]
        if not opt.frag_mode:
            ok &= cid[a] == cid[b]
        dd = np.abs(cm[a] - cm[b])
        cc = np.abs(rank[a].astype(np.int64) - rank[b].astype(np.int64))
        local = ok & ((dd <= opt.local_dist) | (cc <= opt.local_count))
        out[s:s + PAIR_CHUNK] = local.sum(axis=1, dtype=np.int32)
    return out[inv]


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated."""
    if len(counts) == 0:
        return np.zeros(0, np.int64)
    total = int(counts.sum())
    out = np.arange(total, dtype=np.int64)
    offs = np.concatenate(([0], np.cumsum(counts)[:-1]))
    out -= np.repeat(offs, counts)
    return out


def mark_branch_flt_arc(opt: PgOpt, g: Graph) -> int:
    """Mark weak branching arcs and per-vertex distant-loci counts
    (reference pg_mark_branch_flt_arc, branch.c:48-106).

    Fully vectorized over vertices: per-source-vertex max scores via
    reduceat, weak candidates against max-score targets via one batched
    ragged cross-join locality test, and the greedy loci grouping done
    closed-form for degree 2 with a loop only over degree>=3 vertices.
    """
    d = g.d
    rep_pos = tuple(np.ascontiguousarray(p.T) for p in gen_rep_pos(d))
    g.seg_n_dist_loci = np.zeros((g.n_seg, 2), np.int32)
    arcs = g.arcs
    n_arc = len(arcs)
    if n_arc == 0:
        log_msg("pg_mark_branch_flt_arc",
                "marked %d locally diverged branches and %d distantly "
                "diverged branches", 0, 0)
        return 0
    tgt_gid = g.seg_gid[(arcs.x & np.uint64(0xFFFFFFFF)).astype(np.int64) >> 1] \
        .astype(np.int64)
    src = (arcs.x >> np.uint64(32)).astype(np.int64)
    # contiguous per-source groups over the x-sorted arc table
    gstart = np.flatnonzero(np.concatenate(([True], src[1:] != src[:-1])))
    gcnt = np.diff(np.append(gstart, n_arc))
    gsrc = src[gstart]
    arc_grp = np.repeat(np.arange(len(gstart)), gcnt)
    s1 = arcs.s1.astype(np.int64)
    gmax = np.maximum.reduceat(s1, gstart)
    gmax = np.maximum(gmax, 0)  # reference max starts from 0 (branch.c:61-65)
    big = gcnt >= 2             # only branching vertices are processed
    arc_active = big[arc_grp]
    with np.errstate(divide="ignore", invalid="ignore"):
        r = 1.0 - s1.astype(opt.ftype) / gmax[arc_grp].astype(opt.ftype)
    is_max = arc_active & (s1 == gmax[arc_grp])
    cand = np.flatnonzero(arc_active & (r > opt.branch_diff))
    # ragged cross-join: each candidate arc x every max-score arc of its group
    max_cnt_g = np.zeros(len(gstart), np.int64)
    np.add.at(max_cnt_g, arc_grp[is_max], 1)
    max_start_g = np.concatenate(([0], np.cumsum(max_cnt_g)[:-1]))
    max_arc_idx = np.flatnonzero(is_max)     # grouped by construction
    n_flt1 = n_flt2 = 0
    if len(cand):
        reps = max_cnt_g[arc_grp[cand]]
        cand_rep = np.repeat(cand, reps)
        within = _ragged_arange(reps)
        max_side = max_arc_idx[np.repeat(max_start_g[arc_grp[cand]], reps)
                               + within]
        nloc_pairs = n_local_batch(opt, rep_pos,
                                   tgt_gid[max_side], tgt_gid[cand_rep])
        nloc = np.zeros(n_arc, np.int64)
        np.add.at(nloc, cand_rep, nloc_pairs.astype(np.int64))
        rc = r[cand]
        cut = ((nloc[cand] == 0) & (rc > opt.branch_diff_dist)) \
            | (rc > opt.branch_diff_cut)
        arcs.weak_br[cand[cut]] = 2
        arcs.weak_br[cand[~cut]] = 1
        n_flt2 = int(cut.sum())
        n_flt1 = int((~cut).sum())
    # distant-loci greedy grouping (branch.c:82-90)
    deg2 = np.flatnonzero(big & (gcnt == 2))
    if len(deg2):
        a0 = gstart[deg2]
        loc01 = n_local_batch(opt, rep_pos,
                              tgt_gid[a0], tgt_gid[a0 + 1]) > 0
        v = gsrc[deg2]
        g.seg_n_dist_loci[v >> 1, v & 1] = np.where(loc01, 1, 2)
    deg3 = np.flatnonzero(gcnt >= 3)
    if len(deg3):
        # ragged all-pairs construction without per-vertex python work
        n3 = gcnt[deg3]
        sq = n3 * n3
        base = np.repeat(gstart[deg3], sq)
        flat = _ragged_arange(sq)
        nn = np.repeat(n3, sq)
        a1 = tgt_gid[base + flat // nn]
        a2 = tgt_gid[base + flat % nn]
        nl = n_local_batch(opt, rep_pos, a1, a2)
        # greedy grouping via per-row bitmasks: a vertex's degree is bounded
        # by max_degree (~15-30), so each row fits a python int
        loc = nl > 0
        off = 0
        for gi in deg3:
            n = int(gcnt[gi])
            m = loc[off:off + n * n].reshape(n, n)
            off += n * n
            rows = (m @ (1 << np.arange(n, dtype=np.int64))).tolist() \
                if n <= 62 else None
            n_group = 0
            if rows is not None:
                unassigned = (1 << n) - 1
                for i in range(n):
                    if (unassigned >> i) & 1:
                        n_group += 1
                    unassigned &= ~(rows[i] & ~((2 << i) - 1))
            else:  # huge degree: object-int bit packing
                grp = np.zeros(n, np.int32)
                for i in range(n):
                    if grp[i] == 0:
                        n_group += 1
                        grp[i] = n_group
                    tgt = np.flatnonzero(m[i, i + 1:]
                                         & (grp[i + 1:] == 0)) + i + 1
                    grp[tgt] = grp[i]
            v = int(gsrc[gi])
            g.seg_n_dist_loci[v >> 1, v & 1] = n_group
    return n_flt1 + n_flt2


def mark_branch_flt_hit(opt: PgOpt, g: Graph) -> int:
    """Propagate arc weak_br onto the incident hits of each genome walk
    (reference pg_mark_branch_flt_hit, branch.c:108-145).

    Vectorized: adjacent kept pairs in cm-order are looked up in the
    x-sorted arc table via searchsorted (both walk directions) and the arc
    weak_br is maxed onto the two incident hits.
    """
    d = g.d
    prot_gid = np.asarray(d.prot_gid, np.int32)
    arc_x = g.arcs.x
    arc_w = g.arcs.weak_br

    def one(gen):
        h = gen.hits
        hit_sort(gen, by_cm=True)
        keep = np.flatnonzero((h.flt == 0) & (h.shadow == 0))
        if len(keep) >= 2 and len(arc_x):
            sid = g.g2s[prot_gid[h.pid[keep]]].astype(np.int64)
            w = (sid << 1) | h.rev[keep].astype(np.int64)
            same = h.cid[keep[1:]] == h.cid[keep[:-1]]
            v = w[:-1][same]
            ww = w[1:][same]
            vi = keep[:-1][same]          # hit index of the earlier hit
            ii = keep[1:][same]           # hit index of the later hit
            key_fwd = (v.astype(np.uint64) << np.uint64(32)) \
                | ww.astype(np.uint64)
            key_rev = ((ww ^ 1).astype(np.uint64) << np.uint64(32)) \
                | (v ^ 1).astype(np.uint64)
            for keys, tgt in ((key_fwd, vi), (key_rev, ii)):
                pos = np.searchsorted(arc_x, keys)
                posc = np.clip(pos, 0, len(arc_x) - 1)
                found = arc_x[posc] == keys
                wk = np.where(found, arc_w[posc], 0).astype(np.uint8)
                np.maximum.at(h.weak_br, tgt, wk)
        hit_sort(gen, by_cm=False)
        return int((h.weak_br != 0).sum())

    n_flt = sum(one(gen) for gen in d.genomes)
    log_msg("pg_mark_branch_flt_hit", "marked %d diverged hits", n_flt)
    return n_flt
