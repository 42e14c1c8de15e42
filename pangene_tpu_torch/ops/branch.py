"""Branching-arc demotion/cutting and weak-branch propagation onto hits.

Reference: branch.c. A vertex with >=2 out-arcs has its weaker arcs demoted
(weak_br=1) or cut (weak_br=2) based on relative score deficit and a
cross-genome locality test (pg_n_local): two genes are "local" in a genome
if their representative positions are on the same contig within local_dist
bp or local_count kept-hit ranks.

Representative positions form a [n_genome, n_gene] table; n_local for a
batch of gene pairs is an elementwise test summed over the genome axis. The
per-vertex greedy loci grouping (branch.c:82-90) is O(degree^2) on a
~20k-arc graph and stays on the host. Every function here takes the native
runtime (ops/sweep_native.py) whenever its library is available, under
every engine, as the JAX package does; the NumPy branches are the path
without a compiler and the tests' second witness.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.data import DataSet
from ..graph.graphdata import Graph
from ..options import PgOpt
from ..util import log_msg
from .sort import cm_cycle_view, hit_sort


def gen_rep_pos(d: DataSet) -> Tuple[np.ndarray, ...]:
    """Per genome, per gene: (present, cid, kept-rank, cm) of its last kept
    hit in cs-order (reference pg_gen_rep_pos, branch.c:6-29).

    Per-genome rows are memoized on the (flt, shadow) byte state — the only
    inputs that change between pruning rounds. The memo also yields a
    per-genome version counter used as a cheap key component by the
    mark_branch_flt_arc memo."""
    G = d.n_genome
    ng = d.n_gene
    prot_gid = None   # converted lazily, only by the NumPy fallback path
    # persistent [G, ng] planes: a genome's row is rewritten ONLY when its
    # (flt, shadow) state changed since the last call — unchanged rows
    # (the common case in converged rounds) cost nothing
    planes = getattr(d, "_rep_planes", None)
    if planes is None or planes[0].shape != (G, ng):
        planes = (np.zeros((G, ng), bool), np.zeros((G, ng), np.int32),
                  np.zeros((G, ng), np.int32), np.zeros((G, ng), np.int64))
        d._rep_planes = planes
        for gen in d.genomes:
            gen._rep_row_ver = None
    present, cid, rank, cm = planes
    versions = []
    for j, gen in enumerate(d.genomes):
        h = gen.hits
        key = (h.flt.tobytes(), h.shadow.tobytes(), ng)
        memo = getattr(gen, "_rep_pos_memo", None)
        if memo is not None and memo[0] == key:
            row, ver = memo[1], memo[2]
        else:
            from . import sweep_native
            if sweep_native.available():
                row = sweep_native.rep_pos_rows(d, gen)
            else:
                keep = np.flatnonzero((h.shadow == 0) & (h.flt == 0))
                row = None
                if len(keep):
                    if prot_gid is None:
                        prot_gid = np.asarray(d.prot_gid, np.int32)
                    gids = prot_gid[h.pid[keep]]
                    ranks = np.arange(len(keep), dtype=np.int32)
                    # last kept hit of each gene wins: final element of
                    # each stable gid group (deterministic)
                    order = np.argsort(gids, kind="stable")
                    gs = gids[order]
                    last = order[np.flatnonzero(
                        np.concatenate((gs[1:] != gs[:-1], [True])))]
                    row = (gids[last], h.cid[keep[last]], ranks[last],
                           h.cm[keep[last]])
            ver = (memo[2] + 1) if memo is not None else 0
            gen._rep_pos_memo = (key, row, ver)
        if getattr(gen, "_rep_row_ver", None) != ver:
            present[j].fill(False)
            if row is not None:
                gl, cl, rl, ml = row
                present[j, gl] = True
                cid[j, gl] = cl
                rank[j, gl] = rl
                cm[j, gl] = ml
            gen._rep_row_ver = ver
        versions.append(ver)
    return (present, cid, rank, cm), tuple(versions)


def n_local_batch(opt: PgOpt, rep_pos, g1: np.ndarray,
                  g2: np.ndarray) -> np.ndarray:
    """Vectorized pg_n_local (branch.c:31-46) for gene-pair batches.

    Locality is symmetric, so pairs are canonicalized and deduped before the
    [n_genome, n_pairs] broadcast — vertices share many pairs and the raw
    pair count grows with sum(degree^2). Sums over the genome axis.
    """
    from . import sweep_native
    if sweep_native.available():
        return sweep_native.n_local_batch(opt, rep_pos, g1, g2)
    present, cid, rank, cm = rep_pos
    ng = present.shape[1]
    a = np.minimum(g1, g2)
    b = np.maximum(g1, g2)
    keys = a * np.int64(ng) + b
    uniq, inv = np.unique(keys, return_inverse=True)
    ua = (uniq // ng).astype(np.int64)
    ub = (uniq % ng).astype(np.int64)
    ok = present[:, ua] & present[:, ub]
    if not opt.frag_mode:
        ok &= cid[:, ua] == cid[:, ub]
    dd = np.abs(cm[:, ua] - cm[:, ub])
    cc = np.abs(rank[:, ua].astype(np.int64) - rank[:, ub].astype(np.int64))
    local = ok & ((dd <= opt.local_dist) | (cc <= opt.local_count))
    return local.sum(axis=0, dtype=np.int32)[inv]


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
    rep_pos, rep_versions = gen_rep_pos(d)
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
    from . import sweep_native
    if sweep_native.available():
        # arcs + per-genome rep-state versions fully determine the result;
        # pruning state is monotone so a repeated key means identical input
        key = (arcs.x.tobytes(), arcs.s1.tobytes(), rep_versions, g.n_seg)
        memo = getattr(g, "_mark_branch_memo", None)
        if memo is not None and memo[0] == key:
            n_flt1, n_flt2, weak, loci = memo[1]
            arcs.weak_br[:] = weak
            g.seg_n_dist_loci[:] = loci
        else:
            n_flt1, n_flt2 = sweep_native.mark_branch(
                opt, rep_pos, arcs.x, arcs.s1, tgt_gid,
                arcs.weak_br, g.seg_n_dist_loci)
            g._mark_branch_memo = (key, (n_flt1, n_flt2,
                                         arcs.weak_br.copy(),
                                         g.seg_n_dist_loci.copy()))
        log_msg("pg_mark_branch_flt_arc",
                "marked %d locally diverged branches and %d distantly "
                "diverged branches", n_flt1, n_flt2)
        return n_flt1 + n_flt2
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
        r = 1.0 - s1.astype(np.float64) / gmax[arc_grp].astype(np.float64)
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
    log_msg("pg_mark_branch_flt_arc",
            "marked %d locally diverged branches and %d distantly diverged branches",
            n_flt1, n_flt2)
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
    if len(arc_x) == 0 or not arc_w.any():
        # no marked arcs: propagation cannot change any hit; count only
        n_flt = sum(int((gen.hits.weak_br != 0).sum()) for gen in d.genomes)
        log_msg("pg_mark_branch_flt_hit", "marked %d diverged hits", n_flt)
        return n_flt
    from . import sweep_native
    native = sweep_native.available()
    # only marked arcs can change a hit (max with 0 is a no-op): probe the
    # small marked subset instead of the full arc table
    marked = np.flatnonzero(arc_w)
    arc_xm = np.ascontiguousarray(arc_x[marked])
    arc_wm = np.ascontiguousarray(arc_w[marked])
    round_key = (arc_xm.tobytes(), arc_wm.tobytes())
    tab = sweep_native.weak_hash_build(arc_xm, arc_wm) if native else None
    n_flt = 0
    for gen in d.genomes:
        h = gen.hits
        if native:
            # weak_br is a monotone max-accumulator and this is its only
            # writer: re-applying the same (kept-walk, marked-arcs) input
            # is a no-op, so skip when the key repeats
            key = (h.flt.tobytes(), h.shadow.tobytes()) + round_key
            if getattr(gen, "_prop_memo", None) == key:
                n_flt += int((h.weak_br != 0).sum())
                continue
            gen._prop_memo = key
        view = cm_cycle_view(gen)
        if view is None:
            hit_sort(gen, by_cm=True)
        if native:
            sweep_native.propagate_weak_hash(d, gen, g.g2s, view, tab)
            keep = ()
        else:
            if view is None:
                keep = np.flatnonzero((h.flt == 0) & (h.shadow == 0))
            else:
                keep = view[np.flatnonzero((h.flt[view] == 0)
                                           & (h.shadow[view] == 0))]
        if (not native) and len(keep) >= 2 and len(arc_x):
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
        n_flt += int((h.weak_br != 0).sum())
        if view is None:
            hit_sort(gen, by_cm=False)
    log_msg("pg_mark_branch_flt_hit", "marked %d diverged hits", n_flt)
    return n_flt
