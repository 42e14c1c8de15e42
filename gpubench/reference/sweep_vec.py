"""Vectorized (NumPy) implementations of the overlap sweeps: a frozen copy
of the port's host versions.

They enumerate the exact candidate pair set directly: for each hit i the
window start J(i) = min{j : cid_j == cid_i, ce_j > cs_i} comes from a
segmented prefix-max + searchsorted, and the ragged windows [J(i), i) are
flattened into one pair list processed in a single vectorized pass. Dominator resolution (max winner score, ties to the
smallest other index — equivalent to the reference's chronological
first-max, overlap.c:148-155) is a lexsort + first-of-group.

NumPy f64 is IEEE, so the cov_short predicate is exact with no ambiguity
fallback (opt.ftype lowers it in the control only).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .data import DataSet, Genome
from .options import PgOpt
from .overlap import cds_len_all
from .util import hash_u32_np

KEY_B = 44


def _exon_windows(g: Genome, K: int, rows=slice(None)
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Each row's (of `rows`) exons as absolute [start, end) in K columns."""
    h = g.hits
    kk = np.arange(K)[None, :]
    idx = h.off_exon[rows].astype(np.int64)[:, None] + kk
    emask = kk < h.n_exon[rows][:, None]
    idxc = np.clip(idx, 0, max(len(g.exon_os) - 1, 0))
    cs = h.cs[rows][:, None]
    # int32 halves the sweep's memory traffic; exact while positions < 2^31
    dt = np.int32 if len(h) == 0 or int(h.ce.max(initial=0)) < 2**31 \
        else np.int64
    abs_os = np.where(emask, g.exon_os[idxc].astype(dt) + cs.astype(dt), 0) \
        .astype(dt)
    abs_oe = np.where(emask, g.exon_oe[idxc].astype(dt) + cs.astype(dt), 0) \
        .astype(dt)
    return abs_os, abs_oe


def _window_starts(cid: np.ndarray, cs: np.ndarray, ce: np.ndarray) -> np.ndarray:
    """J(i) = first j with cid_j == cid_i and ce_j > cs_i (exact)."""
    n = len(cid)
    M = ce.astype(np.int64).copy()
    starts = np.flatnonzero(np.concatenate(([True], cid[1:] != cid[:-1])))
    for s, e in zip(starts, np.append(starts[1:], n)):
        M[s:e] = np.maximum.accumulate(M[s:e])
    keyM = (cid.astype(np.int64) << KEY_B) | M
    keyT = (cid.astype(np.int64) << KEY_B) | cs.astype(np.int64)
    return np.searchsorted(keyM, keyT, side="right")


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    if len(counts) == 0:
        return np.zeros(0, np.int64)
    total = int(counts.sum())
    out = np.arange(total, dtype=np.int64)
    offs = np.concatenate(([0], np.cumsum(counts)[:-1]))
    out -= np.repeat(offs, counts)
    return out


def _pairs(g: Genome, rows=slice(None)) -> Tuple[np.ndarray, np.ndarray]:
    """All candidate (j, i) pairs among `rows` (ascending, so in cs
    order), j in [J(i), i), as positions in `rows`."""
    h = g.hits
    cid = h.cid[rows]
    n = len(cid)
    if n < 2:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    J = _window_starts(cid, np.asarray(h.cs[rows]), np.asarray(h.ce[rows]))
    counts = np.maximum(np.arange(n) - J, 0)
    ii = np.repeat(np.arange(n, dtype=np.int64), counts)
    jj = np.repeat(J, counts) + _ragged_arange(counts)
    return jj, ii


def _pair_overlaps(eos, eoe, jj, ii, chunk: int = 1 << 19) -> np.ndarray:
    """Exact CDS intersection per pair (sum over exon-pair clips)."""
    out = np.empty(len(jj), np.int64)
    for s in range(0, len(jj), chunk):
        e = min(s + chunk, len(jj))
        lo = np.maximum(eos[ii[s:e], :, None], eos[jj[s:e], None, :])
        hi = np.minimum(eoe[ii[s:e], :, None], eoe[jj[s:e], None, :])
        out[s:e] = np.maximum(hi - lo, 0).sum(axis=(1, 2))
    return out


def _packed_scores(d: DataSet, g: Genome):
    h = g.hits
    gid = np.asarray(d.prot_gid, np.int32)[h.pid]
    pref = np.asarray(d.gene_preferred, np.uint8)[gid]
    ps = ((h.score_adj.astype(np.int64).astype(np.uint64) << np.uint64(33))
          | (pref.astype(np.uint64) << np.uint64(32))
          | hash_u32_np(h.pid).astype(np.uint64))
    return ps, gid


def flt_ov_isoform(opt: PgOpt, d: DataSet, g: Genome) -> int:
    """Vectorized pg_flt_ov_isoform (overlap.c:58-93)."""
    h = g.hits
    n = len(h)
    if n == 0:
        return 0
    jj, ii = _pairs(g)
    pscore, gid = _packed_scores(d, g)
    flt = h.flt != 0
    keep = (~flt[ii] & ~flt[jj] & (h.ce[jj] > h.cs[ii])
            & (gid[ii] == gid[jj]))
    if opt.check_strand:
        keep &= h.rev[ii] == h.rev[jj]
    jj, ii = jj[keep], ii[keep]
    marks = np.zeros(n, bool)
    if len(jj):
        K = int(h.n_exon.max(initial=1))
        eos, eoe = _exon_windows(g, K)
        ov = _pair_overlaps(eos, eoe, jj, ii)
        sel = ov > 0
        ii, jj = ii[sel], jj[sel]
        i_loses = (pscore[ii] < pscore[jj]) | (
            (pscore[ii] == pscore[jj]) & (h.rank[ii] > h.rank[jj]))
        marks[ii[i_loses]] = True
        marks[jj[~i_loses]] = True
    h.flt_iso_ov[marks] = 1
    got = h.flt_iso_ov != 0
    h.flt[got] = 1
    return int(got.sum())


def _shadow_pairs(opt: PgOpt, d: DataSet, g: Genome):
    """The sweep's candidate pairs: (j, i) of unfiltered rows (the sweep
    reads no filtered row) with ce_j > cs_i (and one strand under -S), a
    positive CDS overlap, and either the same gene or the coverage ratio;
    with their overlap, same-gene flag and score order, the packed scores
    and the CDS lengths, worked out anew at every call."""
    h = g.hits
    rows = np.flatnonzero(h.flt == 0)
    jl, il = _pairs(g, rows)
    jj, ii = rows[jl], rows[il]
    pscore, gid = _packed_scores(d, g)
    lens = cds_len_all(g).astype(np.int64)
    keep = h.ce[jj] > h.cs[ii]
    if opt.check_strand:
        keep &= h.rev[ii] == h.rev[jj]
    jl, il, jj, ii = jl[keep], il[keep], jj[keep], ii[keep]
    ov = np.zeros(0, np.int64)
    if len(jj):
        K = int(h.n_exon[rows].max(initial=1))
        eos, eoe = _exon_windows(g, K, rows)
        ov = _pair_overlaps(eos, eoe, jl, il)
        sel = ov > 0
        ii, jj, ov = ii[sel], jj[sel], ov[sel]
    same_gene = gid[ii] == gid[jj]
    m = np.minimum(lens[ii], lens[jj]).astype(opt.ftype)
    cov_ok = (ov.astype(opt.ftype) / m) >= opt.min_ov_ratio
    sel = same_gene | cov_ok
    ii, jj, ov, same_gene = ii[sel], jj[sel], ov[sel], same_gene[sel]
    score_i_loses = (pscore[ii] < pscore[jj]) | (
        (pscore[ii] == pscore[jj]) & (h.rank[ii] > h.rank[jj]))
    return ii, jj, ov, same_gene, score_i_loses, pscore, lens


def shadow(opt: PgOpt, d: DataSet, g: Genome, cal_dom_sc: bool) -> int:
    """Vectorized pg_shadow (overlap.c:101-178), quirks preserved
    (stale hit-0/flt shadow, score>0 dominator gate, first-max tie-break)."""
    h = g.hits
    n = len(h)
    if n == 0:
        return 0
    ii, jj, ov, same_gene, score_i_loses, pscore, lens = _shadow_pairs(
        opt, d, g)
    flt = h.flt != 0
    marks = np.zeros(n, bool)
    b_score = np.zeros(n, np.uint64)
    b_other = np.zeros(n, np.int64)
    b_ov = np.zeros(n, np.int64)
    if len(jj):
        wi, wj = h.weak_br[ii], h.weak_br[jj]
        i_loses = np.where(same_gene | (wi == wj), score_i_loses, wi > wj)
        loser = np.where(i_loses, ii, jj)
        winner = np.where(i_loses, jj, ii)
        marks[loser] = True
        # dominator per loser: max winner pscore, ties -> smallest idx
        order = np.lexsort((winner, ~pscore[winner], loser))
        ls = loser[order]
        first = np.flatnonzero(np.concatenate(([True], ls[1:] != ls[:-1])))
        sel_pairs = order[first]
        b_score[loser[sel_pairs]] = pscore[winner[sel_pairs]]
        b_other[loser[sel_pairs]] = winner[sel_pairs]
        b_ov[loser[sel_pairs]] = ov[sel_pairs]
    nonflt = ~flt
    evaluated = nonflt.copy()
    evaluated[0] = False
    new_shadow = np.where(evaluated, marks, (h.shadow != 0) | marks)
    h.set("shadow", new_shadow.astype(np.uint8))
    has_dom = nonflt & (b_score > 0)
    other = np.clip(b_other, 0, n - 1)
    pid_dom = np.where(nonflt, -1, h.pid_dom)
    pid_dom = np.where(has_dom, h.pid[other], pid_dom)
    h.set("pid_dom", pid_dom.astype(np.int32))
    if cal_dom_sc:
        lensf = lens.astype(np.float64)
        ovf = b_ov.astype(np.float64)
        blend = (h.score_ori * (1.0 - ovf / lensf)
                 + h.score_ori[other] * (ovf / lensf[other]) + 0.499)
        sd = np.where(nonflt, -1, h.score_dom.astype(np.int64))
        sd = np.where(has_dom, blend.astype(np.int64), sd)
        h.set("score_dom", sd.astype(np.int32))
    return int((h.shadow[nonflt] != 0).sum())
