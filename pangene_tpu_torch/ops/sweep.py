"""Overlap sweeps: same-gene isoform selection and cross-gene shadowing.

These are the reference's hot loops 2 (pg_flt_ov_isoform, overlap.c:58-93 and
pg_shadow, overlap.c:101-178): windowed scans over the cs-sorted hit axis
comparing each hit with earlier overlapping hits.

The pair set is provably order-independent: the reference's monotone window
pointer stops at the first j with cid_j == cid_i && ce_j > cs_i, and a j
rejected for some i stays rejected for every later i (cs is nondecreasing
within a contig), so

    pairs = {(j, i) : i0(i) <= j < i},  i0(i) = min{j : cid_j==cid_i, ce_j>cs_i}

and every per-pair decision depends only on immutable columns. The shadow
dominator bookkeeping (overlap.c:148-155) resolves ties toward the first
update in the i-then-j scan order, which for a fixed loser L is ascending
order of the *other* hit index — so it reduces to a per-loser argmax of
(winner_packed_score, -other_index). This is the formulation the device
engine vectorizes; the host version here shares the same pair enumeration.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ..core.data import DataSet, Genome
from ..options import PgOpt
from .overlap import cds_len_all, hit_overlap

MASK32 = (1 << 32) - 1
MASK64 = (1 << 64) - 1


def hash_uint32(key: int) -> int:
    """Jenkins-style integer hash used for score tie-breaking
    (reference pg_hash_uint32, pgpriv.h:88-97). Must be bit-exact."""
    key &= MASK32
    key = (key + (~(key << 15) & MASK32)) & MASK32
    key ^= key >> 10
    key = (key + ((key << 3) & MASK32)) & MASK32
    key ^= key >> 6
    key = (key + (~(key << 11) & MASK32)) & MASK32
    key ^= key >> 16
    return key


def packed_score(score_adj: int, preferred: int, pid_hash: int) -> int:
    """(uint64)score_adj<<33 | preferred<<32 | hash(pid) (overlap.c:82-83).
    Arguments may arrive as numpy scalars (IntVec tables) — coerce to
    Python ints so the shifts are unbounded."""
    return ((((int(score_adj)) % (1 << 64)) << 33) & MASK64) \
        | (int(preferred) << 32) | int(pid_hash)


def iter_windows(h, skip_flt_i: bool = True) -> Iterator[Tuple[int, int]]:
    """Yield (i, i0) for the monotone overlap window over cs-sorted hits
    (pointer semantics of overlap.c:67-68 / overlap.c:114-115)."""
    n = len(h)
    i0 = 0
    for i in range(1, n):
        if skip_flt_i and h.flt[i]:
            continue
        while i0 < i and not (h.cid[i0] == h.cid[i] and h.ce[i0] > h.cs[i]):
            i0 += 1
        yield i, i0


def flt_ov_isoform(opt: PgOpt, d: DataSet, g: Genome) -> int:
    """Same-gene overlapping-isoform filter (pg_flt_ov_isoform, overlap.c:58-93)."""
    h = g.hits
    prot_gid = d.prot_gid
    pref = d.gene_preferred
    check_strand = opt.check_strand
    for i, i0 in iter_windows(h):
        gi = prot_gid[h.pid[i]]
        hi = hash_uint32(int(h.pid[i]))
        si = None
        for j in range(i0, i):
            if h.flt[j] or h.ce[j] <= h.cs[i]:
                continue
            gj = prot_gid[h.pid[j]]
            if gi != gj:
                continue
            if check_strand and h.rev[i] != h.rev[j]:
                continue
            ov = hit_overlap(g, j, i)
            if ov == 0:
                continue
            if si is None:
                si = packed_score(int(h.score_adj[i]), pref[gi], hi)
            hj = hash_uint32(int(h.pid[j]))
            sj = packed_score(int(h.score_adj[j]), pref[gj], hj)
            if si < sj or (si == sj and h.rank[i] > h.rank[j]):
                h.flt_iso_ov[i] = 1
            else:
                h.flt_iso_ov[j] = 1
    mask = h.flt_iso_ov != 0
    h.flt[mask] = 1
    return int(mask.sum())


def shadow(opt: PgOpt, d: DataSet, g: Genome, cal_dom_sc: bool) -> int:
    """Cross-gene shadow marking with dominator resolution
    (reference pg_shadow, overlap.c:101-178).

    Quirks preserved: the shadow flag of hit 0 and of filtered hits is never
    reset (the reference outer loop starts at i=1 and skips flt hits), and
    pid_dom is only recorded when the winning packed score is > 0.
    """
    h = g.hits
    n = len(h)
    prot_gid = d.prot_gid
    pref = d.gene_preferred
    check_strand = opt.check_strand
    lens = cds_len_all(g)
    tmp_score = [0] * n
    tmp_aid = [0] * n
    tmp_ov = [0] * n
    for i, i0 in iter_windows(h):
        h.shadow[i] = 0
        gi = prot_gid[h.pid[i]]
        hi = hash_uint32(int(h.pid[i]))
        li = int(lens[i])
        si = packed_score(int(h.score_adj[i]), pref[gi], hi)
        wi = int(h.weak_br[i])
        for j in range(i0, i):
            if h.ce[j] <= h.cs[i] or h.flt[j]:
                continue
            if check_strand and h.rev[i] != h.rev[j]:
                continue
            gj = prot_gid[h.pid[j]]
            ov = hit_overlap(g, j, i)
            if ov == 0:
                continue
            lj = int(lens[j])
            cov_short = ov / (li if li < lj else lj)
            if gi != gj and cov_short < opt.min_ov_ratio:
                continue
            hj = hash_uint32(int(h.pid[j]))
            sj = packed_score(int(h.score_adj[j]), pref[gj], hj)
            wj = int(h.weak_br[j])
            if gi == gj or wi == wj:
                loser = i if (si < sj or (si == sj and h.rank[i] > h.rank[j])) else j
            elif wi > wj:
                loser = i
            else:
                loser = j
            if loser == i:
                h.shadow[i] = 1
                if tmp_score[i] < sj:
                    tmp_score[i], tmp_aid[i], tmp_ov[i] = sj, j, ov
            else:
                h.shadow[j] = 1
                if tmp_score[j] < si:
                    tmp_score[j], tmp_aid[j], tmp_ov[j] = si, i, ov
    n_shadow = 0
    for i in range(n):
        if h.flt[i]:
            continue
        h.pid_dom[i] = -1
        if cal_dom_sc:
            h.score_dom[i] = -1
        if tmp_score[i] > 0:
            j = tmp_aid[i]
            h.pid_dom[i] = h.pid[j]
            if cal_dom_sc:
                li, lj = int(lens[i]), int(lens[j])
                h.score_dom[i] = np.int32(int(
                    h.score_ori[i] * (1.0 - tmp_ov[i] / li)
                    + h.score_ori[j] * (tmp_ov[i] / lj) + 0.499))
        if h.shadow[i]:
            n_shadow += 1
    return n_shadow
