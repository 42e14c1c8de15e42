"""What the pruning schedule must hand back, worked out by the reference,
and the comparison of the program's pulled outputs with it.

The schedule (the device-resident phases 2+3) returns 20 arrays: the hit
planes flt, weak_br, shadow, pid_dom [G, H] over each genome's unfiltered
rows at entry, in their order then; the segment planes alive, tot_cnt,
n_genome [S] and the distant-loci counts [S, 2] over the segments of phase
1; the merged arc table (v << B | w over phase-1 segment ids, then s1,
n_genome, tot_cnt, avg_dist, s2) up to its empty slots; the round log, the
#del capture planes and the overflow flag. The reference's host rounds
delete segments and renumber them; here its final state is put back into
that frame. The round log and the capture planes are diagnostics of the
round messages and are not compared; every state they describe is."""
from __future__ import annotations

import numpy as np

from .build import Entry
from .graphdata import Graph

SENT = (1 << 62) - 1        # the schedule's empty arc slot
HIT_PLANES = ("flt", "weak_br", "shadow", "pid_dom")


def loop_answer(q: Graph, entry: Entry) -> dict:
    """The reference's final state in the schedule's frame."""
    d = q.d
    hits = []
    for g, kk in zip(d.genomes, entry.kept):
        h = g.hits
        at = np.empty(len(h), np.int64)
        at[h.cols["uid"]] = np.arange(len(h))    # entry position -> now
        rows = at[kk]
        hits.append({p: np.asarray(h.cols[p])[rows] for p in HIT_PLANES})
    S = len(entry.seg_gid)
    alive = np.isin(entry.seg_gid, q.seg_gid)
    orig = np.flatnonzero(alive)                 # compacted id -> entry id
    B = max(int(2 * S - 1).bit_length(), 2)
    x = q.arcs.x
    v = (x >> np.uint64(32)).astype(np.int64)
    w = (x & np.uint64(0xFFFFFFFF)).astype(np.int64)
    ov = (orig[v >> 1] << 1) | (v & 1)
    ow = (orig[w >> 1] << 1) | (w & 1)
    return dict(
        hits=hits, alive=alive, seg_tot=q.seg_tot_cnt.astype(np.int64),
        seg_ng=q.seg_n_genome.astype(np.int64),
        loci=q.seg_n_dist_loci.astype(np.int64),
        arcs=np.stack([(ov << B) | ow, q.arcs.s1, q.arcs.n_genome,
                       q.arcs.tot_cnt, q.arcs.avg_dist,
                       q.arcs.s2]).astype(np.int64))


def _diff(a: np.ndarray, b: np.ndarray) -> int:
    """Elements that differ, a length difference counting in full."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return int(max(a.size, b.size))
    return int((a != b).sum())


def compare_loop(outs, ans: dict) -> dict:
    """Mismatched values of the program's pulled outputs against the
    reference, by part: hits, segments, arcs; and the overflow flag."""
    (flt, weak, shadow, pid_dom, alive, seg_tot, seg_ng, arc_vw, arc_s1,
     arc_ng, arc_tot, arc_ad, arc_s2, loci) = [np.asarray(o)
                                               for o in outs[:14]]
    planes = dict(flt=flt, weak_br=weak, shadow=shadow, pid_dom=pid_dom)
    n_hit = 0
    G = len(ans["hits"])
    if flt.shape[0] < G:
        n_hit += sum(len(hg["flt"]) * 4 for hg in ans["hits"][flt.shape[0]:])
    for j, hg in enumerate(ans["hits"][:flt.shape[0]]):
        nk = len(hg["flt"])
        for p in HIT_PLANES:
            got = planes[p][j, :nk].astype(np.int64)
            n_hit += _diff(got, hg[p].astype(np.int64))
    al = alive.astype(bool)
    n_seg = _diff(al, ans["alive"])
    if not n_seg:
        n_seg = (_diff(seg_tot[al], ans["seg_tot"])
                 + _diff(seg_ng[al], ans["seg_ng"])
                 + _diff(loci[al], ans["loci"]))
    na = int((arc_vw != SENT).sum())
    got = np.stack([arc_vw[:na], arc_s1[:na], arc_ng[:na], arc_tot[:na],
                    arc_ad[:na], arc_s2[:na]]).astype(np.int64)
    n_arc = _diff(got, ans["arcs"])
    overflow = int(np.asarray(outs[-1]).reshape(-1)[0] != 0)
    return dict(hit_mismatch=n_hit, seg_mismatch=n_seg, arc_mismatch=n_arc,
                overflow=overflow)


def as_outputs(ans: dict) -> list:
    """An answer in the schedule's output layout, so that compare_loop can
    judge one answer by another (the control: the reference computed in a
    lower precision, put in the program's place)."""
    G = len(ans["hits"])
    H = max([len(hg["flt"]) for hg in ans["hits"]] + [1])
    planes = []
    for p in HIT_PLANES:
        a = np.zeros((G, H), np.int64)
        for j, hg in enumerate(ans["hits"]):
            a[j, :len(hg[p])] = hg[p]
        planes.append(a)
    alive = ans["alive"]
    S = len(alive)
    seg = []
    for k, shape in (("seg_tot", (S,)), ("seg_ng", (S,)), ("loci", (S, 2))):
        a = np.zeros(shape, np.int64)
        a[alive] = ans[k]
        seg.append(a)
    arcs = list(ans["arcs"])
    return (planes + [alive] + seg[:2] + arcs + [seg[2]]
            + [np.zeros((0, 10))] * 5 + [np.zeros(1, np.int64)])
