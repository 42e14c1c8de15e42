"""GFA emission: S (gene segments), L (oriented arcs), W (per-contig walks).

Byte-exact mirror of the reference writers (format.c:120-225): S lines in
segment (gid-sorted) order with LN/ng/nc/c1/c2/pp tags, L lines in x-sorted
arc order with 0M overlap and ng/nc/ad/s1/s2 tags, one W line per contig in
cm-order with PanSN "sample#hap#ctg" parsing and lf:B:i loss-of-function
tags. Pure host-side I/O.
"""
from __future__ import annotations

import re
from typing import IO, Optional, Tuple

import numpy as np

from ..core.data import DataSet
from ..graph.graphdata import Graph
from ..ops.sort import hit_sort


def write_seg(q: Graph, out: IO[str]) -> None:
    d = q.d
    for i in range(q.n_seg):
        gid = int(q.seg_gid[i])
        pid = d.gene_rep_pid[gid]
        out.write("S\t%s\t*\tLN:i:%d\tng:i:%d\tnc:i:%d\tc1:i:%d\tc2:i:%d\tpp:Z:%s\n" % (
            d.gene_name[gid], d.prot_len[pid], q.seg_n_genome[i],
            q.seg_tot_cnt[i], q.seg_n_dom[i], q.seg_n_sub[i],
            d.prot_name[pid]))


def write_arc(q: Graph, out: IO[str]) -> None:
    d = q.d
    a = q.arcs
    if q.n_arc == 0:
        return
    from ..ops import sweep_native
    if sweep_native.available():
        out.write(sweep_native.format_arcs(d, q.seg_gid, a))
        return
    v = (a.x >> np.uint64(32)).astype(np.int64)
    w = (a.x & np.uint64(0xFFFFFFFF)).astype(np.int64)
    vn = [d.gene_name[g] for g in q.seg_gid[(v >> 1)].tolist()]
    wn = [d.gene_name[g] for g in q.seg_gid[(w >> 1)].tolist()]
    vs = np.where(v & 1, "-", "+").tolist()
    ws = np.where(w & 1, "-", "+").tolist()
    rows = zip(vn, vs, wn, ws, a.n_genome.tolist(), a.tot_cnt.tolist(),
               a.avg_dist.tolist(), a.s1.tolist(), a.s2.tolist())
    out.write("".join(
        "L\t%s\t%s\t%s\t%s\t0M\tng:i:%d\tnc:i:%d\tad:i:%d\ts1:i:%d\ts2:i:%d\n"
        % r for r in rows))


def write_graph(q: Graph, out: IO[str]) -> None:
    write_seg(q, out)
    write_arc(q, out)


def parse_sample(name: str) -> Tuple[Optional[str], int]:
    """PanSN "sample#hap#ctg" -> (sample, hap) or (None, -1)
    (reference pg_parse_sample, format.c:159-181).

    Field 1 must be fully consumed by strtol and non-negative; an empty
    field parses as hap 0 (strtol end-pointer quirk)."""
    if "#" not in name:
        return None, -1
    parts = name.split("#")
    if not parts[0]:
        return None, -1
    f1 = parts[1]
    if f1 == "":
        return parts[0], 0
    m = re.fullmatch(r"[ \t\v\f\r\n]*([+-]?[0-9]+)", f1)
    if not m:
        return None, -1
    hap = int(m.group(1))
    if hap < 0:
        return None, -1
    return parts[0], hap


def _walk_tokens(d: DataSet):
    """Per-protein oriented walk tokens ('>GENE' / '<GENE'), cached."""
    tok = getattr(d, "_walk_tok", None)
    if tok is None or len(tok[0]) != d.n_prot:
        names = [d.gene_name[g] for g in d.prot_gid]
        tok = ([">" + s for s in names], ["<" + s for s in names])
        d._walk_tok = tok               # type: ignore[attr-defined]
    return tok


def write_walk(q: Graph, out: IO[str]) -> None:
    """W lines (reference pg_write_walk, format.c:183-225).

    One W line per contig over the cm-sorted kept hits; contig groups
    appear in ascending cid order (the sort key is (cid, cm)), exactly the
    reference's emission order."""
    d = q.d
    from ..ops.sort import cm_cycle_view
    fwd_tok, rev_tok = _walk_tokens(d)
    for j, g in enumerate(d.genomes):
        h = g.hits
        view = cm_cycle_view(g)
        if view is None:
            hit_sort(g, by_cm=True)
            cid_a = h.cid
            kept_of = np.flatnonzero(h.flt == 0)
            pid_a, rev_a, lof_a = h.pid, h.rev, h.lof
        else:
            cid_a = h.cid[view]
            kept_of = np.flatnonzero(h.flt[view] == 0)
            rows = view[kept_of]
            pid_a = rev_a = lof_a = None
        n = len(h)
        if n:
            starts = np.flatnonzero(
                np.concatenate(([True], cid_a[1:] != cid_a[:-1])))
            ends = np.append(starts[1:], n)
            if view is None:
                rows = kept_of
            pid_k = (pid_a[rows] if view is None else h.pid[rows]).tolist()
            rev_k = (rev_a[rows] if view is None else h.rev[rows]).tolist()
            lof_k = (lof_a[rows] if view is None else h.lof[rows]).tolist()
            # kept positions partitioned per contig group
            grp_lo = np.searchsorted(kept_of, starts)
            grp_hi = np.searchsorted(kept_of, ends)
            for s, lo, hi in zip(starts.tolist(), grp_lo.tolist(),
                                 grp_hi.tolist()):
                if lo == hi:
                    continue
                cid = int(cid_a[s])
                sample, hap = parse_sample(g.ctg_names[cid])
                walk = [(rev_tok[p] if r else fwd_tok[p])
                        for p, r in zip(pid_k[lo:hi], rev_k[lo:hi])]
                if hap >= 0:
                    hdr = "W\t%s\t%d" % (sample, hap)
                elif g.label:
                    hdr = "W\t%s\t0" % g.label
                else:
                    hdr = "W\t%d\t0" % j
                out.write("%s\t%s\t*\t*\t%s\tlf:B:i,%s\n" % (
                    hdr, g.ctg_names[cid], "".join(walk),
                    ",".join(map(str, lof_k[lo:hi]))))
        if view is None:
            hit_sort(g, by_cm=False)
