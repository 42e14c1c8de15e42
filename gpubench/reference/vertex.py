"""Greedy vertex (gene) selection.

Reference: pg_gen_vtx (vertex.c:6-100), algorithm described in
tex/pangene.tex:248-254: genes are ranked by (preferred, #genomes where
dominant, avg adjusted score) and greedily selected; a gene that is only
shadowed in some genomes records its dominator there, and selecting it
"consumes" the dominator in those genomes so that purely-redundant genes are
not selected later (the y < x test).

The per-genome dom/sub flags and dominator gids are data-parallel over
genomes; they stay on the host because the greedy scan consumes the FULL
[n_gene, n_genome] dominator table with sequential cross-genome mutation,
so a device pass would only add a round trip. A frozen copy of the port's
NumPy scan.
"""
from __future__ import annotations

import numpy as np

from .data import DataSet
from .options import PG_F_WRITE_VTX_SEL, PgOpt
from .util import log_msg
from .graphdata import Graph


def gen_vtx(opt: PgOpt, q: Graph) -> None:
    d = q.d
    ng = d.n_gene
    G = d.n_genome
    prot_gid = np.asarray(d.prot_gid, np.int32)

    # per-gene packed counters, exactly the reference's pg128_t layout:
    #   x = preferred<<63 | n_dom<<32 | avg_score_adj ; y = n_sub<<32 | gid
    rep_pid = np.asarray(d.gene_rep_pid, np.int64)
    avg_adj = np.asarray(d.prot_avg_score_adj, np.int64)[rep_pid]
    x = avg_adj.astype(np.uint64).copy()
    y = np.arange(ng, dtype=np.uint64)

    # aux[gid][j] (gene-major for contiguous column reads in the greedy
    # scan): (n_gene+1)<<1 = unseen; n_gene<<1 = dominant (non-shadowed);
    # dom_gid<<1 = shadowed-only with recorded dominator; low bit =
    # "consumed". Scan-order semantics of the reference loop: any
    # non-shadowed rank-0 hit forces DOM (later hits overwrite a recorded
    # dominator); otherwise the FIRST shadowed hit's dominator is recorded.
    UNSEEN = np.uint32((ng + 1) << 1)
    DOM = np.uint32(ng << 1)
    aux = np.full((ng, G), UNSEEN, np.uint32)
    for j, gen in enumerate(d.genomes):
        h = gen.hits
        idx = np.flatnonzero((h.rank == 0) & (h.flt == 0))
        gids = prot_gid[h.pid[idx]]
        sh = h.shadow[idx] != 0
        g_dom = gids[~sh]
        aux[g_dom, j] = DOM
        flag1 = np.zeros(ng, bool)
        flag1[g_dom] = True
        flag2 = np.zeros(ng, bool)
        if sh.any():
            sh_idx = idx[sh]
            assert (h.pid_dom[sh_idx] >= 0).all()
            g_sh = gids[sh]
            flag2[g_sh] = True
            ug, first = np.unique(g_sh, return_index=True)
            fresh = aux[ug, j] == UNSEEN
            aux[ug[fresh], j] = (prot_gid[h.pid_dom[sh_idx[first[fresh]]]]
                                 .astype(np.uint32) << np.uint32(1))
        x[flag1] += np.uint64(1 << 32)
        y[~flag1 & flag2] += np.uint64(1 << 32)

    pref = np.asarray(d.gene_preferred, bool)
    x[pref] |= np.uint64(1 << 63)

    order = np.argsort(x, kind="stable")  # ascending, ties keep gid order
    sel_gid = []
    sel_dom = []
    sel_sub = []
    included = np.asarray(d.gene_included, bool)
    vtx_thresh = G * opt.min_vertex_ratio
    write_sel = bool(opt.flag & PG_F_WRITE_VTX_SEL)
    for i in range(ng - 1, -1, -1):
        xi = int(x[order[i]])
        yi = int(y[order[i]])
        n_dom = (xi >> 32) & ((1 << 31) - 1)  # bits 62..32 (x<<1>>33 in C)
        n_sub = yi >> 32
        gid = yi & 0xFFFFFFFF
        col = aux[gid]
        is_dom = (col >> 1) == ng
        xx = int(is_dom.sum())
        yy = int((col[is_dom] & 1).sum())
        if write_sel:
            print("g\t%s\t%d\t%d\t%d\t%d\t%c\t%c" % (
                d.gene_name[gid], np.int32(np.uint32(xi & 0xFFFFFFFF)), xx, yy,
                n_sub, "NY"[int(included[gid])], "NY"[int(pref[gid])]))
        if included[gid] or (n_dom >= vtx_thresh and yy < xx):
            sel_gid.append(gid)
            sel_dom.append(n_dom)
            sel_sub.append(n_sub)
            if xx > 0:
                shadowed = np.flatnonzero((col >> 1) < ng)
                aux[(col[shadowed] >> 1).astype(np.int64), shadowed] |= 1

    return _finish(q, d, sel_gid, sel_dom, sel_sub)


def _finish(q: Graph, d: DataSet, sel_gid, sel_dom, sel_sub) -> None:
    # final segment order: ascending gid (vertex.c:85-94)
    seg = np.array(sel_gid, np.int64)
    perm = np.argsort(seg, kind="stable")
    q.seg_gid = seg[perm].astype(np.int32)
    q.seg_n_dom = np.array(sel_dom, np.int32)[perm]
    q.seg_n_sub = np.array(sel_sub, np.int32)[perm]
    q.seg_n_genome = np.zeros(q.n_seg, np.int32)
    q.seg_tot_cnt = np.zeros(q.n_seg, np.int32)
    q.seg_del = np.zeros(q.n_seg, np.uint8)
    q.seg_n_dist_loci = np.zeros((q.n_seg, 2), np.int32)
    q.gen_g2s()
    log_msg("pg_gen_vtx", "selected %d vertices out of %d genes",
            q.n_seg, d.n_gene)
