"""The reference's whole path, from the drawn records to the state that the
pruning schedule hands back: the per-genome read postpass (read.c:243-260),
pg_post_process (graph.c:7-32), phase 1 of pg_graph_gen (graph.c:280-322)
and its phases 2+3 as host rounds (the high-occurrence filters and hard
deletion, graph.c:219-263; branch marking, branch.c; arc regeneration,
graph.c:87-177). A frozen NumPy copy of the port's host engine; nothing
here imports the program."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import arcs as arcs_ops
from . import pseudo as pseudo_ops
from . import sweep_vec as sweep
from .branch import mark_branch_flt_arc, mark_branch_flt_hit
from .data import DataSet, Genome
from .graphdata import Graph
from .options import PgOpt
from .post import post_process
from .sort import hit_sort
from .vertex import gen_vtx


def read_postpass(opt: PgOpt, d: DataSet, g: Genome) -> None:
    pseudo_ops.flag_pseudo(d, g)
    h = g.hits
    h.flt[h.pseudo == 1] = 1
    hit_sort(g, by_cm=False)
    sweep.shadow(opt, d, g, cal_dom_sc=True)
    h.set("pid_dom0", h.pid_dom.copy())
    h.pid_dom[:] = -1
    h.shadow[:] = 0
    sweep.flt_ov_isoform(opt, d, g)
    pseudo_ops.flt_chain_shadow(d, g)
    pseudo_ops.flt_subopt_isoform(d, g)


def set_filter(d: DataSet, field: str, value: int = 1) -> None:
    for g in d.genomes:
        h = g.hits
        h.flt[h.cols[field] == value] = 1


def set_filter_eq0(d: DataSet, field: str) -> None:
    for g in d.genomes:
        h = g.hits
        h.flt[h.cols[field] == 0] = 1


def hard_delete(q: Graph) -> None:
    keep = q.seg_del == 0
    q.seg_gid = q.seg_gid[keep]
    q.seg_n_dom = q.seg_n_dom[keep]
    q.seg_n_sub = q.seg_n_sub[keep]
    q.seg_n_genome = q.seg_n_genome[keep]
    q.seg_tot_cnt = q.seg_tot_cnt[keep]
    q.seg_n_dist_loci = q.seg_n_dist_loci[keep]
    q.seg_del = np.zeros(int(keep.sum()), np.uint8)


def flt_high_occ(q: Graph, max_avg_occ: int, max_degree: int,
                 max_dist_loci: int) -> None:
    d = q.d
    occ_del = q.seg_tot_cnt > max_avg_occ * d.n_genome
    q.seg_del[occ_del] = 1
    if q.n_arc:
        src = (q.arcs.x >> np.uint64(32)).astype(np.int64)
        uniq, cnt = np.unique(src, return_counts=True)
        sids = np.unique(uniq[cnt > max_degree] >> 1)
        newly = sids[q.seg_del[sids] == 0]
        q.seg_del[newly] = 1
    m = q.seg_n_dist_loci.max(axis=1)
    q.seg_del[(m > max_dist_loci) & (q.seg_del == 0)] = 1
    hard_delete(q)
    q.gen_g2s()
    q.flag_vtx()


class Entry(NamedTuple):
    """The graph as phase 1 leaves it, as the schedule takes it: each
    genome's unfiltered rows (physical positions at entry, the order that
    the schedule's hit planes follow) and the segments' gene ids."""
    kept: list
    seg_gid: np.ndarray


def phase1(opt: PgOpt, d: DataSet) -> tuple:
    """Ingested data -> (graph after phase 1, Entry). Each hit gets a row
    tag ("uid", its entry position) that travels with its row through the
    later re-sorts."""
    for g in d.genomes:
        read_postpass(opt, d, g)
    post_process(opt, d)
    q = Graph(d)
    set_filter(d, "pseudo", 1)
    gen_vtx(opt, q)
    q.flag_vtx()
    set_filter_eq0(d, "vtx")
    arcs_ops.gen_arc(opt, q)
    kept = []
    for g in d.genomes:
        h = g.hits
        h.cols["uid"] = np.arange(len(h), dtype=np.int64)
        kept.append(np.flatnonzero(h.flt == 0))
    return q, Entry(kept, q.seg_gid.copy())


def rounds(opt: PgOpt, q: Graph) -> None:
    """Phases 2+3: the relaxed filter and arc round, then the annealed
    branch-filtering rounds (graph.c:294-317)."""
    d = q.d
    flt_high_occ(q, opt.max_avg_occ * 2, opt.max_degree * 2,
                 opt.max_dist_loci)
    set_filter_eq0(d, "vtx")
    arcs_ops.gen_arc(opt, q)
    T = opt.n_branch_flt
    for i in range(T):
        r = 1.0 + (T - 1 - i) / T
        q.arc_index()
        mark_branch_flt_arc(opt, q)
        mark_branch_flt_hit(opt, q)
        set_filter(d, "weak_br", 2)
        if i > 0:
            flt_high_occ(q, int(opt.max_avg_occ * r + 0.499),
                         int(opt.max_degree * r + 0.499),
                         int(opt.max_dist_loci * r + 0.499))
            set_filter_eq0(d, "vtx")
        arcs_ops.gen_arc(opt, q)
