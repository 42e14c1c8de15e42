"""Graph construction: the 3-phase / n_branch_flt-round schedule.

Reference: pg_graph_gen (graph.c:280-322) plus the high-occurrence filters
(graph.c:237-263) and hard deletion (graph.c:219-235). Under the host
engines every round runs on the host (the native runtime under "host").
Under engine "device" gen_arc sends the shadow sweep to the device genome
by genome through ops/dispatch; under engine "sharded" phases 2+3 run on
the device as one loop (parallel/device_loop.py), and where that loop is
switched off (PANGENE_DEVICE_LOOP=0) or cannot take the graph, every
round's sweep, sort, walk and per-genome dedupe run as one device step over
all genomes (parallel/stacked.py). Branch marking, vertex selection and the
filters stay on the host under every engine, in C when the native runtime
is available (ops/branch.py, graph/vertex.py).
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..core.data import DataSet
from ..options import DEVICE_ENGINES, HOST_ENGINES, PgOpt
from ..ops import arcs as arcs_ops
from ..ops.branch import mark_branch_flt_arc, mark_branch_flt_hit
from ..util import log_msg
from .graphdata import Graph
from .vertex import gen_vtx
from .. import util


def set_filter(d: DataSet, field: str, value: int = 1) -> None:
    """flt |= (field == value) over every genome (PG_SET_FILTER, pgpriv.h:109-116)."""
    for g in d.genomes:
        h = g.hits
        mask = h.cols[field] == value
        h.flt[mask] = 1


def set_filter_eq0(d: DataSet, field: str) -> None:
    for g in d.genomes:
        h = g.hits
        h.flt[h.cols[field] == 0] = 1


def hard_delete(q: Graph) -> None:
    """Compact deleted segments out of the seg table (pg_hard_delete,
    graph.c:219-235), logging one #del line per gene like the reference."""
    d = q.d
    del_idx = np.flatnonzero(q.seg_del != 0)
    if util.verbose >= 3:
        for i in del_idx:
            s_occ = q.seg_tot_cnt[i] / d.n_genome
            if q.idx_start is not None:
                deg0 = int(q.idx_cnt[i << 1])
                deg1 = int(q.idx_cnt[(i << 1) | 1])
                sys.stderr.write(
                    "#del\t%s\tavg_occ=%.1f\tdeg=%d,%d\tdist_deg=%d,%d\n" % (
                        d.gene_name[q.seg_gid[i]], s_occ, deg0, deg1,
                        q.seg_n_dist_loci[i, 0], q.seg_n_dist_loci[i, 1]))
            else:
                sys.stderr.write(
                    "#del\t%s\tavg_occ=%.1f\tdeg=*,*\tdist_deg=%d,%d\n" % (
                        d.gene_name[q.seg_gid[i]], s_occ,
                        q.seg_n_dist_loci[i, 0], q.seg_n_dist_loci[i, 1]))
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
    """Delete segments with too many occurrences / too high degree / touching
    too many distant loci (pg_flt_high_occ, graph.c:237-263)."""
    d = q.d
    n_high_deg = 0
    occ_del = q.seg_tot_cnt > max_avg_occ * d.n_genome
    n_high_occ = int(occ_del.sum())
    q.seg_del[occ_del] = 1
    if q.n_arc:
        src = (q.arcs.x >> np.uint64(32)).astype(np.int64)
        uniq, cnt = np.unique(src, return_counts=True)
        # a segment is high-degree when EITHER orientation's out-degree
        # exceeds the cap; np.unique dedupes the orientation pair, and
        # only segments not already occ-deleted count (graph.c:249-255
        # counts each segment once, shielded by the earlier marks)
        sids = np.unique(uniq[cnt > max_degree] >> 1)
        newly = sids[q.seg_del[sids] == 0]
        n_high_deg = len(newly)
        q.seg_del[newly] = 1
    m = q.seg_n_dist_loci.max(axis=1)
    loci_del = (m > max_dist_loci) & (q.seg_del == 0)
    # note: occ/deg deletions above shield segs from the loci counter
    n_high_loci = int(loci_del.sum())
    q.seg_del[loci_del] = 1
    log_msg("pg_flt_high_occ",
            "filtered %d high-occurrence segments, %d high-degree segments "
            "and %d segments connecting distant loci",
            n_high_occ, n_high_deg, n_high_loci)
    hard_delete(q)
    q.gen_g2s()
    q.flag_vtx()


def debug_gene(q: Graph, name: str) -> None:
    """Dump one gene's outgoing arcs as Z lines (reference pg_debug_gene,
    graph.c:265-278 — a developer hook, never wired to a flag there
    either). Call from a debugger or a REPL while chasing graph-quality
    regressions."""
    d = q.d
    gid = d.gene_id[name]
    sid = int(q.g2s[gid])
    assert sid >= 0, "gene %s is not a vertex" % name
    a = q.arcs
    src = (a.x >> np.uint64(32)).astype(np.int64)
    for j in np.flatnonzero((src >> 1) == sid):
        v = int(src[j])
        w = int(a.x[j] & np.uint64(0xFFFFFFFF))
        sys.stderr.write("Z\t%s%s\t%s%s\t%d\t%d\n" % (
            "><"[v & 1], d.gene_name[q.seg_gid[v >> 1]],
            "><"[w & 1], d.gene_name[q.seg_gid[w >> 1]],
            int(a.n_genome[j]), int(a.weak_br[j])))


def cut_low_arc(opt: PgOpt, q: Graph) -> None:
    """-a: drop arcs supported by too few genomes (graph.c:191-200), then
    drop arcs touching deleted segs (pg_graph_rm_del, graph.c:179-189)."""
    keep = q.arcs.n_genome >= opt.min_arc_cnt
    n_flt = int((~keep).sum())
    q.arcs = q.arcs.take(np.flatnonzero(keep))
    log_msg("pg_graph_cut_low_arc", "filtered %d low-occurrence arcs", n_flt)


def graph_gen(opt: PgOpt, q: Graph) -> None:
    """The full 3-phase schedule (pg_graph_gen, graph.c:280-322).

    Under engine "sharded", phases 2+3 run as the device-resident loop
    (parallel/device_loop.py). Phase 1 runs on the host first, which also
    settles the physical sort order into its steady cycle (the loop's
    precondition). Any precondition or capacity failure falls back to the
    host rounds below, bit-identically; their gen_arc is then the per-round
    device step (parallel/stacked.py), as it is for every phase when
    PANGENE_DEVICE_LOOP=0 switches the loop off.
    """
    d = q.d
    if opt.engine not in DEVICE_ENGINES + HOST_ENGINES:
        raise ValueError("engine must be one of %s, not %r"
                         % ("|".join(DEVICE_ENGINES + HOST_ENGINES),
                            opt.engine))
    use_devloop = (opt.engine == "sharded"
                   and os.environ.get("PANGENE_DEVICE_LOOP", "1") != "0")
    # phase 1: initial vertices
    t0 = time.monotonic()
    set_filter(d, "pseudo", 1)
    gen_vtx(opt, q)
    q.flag_vtx()
    set_filter_eq0(d, "vtx")
    if use_devloop:
        arcs_ops.gen_arc_loop(opt, q)
    else:
        arcs_ops.gen_arc(opt, q)
    util.stage_stats["phase1_host_s"] = round(time.monotonic() - t0, 3)
    log_msg("pg_graph_gen", "round-1 graph: %d genes and %d arcs",
            q.n_seg, q.n_arc)
    if use_devloop:
        from ..parallel.device_loop import graph_gen_device
        if graph_gen_device(opt, q):
            set_filter(d, "shadow", 1)
            if opt.min_arc_cnt > 1:
                cut_low_arc(opt, q)
            q.arc_index()
            log_msg("pg_graph_gen", "round-3 graph: %d genes and %d arcs",
                    q.n_seg, q.n_arc)
            return

    # phase 2: relaxed high-occurrence filter (max_dist_loci not yet known)
    flt_high_occ(q, opt.max_avg_occ * 2, opt.max_degree * 2, opt.max_dist_loci)
    set_filter_eq0(d, "vtx")
    arcs_ops.gen_arc(opt, q)  # no shadow filter here (keeps e.g. CYP2D7)
    log_msg("pg_graph_gen", "round-2 graph: %d genes and %d arcs",
            q.n_seg, q.n_arc)

    # phase 3: annealed branch-filtering rounds
    T = opt.n_branch_flt
    branch_s = arc_s = 0.0
    for i in range(T):
        r = 1.0 + (T - 1 - i) / T
        max_avg_occ = int(opt.max_avg_occ * r + 0.499)
        max_degree = int(opt.max_degree * r + 0.499)
        max_dist_loci = int(opt.max_dist_loci * r + 0.499)
        t0 = time.monotonic()
        q.arc_index()
        mark_branch_flt_arc(opt, q)
        mark_branch_flt_hit(opt, q)
        set_filter(d, "weak_br", 2)
        if i > 0:
            flt_high_occ(q, max_avg_occ, max_degree, max_dist_loci)
            set_filter_eq0(d, "vtx")
        t1 = time.monotonic()
        arcs_ops.gen_arc(opt, q)
        branch_s += t1 - t0
        arc_s += time.monotonic() - t1
    # the host rounds' wall by part: branch marking with the filters, and
    # arc regeneration (per genome, or the per-round device step)
    util.stage_stats["rounds_branch_host_s"] = round(branch_s, 3)
    util.stage_stats["rounds_gen_arc_s"] = round(arc_s, 3)
    set_filter(d, "shadow", 1)
    if opt.min_arc_cnt > 1:
        cut_low_arc(opt, q)
    q.arc_index()
    log_msg("pg_graph_gen", "round-3 graph: %d genes and %d arcs",
            q.n_seg, q.n_arc)
