"""The port's native host runtime (pangene_tpu_torch/ops/sweep_native.py over
its copy of native/pgsweep.c) against two witnesses, on the CPU, exactly:
the JAX package's bindings (pangene_tpu/ops/sweep_native.py) on the same
numpy-seeded inputs, and the port's own NumPy branches (ops/sweep_vec.py,
ops/branch.py and ops/arcs.py with the library switched off). Mirrors
tests/test_sweep_native.py case for case, and adds the cache checks the port
needs: HitTable.set / permute bump the physical version that every native
cache keys on, and a warm native round after the per-round path's host apply
(parallel/stacked.py, which replaces columns) equals a cold one.
"""
import copy
import types

import numpy as np
import pytest
import torch

from pangene_tpu.core import data as jdata
from pangene_tpu.graph.graphdata import ArcTable as JaxArcTable
from pangene_tpu.graph.graphdata import Graph as JaxGraph
from pangene_tpu.ops import arcs as jarcs
from pangene_tpu.ops import branch as jbranch
from pangene_tpu.ops import sweep_native as jsn
from pangene_tpu.options import PgOpt as JaxOpt
from pangene_tpu_torch.core import data as tdata
from pangene_tpu_torch.graph.graphdata import ArcTable, Graph
from pangene_tpu_torch.ops import arcs as tarcs
from pangene_tpu_torch.ops import branch as tbranch
from pangene_tpu_torch.ops import sweep, sweep_vec
from pangene_tpu_torch.ops import sweep_native as sn
from pangene_tpu_torch.ops.sort import cm_cycle_view, hit_sort
from pangene_tpu_torch.options import (PG_F_CHECK_STRAND, PG_F_FRAG_MODE,
                                       PgOpt)
from pangene_tpu_torch.testing import clone, random_genome

torch.set_num_threads(1)

SWEEP_COLS = ("shadow", "pid_dom", "score_dom")
ROUND_OUTS = ("x", "n", "dist", "s1", "s2", "seg_cnt")


@pytest.fixture(autouse=True)
def _need_compiler():
    if not sn.available() or not jsn.available():
        pytest.skip("no C compiler for pgsweep")
    yield
    # the pipeline-level cases silence both packages' logs; restore them
    from pangene_tpu import util as jutil
    from pangene_tpu_torch import util
    util.verbose = jutil.verbose = 3


def to_jax(d):
    """The JAX package's DataSet holding copies of d's tables and genomes."""
    jd = jdata.DataSet.new()
    for k, v in d.__dict__.items():
        if k == "genomes" or k.startswith("_"):
            continue
        if isinstance(v, tdata.IntVec):
            v = jdata.IntVec.from_array(np.asarray(v))
        setattr(jd, k, copy.copy(v))
    jd.genomes = [jdata.Genome(
        g.label, list(g.ctg_names), g.ctg_len.copy(),
        jdata.HitTable({k: v.copy() for k, v in g.hits.cols.items()}),
        g.exon_os.copy(), g.exon_oe.copy()) for g in d.genomes]
    return jd


class numpy_branches:
    """Inside the block the port's library counts as unavailable, so every
    function that gates on it takes its NumPy branch."""

    def __enter__(self):
        self.orig = sn.available
        sn.available = lambda: False

    def __exit__(self, *exc):
        sn.available = self.orig


def test_counter_names_every_entry():
    sn.reset_counts()
    assert set(sn.n_calls) == set(sn.ENTRIES)
    assert all(callable(getattr(sn, e)) for e in sn.ENTRIES)
    assert not any(sn.n_calls.values())


def test_set_and_permute_bump_version():
    """Every native cache keys on HitTable._ver (or on the array object),
    so replacing a column or re-ordering the rows must change it; an
    in-place write must not."""
    d, g = random_genome(np.random.default_rng(1), n_hits=30)
    h = g.hits
    v0 = getattr(h, "_ver", 0)
    h.flt[:] = h.flt                       # in place: same buffer
    assert getattr(h, "_ver", 0) == v0
    h.set("flt", h.flt.copy())
    assert h._ver == v0 + 1
    addr = sn._hit_addrs(h)["flt"]
    assert addr == h.flt.ctypes.data
    h.permute(np.arange(len(h))[::-1].copy())
    assert h._ver == v0 + 2
    assert sn._hit_addrs(h)["flt"] == h.flt.ctypes.data != addr


def _sweep_three(seed_rng, n_hits, weak, opt, cal):
    d, g = random_genome(seed_rng, n_hits=n_hits, weak=weak)
    jd = to_jax(d)
    d_vec, g_vec = clone(d, g)
    d_ref, g_ref = clone(d, g)
    n = sn.shadow(opt, d, g, cal_dom_sc=cal)
    jopt = JaxOpt(flag=opt.flag)
    assert n == jsn.shadow(jopt, jd, jd.genomes[0], cal_dom_sc=cal)
    assert n == sweep_vec.shadow(opt, d_vec, g_vec, cal_dom_sc=cal)
    assert n == sweep.shadow(opt, d_ref, g_ref, cal_dom_sc=cal)
    for col in SWEEP_COLS:
        for other in (jd.genomes[0].hits, g_vec.hits, g_ref.hits):
            np.testing.assert_array_equal(g.hits.cols[col], other.cols[col],
                                          err_msg=col)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("check_strand", [False, True])
def test_shadow_native(seed, check_strand):
    opt = PgOpt()
    if check_strand:
        opt.flag |= PG_F_CHECK_STRAND
    _sweep_three(np.random.default_rng(seed), 120, seed % 2 == 0, opt, True)


@pytest.mark.parametrize("seed", range(8))
def test_shadow_native_no_dom_sc(seed):
    _sweep_three(np.random.default_rng(100 + seed), 150, True, PgOpt(), False)


@pytest.mark.parametrize("seed", range(8))
def test_ov_isoform_native(seed):
    opt = PgOpt()
    d, g = random_genome(np.random.default_rng(50 + seed), n_hits=120)
    jd = to_jax(d)
    d_vec, g_vec = clone(d, g)
    n = sn.flt_ov_isoform(opt, d, g)
    assert n == jsn.flt_ov_isoform(JaxOpt(), jd, jd.genomes[0])
    assert n == sweep_vec.flt_ov_isoform(opt, d_vec, g_vec)
    for col in ("flt_iso_ov", "flt"):
        for other in (jd.genomes[0].hits, g_vec.hits):
            np.testing.assert_array_equal(g.hits.cols[col], other.cols[col])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("frag", [False, True])
def test_n_local_native(seed, frag):
    rng = np.random.default_rng(200 + seed)
    G, ng, P = 7, 60, 500
    opt = PgOpt(local_dist=1000, local_count=3)
    if frag:
        opt.flag |= PG_F_FRAG_MODE
    rep_pos = (rng.random((G, ng)) < 0.7,
               rng.integers(0, 3, (G, ng), dtype=np.int32),
               rng.integers(0, 40, (G, ng), dtype=np.int32),
               rng.integers(0, 20000, (G, ng), dtype=np.int64))
    g1 = rng.integers(0, ng, P, dtype=np.int64)
    g2 = rng.integers(0, ng, P, dtype=np.int64)
    got = tbranch.n_local_batch(opt, rep_pos, g1, g2)
    assert sn.n_calls["n_local_batch"] > 0
    jopt = JaxOpt(local_dist=1000, local_count=3, flag=opt.flag)
    np.testing.assert_array_equal(got, jsn.n_local_batch(jopt, rep_pos, g1,
                                                         g2))
    with numpy_branches():
        want = tbranch.n_local_batch(opt, rep_pos, g1, g2)
    np.testing.assert_array_equal(got, want)


def _random_graph(graph_cls, arc_cls, d, rng):
    q = graph_cls(d)
    ng = d.n_gene
    q.seg_gid = np.arange(ng, dtype=np.int32)
    q.seg_n_dist_loci = np.zeros((ng, 2), np.int32)
    v = rng.integers(0, ng * 2, 60).astype(np.uint64)
    w = rng.integers(0, ng * 2, 60).astype(np.uint64)
    x = np.unique((v << np.uint64(32)) | w)
    arcs = arc_cls.empty(len(x))
    arcs.x = x
    arcs.s1 = rng.integers(0, 50, len(x)).astype(np.int32)
    q.arcs = arcs
    return q


@pytest.mark.parametrize("seed", range(6))
def test_mark_branch_native(seed):
    """The full branching-arc pass (with the representative positions) on a
    random graph: the port's native branch == the JAX native branch == the
    port's NumPy branch."""
    rng = np.random.default_rng(300 + seed)
    d, g0 = random_genome(rng, n_hits=150)
    d_np, _ = clone(d, g0)
    jd = to_jax(d)
    state = rng.bit_generator.state
    qs = []
    for dd, gc, ac in ((d, Graph, ArcTable), (d_np, Graph, ArcTable),
                       (jd, JaxGraph, JaxArcTable)):
        rng.bit_generator.state = state
        qs.append(_random_graph(gc, ac, dd, rng))
    qa, qb, qj = qs
    opt = PgOpt(local_dist=2000, local_count=2)
    sn.reset_counts()
    n1 = tbranch.mark_branch_flt_arc(opt, qa)
    assert sn.n_calls["mark_branch"] == 1
    assert sn.n_calls["rep_pos_rows"] == 1
    with numpy_branches():
        n2 = tbranch.mark_branch_flt_arc(opt, qb)
    n3 = jbranch.mark_branch_flt_arc(JaxOpt(local_dist=2000, local_count=2),
                                     qj)
    assert n1 == n2 == n3
    for q in (qb, qj):
        np.testing.assert_array_equal(qa.arcs.weak_br, q.arcs.weak_br)
        np.testing.assert_array_equal(qa.seg_n_dist_loci, q.seg_n_dist_loci)


def _multi_genome(seed):
    """A random genome plus two more over the same gene/protein tables."""
    rng = np.random.default_rng(400 + seed)
    d, _ = random_genome(rng, n_hits=160)
    for extra_seed in (2, 3):
        _, g = random_genome(np.random.default_rng(400 + seed
                                                   + 1000 * extra_seed),
                             n_hits=120)
        g.hits.set("pid", np.minimum(g.hits.pid, np.int32(d.n_prot - 1)))
        d.genomes.append(g)
    return d


def _arc_graph(graph_cls, d):
    q = graph_cls(d)
    ng = d.n_gene
    q.seg_gid = np.arange(ng, dtype=np.int32)
    q.gen_g2s()
    q.seg_n_dist_loci = np.zeros((ng, 2), np.int32)
    return q


@pytest.mark.parametrize("seed", range(5))
def test_gen_arc_native(seed):
    """gen_arc_loop: the native walk/dedupe/merge under "host" (sweep in the
    same C call) and under "sharded" (sweep on the device engine, here its
    plain version on the CPU) against the NumPy path ("host-vec") and the
    JAX package's "host": identical arc table and segment counters."""
    d = _multi_genome(seed)
    runs = {}
    for engine in ("host", "sharded", "host-vec"):
        dd = tdata.DataSet.new()
        dd.__dict__.update({k: v for k, v in d.__dict__.items()
                            if k != "genomes"})
        dd.genomes = [tdata.Genome(g.label, g.ctg_names, g.ctg_len,
                                   g.hits.copy(), g.exon_os.copy(),
                                   g.exon_oe.copy()) for g in d.genomes]
        q = _arc_graph(Graph, dd)
        sn.reset_counts()
        tarcs.gen_arc_loop(PgOpt(engine=engine, device="cpu"), q)
        native = engine != "host-vec"
        assert (sn.n_calls["round_genome"] == 3) == native
        assert (sn.n_calls["merge_arcs_kway"] == 1) == native
        runs[engine] = q
    qj = _arc_graph(JaxGraph, to_jax(d))
    jarcs.gen_arc_loop(JaxOpt(engine="host"), qj)
    want = runs["host-vec"]
    for q in (runs["host"], runs["sharded"], qj):
        for col in ("x", "n_genome", "tot_cnt", "avg_dist", "s1", "s2"):
            np.testing.assert_array_equal(getattr(q.arcs, col),
                                          getattr(want.arcs, col),
                                          err_msg=col)
        np.testing.assert_array_equal(q.seg_n_genome, want.seg_n_genome)
        np.testing.assert_array_equal(q.seg_tot_cnt, want.seg_tot_cnt)


@pytest.mark.parametrize("seed", range(4))
def test_merge_tree_vs_kway(seed):
    """The two global-merge strategies of the library (pairwise tree with
    early aggregation, k-way heap), the port's entries merge_arcs_kway and
    merge_arcs_native, the JAX entry and the NumPy merge_arcs: all equal."""
    rng = np.random.default_rng(500 + seed)
    per = []
    for _ in range(int(rng.integers(1, 9))):
        x = np.unique(rng.integers(0, 500, int(rng.integers(0, 400)))
                      .astype(np.uint64))
        per.append((x, rng.integers(1, 5, len(x)).astype(np.int32),
                    rng.integers(0, 10000, len(x)).astype(np.int32),
                    rng.integers(0, 100, len(x)).astype(np.int32),
                    rng.integers(0, 100, len(x)).astype(np.int32)))
    lib = sn._get_lib()
    offs = np.zeros(len(per) + 1, np.int64)
    offs[1:] = np.cumsum([len(p[0]) for p in per])
    cat = [np.concatenate([p[i] for p in per]) for i in range(5)]
    outs = []
    for fn in (lib.pg_merge_arcs_tree, lib.pg_merge_arcs_kway):
        cap = max(int(offs[-1]), 1)
        bufs = [np.empty(cap, np.uint64)] + [np.empty(cap, np.int32)
                                             for _ in range(5)]
        m = fn(len(per), sn._p(offs, np.int64),
               *[sn._p(c, c.dtype) for c in cat],
               *[sn._p(b, b.dtype) for b in bufs])
        outs.append([b[:m].copy() for b in bufs])
    outs.append(list(sn.merge_arcs_kway(per)))
    outs.append(list(sn.merge_arcs_native(*cat)))
    outs.append(list(jsn.merge_arcs_kway(per)))
    with numpy_branches():
        t = tarcs.merge_arcs(per)
    outs.append([t.x, t.n_genome, t.tot_cnt, t.avg_dist, t.s1, t.s2])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a, b)


def _settle(g):
    """Canonical cs order, then two physical round trips: the cm -> cs cycle
    is known afterwards and cm_cycle_view gives a view (as in the rounds)."""
    hit_sort(g, by_cm=False)
    for _ in range(2):
        hit_sort(g, by_cm=True)
        hit_sort(g, by_cm=False)


def _numpy_round(opt, d, g, g2s, n_seg):
    """round_genome's outputs by the port's NumPy branches: the vectorized
    sweep (cal_dom_sc off), the walk through the cm-order view, the dedupe
    and the segment counts."""
    sweep_vec.shadow(opt, d, g, cal_dom_sc=False)
    walk = types.SimpleNamespace(g2s=g2s, d=d)
    x, dist, s1, s2, sids = tarcs.walk_extract(walk, g, False,
                                               view=cm_cycle_view(g))
    return tarcs.dedupe_genome(x, dist, s1, s2) + (
        np.bincount(sids, minlength=n_seg).astype(np.int32),)


@pytest.mark.parametrize("seed", range(4))
def test_round_caches_across_monotone_rounds(seed):
    """Multi-round differential fuzz of the native cache stack (hot table,
    pair-geometry byte cache, walk-pack, scratch reuse, the prebuilt ctypes
    arguments): the fused round runs again and again on one genome while
    flt / weak_br evolve monotonically (the caches' invariants; see
    pgsweep.c:sweep_shadow_core) and g2s changes arbitrarily. Each round's
    warm outputs must equal a cold run on a fresh clone, the JAX package's
    cold run, and the NumPy branches. At round 3 two columns are replaced
    by set() with equal values: every cache keyed on the address must
    rebuild."""
    rng = np.random.default_rng(900 + seed)
    opt = PgOpt()
    d, g = random_genome(rng, n_hits=200, weak=True)
    g.hits.set("pid_dom0", g.hits.pid_dom.copy())
    _settle(g)
    n_seg = d.n_gene
    for rnd in range(6):
        g2s = np.arange(n_seg, dtype=np.int32)
        if rnd >= 2:   # delete some segments, as the pruning rounds do
            keep = np.ones(n_seg, bool)
            keep[rng.integers(0, n_seg, 3)] = False
            g2s = np.full(n_seg, -1, np.int32)
            g2s[keep] = np.arange(int(keep.sum()), dtype=np.int32)
            gid = np.asarray(d.prot_gid, np.int32)[g.hits.pid]
            g.hits.flt[~keep[gid]] = 1
        # the cold witnesses start from the warm genome's state, stale
        # sweep outputs of hit 0 and of filtered hits included
        d_cold, g_cold = clone(d, g)
        d_np, g_np = clone(d, g)
        jd = to_jax(d)
        view = cm_cycle_view(g)
        assert view is not None
        warm = sn.round_genome(opt, d, g, g2s, False, n_seg, view, True)
        warm = [a.copy() for a in warm]
        _settle(g_cold)
        cold = sn.round_genome(opt, d_cold, g_cold, g2s, False, n_seg,
                               cm_cycle_view(g_cold), True)
        _settle(g_np)
        numpy = _numpy_round(opt, d_np, g_np, g2s, n_seg)
        jg = jd.genomes[0]
        from pangene_tpu.ops.sort import cm_cycle_view as jview
        from pangene_tpu.ops.sort import hit_sort as jsort
        jsort(jg, by_cm=False)
        for _ in range(2):
            jsort(jg, by_cm=True)
            jsort(jg, by_cm=False)
        jax_out = jsn.round_genome(JaxOpt(), jd, jg, g2s, False, n_seg,
                                   jview(jg), True)
        for name, a, b, c, j in zip(ROUND_OUTS, warm, cold, numpy, jax_out):
            np.testing.assert_array_equal(a, b, err_msg="round %d %s cold"
                                          % (rnd, name))
            np.testing.assert_array_equal(a, c, err_msg="round %d %s numpy"
                                          % (rnd, name))
            np.testing.assert_array_equal(a, j, err_msg="round %d %s jax"
                                          % (rnd, name))
        for other in (g_cold.hits, g_np.hits, jg.hits):
            np.testing.assert_array_equal(g.hits.shadow, other.shadow,
                                          err_msg="round %d shadow" % rnd)
        # monotone evolution: set a few more flt, raise a few weak ranks
        g.hits.flt[rng.integers(0, len(g.hits), 4)] = 1
        wi = rng.integers(0, len(g.hits), 4)
        g.hits.weak_br[wi] = np.maximum(g.hits.weak_br[wi],
                                        rng.integers(1, 3))
        if rnd == 3:
            g.hits.set("flt", g.hits.flt.copy())
            g.hits.set("weak_br", g.hits.weak_br.copy())


def test_warm_native_round_after_stacked_apply(tmp_path, monkeypatch):
    """The host rounds of the per-round path: each round the per-round
    step's host apply (parallel/stacked.py) replaces every genome's shadow
    and pid_dom columns by set(); the native calls of the next round
    (representative positions, the fused round, weak propagation) run on
    their warm caches and must equal cold calls on fresh clones."""
    from pangene_tpu_torch import pipeline
    from pangene_tpu_torch.graph import build
    from pangene_tpu_torch.graph.post import post_process
    from pangene_tpu_torch.graph.vertex import gen_vtx
    from pangene_tpu_torch.parallel import stacked
    from pangene_tpu_torch.testing import synth_paf_files
    from pangene_tpu_torch import util
    monkeypatch.setenv("PANGENE_PARSE_WORKERS", "1")
    monkeypatch.setenv("PANGENE_DEVICE_LOOP", "0")
    util.verbose = 0
    files = synth_paf_files(str(tmp_path), n_genome=4, n_gene=120, n_iso=3,
                            seed=5)
    opt = PgOpt(engine="sharded", device="cpu")
    d = pipeline.read_all(opt, files)
    post_process(opt, d)
    q = Graph(d)
    build.set_filter(d, "pseudo", 1)
    gen_vtx(opt, q)
    q.flag_vtx()
    build.set_filter_eq0(d, "vtx")
    stacked.LAST.clear()
    n_checked = 0
    for rnd in range(4):
        tarcs.gen_arc(opt, q)                  # the step and its apply
        assert stacked.LAST["rounds"] == rnd + 1
        for gen in d.genomes:
            view = cm_cycle_view(gen)
            if view is None:
                continue
            d_c, g_c = clone(d, gen)
            g_c._sort_cache = copy.deepcopy(gen._sort_cache)
            rows = sn.rep_pos_rows(d, gen)
            rows = None if rows is None else [a.copy() for a in rows]
            rows_c = sn.rep_pos_rows(d_c, g_c)
            # the native layer addresses the live columns, which the apply
            # replaced
            addr = sn._hit_addrs(gen.hits)
            for k, a in gen.hits.cols.items():
                assert addr[k] == a.ctypes.data, k
            # flip every evaluated row's shadow flag in place: the sweep
            # must rewrite each one in the live column
            ev = np.flatnonzero(gen.hits.flt == 0)
            ev = ev[ev > 0]
            gen.hits.shadow[ev] ^= 1
            g_c.hits.shadow[ev] ^= 1
            warm = [a.copy() for a in sn.round_genome(
                opt, d, gen, q.g2s, False, q.n_seg, view, True)]
            cold = sn.round_genome(opt, d_c, g_c, q.g2s, False, q.n_seg,
                                   cm_cycle_view(g_c), True)
            assert (rows is None) == (rows_c is None)
            if rows is not None:
                for a, b in zip(rows, rows_c):
                    np.testing.assert_array_equal(a, b)
            for name, a, b in zip(ROUND_OUTS, warm, cold):
                np.testing.assert_array_equal(a, b, err_msg="round %d %s"
                                              % (rnd, name))
            np.testing.assert_array_equal(gen.hits.shadow, g_c.hits.shadow)
            n_checked += 1
        q.arc_index()
        tbranch.mark_branch_flt_arc(opt, q)
        tbranch.mark_branch_flt_hit(opt, q)
        build.set_filter(d, "weak_br", 2)
    assert n_checked >= 3 * len(d.genomes)


# The graph-level entries on one phase-1 state that both packages reach
# from the same PAF files: the port's native branch, the port's NumPy
# branch and the JAX package's native branch.

@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory):
    from pangene_tpu_torch.testing import synth_paf_files
    d = tmp_path_factory.mktemp("native_corpus")
    return synth_paf_files(str(d), n_genome=4, n_gene=150, n_iso=3, seed=13)


def _phase1(pkg, files, until_vtx=False):
    """(opt, d, q) after phase 1 of the schedule under engine "host"
    (pkg: "port" or "jax"); with until_vtx, right before gen_vtx."""
    import importlib
    import os
    root = "pangene_tpu_torch" if pkg == "port" else "pangene_tpu"
    mod = lambda name: importlib.import_module(root + "." + name)
    opt = (PgOpt if pkg == "port" else JaxOpt)(engine="host")
    old = os.environ.get("PANGENE_PARSE_WORKERS")
    os.environ["PANGENE_PARSE_WORKERS"] = "1"    # no worker pool
    try:
        mod("util").verbose = 0
        d = mod("pipeline").read_all(opt, files)
    finally:
        if old is None:
            del os.environ["PANGENE_PARSE_WORKERS"]
        else:
            os.environ["PANGENE_PARSE_WORKERS"] = old
    mod("graph.post").post_process(opt, d)
    build = mod("graph.build")
    q = mod("graph.graphdata").Graph(d)
    build.set_filter(d, "pseudo", 1)
    if until_vtx:
        return opt, d, q
    mod("graph.vertex").gen_vtx(opt, q)
    q.flag_vtx()
    build.set_filter_eq0(d, "vtx")
    mod("ops.arcs").gen_arc_loop(opt, q)
    return opt, d, q


def test_gen_vtx_greedy_native(small_corpus):
    from pangene_tpu.graph.vertex import gen_vtx as jgen_vtx
    from pangene_tpu_torch.graph.vertex import gen_vtx
    graphs = []
    for pkg, native in (("port", True), ("port", False), ("jax", True)):
        opt, d, q = _phase1(pkg, small_corpus, until_vtx=True)
        sn.reset_counts()
        if pkg == "jax":
            jgen_vtx(opt, q)
        elif native:
            gen_vtx(opt, q)
            assert sn.n_calls["gen_vtx_greedy"] == 1
        else:
            with numpy_branches():
                gen_vtx(opt, q)
        graphs.append(q)
    for q in graphs[1:]:
        for col in ("seg_gid", "seg_n_dom", "seg_n_sub", "g2s"):
            np.testing.assert_array_equal(getattr(graphs[0], col),
                                          getattr(q, col), err_msg=col)
        np.testing.assert_array_equal(np.asarray(graphs[0].d.gene_rep_pid),
                                      np.asarray(q.d.gene_rep_pid))


@pytest.fixture(scope="module")
def phase1_states(small_corpus):
    return [_phase1("port", small_corpus), _phase1("port", small_corpus),
            _phase1("jax", small_corpus)]


def test_rep_pos_rows_native(phase1_states):
    (_, d, _), (_, d_np, _), (_, jd, _) = phase1_states
    sn.reset_counts()
    got = tbranch.gen_rep_pos(d)[0]
    assert sn.n_calls["rep_pos_rows"] == d.n_genome
    with numpy_branches():
        want = tbranch.gen_rep_pos(d_np)[0]
    jgot = jbranch.gen_rep_pos(jd)[0]
    for a, b, c in zip(got, want, jgot):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert got[0].any()


@pytest.mark.parametrize("use_ori", [False, True])
def test_walk_arcs_native(phase1_states, use_ori):
    """walk_arcs (the walk and per-genome dedupe without the sweep) on every
    genome: == the JAX entry == the NumPy walk_extract + dedupe_genome."""
    (_, d, q), _, (_, jd, jq) = phase1_states
    from pangene_tpu.ops.sort import cm_cycle_view as jview
    for gen, jgen in zip(d.genomes, jd.genomes):
        view = cm_cycle_view(gen)
        got = sn.walk_arcs(d, gen, q.g2s, use_ori, q.n_seg, view)
        jgot = jsn.walk_arcs(jd, jgen, jq.g2s, use_ori, jq.n_seg,
                             jview(jgen))
        x, dist, s1, s2, sids = tarcs.walk_extract(q, gen, use_ori,
                                                   view=view)
        want = tarcs.dedupe_genome(x, dist, s1, s2) + (
            np.bincount(sids, minlength=q.n_seg).astype(np.int32),)
        assert len(got[0])
        for name, a, b, c in zip(ROUND_OUTS, got, want, jgot):
            np.testing.assert_array_equal(a, b, err_msg=name)
            np.testing.assert_array_equal(a, c, err_msg=name)


def test_propagate_weak_native(small_corpus):
    """mark_branch_flt_hit on one set of marked arcs: the native hash
    propagation == the NumPy searchsorted branch == the JAX package; and
    the library's two propagation entries (hash table, sorted arcs) agree."""
    states = [_phase1("port", small_corpus) for _ in range(3)] + [
        _phase1("jax", small_corpus)]
    rng = np.random.default_rng(17)
    w = rng.integers(0, 3, states[0][2].n_arc).astype(np.uint8)
    for _, _, q in states:
        q.arcs.weak_br[:] = w
    (opt, d, q), (_, d_np, q_np), (_, d_pw, q_pw), (jopt, jd, jq) = states
    sn.reset_counts()
    n = tbranch.mark_branch_flt_hit(opt, q)
    assert sn.n_calls["propagate_weak_hash"] == d.n_genome
    with numpy_branches():
        assert tbranch.mark_branch_flt_hit(opt, q_np) == n
    assert jbranch.mark_branch_flt_hit(jopt, jq) == n
    marked = np.flatnonzero(w)
    for gen in d_pw.genomes:
        sn.propagate_weak(d_pw, gen, q_pw.g2s, cm_cycle_view(gen),
                          q_pw.arcs.x[marked].copy(), w[marked].copy())
    assert n > 0
    for other in (d_np, d_pw, jd):
        for g, h in zip(d.genomes, other.genomes):
            np.testing.assert_array_equal(g.hits.weak_br, h.hits.weak_br)


def test_format_arcs_native(phase1_states):
    """The L-line renderer: native == NumPy == the JAX package's."""
    import io
    from pangene_tpu.io.gfa_write import write_arc as jwrite_arc
    from pangene_tpu_torch.io.gfa_write import write_arc
    (_, _, q), _, (_, _, jq) = phase1_states
    rng = np.random.default_rng(19)
    q.arcs.weak_br[:] = rng.integers(0, 3, q.n_arc)
    jq.arcs.weak_br[:] = q.arcs.weak_br
    outs = [io.StringIO() for _ in range(3)]
    sn.reset_counts()
    write_arc(q, outs[0])
    assert sn.n_calls["format_arcs"] == 1
    with numpy_branches():
        write_arc(q, outs[1])
    jwrite_arc(jq, outs[2])
    assert outs[0].getvalue().count("\n") == q.n_arc > 0
    assert outs[0].getvalue() == outs[1].getvalue() == outs[2].getvalue()
