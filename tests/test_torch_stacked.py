"""The port's per-round device path (pangene_tpu_torch/parallel/stacked.py)
against the JAX package's (pangene_tpu/parallel/stacked.py on a one-device
CPU mesh), on the CPU. Every comparison is exact (integers and bytes,
tolerance 0).

  build  build_stacked / stack_mutable against the JAX build_stacked, column
         by column up to padding.
  step   round_step against the JAX round_step, output for output, on one
         graph state both packages reach from the same PAF files and the
         same numpy-seeded changes: the filter redrawn, weak_br, stale
         shadow flags, an empty genome, a genome whose row 0 is filtered,
         kept rows of a non-vertex gene.
  post   reduction_step / post_reductions_sharded against the JAX ones and
         against the host loops of ops/pseudo.py.
  e2e    --engine sharded --device cpu with PANGENE_DEVICE_LOOP=0 against
         the JAX CLI under the same switch; each case asserts that the
         per-round path ran and uploaded its constant columns once. A forced
         fallback of the device loop must land on the same path.
  cache  a genome's sort state changed between two rounds: the cached
         columns follow (a re-ordering on the device, or a new upload), and
         a cache that is kept stale on purpose gives other bytes.
"""
import copy
import gzip
import io
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangene_tpu import pipeline as jpipeline
from pangene_tpu import util as jutil
from pangene_tpu.core import data as jdata
from pangene_tpu.graph import build as jbuild
from pangene_tpu.graph.graphdata import Graph as JaxGraph
from pangene_tpu.graph.post import post_process as jpost_process
from pangene_tpu.graph.vertex import gen_vtx as jgen_vtx
from pangene_tpu.ops import device as jdev
from pangene_tpu.options import PgOpt as JaxOpt
from pangene_tpu.parallel import stacked as jst
from pangene_tpu.parallel.mesh import make_mesh, put_sharded
from pangene_tpu_torch import pipeline, util
from pangene_tpu_torch.core import data as tdata
from pangene_tpu_torch.graph import build as tbuild
from pangene_tpu_torch.graph.graphdata import Graph
from pangene_tpu_torch.graph.post import post_process
from pangene_tpu_torch.graph.vertex import gen_vtx
from pangene_tpu_torch.ops import pseudo as pseudo_ops
from pangene_tpu_torch.ops import sweep_kernel as sk
from pangene_tpu_torch.ops.sort import hit_sort
from pangene_tpu_torch.options import (PG_F_CHECK_STRAND,
                                       PG_F_ORI_FOR_BRANCH, PgOpt)
from pangene_tpu_torch.parallel import device_loop as dl
from pangene_tpu_torch.parallel import stacked as st
from pangene_tpu_torch.testing import synth_paf_files

REPO = pathlib.Path(__file__).resolve().parent.parent
BIAS = np.uint64(1 << 63)

# small tensors: one torch thread per test process, so that several test
# workers on one machine do not contend for its cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The synthetic corpus of tests/test_torch_pipeline.py."""
    d = tmp_path_factory.mktemp("torch_stacked")
    return synth_paf_files(str(d), n_genome=6, n_gene=300, n_iso=3, seed=3)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # parse in the main process: no worker pool to start for six small files
    monkeypatch.setenv("PANGENE_PARSE_WORKERS", "1")
    util.verbose = 0
    jutil.verbose = 0
    yield
    util.verbose = 3
    jutil.verbose = 3


def run_port(files, engine="sharded", **kw):
    opt = PgOpt(engine=engine, device="cpu", **kw)
    out = io.StringIO()
    pipeline.run(opt, files, out=out)
    return out.getvalue()


def run_jax(files, engine="sharded", **kw):
    out = io.StringIO()
    jpipeline.run(JaxOpt(engine=engine, n_devices=1, **kw), files, out=out)
    return out.getvalue()


# ---------------------------------------------------------------------------
# one graph state in both packages
# ---------------------------------------------------------------------------

def change_state(d, q, data_mod):
    """The same numpy-seeded changes to either package's state just before
    the first pg_gen_arc: the filter redrawn (which brings back overlapping
    isoforms and hits of non-vertex genes), weak_br, stale shadow flags, row
    0 of genome 1 filtered, a gene with kept hits made a non-vertex, and an
    empty genome at the end."""
    rng = np.random.default_rng(5)
    for g in d.genomes:
        h = g.hits
        n = len(h)
        h.set("flt", (rng.random(n) < 0.3).astype(h.flt.dtype))
        h.set("weak_br", np.where(rng.random(n) < 0.3, rng.integers(0, 3, n),
                                  0).astype(h.weak_br.dtype))
        h.set("shadow", (rng.random(n) < 0.1).astype(h.shadow.dtype))
    d.genomes[1].hits.flt[0] = 1
    h = d.genomes[0].hits
    row = np.flatnonzero(h.flt == 0)[7]
    q.g2s[np.asarray(d.prot_gid)[h.pid[row]]] = -1
    d.genomes.append(data_mod.Genome(
        "empty", ["c0"], np.full(1, 1000, np.int64),
        data_mod.HitTable.empty(0), np.zeros(0, np.int32),
        np.zeros(0, np.int32)))


def port_state(files, changed=True):
    opt = PgOpt(engine="device", device="cpu")
    d = pipeline.read_all(opt, files)
    post_process(opt, d)
    q = Graph(d)
    tbuild.set_filter(d, "pseudo", 1)
    gen_vtx(opt, q)
    q.flag_vtx()
    tbuild.set_filter_eq0(d, "vtx")
    if changed:
        change_state(d, q, tdata)
    return d, q


def jax_state(files):
    opt = JaxOpt(engine="host")
    d = jpipeline.read_all(opt, files)
    jpost_process(opt, d)
    q = JaxGraph(d)
    jbuild.set_filter(d, "pseudo", 1)
    jgen_vtx(opt, q)
    q.flag_vtx()
    jbuild.set_filter_eq0(d, "vtx")
    change_state(d, q, jdata)
    return d, q


def copy_dataset(d):
    """A data set whose hit tables and sort histories are its own (the gene
    and protein tables, which nothing here writes, stay shared)."""
    e = copy.copy(d)
    e.genomes = []
    for g in d.genomes:
        c = copy.copy(g)
        c.hits = g.hits.copy()
        if hasattr(g, "_sort_cache"):
            c._sort_cache = copy.deepcopy(g._sort_cache)
        e.genomes.append(c)
    return e


_states = {}


def states(corpus):
    if "s" not in _states:
        _states["s"] = (port_state(corpus), jax_state(corpus))
    return _states["s"]


def jax_shapes(d):
    """H, E, K, W as the JAX gen_arc_sharded sizes them."""
    H = jdev.next_pow2(max(g.n_hit for g in d.genomes))
    E = jdev.next_pow2(max(len(g.exon_os) for g in d.genomes))
    K = jdev.next_pow2(max(int(g.hits.n_exon.max(initial=1))
                           for g in d.genomes), lo=2)
    W = 1
    for g in d.genomes:
        if g.n_hit:
            W = max(W, jdev.band_width(g.hits.cid, np.asarray(g.hits.cs),
                                       np.asarray(g.hits.ce)))
    return H, E, K, min(jdev.next_pow2(W, lo=2), H)


# ---------------------------------------------------------------------------
# build level
# ---------------------------------------------------------------------------

def test_build_stacked_equals_jax(corpus):
    (d, _), (jd, _) = states(corpus)
    hs = st.build_stacked(d)
    cols = st.stack_views(*hs[:5])
    JH, JE, _, JW = jax_shapes(jd)
    jcols, jex_os, jex_oe = jst.build_stacked(jd, JH, JE)
    G, H = hs.i32.shape[1:]
    E = hs.ex.shape[2]
    assert G == jd.n_genome == 7
    assert H == max(g.n_hit for g in d.genomes) <= JH
    assert E == max(len(g.exon_os) for g in d.genomes) <= JE
    assert 1 <= hs.W <= JW
    named = dict(cols.batch._asdict(), cm=cols.cm, dom_gid=cols.dom_gid,
                 score_ori=cols.score_ori, score_dom=cols.score_dom)
    for name in st.STACK_I32 + st.STACK_I64 + st.STACK_U8:
        got, want = named[name], jcols[name]
        if name == "pscore":
            got = got.view(np.uint64) ^ BIAS
        assert np.array_equal(got, want[:, :H]), name
        # the JAX padding beyond H repeats what the port pads its rows with
        for j, g in enumerate(d.genomes):
            pad = got[j, g.n_hit:]
            assert (pad == want[j, JH - 1]).all(), name
    assert np.array_equal(cols.batch.exon_os, jex_os[:, :E])
    assert np.array_equal(cols.batch.exon_oe, jex_oe[:, :E])
    assert np.array_equal(cols.batch.n_rows, jcols["valid"].sum(1))
    mut = st.stack_mutable(d, np.zeros((3, G, H), np.uint8))
    for k, name in enumerate(st.MUTABLE_COLS):
        assert np.array_equal(mut[k], jcols[name][:, :H]), name
        assert not jcols[name][:, H:].any()


# ---------------------------------------------------------------------------
# step level
# ---------------------------------------------------------------------------

def jax_round(jd, g2s, check_strand, use_ori, f):
    """The JAX round_step on a one-device mesh, unpacked as its
    gen_arc_sharded unpacks it."""
    mesh = make_mesh(1)
    H, E, K, W = jax_shapes(jd)
    cols, ex_os, ex_oe = jst.build_stacked(jd, H, E)
    big, small = jst.round_step(
        {k: put_sharded(v, mesh) for k, v in cols.items()},
        put_sharded(ex_os, mesh), put_sharded(ex_oe, mesh),
        jnp.asarray(g2s), min_ov_ratio=f, W=W, K=K,
        check_strand=check_strand, use_ori=use_ori, n_gene=jd.n_gene,
        mesh=mesh)
    big, small = np.asarray(big), np.asarray(small)
    out, o = {}, 0
    for name, width in (("shadow", H), ("b_score", H), ("b_other", H),
                        ("uniq_x", 2 * H), ("cnt", 2 * H), ("dsum", 2 * H),
                        ("m1", 2 * H), ("m2", 2 * H)):
        out[name] = big[:, o:o + width]
        o += width
    out["tot_cnt"] = small[:jd.n_gene]
    out["n_genome"] = small[jd.n_gene:2 * jd.n_gene]
    return out


def port_round(d, g2s, check_strand, use_ori, f):
    hs = st.build_stacked(d)
    cols = st.stack_views(*[torch.from_numpy(a) for a in hs[:5]])
    G, H = hs.i32.shape[1:]
    mut = torch.from_numpy(st.stack_mutable(d, np.zeros((3, G, H),
                                                        np.uint8)))
    outs = st.round_step(cols, mut[0], mut[1], mut[2],
                         torch.from_numpy(np.asarray(g2s)), W=hs.W,
                         min_ov_ratio=f, check_strand=check_strand,
                         use_ori=use_ori)
    return {name: o.numpy() for name, o in zip(st.STEP_OUTPUTS, outs)}


@pytest.mark.parametrize("f", [0.5, 0.3])
@pytest.mark.parametrize("use_ori", [False, True])
@pytest.mark.parametrize("check_strand", [False, True])
def test_round_step_equals_jax(corpus, check_strand, use_ori, f):
    (d, q), (jd, jq) = states(corpus)
    assert np.array_equal(q.g2s, jq.g2s)
    got = port_round(d, q.g2s, check_strand, use_ori, f)
    want = jax_round(jd, jq.g2s, check_strand, use_ori, f)
    n_arcs = 0
    high = False
    for j, g in enumerate(d.genomes):
        n = g.n_hit
        assert np.array_equal(got["shadow"][j, :n], want["shadow"][j, :n])
        assert np.array_equal(got["b_score"][j, :n].view(np.uint64) ^ BIAS,
                              want["b_score"][j, :n].view(np.uint64))
        assert np.array_equal(got["b_other"][j, :n], want["b_other"][j, :n])
        sel = got["cnt"][j] > 0
        jsel = want["cnt"][j] > 0
        assert sel.sum() == jsel.sum()
        for name in ("uniq_x", "cnt", "dsum", "m1", "m2"):
            assert np.array_equal(got[name][j][sel], want[name][j][jsel]), \
                (j, name)
        n_arcs += int(sel.sum())
        high |= bool((got["uniq_x"][j][sel] < 0).any())
    assert np.array_equal(got["tot_cnt"], want["tot_cnt"])
    assert np.array_equal(got["n_genome"], want["n_genome"])
    # the state exercises what it is meant to: dominated and shadowed hits,
    # arcs, and the kept hits of a non-vertex gene (keys past 2^63)
    assert (got["b_score"] > sk.SCORE_NONE).any() and got["shadow"].any()
    assert n_arcs > 100 and high
    assert d.genomes[-1].n_hit == 0 and d.genomes[1].hits.flt[0] == 1


def test_round_step_outputs_and_empty_stack(corpus):
    """Shapes and types of the step's outputs, and a stack of empty
    genomes."""
    (d, q), _ = states(corpus)
    got = port_round(d, q.g2s, False, False, 0.5)
    G, H = d.n_genome, max(g.n_hit for g in d.genomes)
    want = {"shadow": ((G, H), np.uint8), "b_score": ((G, H), np.int64),
            "b_other": ((G, H), np.int32), "uniq_x": ((G, 2 * H), np.int64),
            "cnt": ((G, 2 * H), np.int32), "dsum": ((G, 2 * H), np.int64),
            "m1": ((G, 2 * H), np.int32), "m2": ((G, 2 * H), np.int32),
            "tot_cnt": ((d.n_gene,), np.int32),
            "n_genome": ((d.n_gene,), np.int32)}
    for name, (shape, dtype) in want.items():
        assert got[name].shape == shape and got[name].dtype == dtype, name
    e = copy.copy(d)
    e.genomes = [d.genomes[-1], d.genomes[-1]]
    got = port_round(e, q.g2s, False, False, 0.5)
    assert not got["cnt"].any() and not got["tot_cnt"].any()


@pytest.mark.parametrize("check_strand", [False, True])
def test_round_step_on_random_genome_sets(check_strand):
    """testing.stack_cols (the card checks' input): the step's sweep outputs
    equal the per-genome plain sweep with the stale-flag rule, every kept
    pair gives two arcs, and a second step on the merged shadow (updated
    in place) changes nothing."""
    from pangene_tpu_torch.ops import device_engine as de
    from pangene_tpu_torch.testing import random_genome, stack_cols
    sizes = (300, 0, 120, 64, 1)
    genomes = [random_genome(np.random.default_rng(40 + k), n_hits=n,
                             weak=True, max_cs=30 * n + 100)
               for k, n in enumerate(sizes)]
    genomes[2][1].hits.flt[0] = 1
    cpu = torch.device("cpu")
    cols, flt, shadow, weak, g2s, W = stack_cols(genomes, cpu, seed=3)
    kw = dict(W=W, min_ov_ratio=0.3, check_strand=check_strand,
              use_ori=False)
    outs = st.round_step(cols, flt, shadow, weak, g2s, **kw)
    again = st.round_step(cols, flt, shadow.clone(), weak, g2s, **kw)
    for a, b in zip(outs, again):
        assert a.dtype == b.dtype and torch.equal(a, b)
    new_shadow, b_score, b_other = outs[:3]
    for j, (d, g) in enumerate(genomes):
        n = g.n_hit
        m, s, o, _ = sk.shadow_sweep_plain(de.build_cols(d, g, cpu), W,
                                           sk.SHADOW, check_strand, 0.3)
        ev = (flt[j, :n] == 0) & (torch.arange(n) >= 1)
        want = torch.where(ev, m != 0, (shadow[j, :n] != 0) | (m != 0))
        assert torch.equal(new_shadow[j, :n] != 0, want)
        assert torch.equal(b_score[j, :n], s)
        assert torch.equal(b_other[j, :n], o)
    cnt = outs[4]
    assert cnt.sum() > 0 and int(cnt.sum()) % 2 == 0
    assert int(outs[8].sum()) == int(((flt == 0) & (new_shadow == 0)
                                      & (torch.arange(flt.shape[1])[None, :]
                                         < cols.batch.n_rows[:, None])).sum())


# ---------------------------------------------------------------------------
# the protein-keyed reductions
# ---------------------------------------------------------------------------

def test_post_reductions_equal_jax(corpus):
    opt = PgOpt(engine="sharded", device="cpu")
    d = pipeline.read_all(opt, corpus)
    jd = jpipeline.read_all(JaxOpt(engine="host"), corpus)
    mx, z, (c, s) = st.post_reductions_sharded(opt, d)
    jmx, jz, (jc, js) = jst.post_reductions_sharded(
        JaxOpt(engine="sharded", n_devices=1), jd)
    for got, want in ((mx, jmx), (z, jz), (c, jc), (s, js)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert mx.max() > 0 and c.sum() > 0 and (z >> np.uint64(32)).any()
    # and the host loops of ops/pseudo.py, value for value
    hc, hs = pseudo_ops.joint_counts(d)
    for got, want in ((mx, pseudo_ops.max_score_ori(d)),
                      (z, pseudo_ops.representative_sums(d)), (c, hc),
                      (s, hs)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("flag", [0, 0x200], ids=["default", "-E"])
def test_post_reductions_equal_host_loops(corpus, flag):
    """cap_score_dom, flag_representative and flag_pseudo_joint leave the
    same tables whether they loop on the host or take the device's
    reductions."""
    opt = PgOpt(engine="sharded", device="cpu", flag=flag)
    a = pipeline.read_all(opt, corpus)
    b = copy_dataset(a)
    mx, z, acc = st.post_reductions_sharded(opt, b)
    pseudo_ops.cap_score_dom(a)
    pseudo_ops.cap_score_dom(b, mx)
    pseudo_ops.flag_representative(a)
    pseudo_ops.flag_representative(b, z)
    n_a = pseudo_ops.flag_pseudo_joint(opt, a)
    n_b = pseudo_ops.flag_pseudo_joint(opt, b, acc)
    assert n_a == n_b
    for name in ("prot_max_score_ori", "prot_n", "prot_avg_score_adj",
                 "gene_rep_pid", "prot_rep"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    for ga, gb in zip(a.genomes, b.genomes):
        for name in ("score_dom", "rep", "pseudo"):
            assert np.array_equal(ga.hits.cols[name], gb.hits.cols[name])


def test_reduction_step_on_padded_stack():
    """Rows past n_rows add nothing, whatever they hold."""
    rng = np.random.default_rng(2)
    G, H, P = 3, 50, 11
    n_rows = np.array([50, 0, 20], np.int32)
    cols = {k: rng.integers(0, 9, (G, H)).astype(np.int32)
            for k in ("pid", "score_ori", "score_adj", "n_exon")}
    cols["rank"] = rng.integers(0, 2, (G, H)).astype(np.int32)
    flt = rng.integers(0, 2, (G, H)).astype(np.uint8)
    t = torch.from_numpy
    outs = st.reduction_step(*[t(cols[k]) for k in st.REDUCTION_COLS],
                             t(flt), t(n_rows), n_prot=P)
    want = np.zeros((7, P), np.int64)
    for j in range(G):
        for i in range(n_rows[j]):
            p = cols["pid"][j, i]
            so = cols["score_ori"][j, i]
            want[0, p] = max(want[0, p], so)
            if cols["rank"][j, i] == 0 and flt[j, i] == 0:
                m = int(cols["n_exon"][j, i] != 1)
                want[1 + m, p] += 1
                want[3 + m, p] += so
                want[5, p] += cols["score_adj"][j, i]
                want[6, p] += 1
    for k, o in enumerate(outs):
        assert np.array_equal(o.numpy(), want[k]), k
    assert outs[0].dtype == torch.int32 and outs[1].dtype == torch.int64


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def assert_per_round_path(rounds=None):
    assert st.LAST["rounds"] > 0
    if rounds is not None:
        assert st.LAST["rounds"] == rounds
    assert st.LAST["const_uploads"] == 1
    assert st.LAST["device"] == "cpu" and st.LAST["sweep_launches"] == 0
    assert st.LAST["shape"]["G"] > 0 and st.LAST["pull_bytes"] > 0


@pytest.mark.parametrize("kw", [
    {}, {"flag": PG_F_CHECK_STRAND}, {"flag": PG_F_ORI_FOR_BRANCH},
    {"min_arc_cnt": 2}, {"min_ov_ratio": 0.3}],
    ids=["default", "-S", "--ori-sc", "-a2", "-f0.3"])
def test_cli_per_round_path_vs_jax(corpus, monkeypatch, kw):
    monkeypatch.setenv("PANGENE_DEVICE_LOOP", "0")
    dl.LAST.clear()
    sk.reset_counts()
    got = run_port(corpus, **kw)
    assert_per_round_path(rounds=17)
    assert sk.n_batched() == {"kernel": 0, "plain": 17}
    assert dl.LAST == {}            # the loop did not run
    assert got == run_jax(corpus, **kw)
    assert got == run_port(corpus, engine="device", **kw)


def test_synth16_golden_per_round_path(tmp_path, monkeypatch):
    monkeypatch.setenv("PANGENE_DEVICE_LOOP", "0")
    files = synth_paf_files(str(tmp_path), n_genome=16, n_gene=500,
                            n_iso=3, seed=42)
    want = gzip.open(REPO / "tests" / "golden" / "synth16.gfa.gz",
                     "rt").read()
    assert run_port(files) == want
    assert_per_round_path(rounds=17)


def test_forced_loop_fallback_takes_per_round_path(corpus, monkeypatch):
    """The device loop refuses the graph (arc capacity 1): phase 1 ran per
    genome, and every later round is one device step."""
    want = run_port(corpus, engine="device")
    monkeypatch.setenv("PANGENE_DEVLOOP_MAX_A", "1")
    st.LAST.clear()
    sk.reset_counts()
    got = run_port(corpus)
    assert dl.LAST["engaged"] is False and "capacity" in dl.LAST["reason"]
    assert_per_round_path(rounds=16)
    assert st.LAST["const_permutes"] == 0     # phase 1 settled the order
    assert sk.n_batched()["plain"] == 16
    assert got == want


# the ceiling of aten operations a step that round_step dispatches outside
# its kernels' wrappers (the fused sweep's, step_walk's, step_dedupe's):
# the two sorts and the counters' two rows, 4 as measured (140 before
# the walk, the dedupe and the counters became kernels)
STEP_OPS_CEILING = 4


def test_step_ops_a_step(corpus, monkeypatch):
    """Counts the aten operations round_step dispatches on the CPU outside
    the kernels' wrappers (what the host enqueues one at a time on the
    card), per step of a per-round run."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from pangene_tpu_torch.ops import step_kernels as stk
    count, inside = [0], [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not inside[0]:
                count[0] += 1
            return func(*args, **(kwargs or {}))

    def wrapped(fn):
        def call(*a, **kw):
            inside[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                inside[0] -= 1
        return call

    monkeypatch.setattr(sk, "sweep_round_step", wrapped(sk.sweep_round_step))
    for name in stk.n_calls:
        monkeypatch.setattr(stk, name, wrapped(getattr(stk, name)))
    round_step = st.round_step

    def counted(*a, **kw):
        with Count():
            return round_step(*a, **kw)
    monkeypatch.setattr(st, "round_step", counted)
    monkeypatch.setenv("PANGENE_DEVICE_LOOP", "0")
    st.LAST.clear()
    run_port(corpus)
    assert_per_round_path(rounds=17)
    a_step = count[0] / st.LAST["rounds"]
    assert 0 < a_step <= STEP_OPS_CEILING, (count[0], a_step)


def test_loop_engaged_leaves_per_round_path_alone(corpus):
    st.LAST.clear()
    got = run_port(corpus)
    assert dl.LAST["engaged"] is True and st.LAST == {}
    assert got == run_port(corpus, engine="device")


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def graph_bytes(q):
    h = [np.concatenate([g.hits.cols[name] for g in q.d.genomes])
         for name in ("shadow", "pid_dom", "pid")]
    a = q.arcs
    return [x.tobytes() for x in h + [a.x, a.n_genome, a.tot_cnt, a.avg_dist,
                                      a.s1, a.s2, q.seg_tot_cnt,
                                      q.seg_n_genome]]


def two_rounds(corpus, between, opt=None):
    """Two per-round steps on one graph with `between` run on its data set
    after the first; returns (the bytes after round two, LAST, the bytes of
    a fresh graph and cache on a copy of the state round two started
    from)."""
    opt = opt or PgOpt(engine="sharded", device="cpu")
    d, q = port_state(corpus, changed=False)
    st.gen_arc_sharded(opt, q)
    between(d)
    fresh = copy.copy(q)
    fresh.d = copy_dataset(d)
    del fresh._stacked_dev_cache
    st.gen_arc_sharded(opt, q)
    last = copy.deepcopy(st.LAST)
    st.gen_arc_sharded(opt, fresh)
    assert st.LAST["rounds"] == 1 and st.LAST["const_uploads"] == 1
    return graph_bytes(q), last, graph_bytes(fresh)


def sort_genome0_by_cm(d):
    hit_sort(d.genomes[0], by_cm=True)


def test_cache_follows_a_changed_sort_state(corpus):
    got, last, want = two_rounds(corpus, sort_genome0_by_cm)
    assert got == want
    assert last["rounds"] == 2 and last["const_uploads"] == 1
    # the first round's cm -> cs round trip re-orders cs ties, and then one
    # genome was sorted by cm: both arrive as permutations, not uploads
    assert last["const_permutes"] == 1


def test_cache_dropped_when_rows_cannot_be_followed(corpus):
    """A genome whose sort history is gone is uploaded anew."""
    def forget(d):
        sort_genome0_by_cm(d)
        del d.genomes[0]._sort_cache

    got, last, want = two_rounds(corpus, forget)
    assert got == want
    assert last["rounds"] == 2 and last["const_uploads"] == 2


def test_stale_cache_gives_other_bytes(corpus, monkeypatch):
    """The check above can see a stale cache: with the tags frozen the
    second round reads the old rows and its bytes differ."""
    monkeypatch.setattr(st, "_sort_tags", lambda d: ())
    got, last, want = two_rounds(corpus, sort_genome0_by_cm)
    assert last["const_uploads"] == 1 and last["const_permutes"] == 0
    assert got != want
