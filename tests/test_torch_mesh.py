"""The port's genome mesh (pangene_tpu_torch/parallel/mesh.py) and the
nd > 1 paths of its device loop and per-round step, against numpy and the
JAX package's mesh, on the CPU: ranks are processes of their own (started
as torchrun starts them, mesh.launch) joined by gloo; the JAX side runs on
the test process's virtual CPU devices (tests/conftest.py). Every
comparison is exact (integers, tolerance 0), and every launch has a timeout
of its own, so a deadlock fails the test instead of hanging the suite.

  collectives  psum (int64), pmax (int32), the tiled all_gather and an
               all_to_all whose per-destination counts differ (padded to a
               common capacity, as the bucket exchange sends them), at 2 and
               4 ranks, against numpy over every rank's input;
  schedule     the loop's schedule() at 2, 3 and 4 ranks on the numpy inputs
               a spy captured from the JAX _schedule on a mesh of as many
               devices: all 20 outputs equal, on every rank. At 3 and 4 both
               sides merge by the bucket exchange; with a small
               PANGENE_DEVLOOP_A2A_SLACK both overflow, and still agree;
  step         stacked.round_step and the protein-keyed reductions at 2 ranks
               against the JAX round_step and post_reductions_sharded on a
               2-device mesh.
"""
import io
import json
import os
import pathlib
import sys
import tempfile

import numpy as np
import pytest
import torch

from pangene_tpu import pipeline as jpipeline
from pangene_tpu import util as jutil
from pangene_tpu.options import PgOpt as JaxOpt
from pangene_tpu.parallel import device_loop as jdl
from pangene_tpu.parallel import stacked as jst
from pangene_tpu.parallel.mesh import make_mesh as jax_mesh
from pangene_tpu.parallel.mesh import put_sharded as jax_put
from pangene_tpu_torch.parallel import device_loop as dl
from pangene_tpu_torch.parallel import mesh
from pangene_tpu_torch.parallel import stacked as st
from pangene_tpu_torch.testing import synth_paf_files

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 120.0          # seconds, each launch of ranks
BIAS = np.uint64(1 << 63)
OUT_NAMES = ("flt", "weak", "shadow", "pid_dom", "alive", "seg_tot",
             "seg_ng", "arc_vw", "arc_s1", "arc_ng", "arc_tot", "arc_ad",
             "arc_s2", "loci", "logs", "dcap_mask", "dcap_deg", "dcap_loci",
             "dcap_tot", "overflow")

torch.set_num_threads(1)


def launch_script(script, world, args, env=None):
    """`world` ranks of `python -c script *args` (every rank killed after
    TIMEOUT); fails with the ranks' stderr unless every one exits 0."""
    e = dict(os.environ if env is None else env)
    e["PYTHONPATH"] = str(REPO) + os.pathsep + e.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        errs = [open(os.path.join(tmp, "%d.err" % r), "w+")
                for r in range(world)]
        try:
            rcs = mesh.launch([sys.executable, "-c", script] + list(args),
                              world, env=e, stderrs=errs, timeout=TIMEOUT,
                              cwd=str(REPO))
            texts = []
            for f in errs:
                f.seek(0)
                texts.append(f.read())
        finally:
            for f in errs:
                f.close()
    assert rcs == [0] * world, "ranks exited %s:\n%s" % (
        rcs, "\n".join(t[-2000:] for t in texts))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

COLLECTIVES = r"""
import sys
import numpy as np
import torch
from pangene_tpu_torch.parallel import mesh as M
m = M.make_mesh(0, "cpu")
rng = np.random.default_rng(100 + m.rank)
C = 5
a = rng.integers(-2**40, 2**40, 7)
b = rng.integers(-2**31, 2**31 - 1, (3, 4)).astype(np.int32)
g = rng.integers(0, 1000, (m.rank + 2, 3)).astype(np.int32)[:2]
counts = rng.integers(0, C + 1, m.world)
x = np.full((m.world, C, 2), -1, np.int64)
for t, n in enumerate(counts):
    x[t, :n] = rng.integers(0, 10**12, (n, 2))
t = torch.from_numpy
out = dict(a=a, b=b, g=g, x=x,
           psum=M.psum(t(a), m).numpy(), pmax=M.pmax(t(b), m).numpy(),
           gather=M.all_gather(t(g), m).numpy(),
           pulled=M.pull_global(t(g), m),
           a2a=M.all_to_all(t(x.reshape(-1, 2)), m).numpy(),
           world=m.world, rank=m.rank, backend=m.backend)
np.savez(sys.argv[1] + "/%d.npz" % m.rank, **out)
M.shutdown()
"""


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_against_numpy(tmp_path, world):
    mesh.reset_counts()
    launch_script(COLLECTIVES, world, [str(tmp_path)])
    r = [np.load(tmp_path / ("%d.npz" % k)) for k in range(world)]
    assert [int(x["rank"]) for x in r] == list(range(world))
    assert all(int(x["world"]) == world and str(x["backend"]) == "gloo"
               for x in r)
    want_sum = sum(x["a"] for x in r)
    want_max = np.max([x["b"] for x in r], axis=0)
    want_gather = np.concatenate([x["g"] for x in r])
    for k, x in enumerate(r):
        assert x["psum"].dtype == np.int64
        assert np.array_equal(x["psum"], want_sum)
        assert x["pmax"].dtype == np.int32
        assert np.array_equal(x["pmax"], want_max)
        assert np.array_equal(x["gather"], want_gather)
        assert np.array_equal(x["pulled"], want_gather)
        # rank k receives chunk k of every sender, in the senders' order
        want_a2a = np.concatenate([y["x"][k] for y in r])
        assert np.array_equal(x["a2a"], want_a2a)
    # the per-destination counts did differ
    assert len({int((y["x"][t][:, 0] >= 0).sum()) for y in r
                for t in range(world)}) > 1
    # nothing ran in this process
    assert mesh.LAST["calls"] == {}


def test_one_device_has_no_group():
    """Without a launch: no process group, and every collective returns its
    input without a call."""
    assert not mesh.launched()
    m = mesh.make_mesh(0, "cpu")
    assert m == mesh.local(torch.device("cpu"))
    assert m.group is None and m.world == 1 and m.backend is None
    mesh.reset_counts()
    x = torch.arange(6).reshape(3, 2)
    for f in (mesh.psum, mesh.pmax, mesh.all_gather, mesh.all_to_all):
        assert f(x, m) is x
    assert np.array_equal(mesh.pull_global(x, m), x.numpy())
    assert mesh.put_sharded(x.numpy(), m, 1).shape == (3, 2)
    assert mesh.LAST["calls"] == {} and mesh.LAST["staged_bytes"] == 0
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="2 devices need 2 ranks"):
        mesh.make_mesh(2, "cpu")


def test_rank_device_rules(monkeypatch):
    """cpu: gloo; cuda: cuda:LOCAL_RANK over NCCL, a rank past the visible
    cards raises; PANGENE_MESH_SHARE_DEVICE=1: cuda:0 over gloo. Nothing
    falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv(mesh.SHARE_DEVICE_ENV, raising=False)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh._rank_device("cpu") == (torch.device("cpu"), "gloo")
    assert mesh._rank_device("cuda") == (torch.device("cuda", 1), "nccl")
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="cuda:2 is not visible"):
        mesh._rank_device("cuda")
    monkeypatch.setenv(mesh.SHARE_DEVICE_ENV, "1")
    assert mesh._rank_device("cuda") == (torch.device("cuda", 0), "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh._rank_device("cuda")


def test_put_sharded_and_pad():
    x = np.arange(2 * 6 * 3).reshape(2, 6, 3)
    for rank in range(3):
        m = mesh.Mesh(3, rank, torch.device("cpu"), "gloo", None)
        assert mesh.pad_genomes(7, m) == 9 and mesh.pad_genomes(6, m) == 6
        got = mesh.put_sharded(x, m, 1)
        assert np.array_equal(got.numpy(), x[:, 2 * rank:2 * rank + 2])
        assert got.is_contiguous()


def test_launch_kills_the_others(tmp_path):
    """A rank that fails ends the launch: the rank still waiting is killed
    and its exit code is negative; a launch that outlives its timeout is
    killed whole."""
    script = ("import os, sys, time\n"
              "sys.exit(3) if os.environ['RANK'] == '1' else time.sleep(60)\n")
    rcs = mesh.launch([sys.executable, "-c", script], 2, timeout=50)
    assert rcs[1] == 3 and rcs[0] < 0
    rcs = mesh.launch([sys.executable, "-c", "import time; time.sleep(60)"],
                      2, timeout=1.0)
    assert all(rc < 0 for rc in rcs)
    rcs = mesh.launch([sys.executable, "-c", "import os; print(os.environ["
                       "'RANK'], os.environ['WORLD_SIZE'], os.environ["
                       "'LOCAL_WORLD_SIZE'])"], 3,
                      stdouts=[open(tmp_path / ("%d" % r), "w")
                               for r in range(3)], timeout=50)
    assert rcs == [0, 0, 0]
    assert [(tmp_path / ("%d" % r)).read_text().split() for r in range(3)] \
        == [[str(r), "3", "3"] for r in range(3)]


# ---------------------------------------------------------------------------
# the loop's schedule at nd > 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus of tests/test_torch_device_loop.py."""
    d = tmp_path_factory.mktemp("torch_mesh")
    return synth_paf_files(str(d), n_genome=10, n_gene=250, n_iso=3, seed=17)


_captures = {}


def jax_capture(corpus, nd, slack=None):
    """One run of the JAX package's sharded engine on a mesh of nd virtual
    devices with a spy on _schedule: its numpy inputs and outputs, cfg and
    the GFA."""
    key = (nd, slack)
    if key in _captures:
        return _captures[key]
    cap = {}
    orig = jdl._schedule

    def spy(*args, cfg, mesh):
        outs = orig(*args, cfg=cfg, mesh=mesh)
        cap.update(inputs=[np.asarray(a) for a in args], cfg=cfg,
                   outputs=[np.asarray(o) for o in outs])
        return outs

    old = os.environ.get("PANGENE_DEVLOOP_A2A_SLACK")
    if slack is not None:
        os.environ["PANGENE_DEVLOOP_A2A_SLACK"] = slack
    os.environ["PANGENE_PARSE_WORKERS"] = "1"
    jdl._schedule = spy
    try:
        jutil.verbose = 0
        out = io.StringIO()
        jpipeline.run(JaxOpt(engine="sharded", n_devices=nd), corpus, out=out)
        cap["gfa"] = out.getvalue()
    finally:
        jdl._schedule = orig
        jutil.verbose = 3
        del os.environ["PANGENE_PARSE_WORKERS"]
        if slack is not None:
            if old is None:
                del os.environ["PANGENE_DEVLOOP_A2A_SLACK"]
            else:
                os.environ["PANGENE_DEVLOOP_A2A_SLACK"] = old
    cap["last"] = dict(jdl.LAST)
    _captures[key] = cap
    return cap


SCHEDULE = r"""
import json, sys
import numpy as np
from pangene_tpu_torch.ops import loop_kernels as lk
from pangene_tpu_torch.parallel import device_loop as dl
from pangene_tpu_torch.parallel import mesh as M
d = sys.argv[1]
z = np.load(d + "/in.npz")
cfg = dl.Cfg(**json.load(open(d + "/cfg.json")))
m = M.make_mesh(0, "cpu")
outs = dl.schedule(*[z["a%d" % i] for i in range(19)], cfg=cfg, mesh=m)
np.savez(d + "/out%d.npz" % m.rank, *outs)
json.dump(lk.n_calls, open(d + "/calls%d.json" % m.rank, "w"))
M.shutdown()
"""


def run_schedule(tmp_path, cap, world):
    np.savez(tmp_path / "in.npz", **{"a%d" % i: a
                                     for i, a in enumerate(cap["inputs"])})
    cfg = dl.cfg_from(cap["cfg"])
    (tmp_path / "cfg.json").write_text(json.dumps(cfg._asdict()))
    launch_script(SCHEDULE, world, [str(tmp_path)])
    outs, calls = [], []
    for r in range(world):
        z = np.load(tmp_path / ("out%d.npz" % r))
        outs.append([z["arr_%d" % i] for i in range(len(OUT_NAMES))])
        calls.append(json.loads((tmp_path / ("calls%d.json" % r))
                                .read_text()))
    return cfg, outs, calls


@pytest.mark.parametrize("world", [2, 3, 4])
def test_schedule_equals_jax_mesh(corpus, tmp_path, world):
    cap = jax_capture(corpus, world)
    cfg, outs, calls = run_schedule(tmp_path, cap, world)
    want = cap["outputs"]
    assert cfg.G_loc * world == want[0].shape[0] >= 10
    # the exchange merge from three ranks on, on both sides
    assert (cfg.a2a_cap > 0) == (world > 2) and cap["last"]["shard_merge"] \
        == (world > 2)
    assert not want[19] and want[14][:, 9].sum() > 1
    for r, got in enumerate(outs):
        for name, g, w in zip(OUT_NAMES, got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, (r, name)
            assert np.array_equal(g, w), (r, name)
    # every branch round went through the split entries on every rank
    n_branch = int(want[14][:, 8].sum())
    for c in calls:
        assert c["branch_block"]["plain"] == 0
        assert c["branch_locality"]["plain"] == c["branch_classify"][
            "plain"] == n_branch > 0
        assert c["merge_fold_full"] == {"kernel": 0, "plain": 1}


def test_schedule_overflow_alike(corpus, tmp_path):
    """A bucket too small for its keys: both sides set the overflow flag
    on every rank (the host rounds then take over), and every output of the
    run past the overflow is still equal."""
    cap = jax_capture(corpus, 4, slack="0.05")
    cfg, outs, _ = run_schedule(tmp_path, cap, 4)
    assert 0 < cfg.a2a_cap < jax_capture(corpus, 4)["cfg"].a2a_cap
    assert cap["outputs"][19] and cap["last"]["engaged"] is False
    for r, got in enumerate(outs):
        assert got[19]
        for name, g, w in zip(OUT_NAMES, got, cap["outputs"]):
            assert g.dtype == w.dtype and np.array_equal(g, w), (r, name)


# ---------------------------------------------------------------------------
# the per-round step and the reductions at two ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_corpus(tmp_path_factory):
    """The corpus of tests/test_torch_stacked.py."""
    d = tmp_path_factory.mktemp("torch_mesh_step")
    return synth_paf_files(str(d), n_genome=6, n_gene=300, n_iso=3, seed=3)


STEP = r"""
import sys
import numpy as np
import torch
from pangene_tpu_torch import pipeline, util
from pangene_tpu_torch.options import PgOpt
from pangene_tpu_torch.parallel import mesh as M
from pangene_tpu_torch.parallel import stacked as st
d = sys.argv[1]
z = np.load(d + "/stack.npz")
m = M.make_mesh(0, "cpu")
blocks = [M.put_sharded(z[k], m, 1 if z[k].ndim == 3 else 0)
          for k in ("n_rows", "i32", "i64", "u8", "ex")]
flt, shadow, weak = M.put_sharded(z["mut"], m, 1)
outs = st.round_step(st.stack_views(*blocks), flt, shadow, weak,
                     torch.from_numpy(z["g2s"]), W=int(z["W"]),
                     min_ov_ratio=0.3, check_strand=False, use_ori=False,
                     mesh=m)
res = {n: (M.pull_global(o, m) if k < 8 else o.numpy())
       for k, (n, o) in enumerate(zip(st.STEP_OUTPUTS, outs))}
util.verbose = 0
opt = PgOpt(engine="sharded", device="cpu")
ds = pipeline.read_all(opt, sys.argv[2:])
mx, zz, (c, s) = st.post_reductions_sharded(opt, ds)
np.savez(d + "/out%d.npz" % m.rank, mx=mx, z=zz, c=c, s=s, **res)
M.shutdown()
"""

_step = {}


def step_ranks(step_corpus, tmp):
    """The port's round_step and post_reductions_sharded at two ranks on the
    graph state of tests/test_torch_stacked.py, and the JAX functions on a
    2-device mesh; computed once."""
    if _step:
        return _step
    import test_torch_stacked as ts
    (d, q), (jd, jq) = ts.port_state(step_corpus), ts.jax_state(step_corpus)
    G = d.n_genome
    Gp = G + G % 2
    hs = st.build_stacked(d, Gp=Gp)
    H = hs.i32.shape[2]
    mut = st.stack_mutable(d, np.zeros((3, Gp, H), np.uint8))
    os.environ["PANGENE_PARSE_WORKERS"] = "1"
    try:
        np.savez(tmp / "stack.npz", n_rows=hs.n_rows, i32=hs.i32,
                 i64=hs.i64, u8=hs.u8, ex=hs.ex, W=hs.W, mut=mut,
                 g2s=np.asarray(q.g2s, np.int32))
        launch_script(STEP, 2, [str(tmp)] + list(step_corpus))
        # the JAX round_step on a 2-device mesh, padded as its
        # gen_arc_sharded pads
        m2 = jax_mesh(2)
        JH, JE, K, JW = ts.jax_shapes(jd)
        cols, ex_os, ex_oe = jst.build_stacked(jd, JH, JE)
        for k in cols:
            pad = np.zeros((Gp - G,) + cols[k].shape[1:], cols[k].dtype)
            if k == "cid":
                pad[:] = st.PAD_CID
            cols[k] = np.concatenate([cols[k], pad])
        zex = np.zeros((Gp - G, JE), np.int32)
        import jax.numpy as jnp
        big, small = jst.round_step(
            {k: jax_put(v, m2) for k, v in cols.items()},
            jax_put(np.concatenate([ex_os, zex]), m2),
            jax_put(np.concatenate([ex_oe, zex]), m2), jnp.asarray(jq.g2s),
            min_ov_ratio=0.3, W=JW, K=K, check_strand=False, use_ori=False,
            n_gene=jd.n_gene, mesh=m2)
        jutil.verbose = 0
        jd_post = jpipeline.read_all(JaxOpt(engine="host"), step_corpus)
        jred = jst.post_reductions_sharded(
            JaxOpt(engine="sharded", n_devices=2), jd_post)
    finally:
        del os.environ["PANGENE_PARSE_WORKERS"]
        jutil.verbose = 3
    _step.update(ranks=[dict(np.load(tmp / ("out%d.npz" % r)))
                        for r in range(2)],
                 big=np.asarray(big), small=np.asarray(small), jred=jred,
                 d=d, jd=jd, H=H, JH=JH, G=G, Gp=Gp)
    return _step


def test_round_step_two_ranks_equals_jax(step_corpus, tmp_path):
    s = step_ranks(step_corpus, tmp_path)
    big, small, JH, d, jd = s["big"], s["small"], s["JH"], s["d"], s["jd"]
    want, o = {}, 0
    for name, width in (("shadow", JH), ("b_score", JH), ("b_other", JH),
                        ("uniq_x", 2 * JH), ("cnt", 2 * JH),
                        ("dsum", 2 * JH), ("m1", 2 * JH), ("m2", 2 * JH)):
        want[name] = big[:, o:o + width]
        o += width
    assert big.shape[0] == s["Gp"] == 8
    for r, got in enumerate(s["ranks"]):
        assert got["shadow"].shape == (s["Gp"], s["H"])
        n_arcs = 0
        for j, g in enumerate(d.genomes):
            n = g.n_hit
            assert np.array_equal(got["shadow"][j, :n],
                                  want["shadow"][j, :n]), (r, j)
            assert np.array_equal(got["b_score"][j, :n].view(np.uint64)
                                  ^ BIAS,
                                  want["b_score"][j, :n].view(np.uint64))
            assert np.array_equal(got["b_other"][j, :n],
                                  want["b_other"][j, :n])
            sel, jsel = got["cnt"][j] > 0, want["cnt"][j] > 0
            for name in ("uniq_x", "cnt", "dsum", "m1", "m2"):
                assert np.array_equal(got[name][j][sel],
                                      want[name][j][jsel]), (r, j, name)
            n_arcs += int(sel.sum())
        # the counters are sums over both ranks' genomes
        assert np.array_equal(got["tot_cnt"], small[:jd.n_gene])
        assert np.array_equal(got["n_genome"],
                              small[jd.n_gene:2 * jd.n_gene])
        assert n_arcs > 100 and not got["cnt"][s["G"]:].any()
    assert int(s["ranks"][0]["n_genome"].max()) > 1


def test_reductions_two_ranks_equal_jax(step_corpus, tmp_path):
    s = step_ranks(step_corpus, tmp_path)
    jmx, jz, (jc, js) = s["jred"]
    for got in s["ranks"]:
        for name, want in (("mx", jmx), ("z", jz), ("c", jc), ("s", js)):
            assert got[name].dtype == want.dtype, name
            assert np.array_equal(got[name], want), name
    assert jmx.max() > 0 and jc.sum() > 0
