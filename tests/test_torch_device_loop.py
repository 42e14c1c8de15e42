"""The port's device-resident pruning loop
(pangene_tpu_torch/parallel/device_loop.py) against the JAX package's
(pangene_tpu/parallel/device_loop.py at one device), on the CPU.

Three levels, every comparison exact (integers and bytes, tolerance 0):

  state  a spy on the JAX package's _schedule captures its numpy inputs, its
         static configuration and its 20 outputs from a run of
         --engine sharded on one device; the port's schedule() gets the same
         inputs and must return the same 20 outputs. Then, with the same
         jitted JAX schedule, one block switched off at a time (and the
         convergence skip defeated), so that a wrong block is named by the
         case that fails.
  pack   the port's host pack on the port's own graph after phase 1 equals
         the captured JAX inputs, configuration and stale n_prop constant.
  e2e    the port's --engine sharded --device cpu gives the bytes of the
         JAX package's --engine host (whose tests hold sharded == host) for
         every option set, flag, log line and fallback; each case asserts
         that the loop engaged, since GFA equality alone also passes on a
         silent fallback to the host rounds.
"""
import gzip
import io
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from pangene_tpu import pipeline as jpipeline
from pangene_tpu import util as jutil
from pangene_tpu.options import PgOpt as JaxOpt
from pangene_tpu.parallel import device_loop as jdl
from pangene_tpu_torch import cli, pipeline, util
from pangene_tpu_torch.options import (PG_F_CHECK_STRAND, PG_F_FRAG_MODE,
                                       PG_F_ORI_FOR_BRANCH,
                                       PG_F_WRITE_BED_FLAG,
                                       PG_F_WRITE_BED_WALK, PgOpt)
from pangene_tpu_torch.parallel import device_loop as dl
from pangene_tpu_torch.ops import loop_kernels as lk
from pangene_tpu_torch.testing import synth_paf_files, wide_paf_files

REPO = pathlib.Path(__file__).resolve().parent.parent

# small tensors: one torch thread per test process, so that several test
# workers on one machine do not contend for its cores
torch.set_num_threads(1)

OUT_NAMES = ("flt", "weak", "shadow", "pid_dom", "alive", "seg_tot",
             "seg_ng", "arc_vw", "arc_s1", "arc_ng", "arc_tot", "arc_ad",
             "arc_s2", "loci", "logs", "dcap_mask", "dcap_deg", "dcap_loci",
             "dcap_tot", "overflow")
# positions in _schedule's argument list
DO_BRANCH, DO_OCC, DO_SWEEP, DO_WALK, NO_SKIP = 14, 15, 16, 17, 18

OPTION_SETS = {
    "default": {},
    # several softfloat predicates + capacity pressure at once
    "combined": {"min_ov_ratio": 0.3, "max_degree": 5, "branch_diff": 0.005,
                 "branch_diff_dist": 0.02, "n_branch_flt": 7},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_devloop")
    return synth_paf_files(str(d), n_genome=10, n_gene=250, n_iso=3, seed=17)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # parse in the main process: no worker pool to start for ten small files
    monkeypatch.setenv("PANGENE_PARSE_WORKERS", "1")
    yield
    util.verbose = 3
    jutil.verbose = 3


def run_port(files, engine="sharded", **kw):
    util.verbose = 0
    opt = PgOpt(engine=engine, device="cpu", **kw)
    out = io.StringIO()
    pipeline.run(opt, files, out=out)
    return out.getvalue()


def run_jax(files, engine="host", **kw):
    jutil.verbose = 0
    out = io.StringIO()
    jpipeline.run(JaxOpt(engine=engine, **kw), files, out=out)
    return out.getvalue()


# ---------------------------------------------------------------------------
# state level
# ---------------------------------------------------------------------------

_captures = {}


def jax_capture(corpus, name):
    """One run of the JAX package's sharded engine on one device with a spy
    on _schedule: its inputs and outputs as numpy, cfg, mesh, the function
    itself and the n_prop constant graph_gen_device added to the logs."""
    if name in _captures:
        return _captures[name]
    cap = {}
    orig, orig_emit = jdl._schedule, jdl._emit_round_logs

    def spy(*args, cfg, mesh):
        outs = orig(*args, cfg=cfg, mesh=mesh)
        cap.update(inputs=[np.asarray(a) for a in args], cfg=cfg, mesh=mesh,
                   outputs=[np.asarray(o) for o in outs], fn=orig)
        return outs

    def spy_emit(q, logs, *rest):
        cap["logs_emitted"] = np.array(logs)
        return orig_emit(q, logs, *rest)

    jdl._schedule, jdl._emit_round_logs = spy, spy_emit
    try:
        cap["gfa"] = run_jax(corpus, "sharded", n_devices=1,
                             **OPTION_SETS[name])
    finally:
        jdl._schedule, jdl._emit_round_logs = orig, orig_emit
    assert jdl.LAST["engaged"] and cap["cfg"].G_loc == 10
    cap["n_prop_stale"] = int((cap["logs_emitted"][:, 2]
                               - cap["outputs"][14][:, 2])[0])
    _captures[name] = cap
    return cap


def assert_outputs_equal(got, want):
    assert len(got) == len(want) == len(OUT_NAMES)
    for name, g, w in zip(OUT_NAMES, got, want):
        assert g.shape == w.shape, name
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        assert np.array_equal(g, w), name


VARIANTS = {
    "as run": None,
    "no branch": (DO_BRANCH, False),
    "no occ": (DO_OCC, False),
    "no sweep": (DO_SWEEP, False),
    "no walk": (DO_WALK, False),
    "no skip": (NO_SKIP, True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("optset", list(OPTION_SETS))
def test_schedule_equals_jax(corpus, optset, variant):
    cap = jax_capture(corpus, optset)
    inputs = list(cap["inputs"])
    if VARIANTS[variant] is None:
        want = cap["outputs"]
        assert want[14][:, 8].sum() > 1 and want[14][:, 9].sum() > 1
        assert not want[19]
    else:
        pos, value = VARIANTS[variant]
        inputs[pos] = np.full_like(inputs[pos], value)
        # the same jitted schedule (cfg, mesh): only input values differ
        want = [np.asarray(o) for o in cap["fn"](
            *inputs, cfg=cap["cfg"], mesh=cap["mesh"])]
    got = dl.schedule(*inputs, cfg=dl.cfg_from(cap["cfg"]), device="cpu")
    assert_outputs_equal(got, want)


@pytest.mark.parametrize("optset", list(OPTION_SETS))
def test_schedule_split_branch_entries_equal_jax(corpus, optset, monkeypatch):
    """The branch block through the mesh's split entries (arc_groups, then
    branch_locality and branch_classify, between which the ranks OR their
    locality bits) in place of the one-rank branch_block: all 20 outputs
    still equal the JAX schedule's."""
    from pangene_tpu_torch.ops import loop_kernels as lk
    cap = jax_capture(corpus, optset)
    calls = []

    def split(r_pres, r_cid, r_cm, r_rank, tgt_gid, arc_vw, arc_s1, *, B,
              frag_mode, local_dist, local_count, tally, **cls):
        calls.append(1)
        gs_of, mx, branching, is_max = lk.arc_groups(arc_vw, arc_s1, B)
        aml, he = lk.branch_locality(
            r_pres, r_cid, r_cm, r_rank, tgt_gid, gs_of, branching, is_max,
            frag_mode=frag_mode, local_dist=local_dist,
            local_count=local_count)
        return lk.branch_classify(arc_s1, mx, branching, aml, he, gs_of,
                                  **cls)

    def split_bound(*bound, B, **kw):
        # the loop launches the branch block through its binding
        def launch(r_pres, r_cid, r_cm, r_rank, tgt_gid, arc_vw, arc_s1,
                   counts):
            aw, n_grp, cnt = split(r_pres, r_cid, r_cm, r_rank, tgt_gid,
                                   arc_vw, arc_s1, B=B, **kw)
            return aw, n_grp, counts.copy_(cnt)
        return lk.Bound(launch, bind(*bound, B=B, **kw).out)

    bind = lk.bind_branch_block
    monkeypatch.setattr(lk, "bind_branch_block", split_bound)
    want = cap["outputs"]
    got = dl.schedule(*cap["inputs"], cfg=dl.cfg_from(cap["cfg"]),
                      device="cpu")
    assert_outputs_equal(got, want)
    assert len(calls) == int(want[14][:, 8].sum()) > 1


def test_block_variants_change_the_outputs(corpus):
    """The switches do isolate blocks: each variant's JAX outputs differ
    from the run's own."""
    cap = jax_capture(corpus, "default")
    for variant in ("no branch", "no occ", "no sweep", "no walk"):
        pos, value = VARIANTS[variant]
        inputs = list(cap["inputs"])
        inputs[pos] = np.full_like(inputs[pos], value)
        outs = [np.asarray(o) for o in cap["fn"](
            *inputs, cfg=cap["cfg"], mesh=cap["mesh"])]
        assert any(not np.array_equal(a, b)
                   for a, b in zip(outs, cap["outputs"])), variant


# ---------------------------------------------------------------------------
# pack level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optset", list(OPTION_SETS))
def test_pack_equals_jax(corpus, optset, monkeypatch):
    cap = jax_capture(corpus, optset)
    packs = []
    orig = dl.pack_host

    def spy(opt, q, pin=False):
        packs.append(orig(opt, q, pin))
        return packs[-1]

    monkeypatch.setattr(dl, "pack_host", spy)
    gfa = run_port(corpus, **OPTION_SETS[optset])
    assert dl.LAST["engaged"] is True and len(packs) == 1
    pk = packs[0]
    assert pk.cfg == dl.cfg_from(cap["cfg"])
    assert len(pk.inputs) == len(cap["inputs"])
    for i, (a, b) in enumerate(zip(pk.inputs, cap["inputs"])):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        assert np.array_equal(a, b), i
    assert pk.n_prop_stale == cap["n_prop_stale"]
    assert gfa == cap["gfa"]
    shape = dl.LAST["shape"]
    assert {k: shape[k] for k in ("G", "H", "K", "W", "S", "A", "R")} \
        == {"G": 10, **{k: getattr(pk.cfg, k) for k in "HKWSAR"}}


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {},
    {"min_ov_ratio": 0.3},
    {"max_avg_occ": 2, "max_degree": 4, "max_dist_loci": 1},
    {"branch_diff": 0.001, "branch_diff_cut": 0.1, "branch_diff_dist": 0.01},
    {"min_arc_cnt": 2},
    {"n_branch_flt": 0},
    {"n_branch_flt": 1},
    {"n_branch_flt": 3},
    {"local_dist": 100000, "local_count": 2},
    OPTION_SETS["combined"],
])
def test_devloop_matches_jax_host(corpus, kw):
    got = run_port(corpus, **kw)
    assert dl.LAST["engaged"] is True
    assert dl.LAST["rounds_total"] == kw.get("n_branch_flt", 15) + 1
    assert got == run_jax(corpus, **kw)


@pytest.mark.parametrize("flag", [PG_F_CHECK_STRAND, PG_F_ORI_FOR_BRANCH,
                                  PG_F_FRAG_MODE])
def test_devloop_matches_jax_host_flags(corpus, flag):
    got = run_port(corpus, flag=flag)
    assert dl.LAST["engaged"] is True
    assert got == run_jax(corpus, flag=flag)


@pytest.mark.parametrize("mode,flag", [("walk", PG_F_WRITE_BED_WALK),
                                       ("flag", PG_F_WRITE_BED_FLAG)])
def test_devloop_bed_modes(corpus, mode, flag):
    """The BED dump reads the final flt/shadow/weak/pid_dom state that the
    loop pulled back and scattered to the kept rows."""
    got = run_port(corpus, flag=flag)
    assert dl.LAST["engaged"] is True
    assert got == run_jax(corpus, flag=flag)
    assert got.count("\n") > 1000


def test_devloop_equals_port_device_engine(corpus):
    got = run_port(corpus)
    assert dl.LAST["engaged"] is True
    dl.LAST.clear()
    assert got == run_port(corpus, engine="device")
    assert dl.LAST == {}


def test_devloop_jb_fallback(corpus, monkeypatch):
    """The co-sorted lean merge (JB = 0) stays byte-identical."""
    monkeypatch.setenv("PANGENE_DEVLOOP_NO_JB", "1")
    packs = []
    orig = dl.pack_host
    monkeypatch.setattr(dl, "pack_host",
                        lambda *a, **kw: packs.append(orig(*a, **kw))
                        or packs[-1])
    got = run_port(corpus)
    assert dl.LAST["engaged"] is True and packs[0].cfg.JB == 0
    assert got == run_jax(corpus)


def test_devloop_capacity_fallback(corpus, monkeypatch):
    """An arc table too small for phase 1 falls back to the host rounds,
    with its reason, and the bytes stay the same."""
    monkeypatch.setenv("PANGENE_DEVLOOP_MAX_A", "64")
    got = run_port(corpus)
    assert dl.LAST["engaged"] is False
    assert dl.LAST["reason"].startswith("arc capacity 64 < phase-1 count")
    assert got == run_jax(corpus)


def test_devloop_overflow_in_loop_falls_back(corpus, monkeypatch):
    """An arc table full inside the loop (capacity one below phase 1's
    count, the table cut to it: the first merge needs more) sets the
    overflow flag; the host rounds take over and the bytes stay the
    same."""
    orig = dl.pack_host
    seen = {}

    def tight(opt, q, pin=False):
        pk = orig(opt, q, pin)
        A = q.n_arc - 1
        seen["A"] = A
        inputs = list(pk.inputs)
        inputs[7], inputs[8] = inputs[7][:A].copy(), inputs[8][:A].copy()
        return pk._replace(inputs=tuple(inputs), cfg=pk.cfg._replace(A=A))

    monkeypatch.setattr(dl, "pack_host", tight)
    got = run_port(corpus)
    assert dl.LAST["engaged"] is False and seen["A"] > 0
    assert dl.LAST["reason"] == "arc capacity overflow"
    assert got == run_jax(corpus)


def test_devloop_wide_group_engaged(tmp_path, monkeypatch):
    """A corpus whose branch rounds meet a group of 80 arcs, past the JAX
    package's branch window (D = 64), where its loop falls back: the port's
    loop takes it (the kernels' wide path, every pair of the group), stays
    engaged and gives the JAX package's bytes."""
    files = wide_paf_files(str(tmp_path))
    got = run_port(files)
    assert dl.LAST["engaged"] is True
    assert dl.LAST["branch_max_group"] == 80 > lk.WIDE_ROWS
    assert dl.LAST["branch_wide_groups"] >= 1
    assert dl.LAST["branch_branching_arcs"] <= dl.LAST["branch_valid_arcs"]
    assert got == run_jax(files)
    assert got == run_jax(files, "sharded", n_devices=1)
    assert jdl.LAST["engaged"] is False


def test_devloop_hit0_filtered_at_entry(corpus, monkeypatch):
    """The ev1 precondition: the corpus has a genome whose original hit 0
    is filtered in phase 1, so the first row of its compacted plane is a
    later hit, which the reference does evaluate in the shadow sweep."""
    seen = {}
    orig = dl.graph_gen_device

    def spy(opt, q):
        seen["first_flt"] = [int(np.asarray(g.hits.flt)[0]) if g.n_hit else 0
                             for g in q.d.genomes]
        return orig(opt, q)

    monkeypatch.setattr(dl, "graph_gen_device", spy)
    got = run_port(corpus)
    assert dl.LAST["engaged"] is True
    assert got == run_jax(corpus)
    assert any(f > 0 for f in seen["first_flt"])


def _log_lines(run, **kw):
    err = io.StringIO()
    old = sys.stderr
    sys.stderr = err
    try:
        out = run(**kw)
    finally:
        sys.stderr = old
    keep = [l for l in err.getvalue().splitlines()
            if l.startswith("#del") or "marked" in l or "filtered" in l
            or "round-" in l]
    # strip wall-clock timestamps
    return [re.sub(r"::[0-9.]+\*[0-9.]+", "", l) for l in keep], out


def test_devloop_verbose_del_logs(corpus):
    """verbose >= 3 replays the #del lines and the per-round counters from
    the pulled capture planes; the lines equal the JAX host engine's."""
    kw = {"max_avg_occ": 2, "max_degree": 4}

    def port(**kw):
        util.verbose = 3
        out = io.StringIO()
        pipeline.run(PgOpt(engine="sharded", device="cpu", **kw), corpus,
                     out=out)
        return out.getvalue()

    def host(**kw):
        jutil.verbose = 3
        out = io.StringIO()
        jpipeline.run(JaxOpt(engine="host", **kw), corpus, out=out)
        return out.getvalue()

    want_lines, want = _log_lines(host, **kw)
    got_lines, got = _log_lines(port, **kw)
    assert dl.LAST["engaged"] is True
    assert got == want
    assert got_lines == want_lines
    assert sum(l.startswith("#del") for l in got_lines) > 3


def test_devloop_synth16_golden(tmp_path):
    files = synth_paf_files(str(tmp_path), n_genome=16, n_gene=500,
                            n_iso=3, seed=42)
    want = gzip.open(REPO / "tests" / "golden" / "synth16.gfa.gz",
                     "rt").read()
    got = run_port(files)
    assert dl.LAST["engaged"] is True
    assert got == want


def test_last_diagnostics(corpus):
    run_port(corpus)
    last = dl.LAST
    for key in ("engaged", "shape", "kept_frac", "upload_bytes", "pack_s",
                "upload_s", "run_s", "pull_s", "rounds_branch_run",
                "rounds_sweep_run", "rounds_total", "host_syncs",
                "block_ms", "sweep_launches"):
        assert key in last, key
    assert last["device"] == "cpu" and last["sweep_launches"] == 0
    assert 0 < last["rounds_sweep_run"] <= last["rounds_total"] == 16
    assert 0 < last["kept_frac"] < 1
    # at most three host reads a round, plus none outside the rounds
    assert last["host_syncs"] <= 3 * last["rounds_total"]
    assert set(last["block_ms"]) == set(dl.BLOCKS)


def test_host_syncs_one_a_round(corpus):
    """The round's blocks read nothing on the host (their kernels' plain
    versions ran: the branch block and its prelude once per branch round,
    weak propagation and the occ block once a round, the walk and the
    in-loop merge once per in-loop merge plus once for the full=True tail):
    the one host read a round is the change bit."""
    from pangene_tpu_torch.ops import loop_kernels as lk
    lk.reset_counts()
    run_port(corpus)
    last = dl.LAST
    assert last["engaged"] is True
    assert last["host_syncs"] == last["rounds_total"] == 16
    assert last["loop_launches"] == {k: 0 for k in lk.n_calls}
    merges = last["rounds_sweep_run"] + 1
    assert lk.n_calls == {
        "branch_block": {"kernel": 0, "plain": last["rounds_branch_run"]},
        "branch_locality": {"kernel": 0, "plain": 0},
        "branch_classify": {"kernel": 0, "plain": 0},
        "merge_fold": {"kernel": 0, "plain": merges},
        "merge_fold_full": {"kernel": 0, "plain": 1},
        "walk_pairs": {"kernel": 0, "plain": merges},
        "branch_prep": {"kernel": 0, "plain": last["rounds_branch_run"]},
        "prop_round": {"kernel": 0, "plain": last["rounds_total"]},
        "occ_round": {"kernel": 0, "plain": last["rounds_total"]}}
    assert last["rounds_branch_run"] > 0
    lk.reset_counts()


def test_sharded_plain_sweep_calls_equal_sweep_rounds(corpus):
    from pangene_tpu_torch.ops import sweep_kernel as sk
    sk.reset_counts()
    run_port(corpus)
    assert sk.n_batched() == {"kernel": 0,
                            "plain": dl.LAST["rounds_sweep_run"]}
    sk.reset_counts()


def test_sharded_without_cuda_raises(corpus, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--engine", "sharded", "-v", "0"] + corpus)


def test_cli_engine_flag(corpus, capsys):
    with pytest.raises(SystemExit):
        cli.main(["--engine", "jax", "--device", "cpu"] + corpus)
    capsys.readouterr()
    cli.main(["--engine", "sharded", "--device", "cpu", "-v", "0"] + corpus)
    assert dl.LAST["engaged"] is True
    assert capsys.readouterr().out == run_jax(corpus)
    with pytest.raises(ValueError):
        run_port(corpus, engine="jax")
    # "host" is one of the port's host engines (the JAX package's names)
    assert run_port(corpus, engine="host") == run_jax(corpus)


# the ceiling of aten operations a round that the loop dispatches outside
# its kernels' wrappers (the fused sweep's and ops/loop_kernels'): the
# merge's sort, the pair plane's window, the round's word and the schedule's
# set-up spread over its rounds; 10.6875 measured when the sweep's epilogue
# moved into its kernel (29 before), plus at most 3
ROUND_OPS_CEILING = 13


def test_loop_ops_a_round(corpus, monkeypatch):
    """Counts the aten operations one engaged loop dispatches on the CPU
    outside the kernels' wrappers (what the host enqueues one at a time on
    the card), per round."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from pangene_tpu_torch.ops import loop_kernels as lk
    from pangene_tpu_torch.ops import sweep_kernel as sk
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

    def wrapped_bind(bind):
        # a binding (its allocations) and each of its launches
        def call(*a, **kw):
            b = wrapped(bind)(*a, **kw)
            return lk.Bound(wrapped(b.launch), b.out)
        return call

    for name in lk.n_calls:
        if name != "merge_fold_full":
            monkeypatch.setattr(lk, name, wrapped(getattr(lk, name)))
            if hasattr(lk, "bind_" + name):
                monkeypatch.setattr(lk, "bind_" + name, wrapped_bind(
                    getattr(lk, "bind_" + name)))
    monkeypatch.setattr(sk, "sweep_round_loop", wrapped(sk.sweep_round_loop))
    monkeypatch.setattr(sk, "bind_sweep_round_loop",
                        wrapped_bind(sk.bind_sweep_round_loop))
    schedule_device = dl.schedule_device

    def counted(*a, **kw):
        with Count():
            return schedule_device(*a, **kw)
    monkeypatch.setattr(dl, "schedule_device", counted)
    run_port(corpus)
    last = dl.LAST
    assert last["engaged"] and last["rounds_sweep_run"] > 1
    a_round = count[0] / last["rounds_total"]
    assert 0 < a_round <= ROUND_OPS_CEILING, (count[0], a_round)
