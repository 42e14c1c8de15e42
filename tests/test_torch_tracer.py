"""The spans and counters of the port's schedule driver (util.Tracer in
parallel/device_loop.schedule_device and run_packed, and the set-up spans of
pipeline.read_all and pack_host), on the CPU: how they nest, what they sum
to, what they cost when off, and that run_packed gives the outputs of the
lines graph_gen_device ran before it."""
import io
import json

import numpy as np
import pytest
import torch

from pangene_tpu_torch import pipeline, util
from pangene_tpu_torch.options import PgOpt
from pangene_tpu_torch.parallel import device_loop as dl
from pangene_tpu_torch.parallel import mesh as M
from pangene_tpu_torch.testing import synth_paf_files

torch.set_num_threads(1)

BLOCK_SPANS = dl.BLOCKS + ("walk_merge_full",)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_tracer")
    return synth_paf_files(str(d), n_genome=6, n_gene=200, n_iso=3, seed=23)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PANGENE_PARSE_WORKERS", "1")
    yield
    util.verbose = 3


def build(files):
    util.verbose = 0
    out = io.StringIO()
    pipeline.run(PgOpt(engine="sharded", device="cpu"), files, out=out)
    return out.getvalue()


@pytest.fixture(scope="module")
def packed(corpus):
    """pack_host's Pack of the corpus's graph after phase 1."""
    packs = []
    orig = dl.pack_host
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PANGENE_PARSE_WORKERS", "1")
        mp.setattr(dl, "pack_host", lambda *a, **kw:
                   packs.append(orig(*a, **kw)) or packs[-1])
        build(corpus)
    util.verbose = 3
    assert dl.LAST["engaged"] is True and len(packs) == 1
    return packs[0]


MESH = M.local(torch.device("cpu"))


class Spy(util.Tracer):
    made: list = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        Spy.made.append(self)


def schedule_tracer(pk, monkeypatch, stats):
    """run_packed with every tracer kept: (its tracer, schedule_device's)."""
    Spy.made = []
    monkeypatch.setattr(util, "Tracer", Spy)
    dl.run_packed(pk, MESH, stats)
    run, sched = Spy.made
    assert run.names[0] == "upload" and sched.names[0] == "schedule"
    return run, sched


def test_spans_nest(packed, monkeypatch):
    stats: dict = {}
    _, tr = schedule_tracer(packed, monkeypatch, stats)
    assert all(b >= a for a, b in zip(tr.t0, tr.t1))
    parent = lambda i: tr.names[tr.parents[i]] if tr.parents[i] >= 0 \
        else None
    for i, name in enumerate(tr.names):
        # a child lies inside its parent
        p = tr.parents[i]
        if p >= 0:
            assert tr.t0[p] <= tr.t0[i] <= tr.t1[i] <= tr.t1[p]
        want = {"schedule": None, "round": "schedule",
                "walk_merge_full": "schedule", "sync": "occ"}
        if name in dl.BLOCKS:
            assert parent(i) == "round", name
        else:
            assert parent(i) == want[name], name
    assert tr.names.count("schedule") == 1
    assert tr.names.count("round") == packed.cfg.R
    assert tr.names.count("walk_merge_full") == 1
    # the blocks' host time lies inside the schedule span
    assert sum(stats["host_ms"].values()) <= tr.ns("schedule") / 1e6
    assert set(stats["host_ms"]) == set(BLOCK_SPANS)
    assert all(v > 0 for k, v in stats["host_ms"].items() if k != "sweep")


def test_driver_and_wait_make_the_schedule(packed, monkeypatch):
    stats: dict = {}
    _, tr = schedule_tracer(packed, monkeypatch, stats)
    assert stats["driver_ms"] + stats["sync_wait_ms"] == pytest.approx(
        tr.ns("schedule") / 1e6, rel=1e-9)
    assert stats["sync_wait_ms"] == pytest.approx(
        tr.ns("sync", "sync_final") / 1e6, rel=1e-9)
    assert 0 <= stats["sync_wait_ms"] < stats["driver_ms"]
    # no CUDA events on the CPU: no closing synchronise, and block_ms is
    # the blocks' host time, the tail counted under walk_merge
    assert "sync_final" not in tr.names
    hm, bm = stats["host_ms"], stats["block_ms"]
    assert set(bm) == set(dl.BLOCKS)
    assert bm["walk_merge"] == pytest.approx(
        hm["walk_merge"] + hm["walk_merge_full"], abs=2e-3)
    assert bm["branch"] == pytest.approx(hm["branch"], abs=1e-3)


def test_host_syncs_are_the_sync_spans(packed, monkeypatch):
    stats: dict = {}
    _, tr = schedule_tracer(packed, monkeypatch, stats)
    assert stats["host_syncs"] == tr.names.count("sync") == packed.cfg.R


class Counting:
    """A stand-in for torch.profiler.record_function that counts entries."""
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        Counting.entered += 1

    def __exit__(self, *exc):
        return False


def test_off_reads_no_clock_and_enters_no_scope(packed, monkeypatch):
    import time
    reads = [0]
    clock = time.perf_counter_ns

    def counted():
        reads[0] += 1
        return clock()

    Counting.entered = 0
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    # even while a profiler records
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(time, "perf_counter_ns", counted)
            outs = dl.run_packed(packed, MESH, None)
    assert reads[0] == 0 and Counting.entered == 0
    assert len(outs) == 20
    # the same tracers on: a clock read at each end of every span (upload,
    # run, pull, schedule, and a round, its sync and its prop and occ
    # blocks at least)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "perf_counter_ns", counted)
        dl.run_packed(packed, MESH, {})
    assert reads[0] >= 2 * (4 + 4 * packed.cfg.R)


def test_no_profiler_no_record_function(packed, monkeypatch):
    Counting.entered = 0
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    stats: dict = {}
    dl.run_packed(packed, MESH, stats)
    assert stats["host_syncs"] > 0 and Counting.entered == 0
    # and one a span while a profiler records
    Spy.made = []
    monkeypatch.setattr(util, "Tracer", Spy)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        dl.run_packed(packed, MESH, {})
    assert Counting.entered == sum(len(t.names) for t in Spy.made) > 0


def test_profiler_trace_holds_the_spans(packed, tmp_path):
    stats: dict = {}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        dl.run_packed(packed, MESH, stats)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e["name"].startswith("pg."):
            t0 = float(e["ts"])
            spans.setdefault(e["name"][3:], []).append(
                (t0, t0 + float(e["dur"])))
    for name in ("upload", "run", "pull", "schedule", "round", "sync") \
            + BLOCK_SPANS:
        assert name in spans, name
    assert len(spans["round"]) == packed.cfg.R
    assert len(spans["sync"]) == stats["host_syncs"]

    def inside(child, parents):
        for a, b in spans[child]:
            assert any(p0 <= a and b <= p1 for p0, p1 in spans[parents]), \
                (child, parents)

    inside("schedule", "run")
    inside("round", "schedule")
    for block in dl.BLOCKS:
        inside(block, "round")
    inside("walk_merge_full", "schedule")
    inside("sync", "occ")


def inline(pk, mesh, pull_dcap):
    """The lines graph_gen_device ran between its pack and its apply before
    run_packed held them."""
    N = dl.N_DEVICE_INPUTS
    on_dev = [M.put_sharded(a, mesh, 1) for a in pk.inputs[:5]] \
        + [torch.from_numpy(a).to(mesh.device, non_blocking=True)
           for a in pk.inputs[5:N]]
    outs = dl.schedule_device(*on_dev, *pk.inputs[N:-1],
                              bool(pk.inputs[-1]), cfg=pk.cfg, stats={},
                              mesh=mesh)
    bool(outs[-1].item())
    return [M.pull_global(o, mesh) if i < 4
            else o.cpu().numpy() if pull_dcap or not 15 <= i < 19
            else np.zeros((0,) + tuple(o.shape[1:]), np.int32)
            for i, o in enumerate(outs)]


@pytest.mark.parametrize("pull_dcap", [False, True])
def test_run_packed_equals_the_inline_lines(packed, pull_dcap):
    want = inline(packed, MESH, pull_dcap)
    stats: dict = {}
    for _ in range(2):       # the pack is not changed by a schedule
        got = dl.run_packed(packed, MESH, stats, pull_dcap=pull_dcap)
        assert len(got) == len(want) == 20
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and a.shape == b.shape, i
            assert np.array_equal(a, b), i
    assert want[-1].item() is False
    if pull_dcap:
        # the numpy entry of the schedule gives the same 20 outputs
        ref = dl.schedule(*packed.inputs, cfg=packed.cfg, device="cpu")
        for i, (a, b) in enumerate(zip(want, ref)):
            assert np.array_equal(a, b), i
    for k in ("upload_s", "run_s", "pull_s"):
        assert stats[k] >= 0, k


def test_last_and_stage_stats(corpus):
    build(corpus)
    last = dl.LAST
    for key in ("engaged", "device", "shape", "rank", "kept_frac",
                "upload_bytes", "pack_s", "upload_s", "run_s", "pull_s",
                "rounds_branch_run", "rounds_sweep_run", "rounds_total",
                "collective_calls", "host_syncs", "block_ms",
                "sweep_launches", "loop_launches", "host_ms",
                "sync_wait_ms", "driver_ms"):
        assert key in last, key
    assert last["engaged"] is True
    # run_s is rounded to the millisecond
    assert last["run_s"] * 1e3 + 0.5 >= \
        last["driver_ms"] + last["sync_wait_ms"]
    # the set-up spans
    st = util.stage_stats
    assert last["pack_s"] == st["pack_s"] and st["pack_s"] >= 0
    assert st["parse_s"] >= 0 and "graph_s" in st


def test_tracer_off_and_stage_span(monkeypatch):
    off = util.Tracer(False)
    with off.span("a"):
        with off.block("b"):
            pass
    off.begin("c")
    off.end()
    assert off.names == [] and off._next is None and off.ns("a") == 0
    assert off.block_ms(["b"]) == {"b": 0.0}

    calls = []

    @util.stage_span("demo")
    def work(x, y=1):
        """doc"""
        calls.append((x, y))
        return x + y

    monkeypatch.setattr(util, "stage_stats", {})
    assert work(2, y=3) == 5 and calls == [(2, 3)]
    assert work.__doc__ == "doc" and work.__name__ == "work"
    assert util.stage_stats["demo_s"] >= 0
