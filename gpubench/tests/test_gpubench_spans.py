"""The readers of the schedule driver's spans and the idle gaps named by the
program's spans, on hand-built runs and a fixed event list."""
import pytest

from gpubench import idle_spans as S
from gpubench import run as R
from gpubench import trace
from gpubench.harness import Run


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_driver_and_wait_readers():
    r = Run()
    r.stats = [{"driver_ms": 12.0, "sync_wait_ms": 1.0},
               {"driver_ms": 14.0, "sync_wait_ms": 3.0}]
    assert R.metric_reader("driver_ms.loop")(r) == pytest.approx(13.0)
    assert R.metric_reader("sync_wait_ms.loop")(r) == pytest.approx(2.0)
    # a program without the spans (the stats of an older schedule_device)
    r.stats = [{"host_syncs": 16, "block_ms": {"branch": 1.0}}]
    assert R.metric_reader("driver_ms.loop")(r) is None
    assert R.metric_reader("sync_wait_ms.loop")(r) is None
    assert R.metric_reader("driver_ms.loop")(Run()) is None


# one schedule: the benchmark's spans, the program's (pg.*), the device's
# work and the host's operations; the device is idle in 0-10 (upload, no
# program span), 30-60 (walk_merge's Python), 70-100 (a host read), 110-130
# (the round, between blocks) and 140-160 (the schedule, after the rounds)
PROGRAM = [
    ev("user_annotation", "pg.schedule", 20, 140),
    ev("user_annotation", "pg.round", 25, 105),
    ev("user_annotation", "pg.walk_merge", 28, 40),
    ev("user_annotation", "pg.occ", 68, 40),
    ev("user_annotation", "pg.sync", 70, 35),
]
EVENTS = [
    ev("user_annotation", "gpubench.upload", 0, 20),
    ev("user_annotation", "gpubench.run", 20, 140),
    ev("gpu_memcpy", "Memcpy HtoD", 10, 10),
    ev("kernel", "k1", 20, 10),
    ev("kernel", "k2", 60, 10),
    ev("kernel", "k3", 100, 10),
    ev("kernel", "k4", 130, 10),
    ev("cpu_op", "aten::item", 69, 33),
    ev("cuda_runtime", "cudaStreamSynchronize", 69.5, 31),
]


def test_idle_spans_name_the_program_span():
    got = dict(S.idle_spans(EVENTS + PROGRAM))
    assert got == {
        "upload:host": pytest.approx(10e-6),
        "run/walk_merge:host": pytest.approx(30e-6),
        "run/sync:cudaStreamSynchronize": pytest.approx(30e-6),
        "run/round:host": pytest.approx(20e-6),
        "run/schedule:host": pytest.approx(20e-6)}
    # the same gaps as idle_gaps, which the program's spans do not move
    gaps = trace.idle_gaps(EVENTS + PROGRAM)
    assert gaps == trace.idle_gaps(EVENTS)
    assert sum(got.values()) == pytest.approx(sum(v for _, v in gaps))
    assert dict(gaps) == {"upload:host": pytest.approx(10e-6),
                          "run:host": pytest.approx(70e-6),
                          "run:cudaStreamSynchronize": pytest.approx(30e-6)}


def test_idle_spans_without_program_spans_are_idle_gaps():
    assert S.idle_spans(EVENTS) == trace.idle_gaps(EVENTS)
    assert S.idle_spans(EVENTS[2:] + PROGRAM) == []


def test_main_adds_idle_spans_and_restores(monkeypatch):
    """The runner wraps gpubench.run's cell and trace reduction only for
    its own call."""
    seen = {}

    def fake_main(argv):
        gaps = trace.idle_gaps(EVENTS + PROGRAM)
        seen["result"] = R.run_cell({"breakdown": {"idle_gaps": gaps}})
        return 0

    def fake_cell(result):
        return result

    monkeypatch.setattr(R, "main", fake_main)
    monkeypatch.setattr(R, "run_cell", fake_cell)
    idle_gaps = trace.idle_gaps
    assert S.main([]) == 0
    bd = seen["result"]["breakdown"]
    assert bd["idle_spans"] == S.idle_spans(EVENTS + PROGRAM)
    assert bd["idle_gaps"] == idle_gaps(EVENTS + PROGRAM)
    assert trace.idle_gaps is idle_gaps and R.run_cell is fake_cell
