"""The end-to-end arithmetic: over every sample and the whole window."""
import importlib.util
import os

import pytest

from gpubench import run as R
from gpubench import trace
from gpubench.harness import Run


def reader(name):
    return R.metric_reader(name)


def window(walls):
    r = Run()
    r.walls = list(walls)
    r.window_s = sum(walls)
    return r


def test_rate_is_the_window_over_the_count():
    r = window([0.05] * 100)
    assert reader("schedule_ms")(r) == pytest.approx(50.0)
    # one stalled schedule moves the mean by its excess over the count
    r = window([0.05] * 99 + [1.05])
    assert reader("schedule_ms")(r) == pytest.approx(60.0)


@pytest.mark.parametrize("name", ["schedule_p95_ms", "tail_p95_ms.loop"])
def test_p95_takes_every_sample(name):
    r = window([0.05] * 100)
    assert reader(name)(r) == pytest.approx(50.0)
    r = window([0.05] * 90 + [0.2] * 10)
    assert reader(name)(r) > 150.0


def test_setup_and_spans():
    r = Run()
    r.setup_s = 12.5
    assert reader("setup_s")(r) == 12.5
    r.spans["parse"] = [3.0]
    r.spans["pack"] = [0.5, 0.25]
    assert reader("parse_s")(r) == 3.0
    assert reader("pack_s")(r) == 0.75
    r.walls = [0.1, 0.1]
    r.window_spans = {"upload": [0.001, 0.003], "pull": [0.01, 0.01]}
    assert reader("transfer_ms.loop")(r) == pytest.approx(12.0)
    r.stats = [{"host_syncs": 16, "block_ms": {"a": 1.0, "b": 2.0}},
               {"host_syncs": 18, "block_ms": {"a": 3.0, "b": 2.0}}]
    assert reader("host_syncs.loop")(r) == 17
    assert reader("block_ms.loop")(r) == 4.0


def test_reader_finds_nothing_reads_nothing():
    r = Run()
    for name in ("parse_s", "pack_s", "transfer_ms.loop", "host_syncs.loop",
                 "block_ms.loop", "idle_share.loop", "kernel_ms.loop",
                 "schedule_ms", "schedule_p95_ms", "tail_p95_ms.loop"):
        assert reader(name)(r) is None


def test_every_metric_has_a_reader():
    bench = R.load_json(R.ROOT, "BENCHMARK.json")
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert os.path.exists(os.path.join(
                R.HERE, "metrics", m["name"] + ".py")), m["name"]
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(R.HERE, "configs",
                                           w["config"] + ".json"))
        tr = R.load_json(R.HERE, "traffic", w["traffic"] + ".json")
        assert importlib.util.find_spec("gpubench.entries." + tr["entry"])


def test_every_layer_metric_moves_what_its_cells_report():
    bench = R.load_json(R.ROOT, "BENCHMARK.json")
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        moved = [e for e in bench["end_to_end"] if e["name"] == m["moves"]]
        assert moved, m["name"]
        for c in m.get("workloads", cells):
            assert c in moved[0].get("workloads", cells), (m["name"], c)


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_busy_union_and_gaps():
    events = [
        ev("user_annotation", "gpubench.upload", 0, 100),
        ev("user_annotation", "gpubench.run", 100, 300),
        ev("gpu_memcpy", "Memcpy HtoD", 10, 60),
        ev("kernel", "k1", 120, 100),
        ev("kernel", "k2", 200, 50),      # overlaps k1: counted once
        ev("kernel", "k1", 300, 40),
        ev("cpu_op", "aten::item", 250, 40),
    ]
    s = trace.device_summary(events)
    assert s["busy_s"] == pytest.approx((60 + 130 + 40) * 1e-6)
    assert s["kernel_s"] == pytest.approx((130 + 40) * 1e-6)
    assert s["device_ops"][0] == ["k1", pytest.approx(140e-6)]
    # the gaps lie inside the annotated window: a kernel after it counts
    # in none
    gaps = dict(trace.idle_gaps(events + [ev("kernel", "late", 900, 50)]))
    assert gaps["run:aten::item"] == pytest.approx(50e-6)
    assert sum(gaps.values()) == pytest.approx(400e-6 - s["busy_s"])
    assert trace.idle_gaps(events[2:]) == []


def test_device_readers():
    # busy 15 ms a traced schedule against a mean untraced wall of 20 ms:
    # the traced window's own wall (the profiler's host cost) is not read
    r = window([0.02] * 50)
    r.trace = {"busy_s": 0.03, "kernel_s": 0.02, "window_s": 0.08,
               "reps": 2}
    assert reader("idle_share.loop")(r) == pytest.approx(25.0)
    assert reader("kernel_ms.loop")(r) == pytest.approx(10.0)
    r.trace = {"busy_s": 0.0, "kernel_s": 0.0, "window_s": 0.04, "reps": 2}
    assert reader("kernel_ms.loop")(r) is None
