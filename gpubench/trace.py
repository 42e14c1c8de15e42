"""Reduction of torch.profiler chrome traces to what the benchmark reports.

Two traces of the same repetitions are read. The first records the device's
activity alone, so that the profiler adds no host work to the repetitions:
from it come the device's busy time (the union of the intervals in which a
kernel, a copy or a memset ran: the arithmetic of pangene_tpu_torch.util.
trace_device_summary), the kernels' own time (the union of the kernel
intervals) and the operations that took most device time. The second also
records the host, with the benchmark's spans as annotations, and only names
the idle gaps of the device by what the host was doing then (the benchmark's
span and the innermost host operation open at the gap's start)."""
from __future__ import annotations

import bisect
import json
from typing import List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(spans: List[Tuple[float, float]]):
    """Sorted disjoint intervals covering `spans`."""
    out: List[List[float]] = []
    for t0, t1 in sorted(spans):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def _innermost(events, t: float) -> str:
    """Name of the shortest of `events` (ts, end, name) that covers t."""
    best, name = None, ""
    for t0, t1, n in events:
        if t0 <= t < t1 and (best is None or t1 - t0 < best):
            best, name = t1 - t0, n
    return name


def _complete(events):
    for e in events:
        if e.get("ph") == "X":
            t0 = float(e["ts"])
            yield e, t0, t0 + float(e.get("dur", 0))


def _rank(d: dict, top: int) -> list:
    return [[n, us / 1e6] for n, us in
            sorted(d.items(), key=lambda kv: -kv[1])[:top]]


def device_summary(events: list, top: int = 10) -> dict:
    """events: the traceEvents of a trace of the device alone. Seconds the
    device was busy, seconds a kernel ran, and the heaviest operations."""
    dev, kern = [], []
    by_name: dict = {}
    for e, t0, t1 in _complete(events):
        if e.get("cat") in DEVICE_CATS:
            dev.append((t0, t1))
            if e["cat"] == "kernel":
                kern.append((t0, t1))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t1 - t0)
    size = lambda spans: sum(b - a for a, b in _union(spans)) / 1e6
    return {"busy_s": size(dev), "kernel_s": size(kern),
            "device_ops": _rank(by_name, top)}


def idle_gaps(events: list, top: int = 10) -> list:
    """events: the traceEvents of a trace of the host and the device. The
    idle gaps of the device inside the span of the benchmark's annotations
    ("gpubench.*"), in seconds, by what the host was doing."""
    dev, ann, ops = [], [], []
    for e, t0, t1 in _complete(events):
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append((t0, t1))
        elif cat == "user_annotation" and e["name"].startswith("gpubench."):
            ann.append((t0, t1, e["name"][len("gpubench."):]))
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver"):
            ops.append((t0, t1, e["name"]))
    if not ann:
        return []
    w0 = min(a[0] for a in ann)
    w1 = max(a[1] for a in ann)
    busy = _union([(max(a, w0), min(b, w1)) for a, b in dev
                   if b > w0 and a < w1])
    gaps = []
    prev = w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    ops.sort()
    starts = [o[0] for o in ops]
    by_gap: dict = {}
    for a, b in gaps:
        i = bisect.bisect_right(starts, a)
        near = [o for o in ops[max(0, i - 400):i] if o[1] > a]
        what = "%s:%s" % (_innermost(ann, a) or "harness",
                          _innermost(near, a) or "host")
        by_gap[what] = by_gap.get(what, 0.0) + (b - a)
    return _rank(by_gap, top)


def events_of(prof, path: str) -> list:
    """The traceEvents of a finished profiler, by way of a file at `path`
    (removed again)."""
    import os
    prof.export_chrome_trace(path)
    try:
        with open(path) as fp:
            return json.load(fp)["traceEvents"]
    finally:
        os.remove(path)
