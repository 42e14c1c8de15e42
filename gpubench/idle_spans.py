"""The device's idle gaps named by the program's own spans.

idle_spans(events) finds the idle gaps that trace.idle_gaps finds, in the
same trace of the host and the device, and names each by the benchmark's
span, the innermost of the program's spans open at the gap's start (its
profiler annotations "pg.<name>", which pangene_tpu_torch's util.Tracer
records while a profiler runs) and the innermost host operation:
"run/walk_merge:host" is a gap that began while the host ran Python in the
walk_merge block of a schedule, under the benchmark's span "run". With no
program span open the name is trace.idle_gaps' ("run:host").

    python3 -m gpubench.idle_spans --workload <name> --seed <n> --seconds <s> --trace 1

runs one cell as gpubench.run does and adds idle_spans to the result line's
breakdown, beside device_ops and idle_gaps (run.py does not report it
itself yet)."""
from __future__ import annotations

import bisect
import sys

from . import trace
from .trace import DEVICE_CATS, _complete, _innermost, _rank, _union


def _covering(spans, starts, t: float) -> str:
    """Name of the innermost of nested `spans` (start, end, name), sorted
    by start, that covers t: the latest started one that has not ended."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if spans[i][1] > t:
            return spans[i][2]
    return ""


def idle_spans(events: list, top: int = 10) -> list:
    """events: the traceEvents of a trace of the host and the device. The
    idle gaps of trace.idle_gaps, in seconds, by the benchmark's span, the
    program's innermost span and the host's innermost operation."""
    dev, ann, prog, ops = [], [], [], []
    for e, t0, t1 in _complete(events):
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append((t0, t1))
        elif cat == "user_annotation" and e["name"].startswith("gpubench."):
            ann.append((t0, t1, e["name"][len("gpubench."):]))
        elif cat == "user_annotation" and e["name"].startswith("pg."):
            prog.append((t0, t1, e["name"][len("pg."):]))
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
    prog.sort()
    prog_starts = [p[0] for p in prog]
    by_gap: dict = {}
    for a, b in gaps:
        i = bisect.bisect_right(starts, a)
        near = [o for o in ops[max(0, i - 400):i] if o[1] > a]
        where = _innermost(ann, a) or "harness"
        inner = _covering(prog, prog_starts, a)
        if inner:
            where += "/" + inner
        what = "%s:%s" % (where, _innermost(near, a) or "host")
        by_gap[what] = by_gap.get(what, 0.0) + (b - a)
    return _rank(by_gap, top)


def main(argv=None) -> int:
    """gpubench.run's main, with idle_spans computed from the trace that
    idle_gaps reads and added to the result's breakdown."""
    from . import run
    got: dict = {}
    idle_gaps, run_cell = trace.idle_gaps, run.run_cell

    def gaps_and_spans(events, top=10):
        got["idle_spans"] = idle_spans(events, top)
        return idle_gaps(events, top)

    def cell(*args, **kw):
        result = run_cell(*args, **kw)
        if "breakdown" in result and "idle_spans" in got:
            result["breakdown"]["idle_spans"] = got["idle_spans"]
        return result

    trace.idle_gaps, run.run_cell = gaps_and_spans, cell
    try:
        return run.main(argv)
    finally:
        trace.idle_gaps, run.run_cell = idle_gaps, run_cell


if __name__ == "__main__":
    sys.exit(main())
