"""The state of one benchmark run that the per-layer readers read: the host
spans (seconds, by name, in order), each window repetition's wall and the
program's counters, the device trace's summary, the shape of the input.

A span is taken with the host clock around a call into the program; while
the profiler records, the same span is also a profiler annotation
("gpubench.<name>"), so that the trace can say what the host was doing in
each idle gap of the device."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


class Run:
    def __init__(self):
        self.spans: Dict[str, List[float]] = {}
        self.walls: List[float] = []        # each window repetition's wall
        self.stats: List[dict] = []         # the program's counters of each
        self.window_s = 0.0
        self.shape: dict = {}
        self.trace: Optional[dict] = None   # trace.summarise's result
        self.annotate = False               # spans are profiler annotations
        self.in_window = False
        self.window_spans: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        ann = contextlib.nullcontext()
        if self.annotate:
            import torch
            ann = torch.profiler.record_function("gpubench." + name)
        t0 = time.monotonic()
        with ann:
            yield
        dt = time.monotonic() - t0
        self.spans.setdefault(name, []).append(dt)
        if self.in_window:
            self.window_spans.setdefault(name, []).append(dt)

    def total(self, name: str) -> Optional[float]:
        v = self.spans.get(name)
        return sum(v) if v else None

    def per_rep_ms(self, *names: str) -> Optional[float]:
        """The window's mean of the named spans, summed, a repetition."""
        n = len(self.walls)
        parts = [self.window_spans.get(k) for k in names]
        if not n or not all(parts):
            return None
        return 1e3 * sum(sum(p) for p in parts) / n
