"""Timers and stderr logging in the reference's format.

Every stage logs "[M::func::<wall>*<cpu%>]" lines gated by a verbosity level
(reference sys.c:95-138, pgpriv.h:60-64). Keeping the same discipline makes
graph-quality regressions diffable against reference stderr output.
"""
from __future__ import annotations

import functools
import os
import resource
import sys
import time

verbose = 3

# Coarse wall-clock of the most recent pipeline.run, keyed by stage
# (parse_s/post_s/graph_s/emit_s; parse_s and pack_s from the spans of
# read_all and device_loop.pack_host). Reset at the start of each run;
# chip_smoke.py prints it.
stage_stats: dict = {}

# The timing events of Tracer's blocks no tracer holds now, by CUDA device
# index: a tracer takes two a block and gives them back once block_ms has
# read them, so the pool holds as many as the most blocks timed at once,
# each created once (event_pool).
_event_pools: dict = {}


def event_pool(index: int) -> list:
    """The free timing events of CUDA device `index` (created on first
    use, never released)."""
    return _event_pools.setdefault(index, [])


class Tracer:
    """Spans of the port's host code. A span has a name, its parent (the
    span open when it began; -1 for none), a start and an end on
    time.perf_counter_ns(), and for a block a key; the spans stay in
    memory until the caller sums them. While a torch.profiler records, a
    span is also the profiler annotation "pg.<name>", so that a trace shows
    which span the host was in beside the device's kernels and copies. A
    span with a key (`block`) on a CUDA device also records a pair of CUDA
    events, taken from the device's event_pool and recorded on the stream
    current when the tracer was made, which block_ms() reads. A tracer
    that is off reads no clock, allocates nothing a span and enters no
    profiler scope.

        tr = Tracer(on, device)
        with tr.span("name"):         # or tr.begin("name") ... tr.end()
            with tr.block("branch"):
                ...
    """

    def __init__(self, on: bool = True, device=None):
        self.on = on
        self.cuda = on and getattr(device, "type", None) == "cuda"
        self.names: list = []
        self.keys: list = []
        self.parents: list = []
        self.t0: list = []
        self.t1: list = []
        self._open: list = []         # (index, annotation, end event)
        self._events: list = []       # (key, start event, end event)
        self._next = None             # (name, key) of the next `with`
        torch = sys.modules.get("torch")
        self._profiling = (torch._C._autograd._profiler_enabled
                           if on and torch is not None else None)
        if self.cuda:
            self._stream = torch.cuda.current_stream(device)
            self._pool = event_pool(self._stream.device_index)

    def begin(self, name: str, key=None) -> None:
        if not self.on:
            return
        t = time.perf_counter_ns()
        i = len(self.names)
        self.names.append(name)
        self.keys.append(key)
        self.parents.append(self._open[-1][0] if self._open else -1)
        self.t0.append(t)
        self.t1.append(t)
        ann = end = None
        if self._profiling is not None and self._profiling():
            ann = sys.modules["torch"].profiler.record_function("pg." + name)
            ann.__enter__()
        if key is not None and self.cuda:
            start, end = self._take(), self._take()
            start.record(self._stream)
            self._events.append((key, start, end))
        self._open.append((i, ann, end))

    def end(self) -> None:
        if not self.on:
            return
        i, ann, end = self._open.pop()
        if end is not None:
            end.record(self._stream)
        if ann is not None:
            ann.__exit__(None, None, None)
        self.t1[i] = time.perf_counter_ns()

    def _take(self):
        if self._pool:
            return self._pool.pop()
        return sys.modules["torch"].cuda.Event(enable_timing=True)

    def span(self, name: str, key=None) -> "Tracer":
        if self.on:
            self._next = (name, key)
        return self

    def block(self, name: str, key=None) -> "Tracer":
        """A span timed on the device too, under `key` (default: name)."""
        return self.span(name, key or name)

    def __enter__(self) -> None:
        if self.on:
            self.begin(*self._next)

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    def ns(self, *names: str) -> int:
        """Host nanoseconds in the finished spans of these names."""
        return sum(b - a for n, a, b in zip(self.names, self.t0, self.t1)
                   if n in names)

    def seconds(self, name: str) -> float:
        return round(self.ns(name) / 1e9, 3)

    def host_ms(self, names) -> dict:
        """Host milliseconds by span name, each summed over its spans."""
        return {n: self.ns(n) / 1e6 for n in names}

    def block_ms(self, keys) -> dict:
        """Milliseconds by block key, summed over the blocks' spans: on a
        CUDA device from their events, after a synchronise that is itself a
        span, "sync_final"; elsewhere their host time."""
        ms = dict.fromkeys(keys, 0.0)
        if self.cuda:
            import torch
            with self.span("sync_final"):
                torch.cuda.synchronize()
            for key, start, end in self._events:
                ms[key] += start.elapsed_time(end)
                self._pool += (start, end)
            self._events = []
        else:
            for k, a, b in zip(self.keys, self.t0, self.t1):
                if k is not None:
                    ms[k] += (b - a) / 1e6
        return {k: round(v, 3) for k, v in ms.items()}


def stage_span(name: str):
    """Decorator: each call of the function is a span `name` of a tracer of
    its own (one pair of clock reads; the annotation "pg.<name>" under
    --profile), whose seconds go to stage_stats["<name>_s"]."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            tr = Tracer()
            with tr.span(name):
                out = fn(*args, **kw)
            stage_stats[name + "_s"] = tr.seconds(name)
            return out
        return call
    return wrap

_t0 = time.monotonic()
_cpu0 = time.process_time()


def realtime() -> float:
    return time.monotonic() - _t0


def cputime() -> float:
    return time.process_time() - _cpu0


def peakrss() -> float:
    """Peak RSS in bytes."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    mult = 1024 if sys.platform != "darwin" else 1
    return ru.ru_maxrss * mult


def percent_cpu() -> float:
    rt = realtime()
    return 100.0 * cputime() / rt if rt > 0 else 0.0


def timestamp() -> str:
    return f"{realtime():.3f}*{percent_cpu() / 100.0:.2f}"


def log_msg(func: str, fmt: str, *args, min_verbose: int = 3,
            with_ts: bool = True) -> None:
    if verbose < min_verbose:
        return
    msg = fmt % args if args else fmt
    if with_ts:
        sys.stderr.write(f"[M::{func}::{timestamp()}] {msg}\n")
    else:
        sys.stderr.write(f"[M::{func}] {msg}\n")


def launched() -> bool:
    """Whether this process is a rank of a launch: torchrun's variables, or
    the CLI's own --devices N (parallel/mesh.launch), are set."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def launch_rank() -> int:
    """This process's rank in its launch; 0 without one. Only rank 0 writes
    output."""
    return int(os.environ["RANK"]) if launched() else 0


def local_world() -> int:
    """The ranks of this launch on this host; 1 without one."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", "1")) if launched() else 1


def trace_device_summary(path: str, top: int = 5) -> dict:
    """What a chrome trace written by ``--profile`` says of the device:
    busy_s (the union of the intervals in which a kernel, copy or memset
    ran on it), n_events, and the `top` operations by summed time as
    [name, seconds, calls]. A run on the CPU has no such event."""
    import json
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    spans = []
    by_name: dict = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((e["ts"], e["ts"] + e["dur"]))
        rec = by_name.setdefault(e["name"], [0.0, 0])
        rec[0] += e["dur"]
        rec[1] += 1
    busy = 0.0
    end = float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"busy_s": busy / 1e6, "n_events": len(spans),
            "top": [[name, us / 1e6, n] for name, (us, n) in ranked]}


def build_dir() -> str:
    """build/pangene_tpu_torch/ beside the package (git-ignored): where the
    native parser and the CUDA kernels are compiled at first use."""
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "build", "pangene_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d
