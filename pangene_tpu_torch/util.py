"""Timers and stderr logging in the reference's format.

Every stage logs "[M::func::<wall>*<cpu%>]" lines gated by a verbosity level
(reference sys.c:95-138, pgpriv.h:60-64). Keeping the same discipline makes
graph-quality regressions diffable against reference stderr output.
"""
from __future__ import annotations

import os
import resource
import sys
import time

verbose = 3

# Coarse wall-clock of the most recent pipeline.run, keyed by stage
# (parse_s/post_s/graph_s/emit_s). Reset at the start of each run;
# chip_smoke.py prints it.
stage_stats: dict = {}

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
