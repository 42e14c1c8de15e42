"""Where the schedule driver's host time goes, on one CUDA card, on a
gpubench configuration's corpus: warm schedule_device calls (through
device_loop.run_packed with `stats`, as every user build runs them) under
cProfile, each function's own time put in one of

  checks      the launch wrappers' argument checks (dtype, device, shape,
              contiguity; the round scratch's check)
  pointers    data_ptr() reads, the device guard, the current-stream
              lookup, the sweep's pointer table
  allocs      tensor allocations and the memsets that zero them
  events      the block timer's CUDA events (creation, record, read)
  sync        host reads and synchronises (schedule_device's `sync` and
              `sync_final` spans, outside driver_ms)
  other       the rest: the driver's Python, the launches themselves
              (ctypes calls are charged to their caller), torch ops

and, without the profiler, the mean driver_ms and sync_wait_ms of the same
schedules (stats["driver_ms"], the span `schedule` less its waits).

    python3 scripts/torch_driver_profile.py [--config human2] [--seed 7]
        [--reps 50] [--device cuda] [--top 40]

From the root of a checkout (--device cpu rehearses it with the kernels'
plain versions; its times are not the card's); prints one JSON line: ms a
schedule by category under the profiler (their shares are what to read:
cProfile adds a cost to every Python call), the top functions by own time,
and driver_ms / sync_wait_ms / launch counts without it."""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import shutil
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CHECKS = ("_check", "_check_planes", "_check_batched", "_check_args",
          "_round_scratch", "_launch_device", "_on_cuda", "is_contiguous")
# the device guard (torch.cuda.device), the stream lookup and what they
# call: CUDA's availability (an environment read), the lazy init
POINTERS = ("data_ptr", "_stream", "bound_stream", "current_stream",
            "_col_ptrs", "_exchange_device", "_get_device_index",
            "_get_device_attr", "_get_current_device_index",
            "current_device", "is_available", "_nvml_based_avail",
            "_lazy_init", "is_initialized", "_cuda_isInBadFork",
            "_cuda_getCurrentStream", "_cuda_getDevice", "cuda_stream",
            "device_guard")
ALLOCS = ("empty", "zeros", "full", "new_empty", "new_zeros", "new_full",
          "zero_", "empty_like", "zeros_like", "round_scratch")
EVENTS = ("record", "elapsed_time", "_take")
SYNC = ("tolist", "item", "synchronize")


def func_name(func: str) -> str:
    """The bare name of a pstats function entry: "<built-in method
    torch.empty>" -> "empty", "<method 'data_ptr' of ...>" -> "data_ptr",
    "<function Event.record at 0x...>" -> "record"."""
    f = func.strip("<>{}")
    if f.startswith("method '"):
        return f.split("'")[1]
    words = f.split()
    if f.startswith("function "):
        return words[1].split(".")[-1]
    return words[-1].split(".")[-1] if words else f


def category(key, stream_new: int, event_new: int) -> str:
    path, line, func = key
    name = func_name(func)
    if "frozen os" in path or "collections_abc" in path:
        return "pointers"           # os.environ reads of is_available
    if "streams.py" in path and name == "__new__":
        return "events" if line == event_new else "pointers"
    if name in EVENTS or (name == "__init__" and "streams.py" in path):
        return "events"
    if name in SYNC:
        return "sync"
    if name in CHECKS:
        return "checks"
    if name in POINTERS or (path.endswith("cuda/__init__.py")
                            and name in ("__enter__", "__exit__")):
        return "pointers"
    if name in ALLOCS:
        return "allocs"
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="human2")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch
    from gpubench import run as R
    from gpubench.entries.schedule import Entry
    from gpubench.harness import Run
    from gpubench.inputs import synth
    from pangene_tpu_torch import util
    from pangene_tpu_torch.options import PgOpt
    from pangene_tpu_torch.parallel import device_loop as dl

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        sys.stderr.write("needs a CUDA device\n")
        return 3
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = R.load_json(R.HERE, "configs", args.config + ".json")
    tmp = tempfile.mkdtemp(prefix="driver-profile-")
    try:
        shape = synth.shape_of(cfg)
        files = synth.write_corpus(shape, args.seed, os.path.join(tmp, "paf"),
                                   workers=max(1, min(8, shape.n_genome)))
        util.verbose = 0
        entry = Entry(PgOpt(device=args.device, **cfg.get("options", {})),
                      files, Run())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pk, mesh = entry.pk, entry.mesh
    for _ in range(5):
        dl.run_packed(pk, mesh, {})
    sync()

    driver, wait = [], []
    stats: dict = {}
    for _ in range(args.reps):
        stats = {}
        dl.run_packed(pk, mesh, stats)
        driver.append(stats["driver_ms"])
        wait.append(stats["sync_wait_ms"])
    sync()

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(args.reps):
        dl.run_packed(pk, mesh, {})
    sync()
    prof.disable()
    st = pstats.Stats(prof).stats
    lines = (torch.cuda.Stream.__new__.__code__.co_firstlineno,
             torch.cuda.Event.__new__.__code__.co_firstlineno)
    by_cat: dict = {}
    rows = []
    for key, (_, ncalls, tt, _, _) in st.items():
        c = category(key, *lines)
        by_cat[c] = by_cat.get(c, 0.0) + tt
        rows.append((tt, ncalls, c, "%s:%d:%s" % (
            os.path.basename(key[0]), key[1], key[2])))
    rows.sort(reverse=True)
    per = lambda s: 1e3 * s / args.reps
    print(json.dumps({
        "config": args.config, "seed": args.seed, "reps": args.reps,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "driver_ms": statistics.median(driver),
        "sync_wait_ms": statistics.median(wait),
        "launches": {k: stats.get(k) for k in (
            "sweep_launches", "loop_launches", "launch_checks",
            "bound_launches")},
        "profiled_ms_a_schedule": {c: per(s) for c, s in sorted(
            by_cat.items())},
        "profiled_total_ms": per(sum(by_cat.values())),
        "top": [[name, c, round(per(tt), 4), n // args.reps]
                for tt, n, c, name in rows[:args.top]],
        "others": [[name, round(per(tt), 4), n // args.reps]
                   for tt, n, c, name in rows if c == "other"
                   and per(tt) >= 0.01][args.top:]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
