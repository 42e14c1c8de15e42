"""One run of one benchmark cell of pangene_tpu_torch on one card.

    python3 -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (BENCHMARK.json's `workloads`) names a
configuration (configs/<config>.json: the corpus's shape and the build's
options) and a traffic mix (traffic/<traffic>.json: the program entry that
the window drives, entries/<entry>.py, and its repetition counts). The run
draws the corpus from the seed into TMPDIR, runs the port's pipeline up to
the entry (set-up), calls the entry once cold and a few times warm, then
repeats it in a closed loop for --seconds (the window). Each metric of the
cell is read by metrics/<name>.py: with --trace 0 the end-to-end metrics,
with --trace 1 the per-layer ones, after a few more repetitions under the
profiler (the device alone, then the host too). After the window the
program's state is freed and the reference (reference/, NumPy, none of the
program) works the answer out again from the same seed; every sampled
repetition's outputs must equal it.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and with --trace 1 breakdown), then checks, each
compared number with its limit. The same checks are the last lines of
standard error. Without a CUDA device, or with fewer than the cell asks
for, it prints no result and exits 3; if JAX or the JAX package was loaded,
it exits 4.
"""
from __future__ import annotations

import os
import time

T0 = time.monotonic()


def _process_age() -> float:
    """Seconds since this process started (the interpreter's own start
    counts to set-up)."""
    try:
        with open("/proc/self/stat") as fp:
            rest = fp.read().rsplit(")", 1)[1].split()
        start = int(rest[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as fp:
            return max(0.0, float(fp.read().split()[0]) - start)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = T0 - _process_age()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
HERE = os.path.join(ROOT, "gpubench")
# modules that no run may load, compared by whole top-level name: the
# port's own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "pangene_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as fp:
        return json.load(fp)


def metric_reader(name: str):
    """metrics/<name>.py, loaded by path (metric names hold dots)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({k.split(".", 1)[0] for k in sys.modules}
                  & set(FORBIDDEN))


class Sampler:
    """A seeded reservoir of `k` window repetitions beside the first."""

    def __init__(self, seed: int, k: int):
        import numpy as np
        self.rng = np.random.default_rng([seed % (1 << 64), 7])
        self.k = k
        self.kept: dict = {}

    def offer(self, i: int, outs) -> None:
        if i == 0 or len(self.kept) < self.k + 1:
            self.kept[i] = outs
            return
        j = int(self.rng.integers(0, i))
        if j < self.k:
            victim = sorted(k for k in self.kept if k)[j]
            del self.kept[victim]
            self.kept[i] = outs


def traced(entry, run, activities, reps: int, warm: int = 2):
    """`reps` repetitions under the profiler, after `warm` that it records
    and discards (the profiler's own start-up falls in those); returns the
    profiler, the host wall of the `reps` and the last one's outputs."""
    from torch.profiler import profile, schedule
    with profile(activities=activities, schedule=schedule(
            wait=0, warmup=warm, active=reps, repeat=1)) as prof:
        for _ in range(warm):
            entry.once(run, stats={})
            prof.step()
        t0 = time.monotonic()
        for k in range(reps):
            last = entry.once(run, stats={})
            if k < reps - 1:
                prof.step()
        wall = time.monotonic() - t0
    return prof, wall, last


def run_cell(bench: dict, cell: dict, cfg: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, files: list, run,
             device: str = "cuda", wrap=None, tmp: str = ".") -> dict:
    """Set-up, window, trace, reference and checks of one cell on the
    corpus `files`; returns the result object. `wrap` (tests) replaces the
    entry by a wrapper of it."""
    import torch
    from pangene_tpu_torch import util
    from pangene_tpu_torch.options import PgOpt
    from . import trace as trace_mod

    util.verbose = 0
    cuda = device == "cuda"
    opt = PgOpt(device=device, **cfg.get("options", {}))
    mod = importlib.import_module("gpubench.entries." + traffic["entry"])
    # the entry's set-up parses before anything initialises CUDA, as a
    # user's build does (the port's parse pool forks only then)
    entry = mod.Entry(opt, files, run)
    if wrap is not None:
        entry = wrap(entry)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with run.span("cold"):
        entry.once(run, stats={})
    for _ in range(int(traffic.get("warm_reps", 2))):
        entry.once(run, stats={})
    run.setup_s = time.monotonic() - T_START

    sampler = Sampler(seed, int(traffic.get("sample_reps", 4)))
    run.in_window = True
    t_w = time.monotonic()
    i = 0
    while True:
        t0 = time.monotonic()
        stats: dict = {}
        outs = entry.once(run, stats=stats)
        t1 = time.monotonic()
        run.walls.append(t1 - t0)
        run.stats.append(stats)
        sampler.offer(i, outs)
        i += 1
        if t1 - t_w >= seconds:
            break
    run.window_s = t1 - t_w
    run.in_window = False
    del outs

    if trace:
        from torch.profiler import ProfilerActivity
        reps = int(traffic.get("trace_reps", 5))
        host = [ProfilerActivity.CPU]
        device = [ProfilerActivity.CUDA] if cuda else host
        # the device alone first: the profiler then records no host
        # operation, and the schedules' host wall is the traced window
        prof, wall, last = traced(entry, run, device, reps)
        run.trace = dict(trace_mod.device_summary(
            trace_mod.events_of(prof, os.path.join(tmp, "trace.json"))),
            window_s=wall, reps=reps)
        # then the host as well, only to name the device's idle gaps
        run.annotate = True
        prof, _, _ = traced(entry, run, host + (device if cuda else []),
                            reps)
        run.annotate = False
        run.trace["idle_gaps"] = trace_mod.idle_gaps(
            trace_mod.events_of(prof, os.path.join(tmp, "trace.json")))
        del prof
        sampler.kept["traced"] = last
        del last

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell.get("chips", 1)),
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if cuda else 0}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell["name"], kind):
        v = metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace and run.trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]

    # the program's state goes before the reference runs
    entry.close()
    del entry
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.monotonic()
    ans = mod.reference(cfg, seed)
    ref_s = time.monotonic() - t_ref
    totals = {k: 0 for k in mod.CHECKS}
    failed = 0
    for outs in sampler.kept.values():
        got = mod.compare(outs, ans)
        failed += any(got.values())
        for k, v in got.items():
            totals[k] += v
    checks = {k: {"value": v, "limit": 0} for k, v in totals.items()}
    result = {"correct": not failed, "attempted": len(run.walls),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and run.trace:
        result["breakdown"] = {k: run.trace[k]
                               for k in ("device_ops", "idle_gaps")}
    result["info"] = {"compared": len(sampler.kept), "reference_s": ref_s,
                      "window_s": run.window_s, "shape": run.shape,
                      "spans_s": {k: sum(v) for k, v in run.spans.items()}}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        sys.stderr.write("no workload %r in BENCHMARK.json\n" % args.workload)
        return 2
    cell = cells[args.workload]
    cfg = load_json(HERE, "configs", cell["config"] + ".json")
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell.get("chips", 1)):
        sys.stderr.write("this cell needs %d CUDA device(s); found %d\n" % (
            int(cell.get("chips", 1)),
            torch.cuda.device_count() if torch.cuda.is_available() else 0))
        return 3
    from .harness import Run
    from .inputs import synth
    run = Run()
    tmp = tempfile.mkdtemp(prefix="gpubench-")
    try:
        shape = synth.shape_of(cfg)
        with run.span("draw"):
            files = synth.write_corpus(
                shape, args.seed, os.path.join(tmp, "paf"),
                workers=max(1, min(8, os.cpu_count() or 1, shape.n_genome)))
        result = run_cell(bench, cell, cfg, traffic, args.seed,
                          args.seconds, bool(args.trace), files, run,
                          tmp=tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        sys.stderr.write("loaded forbidden modules: %s\n" % " ".join(bad))
        return 4
    for name, c in result["checks"].items():
        sys.stderr.write("check %s %s limit %s\n"
                         % (name, c["value"], c["limit"]))
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
