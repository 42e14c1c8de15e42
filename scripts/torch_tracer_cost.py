"""What the schedule driver's tracer (pangene_tpu_torch.util.Tracer) costs on
one CUDA card, on a gpubench configuration's corpus:

  1. device_loop.run_packed with `stats` (the tracer on: host-clock spans and
     the blocks' CUDA events), with `stats` and the spans alone (no CUDA
     event: "spans"), and with stats=None (off), in rotating blocks of
     schedules, each block's wall ended by a synchronise;
  2. schedules traced by torch.profiler (host and device), with the
     tracer's annotations ("pg.<name>") against the same tracer with them
     left out, in turns.

    python3 scripts/torch_tracer_cost.py [--config human2] [--seed 7]
        [--blocks 10] [--reps 50] [--turns 4] [--device cuda]

From the root of a checkout (--device cpu rehearses it with the kernels'
plain versions; its times are not the card's); prints one JSON line: ms a
schedule of each side (medians over the blocks or turns, and every block),
spans a schedule."""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="human2")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--blocks", type=int, default=10)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
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
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    cfg = R.load_json(R.HERE, "configs", args.config + ".json")
    tmp = tempfile.mkdtemp(prefix="tracer-cost-")
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

    tracer = util.Tracer
    made = []

    class HostOnly(tracer):
        """The same tracer without the blocks' CUDA events."""
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.cuda = False

    def block(mode: str, n: int) -> float:
        util.Tracer = HostOnly if mode == "spans" else tracer
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            dl.run_packed(pk, mesh, None if mode == "off" else {})
        sync()
        util.Tracer = tracer
        return 1e3 * (time.perf_counter() - t0) / n

    modes = ("on", "spans", "off")
    walls = {m: [] for m in modes}
    for k in range(args.blocks):
        for m in modes[k % 3:] + modes[:k % 3]:
            walls[m].append(block(m, args.reps))

    class Counted(tracer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    class Bare(tracer):
        """The same tracer, its profiler annotations left out."""
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._profiling = None

    util.Tracer = Counted
    dl.run_packed(pk, mesh, {})
    spans = sum(len(t.names) for t in made)

    def traced(n: int = 5, warm: int = 2) -> float:
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=warm, active=n, repeat=1)) as prof:
            for _ in range(warm):
                dl.run_packed(pk, mesh, {})
                prof.step()
            sync()
            t0 = time.perf_counter()
            for k in range(n):
                dl.run_packed(pk, mesh, {})
                if k < n - 1:
                    prof.step()
            sync()
            wall = time.perf_counter() - t0
        return 1e3 * wall / n

    prof_walls = {"annotated": [], "bare": []}
    try:
        for k in range(args.turns):
            for ann in ((True, False) if k % 2 == 0 else (False, True)):
                util.Tracer = tracer if ann else Bare
                prof_walls["annotated" if ann else "bare"].append(traced())
    finally:
        util.Tracer = tracer
    med = {k: statistics.median(v) for k, v in {**walls, **prof_walls}.items()}
    print(json.dumps({
        "config": args.config, "seed": args.seed,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "spans_a_schedule": spans,
        "ms_a_schedule": med,
        "tracer_on_minus_off_ms": med["on"] - med["off"],
        "spans_minus_off_ms": med["spans"] - med["off"],
        "annotations_ms": med["annotated"] - med["bare"],
        "blocks": walls, "profiled": prof_walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
