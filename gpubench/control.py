"""The control of the benchmark's correctness check: the reference put in
the program's place, computed in float32 (the configuration states IEEE
double: the reference's rounded averages and ratios), judged by the same
comparison against the reference in double. It must come out not correct.

    python3 -m gpubench.control --workload <name> --seeds <n,n,...>

Prints one JSON line a seed: the mismatch counts of the control and the
seconds each side took. Needs no card (the reference runs on the host).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .reference import answer, compare
from .run import HERE, ROOT, load_json


def control(cfg: dict, seed: int) -> dict:
    t0 = time.monotonic()
    ref = answer.loop(cfg, seed)
    t1 = time.monotonic()
    low = answer.loop(cfg, seed, ftype=np.float32)
    t2 = time.monotonic()
    got = compare.compare_loop(compare.as_outputs(low), ref)
    got.update(seed=seed, reference_s=t1 - t0, control_s=t2 - t1)
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg = load_json(HERE, "configs", cell["config"] + ".json")
    for s in args.seeds.split(","):
        print(json.dumps(dict(workload=args.workload,
                              **control(cfg, int(s)))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
