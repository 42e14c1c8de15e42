#!/usr/bin/env python3
"""Two checkouts of the PyTorch / CUDA port on one card, in turns: the
device loop's warm block_ms and run_s on chip_smoke.py's big and
north-star corpora, and the per-round path's (PANGENE_DEVICE_LOOP=0)
step_s and block_ms on big. Run from the root of a checkout (the corpora
are drawn as chip_smoke.py draws them, or taken from its cache,
build/chip_smoke/):

    python3 scripts/torch_step_compare.py --parent archive_check/parent

(unpack the parent there with `git archive <commit> | tar -x -C
archive_check/parent`). The turns are parent, change, change, parent, each
a process of its own that imports its checkout's package only; in a turn
every path runs twice on the card and the second (warm) run is kept. Each
run's GFA md5 must be the corpus's. Prints the card, one JSON line a turn
and, last, the per-checkout best of each number.
"""
import argparse
import contextlib
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (corpus, path, environment) of a turn, in order
RUNS = (("big", "loop", {}), ("big", "rounds", {"PANGENE_DEVICE_LOOP": "0"}),
        ("northstar", "loop", {}))


def chip_smoke():
    """This checkout's chip_smoke.py (its corpora), whatever the path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_corpora", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root):
    """One turn: the RUNS of the checkout at `root`, twice each; prints
    one JSON line."""
    sys.path.insert(0, root)
    import torch
    from pangene_tpu_torch import cli
    from pangene_tpu_torch.parallel import device_loop as dl
    from pangene_tpu_torch.parallel import stacked as st
    cs = chip_smoke()
    out = {"root": root, "runs": {}}
    for name, path, env in RUNS:
        files, _, _ = cs.make_corpus(name, None)
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        for rep in range(2):
            md5 = hashlib.md5()

            class Sink:
                def write(self, text):
                    md5.update(text.encode())
                    return len(text)

                def flush(self):
                    pass
            dl.LAST.clear()
            st.LAST.clear()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            with contextlib.redirect_stdout(Sink()):
                cli.main(["--engine", "sharded", "-v", "0"] + files)
            wall = time.monotonic() - t0
            if md5.hexdigest() != cs.CORPORA[name].md5:
                raise AssertionError("%s %s: md5 %s" % (name, path,
                                                         md5.hexdigest()))
        for k, v in env.items():
            old_v = old[k]
            if old_v is None:
                del os.environ[k]
            else:
                os.environ[k] = old_v
        if path == "loop":
            last = dl.LAST
            if last.get("engaged") is not True:
                raise AssertionError("%s: the loop did not engage" % name)
            rec = {k: last[k] for k in ("run_s", "host_syncs", "block_ms",
                                        "rounds_total", "sweep_launches")}
        else:
            rec = {k: st.LAST[k] for k in ("rounds", "step_s", "pull_s",
                                           "block_ms", "sweep_launches")}
            rec["step_s_a_round"] = st.LAST["step_s"] / st.LAST["rounds"]
        rec["wall_s"] = round(wall, 3)
        out["runs"]["%s_%s" % (name, path)] = rec
    print("TURN=" + json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--worker")
    a = ap.parse_args()
    if a.worker:
        return worker(os.path.abspath(a.worker))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print("card: " + smi, flush=True)
    cs = chip_smoke()
    names = sorted({name for name, _, _ in RUNS})
    draws = {name: cs.start_draw(name) for name in names}
    for name in names:
        _, draw_s, _ = cs.make_corpus(name, draws[name])
        print("corpus %s: %s" % (name, "cached" if draw_s is None
                                 else "drawn in %.3f s" % draw_s), flush=True)
    parent = os.path.abspath(a.parent)
    turns = []
    for label, root in (("parent", parent), ("change", ROOT),
                        ("change", ROOT), ("parent", parent)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", root], cwd=root, capture_output=True,
                           text=True, timeout=900)
        if r.returncode:
            raise SystemExit("%s turn exited %d: %s" % (
                label, r.returncode, r.stderr[-3000:]))
        line = [x for x in r.stdout.splitlines() if x.startswith("TURN=")]
        turn = json.loads(line[-1][len("TURN="):])
        turn["label"] = label
        turns.append(turn)
        print(json.dumps(turn), flush=True)
    best = {}
    for turn in turns:
        b = best.setdefault(turn["label"], {})
        for key, rec in turn["runs"].items():
            for k, v in rec.items():
                if isinstance(v, dict):
                    for kk, vv in v.items():
                        name = "%s.%s.%s" % (key, k, kk)
                        b[name] = min(b.get(name, vv), vv)
                elif isinstance(v, float):
                    name = "%s.%s" % (key, k)
                    b[name] = min(b.get(name, v), v)
    print("BEST=" + json.dumps(best))


if __name__ == "__main__":
    sys.exit(main())
