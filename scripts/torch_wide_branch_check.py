"""The branch block on every round's arc table of an mtb152 schedule, on
the card. One schedule of the benchmark's entry (gpubench/entries/
schedule.py: the timed path, after a warm one) runs with each branch_block
launch captured (its inputs before and its outputs after, copied); each
launch's outputs are held bit for bit against the plain reference
(pangene_tpu_torch/plain_branch.py, run on the card) and against the
kernel's plain version, and the kernel is timed on each table (CUDA events
around 20 launches). Then the CLI on the same corpus, each build in a
process of its own: the device loop's (--engine sharded) against the host
rounds' (--engine host), byte for byte, with the loop's LAST; with
--parent DIR also that checkout's build (its loop falls back here), for
the wall it costs.

    python3 scripts/torch_wide_branch_check.py [--seed N] [--parent DIR]
        [--out FILE] [--device cpu --draw JSON]

--device cpu with a smaller --draw (keys of the configuration's "draw")
rehearses it on the CPU (the kernel's part then times the plain version).

Prints one line a launch and a last JSON line (also written to --out).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TAG = "RANK_REPORT="


def cli_build(cwd: str, files, *args) -> dict:
    """The CLI (-J, as the configuration's build) in a process of its own
    under `cwd`'s package: its report (testing.rank_report_main)."""
    r = subprocess.run(
        [sys.executable, "-m", "pangene_tpu_torch.testing", "-J", "-v", "1",
         *args, *files], cwd=cwd, capture_output=True, text=True,
        timeout=1800)
    lines = [x for x in r.stderr.splitlines() if x.startswith(TAG)]
    if r.returncode or not lines:
        raise RuntimeError("CLI build under %s failed (%d): %s"
                           % (cwd, r.returncode, r.stderr[-3000:]))
    rep = json.loads(lines[-1][len(TAG):])
    last = rep["LAST"]
    keep = ("engaged", "reason", "branch_max_group", "branch_wide_groups",
            "run_s", "upload_s", "pull_s", "pack_s")
    return dict(md5=rep["md5"], wall_s=rep["wall_s"],
                stages=rep["stages"], LAST={k: last.get(k) for k in keep})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--draw", default="{}")
    args = ap.parse_args(argv)
    from gpubench.inputs import synth
    cfg = json.load(open(os.path.join(ROOT, "gpubench", "configs",
                                      "mtb152.json")))
    cfg["draw"].update(json.loads(args.draw))
    dev = ["--device", args.device] if args.device != "cuda" else []
    tmp = tempfile.mkdtemp(prefix="wide-check-")
    files = synth.write_corpus(synth.shape_of(cfg), args.seed,
                               os.path.join(tmp, "paf"),
                               workers=min(8, os.cpu_count() or 1))
    res = {"seed": args.seed, "cli": {}}
    # the CLI builds first: this process has not touched CUDA yet
    res["cli"]["sharded"] = cli_build(ROOT, files, *dev)
    res["cli"]["host"] = cli_build(ROOT, files, "--engine", "host")
    if args.parent:
        res["cli"]["parent_sharded"] = cli_build(args.parent, files, *dev)
    res["cli_md5_equal"] = (res["cli"]["sharded"]["md5"]
                            == res["cli"]["host"]["md5"])
    print("CLI", json.dumps(res["cli"]), flush=True)

    import torch
    from gpubench.entries.schedule import Entry
    from gpubench.harness import Run
    from pangene_tpu_torch import plain_branch, util
    from pangene_tpu_torch.ops import loop_kernels as lk
    from pangene_tpu_torch.options import PgOpt
    util.verbose = 0
    entry = Entry(PgOpt(device=args.device, **cfg["options"]), files,
                  Run())
    run = Run()
    entry.once(run, stats={})
    caps = []
    orig = lk.bind_branch_block

    def bind(*a, **kw):
        b = orig(*a, **kw)

        def launch(*xs):
            before = [x.clone() for x in xs]
            out = b.launch(*xs)
            sync()
            caps.append((before, [o.clone() for o in out], kw))
            return out
        return lk.Bound(launch, b.out)

    cuda = args.device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    lk.bind_branch_block = bind
    stats: dict = {}
    try:
        entry.once(run, stats=stats)
    finally:
        lk.bind_branch_block = orig
    rounds = []
    for r, (xs, got, kw) in enumerate(caps):
        kw = {k: v for k, v in kw.items() if k not in ("tally", "scratch")}
        want = plain_branch.mark_branch(*xs[:7], **kw)
        plain = lk.branch_block_plain(*xs[:7], **kw)
        sync()
        ref_eq = all(torch.equal(a, b) for a, b in zip(got, want))
        plain_eq = all(torch.equal(a, b) for a, b in zip(plain, want))
        gs_of, _, branching, _ = lk.arc_groups(xs[5], xs[6], kw["B"])
        n = torch.unique_consecutive(gs_of[branching],
                                     return_counts=True)[1]
        bound = orig(*xs[:7], **kw)
        cnt = torch.zeros(2, dtype=torch.int64, device=xs[0].device)
        for _ in range(3):
            bound.launch(*xs[:7], cnt)
        t0 = time.perf_counter()
        if cuda:
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
        for _ in range(20):
            bound.launch(*xs[:7], cnt)
        if cuda:
            e1.record()
        sync()
        ms = e0.elapsed_time(e1) if cuda else \
            (time.perf_counter() - t0) * 1e3
        line = dict(launch=r, A=int(xs[5].numel()),
                    valid=int((xs[5] != lk.SENT_I).sum()),
                    branching=int(branching.sum()),
                    widest=int(n.max()) if n.numel() else 0,
                    wide=int((n > lk.WIDE_ROWS).sum()),
                    counts=got[2].tolist(), kernel_eq_reference=ref_eq,
                    plain_eq_reference=plain_eq,
                    kernel_ms=ms / 20)
        rounds.append(line)
        print("LAUNCH", json.dumps(line), flush=True)
    res.update(device=torch.cuda.get_device_name(0) if cuda else "cpu",
               launches=len(rounds),
               all_equal=all(x["kernel_eq_reference"]
                             and x["plain_eq_reference"] for x in rounds),
               stats={k: stats.get(k) for k in (
                   "branch_valid_arcs", "branch_branching_arcs",
                   "branch_wide_groups", "branch_max_group", "host_syncs")},
               rounds=rounds)
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(text + "\n")
    print(text)
    return 0 if res["all_equal"] and res["cli_md5_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
