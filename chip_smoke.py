#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (pangene_tpu_torch) on one NVIDIA
GPU. Run from the root of a checkout:

    python3 chip_smoke.py

Phases (each one passes or raises, so any failure exits nonzero):
  1. the card's name and power limit (nvidia-smi); the CUDA kernel is built
     from pangene_tpu_torch/csrc/ with nvcc.
  2. the kernel against its plain PyTorch version on the card, both modes,
     on random genomes from numpy seeds, then on the kernel's edge cases
     (tile edges, a band wider than the staged halo, a hit with 2,000
     exons, every hit filtered, one dense cluster, coordinates beyond
     2^31): all four outputs exactly equal. The kernel is called through
     shadow_sweep_packed, the main path's entry, on a packed upload.
  3. the main path: the CLI on cuda over the small (32 genomes x 2,000
     genes, seed 11) and the big (64 x 10,000, seed 7) synthetic corpora.
     Each GFA's md5 must be the reference binary's. Launch counts are zeroed
     before and read after each run: both modes launched, no plain call.
  4. the kernel against the plain version on the largest genome of the big
     corpus (the main path's shapes), unfiltered and in the run's final
     filter state. Kernel time is the device time per launch of 200
     launches replayed from one CUDA graph; beside it the least time the
     card could take for the same work.

Before the last line it prints the nvidia-smi line and one JSON line with a
record per kernel; the last line is {"ok": true, "device": {...}}. Without
a CUDA device it exits 2 and prints no result. Corpora and build outputs go
to build/ (git-ignored).
"""
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
CORPORA = {  # name: (n_genome, n_gene, seed, md5 of the reference's GFA)
    "small": (32, 2000, 11, "4e077812357fa691683bea45c7831a8c"),
    "big": (64, 10000, 7, "b988fc85e7633316be354ab315a0449c"),
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
# Integer peak: the sweep's work is INT32 / INT64 compares, adds and
# min/max. Hopper has 64 INT32 lanes per SM (against 128 FP32 lanes), so the
# rate is 132 SMs x 64 lanes x 1.98 GHz (the H100 SXM boost clock) =
# 1.67e13 operations/s, a quarter of the 67e12 FP32 FMA FLOP figure. An
# int64 compare or add counts as two operations.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
EXON_BYTES = 8              # exon_os + exon_oe, int32 each
TIMED_LAUNCHES = 200


def hit_bytes(sk, mode, check_strand):
    """(in, out) bytes a hit that the function needs, by mode: both modes
    read cid, cs, ce, flt, gid, pscore, rank, off_exon, n_exon (45 bytes)
    and rev only when strands are checked; SHADOW also reads weak and
    cds_len and its caller reads all four outputs (17 bytes); ISOFORM's
    caller reads the marks alone (1 byte)."""
    strand = 1 if check_strand else 0
    if mode == sk.SHADOW:
        return 50 + strand, 17
    return 45 + strand, 1


def log(msg):
    print(msg, flush=True)


def stream_ms(fn, reps):
    """Wall on the card per call of `fn`, over `reps` back-to-back calls on
    the current stream after a warm-up (CUDA events around the run). When
    the host enqueues slower than the card runs, this is the enqueue
    rate."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps):
    """Device time per call of `fn`: `reps` calls captured in one CUDA graph,
    replayed once to warm up and once between CUDA events, so the host's
    launch cost stays out of the number."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def compare(sk, buf, n, E, W, mode, check_strand, f):
    """The kernel through the main path's entry (shadow_sweep_packed) on a
    packed upload, against the plain version on views of the same buffer;
    returns the largest absolute difference over the four outputs (must be
    0)."""
    got = sk.unpack_out(sk.shadow_sweep_packed(buf, n, E, W, mode,
                                               check_strand, f), n)
    want = sk.shadow_sweep_plain(sk.unpack_cols(buf, n, E), W, mode,
                                 check_strand, f)
    torch.cuda.synchronize()
    err = 0
    for name, a, b in zip(("marks", "score", "other", "ov"), got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError("%s: %s %s vs plain %s %s" % (
                name, a.shape, a.dtype, b.shape, b.dtype))
        diff = (a.long() - b.long()).abs()
        if name == "score":   # biased int64: compare exactly, report 0/1
            diff = (a != b).long()
        err = max(err, int(diff.max()) if diff.numel() else 0)
    if err:
        raise AssertionError("kernel != plain (mode %s, strand %s, f %s): "
                             "max abs err %d" % (sk.MODE_NAMES[mode],
                                                 check_strand, f, err))
    return err


def bound_ms(sk, cols, W, mode, check_strand):
    """Least time for the sweep on these inputs: the bytes this mode needs
    (hit_bytes, plus the exons) read once and written once over the memory
    rate, or the integer operations these inputs need over the INT32 rate,
    whichever is larger. Operations: 5 for every band
    pair (two flt tests, the cid compare, the int64 ce > cs compare); for
    each pair that passes those (and, by mode, the strand and gene gates) 5
    more (strand and gene compares, the int64 score compare and the rank)
    and 4 per exon pair (max, min, compare, add on int32 offsets). The f64
    coverage division of cross-gene pairs is left out."""
    c = {k: v.cpu().numpy() for k, v in cols._asdict().items()}
    n = len(c["cid"])
    nbytes = (n * sum(hit_bytes(sk, mode, check_strand))
              + len(c["exon_os"]) * EXON_BYTES)
    ops = 0
    flt = c["flt"] != 0
    ne = c["n_exon"].astype(np.int64)
    for d in range(1, min(W, n - 1) + 1):
        i, j = slice(d, n), slice(0, n - d)
        m = ((c["cid"][j] == c["cid"][i]) & (c["ce"][j] > c["cs"][i])
             & ~flt[i] & ~flt[j])
        if check_strand:
            m &= c["rev"][j] == c["rev"][i]
        if mode == sk.ISOFORM:
            m &= c["gid"][j] == c["gid"][i]
        ops += (5 * (n - d) + 5 * int(m.sum())
                + 4 * int((ne[i] * ne[j])[m].sum()))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), ops, nbytes


def make_corpus(name):
    from pangene_tpu_torch.testing import synth_paf_files
    n_genome, n_gene, seed, _ = CORPORA[name]
    out = os.path.join(ROOT, "build", "chip_smoke",
                       "synth_%d_%d_%d" % (n_genome, n_gene, seed))
    done = os.path.join(out, "done")
    if not os.path.exists(done):
        synth_paf_files(out, n_genome=n_genome, n_gene=n_gene, n_iso=3,
                        seed=seed)
        with open(done, "w") as fp:
            fp.write("ok\n")
    return sorted(os.path.join(out, f) for f in os.listdir(out)
                  if f.endswith(".paf.gz"))


def run_cli(files):
    """The user's entry point on cuda; returns (GFA text, final graph)."""
    from pangene_tpu_torch import cli, pipeline
    graphs = []
    run = pipeline.run

    def keep(*a, **kw):
        graphs.append(run(*a, **kw))
        return graphs[-1]

    buf = io.StringIO()
    pipeline.run = keep
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(["--device", DEVICE, "-v", "1"] + files)
    finally:
        pipeline.run = run
    return buf.getvalue(), graphs[0]


def main():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 2
    sys.path.insert(0, ROOT)
    from pangene_tpu_torch import util
    from pangene_tpu_torch.ops import device_engine as de
    from pangene_tpu_torch.ops import dispatch
    from pangene_tpu_torch.ops import sweep_kernel as sk
    from pangene_tpu_torch.ops.sort import hit_sort
    from pangene_tpu_torch.testing import (SWEEP_EDGE_CASES, random_genome,
                                           sweep_edge_case)
    dev = torch.device(DEVICE)

    # 1. the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("card: %s | torch %s cuda %s" % (smi, torch.__version__,
                                         torch.version.cuda))
    build_s, ptxas = sk.build(force=True)
    log("build: nvcc %.2f s" % build_s)
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    # 2. kernel vs plain on random genomes
    t0 = time.monotonic()
    n_cases = 0
    for seed in range(6):
        for weak in (False, True):
            d, g = random_genome(np.random.default_rng(seed), n_hits=3000,
                                 weak=weak, max_exon=6, max_cs=100000)
            buf = de.upload(d, g, dev)
            n, E = g.n_hit, len(g.exon_os)
            W = sk.band_width(g.hits.cid, g.hits.cs, g.hits.ce)
            for check_strand in (False, True):
                compare(sk, buf, n, E, W, sk.ISOFORM, check_strand, 0.0)
                for f in (0.5, 0.3):
                    compare(sk, buf, n, E, W, sk.SHADOW, check_strand, f)
                n_cases += 3
    log("random genomes: %d cases, kernel == plain in both modes (%.1f s)"
        % (n_cases, time.monotonic() - t0))
    # 2b. the kernel's own edge cases: tile edges, the large-W path,
    # exons that outgrow shared memory, every hit filtered, a dense cluster
    t0 = time.monotonic()
    for case in SWEEP_EDGE_CASES:
        d, g = sweep_edge_case(case)
        buf = de.upload(d, g, dev)
        W = sk.band_width(g.hits.cid, g.hits.cs, g.hits.ce)
        for mode in sk.MODE_NAMES:
            compare(sk, buf, g.n_hit, len(g.exon_os), W, mode, False, 0.3)
        log("  edge %s: hits %d W %d exons %d, launch %s" % (
            case, g.n_hit, W, len(g.exon_os),
            json.dumps(sk.launch_shape(g.n_hit, W))))
    log("edge cases: %d, kernel == plain in both modes (%.1f s)"
        % (len(SWEEP_EDGE_CASES), time.monotonic() - t0))

    # 3. the main path, counts zeroed just before and read just after
    sweep_s = {"s": 0.0}

    def timed(fn):
        def wrapper(*a, **kw):
            t = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                sweep_s["s"] += time.monotonic() - t
        return wrapper

    untimed = (dispatch.shadow, dispatch.flt_ov_isoform)
    dispatch.shadow, dispatch.flt_ov_isoform = (timed(f) for f in untimed)
    launches = {m: 0 for m in sk.MODE_NAMES}
    runs = {}
    graph = None
    for name in ("small", "big"):
        t0 = time.monotonic()
        files = make_corpus(name)
        gen_s = time.monotonic() - t0
        sweep_s["s"] = 0.0
        sk.reset_counts()
        t0 = time.monotonic()
        gfa, graph = run_cli(files)
        wall = time.monotonic() - t0
        counts = dict(sk.n_kernel_launches)
        plain = dict(sk.n_plain_calls)
        md5 = hashlib.md5(gfa.encode()).hexdigest()
        runs[name] = {
            "hits": sum(g.n_hit for g in graph.d.genomes), "md5": md5,
            "wall_s": round(wall, 3), "sweep_s": round(sweep_s["s"], 3),
            "sweep_ms_per_call": round(
                1e3 * sweep_s["s"] / max(sum(counts.values()), 1), 4),
            "corpus_s": round(gen_s, 3), "stages": dict(util.stage_stats),
            "launches": {sk.MODE_NAMES[m]: counts[m] for m in counts},
            "plain_calls": {sk.MODE_NAMES[m]: plain[m] for m in plain}}
        log("e2e %s: %s" % (name, json.dumps(runs[name])))
        if md5 != CORPORA[name][3]:
            raise AssertionError("%s corpus GFA md5 %s != %s"
                                 % (name, md5, CORPORA[name][3]))
        if any(v == 0 for v in counts.values()) or any(plain.values()):
            raise AssertionError("main path did not run on the kernel: "
                                 "launches %s, plain calls %s"
                                 % (counts, plain))
        for m in launches:
            launches[m] += counts[m]
    dispatch.shadow, dispatch.flt_ov_isoform = untimed

    # 4. the largest big-corpus genome: compare, time, bound
    g = max(graph.d.genomes, key=lambda x: x.n_hit)
    hit_sort(g, by_cm=False)
    kernels = []
    states = {"unfiltered": np.zeros_like(g.hits.flt),
              "final": g.hits.flt.copy()}
    for mode, replaces in ((sk.SHADOW, "pangene_tpu/ops/pallas_sweep.py:57"),
                           (sk.ISOFORM, "pangene_tpu/ops/device.py:212")):
        rec = {"name": "shadow_sweep[%s]" % sk.MODE_NAMES[mode],
               "route": "cuda",
               "source": "pangene_tpu_torch/csrc/shadow_sweep.cu",
               "replaces": replaces, "launches": launches[mode],
               "max_abs_err": 0, "library_ms": None}
        for state, flt in states.items():
            g.hits.flt[:] = flt
            n, E = g.n_hit, len(g.exon_os)
            buf = de.upload(graph.d, g, dev)
            cols = sk.unpack_cols(buf, n, E)
            W = sk.band_width(g.hits.cid, g.hits.cs, g.hits.ce)
            err = compare(sk, buf, n, E, W, mode, False, 0.5)

            def kernel():
                sk.shadow_sweep_packed(buf, n, E, W, mode, False, 0.5)
            ms = graph_ms(kernel, TIMED_LAUNCHES)
            eager_ms = stream_ms(kernel, TIMED_LAUNCHES)
            plain_ms = stream_ms(lambda: sk.shadow_sweep_plain(
                cols, W, mode, False, 0.5), 5)
            b_ms, b_by, ops, nbytes = bound_ms(sk, cols, W, mode, False)
            log("%s %s: hits %d W %d ms %.5f (eager back-to-back %.5f) "
                "plain_ms %.3f bound_ms %.6f (%s; %d ops, %d bytes) launch %s"
                % (sk.MODE_NAMES[mode], state, n, W, ms, eager_ms, plain_ms,
                   b_ms, b_by, ops, nbytes,
                   json.dumps(sk.launch_shape(n, W))))
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if state == "unfiltered":
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by)
            else:
                rec["ms_final"] = ms
        kernels.append(rec)
    g.hits.flt[:] = states["final"]

    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
