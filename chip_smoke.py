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
     Then the batched entry of the kernel (all genomes of the device
     loop's [G, H] columns in one launch) against its plain version, the
     split sweep forms, on random genome sets and on the edge cases stacked
     as genomes of one batch (with an empty genome and one whose row 0 is
     filtered).
  3. the main paths: the CLI on cuda over the small (32 genomes x 2,000
     genes, seed 11) and the big (64 x 10,000, seed 7) synthetic corpora,
     first with --engine device (one sweep launch per genome, host rounds),
     then with --engine sharded (the device-resident pruning loop). Each
     GFA's md5 must be the reference binary's. Launch counts are zeroed
     before and read after each run: no plain call; on the sharded path
     the loop engaged and launched the batched kernel once per sweep round.
     For the loop it prints its diagnostics (shape, stage times, rounds run,
     host reads a round, device ms per block, peak device memory).
  4. the kernel against the plain version on the largest genome of the big
     corpus (the main path's shapes), unfiltered and in the run's final
     filter state. Kernel time is the device time per launch of 200
     launches replayed from one CUDA graph; beside it the least time the
     card could take for the same work. The same for the batched entry on
     the big run's device-resident columns, and colsort_i64 against
     torch.sort at the loop's merge key count.

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


def compare_batched(sk, de, genomes, dev, check_strand, f, split_form):
    """The batched kernel on `genomes` stacked into one batch: against its
    plain version (the split sweep forms) on the whole batch when
    `split_form`, and against the per-genome plain version genome by
    genome; rows past a genome's end must come back empty. Returns the
    number of marked rows; raises on any difference."""
    from pangene_tpu_torch.testing import batch_cols
    bc, flt, weak, W = batch_cols(genomes, dev)
    got = sk.shadow_sweep_batched(bc, flt, weak, W, check_strand, f)
    if split_form:
        want = sk.shadow_sweep_batched_plain(bc, flt, weak, W, check_strand,
                                             f)
        for name, a, b in zip(("marks", "score", "other"), got, want):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError("batched kernel != split-form plain: "
                                     "%s (strand %s, f %s)"
                                     % (name, check_strand, f))
    marks, score, other = got
    for j, (d, g) in enumerate(genomes):
        n = g.n_hit
        m, s, o, _ = sk.shadow_sweep_plain(de.build_cols(d, g, dev), W,
                                           sk.SHADOW, check_strand, f)
        same = (torch.equal(marks[j, :n], m) and torch.equal(score[j, :n], s)
                and torch.equal(other[j, :n], o)
                and not bool(marks[j, n:].any())
                and bool((score[j, n:] == sk.SCORE_NONE).all())
                and bool((other[j, n:] == sk.OTHER_NONE).all()))
        if not same:
            raise AssertionError("batched kernel != per-genome plain: genome "
                                 "%d of %d (n %d, W %d, strand %s, f %s)"
                                 % (j, len(genomes), n, W, check_strand, f))
    torch.cuda.synchronize()
    return int(marks.sum())


def bound_batched_ms(bc, flt, W, check_strand):
    """Least time for one batched sweep on these inputs: the bytes it must
    move (for every hit row the SHADOW input columns, hit_bytes; 8 bytes an
    exon of those rows; the three [G, H] output planes, 13 bytes a row,
    padding included since the kernel must write it) over the memory rate,
    or the integer operations these inputs need (as bound_ms counts them,
    summed over genomes) over the INT32 rate, whichever is larger."""
    c = {k: v.cpu().numpy() for k, v in bc._asdict().items()}
    fl = flt.cpu().numpy() != 0
    G, H = c["cid"].shape
    rows = int(c["n_rows"].sum())
    n_exon = sum(int(c["n_exon"][g, :c["n_rows"][g]].sum()) for g in range(G))
    nbytes = (rows * (50 + (1 if check_strand else 0)) + 4 * G
              + n_exon * EXON_BYTES + G * H * 13)
    ops = 0
    for g in range(G):
        n = int(c["n_rows"][g])
        ne = c["n_exon"][g, :n].astype(np.int64)
        for d in range(1, min(W, n - 1) + 1):
            i, j = slice(d, n), slice(0, n - d)
            m = ((c["cid"][g, j] == c["cid"][g, i])
                 & (c["ce"][g, j] > c["cs"][g, i]) & ~fl[g, i] & ~fl[g, j])
            if check_strand:
                m &= c["rev"][g, j] == c["rev"][g, i]
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


def run_cli(files, engine="device"):
    """The user's entry point on cuda with `engine`; returns (GFA text,
    final graph)."""
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
            cli.main(["--device", DEVICE, "--engine", engine, "-v", "1"]
                     + files)
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
    from pangene_tpu_torch.ops import device as tdev
    from pangene_tpu_torch.parallel import device_loop as dl
    from pangene_tpu_torch.testing import (SWEEP_EDGE_CASES, random_genome,
                                           stacked_edge_cases,
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

    # 2c. the batched entry: random genome sets, then the edge cases as
    # genomes of one batch
    t0 = time.monotonic()
    n_cases = 0
    sizes = (3000, 700, 0, 64, 65, 1, 1300, 2500)
    for seed0 in (0, 100):
        genomes = [random_genome(np.random.default_rng(seed0 + k), n_hits=n,
                                 weak=True, max_exon=6, max_cs=30 * n + 100)
                   for k, n in enumerate(sizes)]
        for check_strand in (False, True):
            for f in (0.5, 0.3):
                if not compare_batched(sk, de, genomes, dev, check_strand, f,
                                       True):
                    raise AssertionError("batched sweep marked nothing")
                n_cases += 1
    for which, genomes in stacked_edge_cases().items():
        compare_batched(sk, de, genomes, dev, False, 0.3, False)
        # the split form's [G, H, K, K] exon block cannot hold the hit with
        # 2,000 exons; every other genome is held against it too
        compare_batched(sk, de, [(d, g) for d, g in genomes
                                 if int(g.hits.n_exon.max(initial=0)) < 100],
                        dev, False, 0.3, True)
        n_cases += 2
        log("  stacked edge cases '%s': %d genomes, batched kernel == plain"
            % (which, len(genomes)))
    log("batched entry: %d cases, kernel == plain (%.1f s)"
        % (n_cases, time.monotonic() - t0))

    # 3. the main paths, counts zeroed just before and read just after
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
    batched_launches = 0
    runs = {}
    graph = None
    # the loop's device tensors of the last sharded run, for phase 4
    kept = {}
    schedule_device = dl.schedule_device

    def keep_schedule(*a, **kw):
        outs = schedule_device(*a, **kw)
        kept.update(blocks=a[:5], cfg=kw["cfg"], outs=outs)
        return outs

    dl.schedule_device = keep_schedule
    for name in ("small", "big"):
        t0 = time.monotonic()
        files = make_corpus(name)
        gen_s = time.monotonic() - t0
        sweep_s["s"] = 0.0
        sk.reset_counts()
        t0 = time.monotonic()
        gfa, graph = run_cli(files, "device")
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
        if sk.n_batched["kernel"] or sk.n_batched["plain"]:
            raise AssertionError("the per-genome path ran the batched sweep")
        for m in launches:
            launches[m] += counts[m]

        # the same corpus through the device-resident loop
        sweep_s["s"] = 0.0
        sk.reset_counts()
        dl.LAST.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        gfa, graph = run_cli(files, "sharded")
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = dict(sk.n_kernel_launches)
        plain = dict(sk.n_plain_calls)
        batched = dict(sk.n_batched)
        last = dict(dl.LAST)
        md5 = hashlib.md5(gfa.encode()).hexdigest()
        key = name + "_sharded"
        runs[key] = {
            "md5": md5, "wall_s": round(wall, 3),
            "stages": dict(util.stage_stats),
            "per_genome_sweep_s": round(sweep_s["s"], 3),
            "launches": {sk.MODE_NAMES[m]: counts[m] for m in counts},
            "batched_launches": batched["kernel"],
            "plain_calls": sum(plain.values()) + batched["plain"],
            "host_syncs_a_round": round(
                last.get("host_syncs", 0) / max(last.get("rounds_total", 1),
                                                1), 3),
            "peak_device_bytes": peak, "LAST": last}
        log("e2e %s: %s" % (key, json.dumps(runs[key])))
        if md5 != CORPORA[name][3]:
            raise AssertionError("%s corpus GFA md5 %s != %s (sharded)"
                                 % (name, md5, CORPORA[name][3]))
        if last.get("engaged") is not True:
            raise AssertionError("the device loop did not engage: %s" % last)
        if runs[key]["plain_calls"]:
            raise AssertionError("plain calls on the card path: %s %s"
                                 % (plain, batched))
        if batched["kernel"] == 0 or \
                batched["kernel"] != last["rounds_sweep_run"] or \
                batched["kernel"] != last["sweep_launches"]:
            raise AssertionError("batched launches %d != sweep rounds run %d"
                                 % (batched["kernel"],
                                    last["rounds_sweep_run"]))
        if any(v == 0 for v in counts.values()):
            raise AssertionError("phase 1 of the sharded run did not launch "
                                 "the per-genome kernel: %s" % counts)
        batched_launches += batched["kernel"]
        for m in launches:
            launches[m] += counts[m]
    dispatch.shadow, dispatch.flt_ov_isoform = untimed
    dl.schedule_device = schedule_device

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

    # 4b. the batched entry on the big run's device-resident columns: entry
    # state (no kept row filtered) and the loop's final state
    cfg = kept["cfg"]
    cols, bc = dl.unpack_blocks(*kept["blocks"])
    rec = {"name": "shadow_sweep_batched", "route": "cuda",
           "source": "pangene_tpu_torch/csrc/shadow_sweep.cu",
           "replaces": "pangene_tpu/ops/device.py:232",
           "launches": batched_launches, "max_abs_err": 0,
           "library_ms": None}
    G, H = bc.cid.shape
    for state, flt, weak in (
            ("entry", cols["flt"].contiguous(), cols["weak_br"].contiguous()),
            ("final", kept["outs"][0].contiguous(),
             kept["outs"][1].contiguous())):
        got = sk.shadow_sweep_batched(bc, flt, weak, cfg.W, cfg.check_strand,
                                      cfg.min_ov_ratio)
        geo = {}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        want = sk.shadow_sweep_batched_plain(
            bc, flt, weak, cfg.W, cfg.check_strand, cfg.min_ov_ratio, geo)
        torch.cuda.synchronize()
        plain_first_ms = 1e3 * (time.monotonic() - t0)
        for a, b in zip(got, want):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError("batched kernel != plain on the big "
                                     "run's columns (%s state)" % state)

        def kernel():
            sk.shadow_sweep_batched(bc, flt, weak, cfg.W, cfg.check_strand,
                                    cfg.min_ov_ratio)
        ms = graph_ms(kernel, TIMED_LAUNCHES)
        eager_ms = stream_ms(kernel, TIMED_LAUNCHES)
        # the plain version's round pass alone (its planes are in `geo`)
        plain_round_ms = stream_ms(lambda: sk.shadow_sweep_batched_plain(
            bc, flt, weak, cfg.W, cfg.check_strand, cfg.min_ov_ratio, geo), 5)
        b_ms, b_by, ops, nbytes = bound_batched_ms(bc, flt, cfg.W,
                                                   cfg.check_strand)
        log("BATCHED %s: G %d H %d rows %d W %d blocks %d ms %.5f (eager "
            "back-to-back %.5f) plain_ms %.3f (geometry pass + round pass; "
            "round pass alone %.3f) bound_ms %.6f (%s; %d ops, %d bytes) "
            "marked %d" % (state, G, H, int(bc.n_rows.sum()), cfg.W,
                           G * -(-H // sk.tile_shape()[0]), ms, eager_ms,
                           plain_first_ms,
                           plain_round_ms, b_ms, b_by, ops, nbytes,
                           int(got[0].sum())))
        if state == "entry":
            rec.update(ms=ms, plain_ms=plain_first_ms,
                       plain_round_ms=plain_round_ms, bound_ms=b_ms,
                       bound_by=b_by)
        else:
            rec["ms_final"] = ms
    kernels.append(rec)

    # 4c. colsort_i64 against torch.sort at the loop's merge key count
    n_keys = G * 2 * H
    c = tdev.colsort_cols(n_keys)
    keys = torch.randperm(n_keys, device=dev, dtype=torch.int64) * 977 - 5
    if c:
        if not torch.equal(tdev.colsort_i64(keys, c),
                           torch.sort(keys).values):
            raise AssertionError("colsort_i64 != torch.sort")
        log("sort of %d int64 keys: torch.sort %.4f ms, colsort_i64 (%d "
            "columns) %.4f ms" % (
                n_keys, stream_ms(lambda: torch.sort(keys), 20), c,
                stream_ms(lambda: tdev.colsort_i64(keys, c), 20)))
    else:
        log("sort of %d int64 keys: torch.sort %.4f ms; columnsort has no "
            "valid column count here" % (
                n_keys, stream_ms(lambda: torch.sort(keys), 20)))
    kept.clear()

    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
