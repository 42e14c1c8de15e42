#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (pangene_tpu_torch) on one NVIDIA
GPU. Run from the root of a checkout:

    python3 chip_smoke.py

Phases (each one passes or raises, so any failure exits nonzero):
  1. the card's name and power limit (nvidia-smi); the CUDA kernels are
     built from pangene_tpu_torch/csrc/ (shadow_sweep.cu, loop_blocks.cu,
     loop_round.cu, step_round.cu, mesh_round.cu), one nvcc for each
     source, started together, and the native host runtime
     (native/pgsweep.c, ops/sweep_native.py) with the host's C compiler:
     it must load, since the host rounds' branch marking, the phase-1 walk,
     the vertex scan and the L-line renderer take it on every card path.
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
     filtered); the same launch with each fused epilogue (the loop's:
     shadow and pid_dom in place; the per-round step's: shadow in place,
     the dominators and the sort key) against shadow_sweep_batched_plain
     then sweep_epilogue_plain, on random genome sets, the stacked edge
     cases and the batched tile's band widths, every output equal.
     Then (2d) the per-round device step (parallel/stacked.round_step: the
     batched sweep with filtered rows in place, the sort, the walk, the
     dedupe, the counters) on the card against the same step with the plain
     sweep and against the whole step on the CPU, on random genome sets and
     on the stacked edge cases: every output equal; and step_walk and
     step_dedupe (ops/step_kernels.py) against their plain versions on the
     step states (testing.STEP_STATES, the tile-crossing ones among them),
     use_ori on and off, at the most genes whose seen bits the old
     one-block-a-genome walk kept in shared memory and one past it, and
     inside a CUDA graph of three launches replayed twice on the tile
     states.
     Then (2e) the device loop's block kernels (ops/loop_kernels.py:
     branch_block and the mesh's branch_locality + branch_classify,
     merge_fold) against their plain versions on random arc tables (groups
     up to the window and one past it, 1 to 70 genomes, frag mode on and
     off, deficits on and beside the branch constants; branch_classify
     also alone on groups over several warps, its bit planes unaligned) and
     merge keys (the loop's three call shapes, the arc table smaller and
     larger than the out-groups, no valid row, out-groups over several
     tiles, dist sums past 2^31 and below 0), merge_fold lean and in its
     full mode (the full=True tail's statistics); then the round kernels
     (walk_pairs in its four key forms, branch_prep, prop_round with and
     without propagation, occ_round with and without the cuts and the loci)
     on random round states (testing.ROUND_STATES: random, cm gaps past
     2^31, empty genomes, every hit filtered, hit 0 filtered, every segment
     dead, a group at the window and one past it, 70 genomes over several
     of the scans' tiles, one genome whose hit 0 is filtered, a
     north-star-wide genome whose kept rows leave several tiles in a row
     empty, kept rows only at the tiles' edges, groups of D and D + 1 arcs
     across an arc block's end), every output exactly equal.
  3. the main paths: the CLI on cuda over four synthetic corpora (CORPORA):
     small (32 genomes x 2,000 genes, seed 11), the bacterial shape (150 x
     4,000, seed 13, one isoform, every hit one exon, built with -J), the
     north star (100 x 19,000, seed 42, 3,898,385 records) and big (64 x
     10,000, seed 7), in that order. Each corpus is drawn in a process of
     its own, all started with the run and cached under build/chip_smoke/;
     each draw's seconds are logged. Once its draw has ended, each corpus
     takes its in-process runs (IN_PROCESS): small's and bact's, then the
     genome mesh (3e), beside the north star's draw (BESIDE_DRAW); then the
     north star's and big's, then every corpus's builds in processes of
     their own (3c), so no draw runs beside those. In process: --engine device
     (one sweep launch per genome, host rounds; small and bact), --engine
     sharded (the device-resident pruning loop; big and northstar, whose
     device tensors phase 4 reads), --engine sharded with
     PANGENE_DEVICE_LOOP=0 (the per-round device step; bact, the north
     star and big) and a forced loop fallback (PANGENE_DEVLOOP_MAX_A=1;
     bact).
     Each GFA's md5 must be the reference binary's (bact: pangene_tpu's
     --engine host -J GFA of that draw). Launch counts and the native
     runtime's call counts are zeroed before and read after each run: no
     plain call; the per-genome kernel launched in both modes under
     --engine device and never under sharded, whose single-genome sweeps
     run in C as in the JAX package; the loop engaged and launched the
     batched kernel once per sweep round, branch_block once per branch
     round and merge_fold once per in-loop merge and once for the full=True
     tail, walk_pairs as merge_fold, branch_prep once per branch round,
     prop_round and occ_round once a round (no other path launches those;
     the mesh's split entries are not launched at one rank), the batched
     kernel always with the loop's fused epilogue; the per-round path
     launched the fused sweep (STEP), step_walk and step_dedupe once per
     round (17), uploaded its constant columns once, and the loop did not
     run; a
     fallback reported engaged false and ran 16 rounds; every path called
     the native entries it must take (NATIVE_ENTRIES), so a run that
     quietly fell back to NumPy fails. Each path prints its diagnostics
     (device_loop.LAST, stacked.LAST, the native call counts, the host
     rounds' split rounds_branch_host_s / rounds_gen_arc_s, peak device
     memory). After each per-round run, the protein-keyed reductions on
     the card (stacked.post_reductions_sharded) against the host loops of
     ops/pseudo.py.
  3c. the builds as a user runs them, each in a process of its own that
     imports no torch before the build (BUILD_SCRIPT): the default engine
     and --engine host on each corpus (small's only when big is left out:
     its card paths run in process and on the mesh), and after the last
     corpus big with
     --profile (the idle share of a user's traced build, the five device
     operations with most time). Each GFA's md5; the wall measured outside
     the process, split into the script's import, cli.main outside the
     stages (a card engine's torch import) and the interpreter's start and
     exit; its parse_s beside the in-process parse_s of the same path, and
     the parse pool's start method ("fork" unless CUDA was initialised
     before parsing); no draw may still run beside it. Each process
     reports the path it took, held as in phase 3: a default build engaged
     the loop (its shape, cold run_s, host_syncs, block_ms and peak device
     memory are printed) and launched its kernels as the in-process loop
     does, with no plain call; a host build never imported torch and called
     the host's native entries. Before the first, the start of a card
     engine's process, timed from inside (CUDA_START_PROBE).
  3d. the toolkit on the card's host: `call` and `gfa2matrix` of
     python -m pangene_tpu_torch.tools.cli on the GFA of the big corpus
     built by the default engine, each output's md5 against TOOL_MD5 (the
     JAX package's toolkit on the same GFA), each wall; and `call` on
     tests/golden/C4.gfa against tests/golden/bubble/C4.call.txt.
  3e. (run before the north star's in-process run, beside its draw) the
     genome mesh (parallel/mesh.py) on the small and big corpora, each
     run through the CLI in
     processes of its own, one per rank (testing.run_ranks, as torchrun
     starts them; every rank reports the md5 of the GFA it built, its
     device_loop.LAST, the mesh's collectives and staged bytes, its batched
     launches and peak device memory): gloo ranks sharing cuda:0
     (PANGENE_MESH_SHARE_DEVICE=1) on the small corpus at world 2 and 3 and
     with PANGENE_DEVICE_LOOP=0 at world 2, and on the big corpus at world 4
     (the bucket exchange: shard_merge and engaged asserted) and 2; the CLI's
     own --devices 2 on the small corpus; and the big corpus at world 1
     under torchrun (python -m torch.distributed.run --nproc-per-node 1):
     NCCL on the card. Every rank's md5 must be the reference's, no rank may
     fall back, launch the per-genome kernel or call a plain version, each
     rank of a loop run launches the block kernels as the in-process loop
     does (at world > 1 branch_locality and branch_classify once a branch
     round in place of branch_block), every rank at world > 1 launches
     protein_reduce once (post_process's reductions) and at world > 2
     exchange_pack, exchange_window and exchange_finish once an in-loop
     merge (the bucket exchange; EXCHANGE_RUNS' ranks 16 times each), and
     a rank that does not end within its own timeout fails the run.
  4. the kernel against the plain version on the largest genome of the big
     corpus (the main path's shapes), unfiltered and in the run's final
     filter state. Kernel time is the device time per launch of 200
     launches replayed from one CUDA graph; beside it the least time the
     card could take for the same work. The same for the batched entry on
     the big run's device-resident columns and on the per-round path's full
     [G, H] stack in the run's final filter state, colsort_i64 against
     torch.sort at the loop's merge key count, the least time of each block
     of the loop and of the per-round step (bytes over the memory rate), and
     the reductions' time against the host loops'. Beside them, the native
     runtime's shadow sweep on the same largest genome against the wall of
     one CUDA dispatch of it (device_engine.shadow: pack, upload, kernel,
     download, finalize), best of five each. The batched entry also at the
     shard shapes of the mesh runs (the first G_loc = 16 and 32 genomes of
     the big loop's columns) against its plain version, and timed. The
     fused sweep: LOOP on the big and north-star loops' columns (entry and
     final state), STEP, step_walk and step_dedupe on the per-round path's
     full big and north-star stacks in their final state and on a mesh
     shard of big's (its first G_loc = 16 genomes): kernel == plain, and
     again after a CUDA graph of three launches replayed twice; device
     time of 200 launches in one CUDA graph, the plain version's time, the
     bound (least bytes over the memory rate), the step kernels' launch
     shape (blocks, tile, scratch bytes); beside step_walk the counters'
     PyTorch yardstick (scatter_add_ and the two sums). The protein-keyed
     reductions on big (post_reductions_sharded) split into the host's
     stacking of a rank's rows end to end, the upload, the device and the
     pull, at world 1 and for rank 0's share at world 4; protein_reduce at
     REDUCE_SHAPES on big's and the north star's final rows (rank 0's
     share at world 4, the main path's, and every genome's rows end to end;
     big's padded [G, H] stack): against its plain version and against
     the same seven sums by one scatter_reduce_ and one index_add_ (its
     library time), its device time, the plain version's and its bound on
     the shape's data (reduction_bound_bytes).
     Then (4d) branch_block, merge_fold (lean: the first in-loop merge) and
     merge_fold's full mode (the full=True tail) on the arguments of their
     first call in the default loop of the big corpus and of the north
     star (captured through schedule_device's `capture`), and the mesh's
     branch_locality and branch_classify on the same arc tables (their
     groups by loop_kernels.arc_groups); the round kernels on their
     captured arguments (walk_pairs: the first in-loop walk and the tail's;
     prop_round: its first call that propagates; occ_round: its first with
     the loci and the cuts), the in-place ones on copies; the batched entry
     on the north star loop's columns: kernel == plain exactly, device time
     from 200 launches in one CUDA graph (the in-place kernels from the
     state their first launch leaves; prop_round and occ_round with one
     round_scratch, as the loop's), the plain version's time, the bound;
     after prop_round's line, ORDCM LOCALITY: how local its reads are
     (testing.ordcm_locality of its cm order, testing.sector_shares of its
     arc rows).
     Then (4e) the bucket exchange's kernels (ops/mesh_kernels.py:
     exchange_pack, exchange_window, exchange_finish) at the world-4 shape
     of the big and the north-star loops (G_loc = Gp / 4 genomes of the
     loop's H rows, its S and A), on every state of testing.exchange_calls
     (random keys, a destination over the bucket, every key a sentinel,
     every key to one destination, windows past the table, an empty
     destination between two that are not), every rank: kernel == plain
     exactly, eager and from a CUDA graph replayed twice; device time of
     rank 0's ordinary call (200 launches in one CUDA graph; pack through
     one exchange_scratch, as the loop calls it, left zeroed), the plain
     version's, the bound (exchange_bound_bytes), pack's and finish's
     launch shape (mesh_kernels.launch_shape: tiles, grid, blocks a SM).

``--corpora NAME[,NAME]`` runs only those corpora and what needs them, for
a short first run of new code (``--corpora small`` takes about two
minutes); such a run prints no result line.

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
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"


class Corpus(NamedTuple):
    """A synthetic corpus (testing.synth_paf_files' draw), the extra CLI
    arguments every build of it takes, and the md5 of the GFA it must
    give."""
    n_genome: int
    n_gene: int
    seed: int
    n_iso: int
    single_exon: bool
    args: tuple
    md5: str


CORPORA = {
    # bench.py's corpora; md5 of the reference binary's GFA
    "small": Corpus(32, 2000, 11, 3, False, (),
                    "4e077812357fa691683bea45c7831a8c"),
    "big": Corpus(64, 10000, 7, 3, False, (),
                  "b988fc85e7633316be354ab315a0449c"),
    # the north star of ROADMAP.md, 3,898,385 records; md5 as pinned in
    # NORTHSTAR_MESH_northstar.json and scripts/tpu_gate.py
    "northstar": Corpus(100, 19000, 42, 3, False, (),
                        "9eccc87817f4450bab1ae54a0dac331a"),
    # the bacterial shape of BASELINE.md, 615,492 single-exon records; md5
    # of `python -m pangene_tpu.cli --engine host -J` on this draw (the
    # same bytes without -J)
    "bact": Corpus(150, 4000, 13, 1, True, ("-J",),
                   "e8fa0e27654ad10c96d1e79a1701018b"),
}
# The in-process runs of phase 3 on each corpus, in the order the corpora
# are taken. A default build of each corpus in its own process (phase 3c)
# checks the loop's path as the in-process sharded runs do; those stay only
# where phase 4 reads their device tensors (big, northstar).
IN_PROCESS = {"small": ("device",),
              "bact": ("device", "rounds", "fallback"),
              "northstar": ("sharded", "rounds"),
              "big": ("sharded", "rounds")}
# The north star's draw takes longest. Beside it run the in-process runs of
# these corpora (their records list the draws still running) and then the
# genome mesh (phase 3e) on MESH_CORPORA; the other in-process runs and
# every build in a process of its own (3c) run once no draw runs.
BESIDE_DRAW = ("small", "bact")
# seconds a corpus's draw may take from when the run waits for it: about
# twice the north star's (212-261 s on an H100 machine's host)
DRAW_TIMEOUT = 600
# A corpus's draw in a process of its own: the output directory and the
# draw's keywords as JSON; prints the draw's seconds.
DRAW_SCRIPT = (
    "import json, sys, time\n"
    "from pangene_tpu_torch.testing import synth_paf_files\n"
    "t0 = time.monotonic()\n"
    "synth_paf_files(sys.argv[1], **json.loads(sys.argv[2]))\n"
    "print(round(time.monotonic() - t0, 3))\n")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
# Integer peak: the sweep's work is INT32 / INT64 compares, adds and
# min/max. Hopper has 64 INT32 lanes per SM (against 128 FP32 lanes), so the
# rate is 132 SMs x 64 lanes x 1.98 GHz (the H100 SXM boost clock) =
# 1.67e13 operations/s, a quarter of the 67e12 FP32 FMA FLOP figure. An
# int64 compare or add counts as two operations.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
EXON_BYTES = 8              # exon_os + exon_oe, int32 each
TIMED_LAUNCHES = 200
# Least integer operations branch_locality needs to find one genome of an
# arc pair not local, each test short-circuited and the cheapest first: a
# target absent, one presence test (1); both present on two contigs, the two
# tests and the contig compare (3); else also the int64 cm difference,
# absolute value and compare (6) and the rank difference, absolute value and
# compare (3): 12, or 11 with no contig compare (frag_mode).
LOC_ABSENT_OPS, LOC_OFF_CONTIG_OPS, LOC_FAR_OPS = 1, 3, 12
# The native runtime's entries (ops/sweep_native.py) each path must call:
# every card path marks branches, selects vertices and renders L lines in
# C; the loop's phase 1 and a fallback walk in C; sharded and the host
# engine sweep single genomes in C; --engine device never does.
NATIVE_SHARED = ("gen_vtx_greedy", "format_arcs")
NATIVE_ROUNDS = ("mark_branch", "rep_pos_rows", "propagate_weak_hash")
NATIVE_SWEEPS = ("shadow", "flt_ov_isoform")
NATIVE_ENTRIES = {
    "device": NATIVE_SHARED + NATIVE_ROUNDS,
    "sharded": NATIVE_SHARED + NATIVE_SWEEPS + ("round_genome",
                                                "merge_arcs_kway"),
    "rounds": NATIVE_SHARED + NATIVE_ROUNDS + NATIVE_SWEEPS,
    "fallback": NATIVE_SHARED + NATIVE_ROUNDS + NATIVE_SWEEPS + (
        "round_genome",),
    "host": NATIVE_SHARED + NATIVE_ROUNDS + NATIVE_SWEEPS + (
        "round_genome", "merge_arcs_kway"),
}
# A build as a user runs it, in a process of its own whose __main__
# imports no torch before the build: the CLI's arguments, the GFA on
# stdout, and on stderr one JSON line with util.stage_stats and the path the
# build took: whether it imported torch or initialised CUDA, the peak device
# bytes, the native runtime's calls, the kernels' launches and plain calls,
# and when the device loop ran (the loop's first run in a process: cold)
# its LAST.
BUILD_SCRIPT = """\
import json, sys, time
t0 = time.monotonic()
from pangene_tpu_torch import cli, util
t1 = time.monotonic()
rc = cli.main(sys.argv[1:])
t2 = time.monotonic()
st = dict(util.stage_stats)
st["import_s"] = round(t1 - t0, 3)
st["main_s"] = round(t2 - t1, 3)
m = sys.modules
torch = m.get("torch")
st["torch_imported"] = torch is not None
st["cuda_initialized"] = bool(torch and torch.cuda.is_initialized())
if st["cuda_initialized"]:
    st["peak_device_bytes"] = torch.cuda.max_memory_allocated()
sn = m.get("pangene_tpu_torch.ops.sweep_native")
if sn is not None:
    st["native_calls"] = {k: v for k, v in sn.n_calls.items() if v}
sk = m.get("pangene_tpu_torch.ops.sweep_kernel")
lk = m.get("pangene_tpu_torch.ops.loop_kernels")
stk = m.get("pangene_tpu_torch.ops.step_kernels")
mk = m.get("pangene_tpu_torch.ops.mesh_kernels")
if sk is not None and lk is not None:
    step = stk.n_calls if stk is not None else {}
    mesh = mk.n_calls if mk is not None else {}
    st["launches"] = {
        "per_genome": sum(sk.n_kernel_launches.values()),
        "batched": sk.n_batched()["kernel"],
        "fused": {k: c["kernel"] for k, c in sk.n_fused.items()},
        "loop": {k: c["kernel"] for k, c in lk.n_calls.items()},
        "step": {k: c["kernel"] for k, c in step.items()},
        "mesh": {k: c["kernel"] for k, c in mesh.items()},
        "plain": (sum(sk.n_plain_calls.values()) + sk.n_batched()["plain"]
                  + sum(c["plain"] for c in lk.n_calls.values())
                  + sum(c["plain"] for c in step.values())
                  + sum(c["plain"] for c in mesh.values()))}
dl = m.get("pangene_tpu_torch.parallel.device_loop")
if dl is not None and dl.LAST:
    st["loop"] = {k: dl.LAST.get(k) for k in (
        "engaged", "reason", "shape", "run_s", "host_syncs", "block_ms",
        "rounds_branch_run", "rounds_sweep_run", "rounds_total")}
sys.stderr.write("STAGES=" + json.dumps(st) + "\\n")
sys.exit(rc)
"""
# The start of a card engine's process, timed from inside it.
CUDA_START_PROBE = (
    "import json, time\n"
    "t0 = time.monotonic()\n"
    "import torch\n"
    "t1 = time.monotonic()\n"
    "ok = torch.cuda.is_available()\n"
    "t2 = time.monotonic()\n"
    "init = torch.cuda.is_initialized()\n"
    "torch.zeros(1, device='cuda')\n"
    "torch.cuda.synchronize()\n"
    "t3 = time.monotonic()\n"
    "print(json.dumps({'import_torch_s': round(t1 - t0, 3), "
    "'is_available_s': round(t2 - t1, 3), "
    "'initialised_after_is_available': init, "
    "'first_context_s': round(t3 - t2, 3)}))\n")
# The mesh runs of phase 3e: (key, corpus, world, how the ranks start, env).
# "share": testing.run_ranks, gloo ranks on cuda:0; "cli": the CLI's own
# --devices (its rank 0 writes the GFA); "torchrun": NCCL.
MESH_RUNS = (
    ("small_w2", "small", 2, "share", {}),
    ("small_w3", "small", 3, "share", {}),
    ("small_w2_rounds", "small", 2, "share", {"PANGENE_DEVICE_LOOP": "0"}),
    ("small_w2_cli", "small", 2, "cli", {}),
    ("big_w4", "big", 4, "share", {}),
    ("big_w2", "big", 2, "share", {}),
    ("big_w1_nccl", "big", 1, "torchrun", {}),
)
MESH_TIMEOUT = 300          # seconds, each rank of a mesh run
MESH_CORPORA = tuple(sorted({run[1] for run in MESH_RUNS}))
# md5 of the toolkit's output on each corpus's GFA (the GFA of md5
# CORPORA[name][3]), from the JAX package's toolkit (pangene_tpu.tools.cli)
# on that GFA as the JAX package's --engine host builds it
TOOL_MD5 = {
    "small": {"call": "5854e95ab7f26d9c1074e550c5fbbac9",
              "gfa2matrix": "63787fad792ff06408028d7feda68b01"},
    "big": {"call": "5854e95ab7f26d9c1074e550c5fbbac9",
            "gfa2matrix": "8badaede02cb0b00efe9d1db81ca22bc"},
}


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


def compare_loop_kernel(lk, name, args, kw):
    """The kernel `name` of ops/loop_kernels through its wrapper against its
    plain version on the same arguments on the card; returns the largest
    absolute difference over the outputs (must be 0) and the outputs."""
    got = getattr(lk, name)(*args, **kw)
    want = getattr(lk, name + "_plain")(*args, **kw)
    torch.cuda.synchronize()
    err = 0
    for a, b in zip(got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError("%s: %s %s vs plain %s %s" % (
                name, a.shape, a.dtype, b.shape, b.dtype))
        diff = (a.long() - b.long()).abs()
        err = max(err, int(diff.max()) if diff.numel() else 0)
    if err:
        raise AssertionError("%s kernel != plain: max abs err %d"
                             % (name, err))
    return err, got


def compare_round_kernel(name, make):
    """The round kernel `name` of ops/loop_kernels against its plain
    version, each on its own arguments from make() (testing.round_outputs:
    what it returns, then what it updates in place); returns the largest
    absolute difference (must be 0) and the kernel's outputs."""
    from pangene_tpu_torch.testing import round_outputs
    args, kw = make()
    got = round_outputs(name, args, kw)
    args, kw = make()
    want = round_outputs(name, args, kw, plain=True)
    torch.cuda.synchronize()
    if len(got) != len(want):
        raise AssertionError("%s: %d outputs vs plain %d"
                             % (name, len(got), len(want)))
    err = 0
    for a, b in zip(got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError("%s: %s %s vs plain %s %s" % (
                name, a.shape, a.dtype, b.shape, b.dtype))
        diff = (a.long() - b.long()).abs()
        err = max(err, int(diff.max()) if diff.numel() else 0)
    if err:
        raise AssertionError("%s kernel != plain: max abs err %d"
                             % (name, err))
    return err, got


def round_bound_ms(lk, name, make, got):
    """Least time of one call of the round kernel `name` on the arguments
    make() gives, whose outputs are `got` (compare_round_kernel): the bytes
    it must move over the memory rate, each input read once and each output
    written once; its scratch (branch_prep's last rows and kept ranks,
    walk_pairs' genome bits) not counted, nor what a row reads again at its
    previous row. Returns (ms, bytes, shape).
      walk_pairs   every row: valid 1 in; keys 16, s12 8, pair_ok 1, nxt
                   4 out (full: s21 8, dist2 8 more); a valid row also
                   ordcm 4, flt and shadow (gathered) 2, the two scores 8,
                   the dominant's gene and segment 8 = 22 in (full: cm 8
                   more); a kept row (the only rows a pair or a segment
                   counter reads) cid 4, w 8, the segment 4; a segment
                   alive 1 in, its two counters 8 out.
      branch_prep  every row flt, shadow, valid 3; a kept row its gene 4; a
                   present (gene, genome) its row's cid and cm 12; the four
                   planes 17 a (gene, genome) out; an arc vw 8 in, its
                   target 8 out; the segments' genes 8 each that valid arcs
                   reach.
      prop_round   every row weak, flt, valid 3 (propagating also ordcm 4,
                   pair_ok 1, nxt 4); a pair its two arc rows 8 and marks 2;
                   a byte for each value it changes; the word 16 out.
      occ_round    with the loci or the cuts every arc's vw 8 (the loci:
                   n_grp 4 more); a segment seg_tot 4, alive 1, loci 8 (in,
                   or out when rebuilt from n_grp), the capture rows 1 + 8 +
                   8 + 4 out; with the cuts every row valid and flt 2, a live
                   row's gene 4, sid_of, a byte for each value it changes;
                   the log row and the word 48."""
    args, kw = make()
    if name == "walk_pairs":
        planes, flt, shadow, alive = args
        (G, H), S = flt.shape, alive.numel()
        n_valid = int(planes.valid.sum())
        kept = (flt == 0) & (shadow == 0)
        n_kept = int((torch.gather(kept, 1, planes.ordcm.long())
                      & planes.valid).sum())
        full = kw["full"]
        nbytes = (G * H * (30 + 16 * full) + n_valid * (22 + 8 * full)
                  + 16 * n_kept + 9 * S)
        shape = ("G %d, H %d, valid rows %d, kept %d, pairs %d, jb %d, "
                 "full %s" % (G, H, n_valid, n_kept, int(got[2].sum()),
                              kw["jb"], full))
    elif name == "branch_prep":
        flt, shadow, valid, gid, cid, cm, arc_vw, seg_gid = args
        (G, H), ng = flt.shape, kw["n_gene"]
        A, S = arc_vw.numel(), seg_gid.numel()
        n_kept = int(((flt == 0) & (shadow == 0) & valid).sum())
        n_present = int(got[0].sum())
        n_arc = int((arc_vw != lk.SENT_I).sum())
        nbytes = (3 * G * H + 4 * n_kept + 12 * n_present + 17 * ng * G
                  + 16 * A + 8 * min(S, n_arc))
        shape = "G %d, H %d, kept %d, genes %d, present %d, A %d" % (
            G, H, n_kept, ng, n_present, A)
    elif name == "prop_round":
        weak, flt, _, _, _, _, pair_ok = args[:7]
        (G, H), prop = weak.shape, kw["propagate"]
        n_pairs = int(pair_ok.sum()) if prop else 0
        n_changed = int((got[0] != weak).sum()) + int((got[1] != flt).sum())
        nbytes = G * H * (12 if prop else 3) + 10 * n_pairs + n_changed + 16
        shape = "G %d, H %d, pairs %d, changed %d, propagate %s" % (
            G, H, n_pairs, n_changed, prop)
    else:
        alive, flt, valid, _, sid_of, arc_vw = args[:6]
        (G, H), S, A = flt.shape, alive.numel(), arc_vw.numel()
        loci, cuts = kw["n_grp"] is not None, kw["cuts"] is not None
        nbytes = (A * (8 * (loci or cuts) + 4 * loci) + S * (1 + 4 + 8 + 21)
                  + 48)
        n_changed = int((got[1] != flt).sum()) + int((got[0] != alive).sum())
        if cuts:
            nbytes += (2 * G * H + 4 * int((valid & (flt == 0)).sum())
                       + 4 * sid_of.numel() + n_changed)
        shape = ("G %d, H %d, S %d, A %d, valid arcs %d, loci %s, cuts %s, "
                 "changed %d" % (G, H, S, A, int((arc_vw != lk.SENT_I).sum()),
                                 loci, kw["cuts"], n_changed))
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes, shape


def time_round_kernel(lk, make, name):
    """Device ms a call of the round kernel `name` (200 launches in one
    CUDA graph, the in-place kernels from the state their first launch
    leaves), the same back to back, and the plain version's ms, each on
    its own arguments from make()."""
    a, k = make()
    fn = getattr(lk, name)
    if name in ("prop_round", "occ_round"):
        # the scratch they count through, one for all calls, as the loop's
        k = dict(k, scratch=lk.round_scratch(a[0].device, a[0].numel()))
    ms = graph_ms(lambda: fn(*a, **k), TIMED_LAUNCHES)
    eager_ms = stream_ms(lambda: fn(*a, **k), TIMED_LAUNCHES)
    a, k = make()
    plain = getattr(lk, name + "_plain")
    return ms, eager_ms, stream_ms(lambda: plain(*a, **k), 5)


def locality_bound_ms(args, kw, aml, he):
    """Least time of one branch_locality call on these arguments, whose
    result is (aml, he): the bytes it must move (the branching plane in
    full, 1 byte an arc; for each branching arc its target, group and max
    flag, 17 bytes; the four representative planes of the genes those arcs
    target, 17 bytes a genome a gene; the two bit planes out, 2 bytes an
    arc) over the memory rate, or the operations this data forces over the
    INT32 rate, whichever is larger. A bit that stays 0 is known only once
    every partner that could set it is found not local in every genome:
    for aml[a] each partner that is a max arc, for he[a] each earlier
    partner. Those pairs, each once, cost the LOC_*_OPS of each genome's
    outcome. The set bits' witnesses (one local genome of one pair each)
    are left out, so the count is a lower bound."""
    r_pres, r_cid, _, _, tgt, gs, branching, is_max = args
    G = r_pres.shape[1]
    A = tgt.shape[0]
    nb = int(branching.sum())
    n_tg = int(torch.unique(tgt[branching]).numel())
    nbytes = A + 17 * nb + 17 * n_tg * G + 2 * A
    far = LOC_FAR_OPS - (1 if kw["frag_mode"] else 0)
    ops = 0
    widest = int(torch.unique_consecutive(gs[branching], return_counts=True)[
        1].max()) if nb else 0
    for d in range(1, widest):
        e, l = slice(0, A - d), slice(d, A)     # earlier, later member
        need = (branching[e] & branching[l] & (gs[e] == gs[l])
                & ((~aml[l] & is_max[e]) | (~aml[e] & is_max[l]) | ~he[l]))
        ie = torch.nonzero(need).squeeze(1)
        if not ie.numel():
            continue
        te, tl = tgt[ie], tgt[ie + d]
        both = r_pres[te] & r_pres[tl]
        cost = torch.where(both, far, LOC_ABSENT_OPS)
        if not kw["frag_mode"]:
            cost = torch.where(both & (r_cid[te] != r_cid[tl]),
                               LOC_OFF_CONTIG_OPS, cost)
        ops += int(cost.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), ops, nbytes, nb


def fold_bound_ms(args, kw):
    """Least time of one merge_fold call: the valid rows' sorted int64 keys
    (and permutation entries, when given) read once, with the reads of a
    binary search for where the valid rows end (invalid keys sort last and
    their pair slots read 0), each valid row's s1 read once, the int32 pair
    plane and the [cap] arc rows (8 + 4 bytes) and n_out written once; in
    the full mode each valid row's s2 and dist (4 + 4) more read and four
    int32 planes of [cap] (16 bytes a row) more written; over the memory
    rate (its few integer operations a row are far below the bytes'
    time)."""
    keys, _ = args
    N = keys.shape[0]
    jb = kw["jb"]
    full = kw.get("full") is not None
    n_valid = int(((keys >> jb) != ((1 << 62) >> jb)).sum())
    nbytes = (8 * n_valid * (2 if kw.get("perm") is not None else 1)
              + 8 * max(N, 1).bit_length()
              + (12 if full else 4) * n_valid + 4 * N
              + (28 if full else 12) * kw["cap"] + 8)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes, n_valid


# The loop's block kernels (ops/loop_kernels.n_calls): at one rank the
# branch block is branch_block, at world > 1 branch_locality then
# branch_classify. merge_fold counts both of its modes, merge_fold_full the
# full mode's launches alone. The round kernels run at every world.
ROUND_KERNELS = ("walk_pairs", "branch_prep", "prop_round", "occ_round")
# ops/mesh_kernels.py, launched only by the mesh's ranks (world > 1)
MESH_KERNELS = ("protein_reduce", "exchange_pack", "exchange_window",
                "exchange_finish")
# the mesh runs (MESH_RUNS keys) whose loop takes the bucket exchange, and
# its in-loop merges a rank there (one a round that walks: 16)
EXCHANGE_RUNS = ("big_w4", "small_w3")
EXCHANGE_MERGES = 16
LOOP_KERNELS = ("branch_block", "branch_locality", "branch_classify",
                "merge_fold", "merge_fold_full") + ROUND_KERNELS


# The fused sweep's two epilogues and the per-round step's kernels, by the
# names of their kernel records.
FUSED_KERNELS = ("sweep_round_loop", "sweep_round_step", "step_walk",
                 "step_dedupe")


def fused_counts(sk, stk):
    """{FUSED_KERNELS name: kernel launches} from the wrappers' counts."""
    return {"sweep_round_loop": sk.n_fused["loop"]["kernel"],
            "sweep_round_step": sk.n_fused["step"]["kernel"],
            "step_walk": stk.n_calls["step_walk"]["kernel"],
            "step_dedupe": stk.n_calls["step_dedupe"]["kernel"]}


def add_loop_launches(total, ll):
    """Adds a run's kernel counts `ll` to `total` (the kernels it names)."""
    for k in total:
        total[k] += ll[k]


def loop_kernel_counts(ll, world):
    """{launches of the branch block, of merge_fold, of its full mode, of
    each round kernel} of a loop run at `world` ranks, from its n_calls
    kernel counts; the branch block's count is -1 when an entry of the
    other world ran or the split entries disagree. An engaged loop launches
    the branch block and branch_prep once a branch round, merge_fold and
    walk_pairs once an in-loop merge and once for its full=True tail, the
    full mode for that tail alone, prop_round and occ_round once a round
    (loop_kernels_want)."""
    split = (ll["branch_locality"], ll["branch_classify"])
    if world == 1:
        branch = ll["branch_block"] if split == (0, 0) else -1
    else:
        branch = -1 if ll["branch_block"] or split[0] != split[1] \
            else split[0]
    return dict({k: ll[k] for k in ("merge_fold", "merge_fold_full")
                 + ROUND_KERNELS}, branch=branch)


def loop_kernels_want(last):
    """loop_kernel_counts of the loop run whose LAST is `last`."""
    if not last.get("engaged"):
        return dict.fromkeys(("branch", "merge_fold", "merge_fold_full")
                             + ROUND_KERNELS, 0)
    merges, rb = last["rounds_sweep_run"] + 1, last["rounds_branch_run"]
    return dict(branch=rb, merge_fold=merges, merge_fold_full=1,
                walk_pairs=merges, branch_prep=rb,
                prop_round=last["rounds_total"],
                occ_round=last["rounds_total"])


def branch_split_args(args, kw):
    """The mesh's entries on branch_block's arguments: (branch_locality
    args, kw), and branch_classify's args and kw given (aml, he)."""
    import pangene_tpu_torch.ops.loop_kernels as lk
    r_pres, r_cid, r_cm, r_rank, tgt, vw, s1 = args
    gs_of, mx, branching, is_max = lk.arc_groups(vw, s1, kw["B"])
    loc_kw = {k: kw[k] for k in ("frag_mode", "local_dist", "local_count")}
    cls_kw = {k: kw[k] for k in ("branch_diff", "branch_diff_dist",
                                 "branch_diff_cut")}
    loc = ([r_pres, r_cid, r_cm, r_rank, tgt, gs_of, branching, is_max],
           loc_kw)
    cls = lambda aml, he: ([s1, mx, branching, aml, he, gs_of], cls_kw)
    return loc, cls


def branch_block_bound_ms(args, loc_args, loc_kw, aml, he):
    """Least time of one branch_block call: the bytes it must move (vw 8
    bytes an arc; for each branching arc its target and s1, 12 bytes; the
    four representative planes of the genes those arcs target, 17 bytes a
    genome a gene; aw 1 and n_grp 4 bytes an arc and the two counts out)
    over the memory rate, or the operations the locality's data forces
    (locality_bound_ms on the same groups) over the INT32 rate, whichever
    is larger. The classification's f64 division per branching arc is left
    out, so the count is a lower bound."""
    _, _, ops, _, nb = locality_bound_ms(loc_args, loc_kw, aml, he)
    r_pres, tgt, branching = args[0], args[4], loc_args[6]
    A, G = tgt.shape[0], r_pres.shape[1]
    n_tg = int(torch.unique(tgt[branching]).numel())
    nbytes = 8 * A + 12 * nb + 17 * n_tg * G + 5 * A + 16
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), ops, nbytes, nb


def classify_bound_ms(args):
    """Least time of one branch_classify call: the branching, aml and he
    planes (a byte an arc each) read, s1 and mx (4 + 4) and gs_of (8) read
    for each branching arc (the only arcs whose class or group they
    decide), aw 1 and n_grp 4 bytes an arc and the two counts written
    (bytes; the f64 division per branching arc is far below them)."""
    A = args[0].shape[0]
    nb = int(args[2].sum())
    nbytes = 8 * A + 16 * nb + 16
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes


def compare_batched(sk, de, genomes, dev, check_strand, f, split_form,
                    H=None):
    """The batched kernel on `genomes` stacked into one batch (rows padded
    to H): against its plain version (the split sweep forms) on the whole
    batch when `split_form`, and against the per-genome plain version
    genome by genome; rows past a genome's end must come back empty.
    Returns the number of marked rows; raises on any difference."""
    from pangene_tpu_torch.testing import batch_cols
    bc, flt, weak, W = batch_cols(genomes, dev, H)
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


# Bytes a [G, H] row of the batched sweep's outputs, by epilogue, padding
# rows included since the kernel must write them: NONE the three planes
# (marks 1, score 8, other 4); LOOP ev1 1 and shadow 1 read, shadow 1 and
# pid_dom 4 written (and pid 4 read at each row with a dominator: `extra`);
# STEP shadow 1 and cm 8 read, shadow 1, score 8, other 4, key 8 written.
EPI_ROW_BYTES = {"none": 13, "loop": 7, "step": 30}


def fused_pair(sk, args, epi, check_strand, f, cm=None):
    """One fused sweep (`epi` "loop": loop_sweep_args' arguments; "step":
    the same with `cm`) on the card and its plain version
    (shadow_sweep_batched_plain then sweep_epilogue_plain) on copies of the
    in-place planes; raises unless every output is equal. Returns the
    kernel's outputs (the in-place planes first)."""
    bc, flt, weak, W, shadow, pid_dom, ev1, pid = args
    out = []
    for kernel in (True, False):
        sh = shadow.clone()
        pd = None if pid_dom is None else pid_dom.clone()
        if kernel and epi == "loop":
            sk.sweep_round_loop(bc, flt, weak, W, check_strand, f, sh, pd,
                                ev1, pid)
            res = (sh, pd)
        elif kernel:
            res = (sh,) + sk.sweep_round_step(bc, flt, weak, W, check_strand,
                                              f, sh, cm)
        else:
            marks, score, other = sk.shadow_sweep_batched_plain(
                bc, flt, weak, W, check_strand, f)
            if epi == "loop":
                sk.sweep_epilogue_plain(marks, score, other, flt, sh,
                                        bc.n_rows, ev1=ev1, pid=pid,
                                        pid_dom=pd)
                res = (sh, pd)
            else:
                res = (sh, score, other, sk.sweep_epilogue_plain(
                    marks, score, other, flt, sh, bc.n_rows, cid=bc.cid,
                    cm=cm))
        out.append(res)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(*out)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError("fused sweep (%s) != plain: output %d "
                                 "(strand %s, f %s)" % (epi, k, check_strand,
                                                        f))
    return out[0]


def compare_fused(sk, genomes, dev, check_strand, f, H=None, seed=0):
    """Both fused epilogues on `genomes` (testing.loop_sweep_args, rows
    padded to H) against their plain versions; returns the rows the STEP
    epilogue left shadowed."""
    from pangene_tpu_torch.testing import loop_sweep_args
    args = loop_sweep_args(genomes, dev, seed=seed, H=H)
    fused_pair(sk, args, "loop", check_strand, f)
    G, Hh = args[1].shape
    cm = (torch.arange(G * Hh, dtype=torch.int64, device=dev)
          .reshape(G, Hh) * 7919) % 100003
    return int(fused_pair(sk, args, "step", check_strand, f, cm)[0].sum())


def compare_step_kernels(stk, calls):
    """step_walk and step_dedupe (testing.step_calls' arguments) against
    their plain versions on the card; raises unless every output is
    equal. Returns the arcs the dedupe found."""
    got = None
    for name, (args, kw) in calls.items():
        got = getattr(stk, name)(*args, **kw)
        want = getattr(stk, name + "_plain")(*args, **kw)
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(got, want)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError("%s kernel != plain: output %d"
                                     % (name, k))
    return int((got[1] > 0).sum())


def step_graph_equal(stk, calls):
    """step_walk and step_dedupe (testing.step_calls' arguments), each as
    three launches captured in one CUDA graph and replayed twice, against
    their plain versions: the last launch's outputs must equal them (each
    launch zeroes its scratch, the tickets and the tiles' status, with its
    one memset)."""
    for name, (args, kw) in calls.items():
        fn = getattr(stk, name)
        want = getattr(stk, name + "_plain")(*args, **kw)
        fn(*args, **kw)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(3):
                outs = fn(*args, **kw)
        g.replay()
        g.replay()
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(outs, want)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError("%s in a CUDA graph != plain: output %d"
                                     % (name, k))


def bound_batched_ms(bc, flt, W, check_strand, epi="none", extra=0):
    """Least time for one batched sweep on these inputs: the bytes it must
    move (for every hit row the SHADOW input columns, hit_bytes; 8 bytes an
    exon of those rows; the [G, H] planes of its epilogue `epi`,
    EPI_ROW_BYTES, and `extra`) over the memory rate, or the integer
    operations these inputs need (as bound_ms counts them, summed over
    genomes) over the INT32 rate, whichever is larger."""
    c = {k: v.cpu().numpy() for k, v in bc._asdict().items()}
    fl = flt.cpu().numpy() != 0
    G, H = c["cid"].shape
    rows = int(c["n_rows"].sum())
    n_exon = sum(int(c["n_exon"][g, :c["n_rows"][g]].sum()) for g in range(G))
    nbytes = (rows * (50 + (1 if check_strand else 0)) + 4 * G
              + n_exon * EXON_BYTES + G * H * EPI_ROW_BYTES[epi] + extra)
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


# Least bytes a call of each block of the device loop must move, worked out
# from parallel/device_loop.py: (bytes per [G, H] row, per arc-table slot,
# per segment), inputs read once and outputs written once; what a block
# builds and consumes inside (the [G, n_gene] representative planes, the
# sort's scratch) is not counted.
#   walk_merge  in: flt, shadow (1 + 1), the cm-order planes cid 4, cm 8,
#               w 8, score_ori 4, score_dom 4, dom's segment 4, valid 1,
#               segment 4, ordcm 8 = 47; out: the pair state 4 + 4 + 8 + 1
#               = 17. Per arc out: vw 8, s1 4. Per segment: alive 1 in,
#               seg_tot 4, seg_ng 4 out.
#   branch      in: flt, shadow, valid (3), gid 4, cid 4, cm 8 = 19. Per
#               arc: vw 8, s1 4 in, weak 1 out. Per segment: gene 8 in,
#               loci 8 out.
#   prop        in: the pair state 17, weak 1, flt 1, ordcm 8; out: weak 1,
#               flt 1 = 29. Per arc: weak 1 in.
#   occ         (with the convergence check and the #del capture) in: gid 4,
#               valid 1, flt and weak now and at the round's entry 4; out:
#               flt 1 = 10. Per arc: vw 8 in. Per segment: alive 1, seg_tot
#               4, loci 8 in; alive 1, capture 1 + 8 + 8 + 4 out = 35.
LOOP_BLOCK_BYTES = {"walk_merge": (64, 12, 9), "branch": (19, 13, 16),
                    "prop": (29, 1, 0), "occ": (10, 8, 35)}
# The per-round step beside its sweep (parallel/stacked.round_step): per
# [G, H] row in: flt, shadow, weak 3, cid 4, cm 8, gid 4, rev 1, score_ori
# 4, score_dom 4, dom_gid 4 = 32; out: shadow 1, b_score 8, b_other 4, and
# two arc slots of uniq_x 8, cnt 4, dsum 8, m1 4, m2 4 = 69.
STEP_ROW_BYTES = 32 + 69
def reduction_bound_bytes(pid, score_ori, score_adj, n_exon, rank, flt,
                          n_rows, n_prot):
    """Least bytes of one reduction_step (mesh_kernels.protein_reduce) on
    these [G, H] columns, in either layout: pid, score_ori and rank (12
    bytes) at every valid row (below its genome's n_rows), flt (1) at a
    valid rank-0 row, n_exon and score_adj (8) at a valid rank-0
    unfiltered row; n_rows 4 a genome; out, per protein, the int32 maximum
    and six int64 sums (52). Rows past n_rows (the padded stack's padding)
    are not read."""
    G, H = flt.shape
    n = n_rows.to(torch.int64).clamp(0, H)
    valid = torch.arange(H, device=flt.device)[None, :] < n[:, None]
    r0 = valid & (rank == 0)
    return (12 * int(valid.sum()) + int(r0.sum())
            + 8 * int((r0 & (flt == 0)).sum()) + 4 * G + 52 * max(n_prot, 1))


def loop_block_bounds(shape, calls):
    """{block: (least ms a call, calls)} at the loop's shape."""
    rows = shape["G"] * shape["H"]
    return {b: ((rows * r + shape["A"] * a + shape["S"] * sg)
                / HBM_BYTES_PER_S * 1e3, calls[b])
            for b, (r, a, sg) in LOOP_BLOCK_BYTES.items()}


def batched_on_loop(sk, dl, k, label):
    """The batched entry on a loop run's device-resident columns (`k`: the
    blocks, cfg and outputs kept from its schedule_device call), in the
    entry state (no kept row filtered) and the loop's final state: kernel
    == plain, device time, the plain version's time, the bound. Returns
    the kernel record's fields: ms, plain_ms, plain_round_ms, bound_ms,
    bound_by of the entry state, ms_final."""
    cfg = k["cfg"]
    cols, bc = dl.unpack_blocks(*k["blocks"])
    G, H = bc.cid.shape
    rec = {}
    for state, flt, weak in (
            ("entry", cols["flt"].contiguous(), cols["weak_br"].contiguous()),
            ("final", k["outs"][0].contiguous(), k["outs"][1].contiguous())):
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
                raise AssertionError("batched kernel != plain on the %s "
                                     "run's columns (%s state)"
                                     % (label, state))

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
        log("BATCHED %s %s: G %d H %d rows %d W %d launch %s ms %.5f (eager "
            "back-to-back %.5f) plain_ms %.3f (geometry pass + round pass; "
            "round pass alone %.3f) bound_ms %.6f (%s; %d ops, %d bytes) "
            "marked %d; kernel == plain" % (
                label, state, G, H, int(bc.n_rows.sum()), cfg.W,
                json.dumps(sk.launch_shape_batched(G, H, cfg.W)), ms,
                eager_ms, plain_first_ms, plain_round_ms, b_ms, b_by, ops,
                nbytes, int(got[0].sum())))
        if state == "entry":
            rec.update(ms=ms, plain_ms=plain_first_ms,
                       plain_round_ms=plain_round_ms, bound_ms=b_ms,
                       bound_by=b_by)
        else:
            rec["ms_final"] = ms
    return rec


def fused_on_loop(sk, dl, k, label):
    """The fused LOOP sweep on a loop run's device-resident columns (`k`,
    as batched_on_loop), in the entry state (the uploaded shadow and
    pid_dom) and the loop's final state: kernel == plain, device time (200
    launches in one CUDA graph: the epilogue is idempotent on its in-place
    planes), the plain version's time (its geometry planes cached), the
    bound. Returns the record's fields: ms, plain_ms, bound_ms, bound_by of
    the entry state, ms_final, bound_ms_final."""
    cfg = k["cfg"]
    cols, bc = dl.unpack_blocks(*k["blocks"])
    G, H = bc.cid.shape
    ev1, pid = cols["ev1"].contiguous(), cols["pid"].contiguous()
    rec = {}
    for state, flt, weak, shadow, pid_dom in (
            ("entry", cols["flt"], cols["weak_br"], cols["shadow"],
             cols["pid_dom"]),
            ("final",) + tuple(k["outs"][:4])):
        args = (bc, flt.contiguous(), weak.contiguous(), cfg.W,
                shadow.contiguous(), pid_dom.contiguous(), ev1, pid)
        sh, pd = fused_pair(sk, args, "loop", cfg.check_strand,
                            cfg.min_ov_ratio)

        def kernel():
            sk.sweep_round_loop(bc, args[1], args[2], cfg.W,
                                cfg.check_strand, cfg.min_ov_ratio, sh, pd,
                                ev1, pid)
        ms = graph_ms(kernel, TIMED_LAUNCHES)
        geo = {}

        def plain():
            marks, score, other = sk.shadow_sweep_batched_plain(
                bc, args[1], args[2], cfg.W, cfg.check_strand,
                cfg.min_ov_ratio, geo)
            sk.sweep_epilogue_plain(marks, score, other, args[1], sh.clone(),
                                    bc.n_rows, ev1=ev1, pid=pid,
                                    pid_dom=pd.clone())
            return score
        score = plain()
        plain_ms = stream_ms(plain, 5)
        n_dom = int(((score > sk.SCORE_NONE) & (args[1] == 0)).sum())
        b_ms, b_by, ops, nbytes = bound_batched_ms(
            bc, args[1], cfg.W, cfg.check_strand, "loop", 4 * n_dom)
        log("FUSED LOOP %s %s: G %d H %d rows %d W %d launch %s ms %.5f "
            "plain_ms %.3f (round pass + epilogue) bound_ms %.6f (%s; %d "
            "ops, %d bytes; %d rows with a dominator); kernel == plain" % (
                label, state, G, H, int(bc.n_rows.sum()), cfg.W,
                json.dumps(sk.launch_shape_batched(G, H, cfg.W,
                                                   sk.EPI_LOOP)),
                ms, plain_ms, b_ms, b_by, ops, nbytes, n_dom))
        if state == "entry":
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        else:
            rec.update(ms_final=ms, bound_ms_final=b_ms)
    return rec


def step_bound_bytes(cols, perm, flt, shadow, g2s, use_ori, pair_ok):
    """The least bytes each step kernel moves on this data (each input read
    once, each output written once): {"step_walk": n, "step_dedupe": n}.

    step_walk reads perm at every position, flt below n_rows and shadow at
    an unfiltered row below n_rows; a kept row's columns (cid, gid 4, rev
    1, score_ori 4, cm 8; with use_ori off score_dom 4 and, where
    score_ori <= score_dom, dom_gid 4); n_rows and g2s once; it writes the
    two keys, pair_ok, dist, s1 and s2 (29 bytes) at every position and the
    two counters. step_dedupe reads xs and aperm (16 bytes a key), pair_ok
    at every row and dist, s1, s2 at a pair's row, and writes 28 bytes a
    key (uniq_x, cnt, dsum, m1, m2)."""
    bc = cols.batch
    G, H = flt.shape
    n_gene = g2s.shape[0]
    valid = torch.arange(H, device=flt.device)[None, :] < bc.n_rows[:, None]
    unflt = valid & (flt == 0)
    kept = unflt & (shadow == 0)
    n_kept = int(kept.sum())
    col = 21 * n_kept
    if not use_ori:
        col += 4 * n_kept + 4 * int((kept & (cols.score_ori
                                             <= cols.score_dom)).sum())
    walk = (8 * G * H + int(valid.sum()) + int(unflt.sum()) + col
            + 4 * G + 4 * n_gene + 29 * G * H + 8 * n_gene)
    dedupe = 2 * H * G * (16 + 28) + G * H + 12 * int((pair_ok != 0).sum())
    return {"step_walk": walk, "step_dedupe": dedupe}


def step_on_stack(sk, stkk, cols, flt, weak, shadow, g2s, W, use_ori):
    """The per-round step's kernels on a full stack (cols: StackCols, the
    flags of one round, g2s), each against its plain version, again after
    a CUDA graph of three launches replayed twice, and timed (200 launches
    in one CUDA graph; the plain version's time; the bound): the fused STEP
    sweep, then, on the inputs the step hands them, step_walk (beside it
    the counters' PyTorch yardstick: scatter_add_ into [G, n_gene] and the
    two sums) and step_dedupe, with their launch shape. Returns {record
    name: fields}."""
    bc = cols.batch
    G, H = flt.shape
    n_gene = g2s.shape[0]
    out = {}
    args = (bc, flt, weak, W, shadow, None, None, None)
    sh, score, other, key = fused_pair(sk, args, "step", False, 0.5, cols.cm)

    def kernel():
        sk.sweep_round_step(bc, flt, weak, W, False, 0.5, sh, cols.cm)
    geo = {}

    def plain():
        marks, sc, ot = sk.shadow_sweep_batched_plain(bc, flt, weak, W,
                                                      False, 0.5, geo)
        sk.sweep_epilogue_plain(marks, sc, ot, flt, sh.clone(), bc.n_rows,
                                cid=bc.cid, cm=cols.cm)
    plain()
    b_ms, b_by, ops, nbytes = bound_batched_ms(bc, flt, W, False, "step")
    out["sweep_round_step"] = dict(
        ms=graph_ms(kernel, TIMED_LAUNCHES), plain_ms=stream_ms(plain, 5),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes)
    perm = torch.sort(key, dim=1, stable=True).indices
    wargs = (cols, perm, flt, sh, g2s)
    walk = stkk.step_walk(*wargs, use_ori=use_ori)
    want = stkk.step_walk_plain(*wargs, use_ori=use_ori)
    for k, (a, b) in enumerate(zip(walk, want)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError("step_walk != plain on the full stack: "
                                 "output %d" % k)
    xs, aperm = torch.sort(walk[0], dim=1, stable=True)
    dargs = (xs, aperm) + tuple(walk[1:5])
    step_graph_equal(stkk, {"step_walk": (wargs, dict(use_ori=use_ori)),
                            "step_dedupe": (dargs, {})})
    # the counters alone in PyTorch, on the same kept rows and segments
    gat = lambda a: torch.gather(a, 1, perm)
    valid = torch.arange(H, device=flt.device)[None, :] < bc.n_rows[:, None]
    kept = gat((flt == 0) & (sh == 0) & valid).to(torch.int32)
    sid = g2s[gat(bc.gid).clamp(0, n_gene - 1).long()].long() \
        .clamp(0, n_gene - 1)

    def counters():
        c = torch.zeros((G, n_gene), dtype=torch.int32,
                        device=flt.device).scatter_add_(1, sid, kept)
        return torch.stack([c.sum(0, dtype=torch.int32),
                            (c > 0).sum(0, dtype=torch.int32)])
    if not torch.equal(counters(), walk[5]):
        raise AssertionError("the counters' yardstick != step_walk's")
    least = step_bound_bytes(cols, perm, flt, sh, g2s, use_ori, walk[1])
    shape = stkk.launch_shape(G, H, n_gene)
    nbytes = least["step_walk"]
    out["step_walk"] = dict(
        ms=graph_ms(lambda: stkk.step_walk(*wargs, use_ori=use_ori),
                    TIMED_LAUNCHES),
        plain_ms=stream_ms(lambda: stkk.step_walk_plain(
            *wargs, use_ori=use_ori), 5),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        nbytes=nbytes, counters_torch_ms=graph_ms(counters, TIMED_LAUNCHES),
        pairs=int(walk[1].sum()), kept=int(kept.sum()),
        launch=dict(blocks=shape["walk_blocks"], threads=shape["threads"],
                    tile=shape["tile"],
                    scratch_bytes=shape["walk_scratch_bytes"] + 8 * n_gene))
    got = stkk.step_dedupe(*dargs)
    want = stkk.step_dedupe_plain(*dargs)
    for k, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError("step_dedupe != plain on the full stack: "
                                 "output %d" % k)
    nbytes = least["step_dedupe"]
    n_groups = int((torch.cat([xs.new_ones((G, 1), dtype=torch.bool),
                               xs[:, 1:] != xs[:, :-1]], 1)).sum())
    out["step_dedupe"] = dict(
        ms=graph_ms(lambda: stkk.step_dedupe(*dargs), TIMED_LAUNCHES),
        plain_ms=stream_ms(lambda: stkk.step_dedupe_plain(*dargs), 5),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        nbytes=nbytes, arcs=int((got[1] > 0).sum()), groups=n_groups,
        launch=dict(blocks=shape["dedupe_blocks"], threads=shape["threads"],
                    tile=shape["tile"],
                    scratch_bytes=shape["dedupe_scratch_bytes"]))
    out["torch_sort_ms"] = dict(
        cm_key=stream_ms(lambda: torch.sort(key, dim=1, stable=True), 20),
        arc_key=stream_ms(lambda: torch.sort(walk[0], dim=1, stable=True),
                          20))
    return out


def step_stack(stk, graph, dev, g_loc=None):
    """The per-round path's device-resident stack of a run's final graph
    (its StackCols, cached on the graph by parallel/stacked.py) with the
    run's final flags (flt, weak, shadow) and g2s, on `dev`; with `g_loc`
    its first g_loc genomes, a mesh rank's shard. Returns (cols, flt,
    weak, shadow, g2s, W)."""
    cache = graph._stacked_dev_cache
    G, H = cache["G"], cache["H"]
    flt, shadow, weak = torch.from_numpy(stk.stack_mutable(
        graph.d, np.zeros((3, G, H), np.uint8))).to(dev)
    g2s = np.full(max(graph.d.n_gene, 1), -1, np.int32)
    g2s[:graph.d.n_gene] = graph.g2s
    cols = cache["cols"]
    if g_loc is not None:
        cut = lambda t: t[:g_loc].contiguous()
        cols = type(cols)(type(cols.batch)(*map(cut, cols.batch)),
                          *map(cut, cols[1:]))
        flt, shadow, weak = cut(flt), cut(shadow), cut(weak)
    return (cols, flt.contiguous(), weak.contiguous(), shadow.contiguous(),
            torch.from_numpy(g2s).to(dev), cache["W"])


def fresh_args(name, args):
    """The exchange kernel `name`'s arguments with the plane it writes in
    place (exchange_finish's pair) copied."""
    return [a.clone() if name == "finish" and i == 4 else a
            for i, a in enumerate(args)]


def compare_mesh_kernel(mk, name, args, kw):
    """exchange_`name` (ops/mesh_kernels.py) against its plain version on
    `args`, eager and from a CUDA graph replayed twice; raises unless every
    output is equal."""
    fn = getattr(mk, "exchange_" + name)
    want = getattr(mk, "exchange_%s_plain" % name)(*fresh_args(name, args),
                                                   **kw)
    got = fn(*fresh_args(name, args), **kw)
    torch.cuda.synchronize()
    a = fresh_args(name, args)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        in_graph = fn(*a, **kw)
    g.replay()
    g.replay()
    torch.cuda.synchronize()
    for outs in (got, in_graph):
        for k, (x, y) in enumerate(zip(outs, want)):
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError("exchange_%s != plain: output %d"
                                     % (name, k))


def exchange_sent(bounds, C):
    """The slots sent of a send plane of C slots a destination, from
    exchange_pack's bounds: the sum of min(bounds[t + 1] - bounds[t], C)."""
    return int((bounds[1:] - bounds[:-1]).clamp(max=C).sum())


def exchange_bound_bytes(name, args, kw, got):
    """Least bytes of one call of exchange_`name` on these arguments
    (`got`: its outputs), inputs read once and outputs written once, what
    the data needs: pack reads the keys it sends and their rows' s1 (12
    bytes a key; the reads that find where a run longer than C ends are
    not counted) and writes the [nd, 2, C] plane, the flag, the zeroed
    pair plane and the bounds plane; window reads the gathered (n_out_l,
    overflow) words, its fold's rows that land in the table (12 bytes),
    reply_loc at the received keys that are not sentinels and every
    received key, and writes the [2, A] table, the reply and n_out; finish
    reads the table's live rows, n_out, the bounds plane, and the key and
    the reply of each slot sent, and writes the arc table (12 bytes a
    row) and the pair slots of the keys sent."""
    from pangene_tpu_torch.ops.loop_kernels import KSENT_I as KSENT
    if name == "pack":
        send, bounds = got[0], got[3]
        nd, _, C = send.shape
        NL = args[0].shape[0]
        return (exchange_sent(bounds, C) * 12 + nd * 2 * C * 8 + 8
                + (NL + 1) * 4 + (nd + 1) * 4)
    if name == "window":
        per_rank, vw, s1, reply_loc, got_k = args
        A, rank = kw["A"], kw["rank"]
        nouts = per_rank.reshape(-1, 2)[:, 0].tolist()
        start = min(max(sum(nouts[:rank]), 0), A)
        n_win = max(min(nouts[rank], A - start), 0)
        RL = vw.shape[0]
        n_recv = int((got_k != KSENT).sum())
        return (per_rank.numel() * 8 + n_win * 12 + n_recv * 4 + RL * 8
                + 16 * A + 4 * RL + 8)
    table, n_out, send, reply, pair, bounds = args
    A = table.shape[1]
    nd, _, C = send.shape
    n_live = min(int(n_out), A)
    return (n_live * 16 + 8 + (nd + 1) * 4 + exchange_sent(bounds, C) * 16
            + A * 12)


def reduction_split(stk, opt, d, reps=5):
    """post_reductions_sharded on the card split into its parts, each
    between synchronisations, best of `reps`, for the whole dataset (world
    1) and for rank 0's share at world 4 (its genomes, stacked as that rank
    stacks them; no collective): the host's stacking of the rank's rows
    end to end (stacked.stack_reductions), the upload, the device
    (reduction_step: one protein_reduce launch), the pull. Returns a dict
    of ms."""
    from pangene_tpu_torch.parallel import mesh as M
    mx, z, (c, s) = stk.post_reductions_sharded(opt, d)
    dev = torch.device(DEVICE)
    P = max(d.n_prot, 1)
    best = {}

    def lap(name, t0):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        best[name] = min(best.get(name, 1e9), 1e3 * (t1 - t0))
        return t1
    for world in (1, 4):
        m = M.Mesh(world, 0, dev, None, None)
        sfx = "" if world == 1 else "_w4_rank0"
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.monotonic()
            buf, N = stk.stack_reductions(d, m, True)
            t = lap("stacking" + sfx, t)
            cols = stk.reduction_views(
                torch.from_numpy(buf).to(dev, non_blocking=True), N)
            t = lap("upload" + sfx, t)
            outs = stk.reduction_step(*cols, n_prot=P)
            t = lap("device" + sfx, t)
            arr = torch.cat([o.to(torch.int64) for o in outs]).cpu().numpy()
            lap("pull" + sfx, t)
        best["rows" + sfx] = int(cols[6][0])
        if world == 1 and not (
                np.array_equal(arr[:d.n_prot], mx)
                and np.array_equal(arr[P:P + d.n_prot], c[:, 0])):
            raise AssertionError("reduction split != post_reductions_sharded")
    return best


def padded_reduction_args(stk, d, dev):
    """protein_reduce's arguments on the padded [G, H] stack of d's rows
    (the JAX package's layout; the rows past a genome's count filtered)."""
    G = d.n_genome
    H = max(max((g.n_hit for g in d.genomes), default=1), 1)
    i32 = np.zeros((len(stk.REDUCTION_COLS), G, H), np.int32)
    flt = np.ones((G, H), np.uint8)
    n_rows = np.zeros(G, np.int32)
    for j, g in enumerate(d.genomes):
        n = g.n_hit
        n_rows[j] = n
        for k, name in enumerate(stk.REDUCTION_COLS):
            i32[k, j, :n] = g.hits.cols[name]
        flt[j, :n] = g.hits.flt
    t = lambda a: torch.from_numpy(a).to(dev)
    return [t(x) for x in i32] + [t(flt), t(n_rows)]


def reduction_library(args, P):
    """The same seven outputs as protein_reduce by two PyTorch calls, one
    scatter_reduce_ (the maxima) and one index_add_ of an [N, 6] int64
    block (the six sums), their masks and ids made here beforehand.
    Returns (both calls, the maxima only, the sums only, outputs)."""
    pid, so, sa, n_exon, rank, fl, nr = args
    H = pid.shape[1]
    va = (torch.arange(H, device=pid.device)[None, :]
          < nr[:, None]).reshape(-1)
    ids = pid.reshape(-1).clamp(0, P - 1).long()
    sof = so.reshape(-1)
    multi = n_exon.reshape(-1) != 1
    r0 = (rank.reshape(-1) == 0) & (fl.reshape(-1) == 0) & va
    one = torch.ones_like(sof, dtype=torch.int64)
    vals = torch.stack([
        torch.where(r0 & ~multi, one, 0), torch.where(r0 & multi, one, 0),
        torch.where(r0 & ~multi, sof.long(), 0),
        torch.where(r0 & multi, sof.long(), 0),
        torch.where(r0, sa.reshape(-1).long(), 0),
        torch.where(r0, one, 0)], 1).contiguous()
    mvals = torch.where(va, sof, 0)
    mx_out = torch.zeros(P, dtype=torch.int32, device=pid.device)
    sum_out = torch.zeros((P, 6), dtype=torch.int64, device=pid.device)

    def both():
        mx_out.zero_().scatter_reduce_(0, ids, mvals, "amax",
                                       include_self=True)
        sum_out.zero_().index_add_(0, ids, vals)
    return (both, lambda: mx_out.scatter_reduce_(
        0, ids, mvals, "amax", include_self=True),
        lambda: sum_out.index_add_(0, ids, vals), (mx_out, sum_out))


# protein_reduce's shapes in phase 4: label -> (corpus, world of the share
# (rank 0's; 1: every genome), padded [G, H] stack). The main path launches
# it at a rank's share (world > 1); the first is the kernels line's.
REDUCE_SHAPES = {"big_w4_rank0": ("big", 4, False),
                 "northstar_w4_rank0": ("northstar", 4, False),
                 "big_flat": ("big", 1, False),
                 "northstar_flat": ("northstar", 1, False),
                 "big_padded": ("big", 1, True)}


def reduction_args(stk, d, label, dev):
    """protein_reduce's arguments and n_prot at shape `label`
    (REDUCE_SHAPES) on d's rows: rank 0's share stacked end to end as that
    rank stacks it (stacked.stack_reductions), or the padded stack."""
    from pangene_tpu_torch.parallel import mesh as M
    _, world, padded = REDUCE_SHAPES[label]
    P = max(d.n_prot, 1)
    if padded:
        return padded_reduction_args(stk, d, dev), P
    buf, N = stk.stack_reductions(d, M.Mesh(world, 0, dev, None, None),
                                  False)
    return list(stk.reduction_views(torch.from_numpy(buf).to(dev), N)), P


def reduction_shapes(stk, mk, datas):
    """protein_reduce at REDUCE_SHAPES on the corpora's final rows (datas:
    corpus -> its per-round run's data): the rank's rows stacked end to end
    (stacked.stack_reductions) or the padded stack; at each the kernel
    against its plain version and the library pair (reduction_library)
    against the kernel, exactly; the kernel's device time (200 launches in
    one CUDA graph), the plain version's, the library pair's; the bound on
    the shape's data (reduction_bound_bytes). Returns
    {label: record}."""
    dev = torch.device(DEVICE)
    out = {}
    for label, (name, _, _) in REDUCE_SHAPES.items():
        args, P = reduction_args(stk, datas[name], label, dev)
        got = mk.protein_reduce(*args, n_prot=P)
        want = mk.protein_reduce_plain(*args, n_prot=P)
        for a, b in zip(got, want):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError("protein_reduce != plain (%s)" % label)
        both, lib_max, lib_sums, (mx_out, sum_out) = reduction_library(
            args, P)
        both()
        if not (torch.equal(mx_out, got[0])
                and torch.equal(sum_out.t(), got[1])):
            raise AssertionError("the library calls != protein_reduce (%s)"
                                 % label)
        G, H = args[0].shape
        nbytes = reduction_bound_bytes(*args, P)
        out[label] = dict(
            G=G, H=H, rows=int(args[6].clamp(0, H).sum()), n_prot=P,
            ms=graph_ms(lambda: mk.protein_reduce(*args, n_prot=P),
                        TIMED_LAUNCHES),
            plain_ms=stream_ms(
                lambda: mk.protein_reduce_plain(*args, n_prot=P), 5),
            library_ms=graph_ms(both, TIMED_LAUNCHES),
            library_max_ms=graph_ms(lib_max, TIMED_LAUNCHES),
            library_sums_ms=graph_ms(lib_sums, TIMED_LAUNCHES),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_bytes=nbytes)
    return out


def compare_step(stk, sk, genomes, dev, check_strand, use_ori, f):
    """The per-round step on the card (one launch of the fused sweep, at
    filtered rows in place, weak_br set, one band over all rows) against
    the whole step on the CPU (the plain versions). Every output must be
    equal; returns the number of arcs found."""
    from pangene_tpu_torch.testing import stack_cols
    cols, flt, shadow, weak, g2s, W = stack_cols(genomes, dev, seed=1)
    kw = dict(W=W, min_ov_ratio=f, check_strand=check_strand,
              use_ori=use_ori)
    before = sk.n_batched()["kernel"]
    got = stk.round_step(cols, flt, shadow, weak, g2s, **kw)
    if sk.n_batched()["kernel"] != before + 1:
        raise AssertionError("the step did not launch the batched kernel")
    c = stack_cols(genomes, torch.device("cpu"), seed=1)
    host = stk.round_step(*c[:5], **kw)
    for name, a, h in zip(stk.STEP_OUTPUTS, got, host):
        if not (a.dtype == h.dtype and torch.equal(a.cpu(), h)):
            raise AssertionError(
                "per-round step: %s differs, card vs CPU (strand %s, ori "
                "%s, f %s)" % (name, check_strand, use_ori, f))
    return int((got[4] > 0).sum())


def host_reductions(d):
    """(mx, z, c, s) by the host loops of ops/pseudo.py."""
    from pangene_tpu_torch.ops import pseudo
    c, s = pseudo.joint_counts(d)
    return pseudo.max_score_ori(d), pseudo.representative_sums(d), c, s


def compare_reductions(stk, opt, d):
    """post_reductions_sharded on the card against the host loops: equal,
    value for value. Returns (card seconds, host seconds)."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    mx, z, (c, s) = stk.post_reductions_sharded(opt, d)
    t1 = time.monotonic()
    want = host_reductions(d)
    t2 = time.monotonic()
    for name, a, b in zip(("mx", "z", "c", "s"), (mx, z, c, s), want):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError("post_reductions_sharded != host loops: %s"
                                 % name)
    return t1 - t0, t2 - t1


def run_session(cmd, timeout, env):
    """`cmd` from the checkout's root in a session of its own, killed whole
    (every process it started) when it has not ended within `timeout`
    seconds. Returns (exit code, stdout, stderr)."""
    p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise AssertionError("%s: no end within %d s" % (" ".join(cmd[:8]),
                                                         timeout))
    return p.returncode, out, err


def mesh_phase(corpora):
    """Phase 3e: the MESH_RUNS whose corpus was built, each checked; returns
    ({key: record}, batched launches, {loop kernel: launches},
    {FUSED_KERNELS name: launches} and {MESH_KERNELS name: launches},
    summed over every rank of every run)."""
    from pangene_tpu_torch.parallel.mesh import SHARE_DEVICE_ENV
    from pangene_tpu_torch.testing import REPORT_TAG, run_ranks
    runs = {}
    launches = 0
    loop_launches = {k: 0 for k in LOOP_KERNELS}
    step_launches = {k: 0 for k in FUSED_KERNELS}
    mesh_launches = {k: 0 for k in MESH_KERNELS}
    for key, name, world, how, extra in MESH_RUNS:
        if name not in corpora:
            continue
        want = CORPORA[name].md5
        env = dict(os.environ, **extra)
        if how != "torchrun":
            env[SHARE_DEVICE_ENV] = "1"
        args = ["--engine", "sharded", "--devices", str(world),
                "-v", "3" if how == "cli" else "1"] + list(
                    CORPORA[name].args) + corpora[name]
        t0 = time.monotonic()
        if how == "share":
            reports = run_ranks(world, args, env=env, timeout=MESH_TIMEOUT,
                                cwd=ROOT)
        elif how == "torchrun":
            rc, _, err = run_session(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(world), "-m",
                 "pangene_tpu_torch.testing"] + args, MESH_TIMEOUT, env)
            reports = sorted((json.loads(x[len(REPORT_TAG):])
                              for x in err.splitlines()
                              if x.startswith(REPORT_TAG)),
                             key=lambda r: r["rank"])
            if rc or len(reports) != world:
                raise AssertionError("%s: torchrun exited %d with %d reports:"
                                     " %s" % (key, rc, len(reports),
                                              err[-3000:]))
        else:
            rc, out, err = run_session(
                [sys.executable, "-m", "pangene_tpu_torch.cli"] + args,
                MESH_TIMEOUT, env)
            md5 = hashlib.md5(out.encode()).hexdigest()
            mesh_lines = [x for x in err.splitlines() if "[M::pg_mesh" in x]
            if rc or md5 != want or len(mesh_lines) != world:
                raise AssertionError("%s: the CLI's ranks exited %d, md5 %s, "
                                     "mesh lines %s: %s" % (
                                         key, rc, md5, mesh_lines,
                                         err[-3000:]))
            reports = []
        wall = time.monotonic() - t0
        backend = "nccl" if how == "torchrun" else "gloo"
        rec = {"corpus": name, "world": world, "how": how, "env": extra,
               "wall_s": round(wall, 3), "ranks": []}
        for rep in reports:
            last, rounds = rep["LAST"], rep["rounds_LAST"]
            bad = []
            if rep["md5"] != want:
                bad.append("md5 %s" % rep["md5"])
            if rep["plain_calls"] or rep["kernel_launches"]:
                bad.append("plain calls %d, per-genome launches %d" % (
                    rep["plain_calls"], rep["kernel_launches"]))
            if (rep["mesh"].get("backend"), rep["mesh"].get("device")) != (
                    backend, "cuda:0"):
                bad.append("mesh %s" % rep["mesh"])
            ll = rep["loop_launches"]
            fl = rep["step_launches"]
            if extra.get("PANGENE_DEVICE_LOOP") == "0":
                if last or not (rounds.get("rounds") == 17
                                == rep["batched_launches"]
                                == fl["sweep_round_step"] == fl["step_walk"]
                                == fl["step_dedupe"]) or any(
                                    ll.values()) or fl["sweep_round_loop"]:
                    bad.append("per-round path: %s, loop %s, loop kernels "
                               "%s, step kernels %s" % (rounds, last, ll,
                                                        fl))
            else:
                if loop_kernel_counts(ll, world) != loop_kernels_want(last):
                    bad.append("loop kernels %s" % ll)
                if not (last.get("engaged") is True
                        and last["shape"]["n_devices"] == world
                        and rep["batched_launches"]
                        == fl["sweep_round_loop"]
                        == last["rounds_sweep_run"] > 0) or any(
                            v for k, v in fl.items()
                            if k != "sweep_round_loop"):
                    bad.append("loop %s, step kernels %s" % (last, fl))
                if world > 2 and not last.get("shard_merge"):
                    bad.append("no bucket exchange at world %d" % world)
            # one protein_reduce a build at world > 1 (post_process); the
            # exchange's three kernels once an in-loop merge at world > 2
            # (merge_fold's launches less the full tail's)
            ml = rep["mesh_launches"]
            n_merge = ll["merge_fold"] - 1 if world > 2 and last else 0
            want_ml = dict({k: n_merge for k in MESH_KERNELS[1:]},
                           protein_reduce=int(world > 1))
            if ml != want_ml or (world > 2 and last and n_merge < 1):
                bad.append("mesh kernels %s, expected %s" % (ml, want_ml))
            # the bucket exchange's runs: pack and finish once an in-loop
            # merge, 16 a rank, and no plain call of any mesh kernel
            if key in EXCHANGE_RUNS and not (
                    ml["exchange_pack"] == ml["exchange_finish"]
                    == EXCHANGE_MERGES and not any(
                        c["plain"] for c in rep["mesh_calls"].values())):
                bad.append("exchange kernels %s (calls %s), expected %d "
                           "launches each and no plain call" % (
                               ml, rep["mesh_calls"], EXCHANGE_MERGES))
            if bad:
                raise AssertionError("%s rank %d: %s" % (key, rep["rank"],
                                                         "; ".join(bad)))
            launches += rep["batched_launches"]
            add_loop_launches(loop_launches, ll)
            add_loop_launches(step_launches, fl)
            add_loop_launches(mesh_launches, ml)
            keep = ("pack_s", "upload_s", "run_s", "pull_s", "host_syncs",
                    "collective_calls", "collective_s", "staged_bytes",
                    "upload_bytes")
            rec["ranks"].append(dict(
                rank=rep["rank"], md5=rep["md5"], wall_s=rep["wall_s"],
                batched_launches=rep["batched_launches"],
                loop_launches=ll, step_launches=fl, mesh_launches=ml,
                peak_device_bytes=rep["peak_device_bytes"],
                mesh_calls=rep["mesh"]["calls"],
                mesh_collective_s=round(rep["mesh"]["collective_s"], 3),
                mesh_first_collective_s=round(
                    rep["mesh"]["first_collective_s"], 3),
                mesh_staged_bytes=rep["mesh"]["staged_bytes"],
                stages={k: rep["stages"].get(k) for k in (
                    "parse_s", "post_s", "graph_s", "emit_s")},
                LAST={k: last[k] for k in keep if k in last},
                rounds_LAST={k: rounds[k] for k in (
                    "rounds", "step_s", "pull_s", "apply_s", "pull_bytes")
                    if k in rounds}))
        runs[key] = rec
        log("mesh %s: %s" % (key, json.dumps(rec)))
    return runs, launches, loop_launches, step_launches, mesh_launches


def corpus_dir(name):
    c = CORPORA[name]
    tag = "synth_%d_%d_%d" % (c.n_genome, c.n_gene, c.seed)
    if (c.n_iso, c.single_exon) != (3, False):
        tag += "_iso%d%s" % (c.n_iso, "_single_exon" if c.single_exon else "")
    return os.path.join(ROOT, "build", "chip_smoke", tag)


def start_draw(name):
    """The draw of corpus `name` (DRAW_SCRIPT) in a process of its own, in
    a session of its own; None when build/chip_smoke holds it already."""
    out = corpus_dir(name)
    if os.path.exists(os.path.join(out, "done")):
        return None
    c = CORPORA[name]
    kw = dict(n_genome=c.n_genome, n_gene=c.n_gene, seed=c.seed,
              n_iso=c.n_iso, single_exon=c.single_exon)
    return subprocess.Popen(
        [sys.executable, "-c", DRAW_SCRIPT, out, json.dumps(kw)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def make_corpus(name, draw):
    """The PAF files of corpus `name` once its draw (start_draw's process,
    or None) has ended; returns (files, the draw's seconds or None when it
    was cached, the seconds waited here)."""
    out = corpus_dir(name)
    t0 = time.monotonic()
    draw_s = None
    if draw is not None:
        try:
            stdout, stderr = draw.communicate(timeout=DRAW_TIMEOUT)
        except subprocess.TimeoutExpired:
            raise AssertionError("corpus %s: no draw within %d s"
                                 % (name, DRAW_TIMEOUT))
        if draw.returncode:
            raise AssertionError("corpus %s: the draw exited %d: %s" % (
                name, draw.returncode, stderr[-2000:]))
        draw_s = float(stdout.split()[-1])
        with open(os.path.join(out, "done"), "w") as fp:
            fp.write("ok\n")
    files = sorted(os.path.join(out, f) for f in os.listdir(out)
                   if f.endswith(".paf.gz"))
    return files, draw_s, time.monotonic() - t0


def run_cli(files, engine="device", args=()):
    """The user's entry point on cuda with `engine` (and further flags);
    returns (GFA text, final graph)."""
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
                     + list(args) + files)
    finally:
        pipeline.run = run
    return buf.getvalue(), graphs[0]


def main():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 2
    names = tuple(IN_PROCESS)
    if sys.argv[1:2] == ["--corpora"]:
        names = tuple(n for n in IN_PROCESS if n in sys.argv[2].split(","))
        if set(sys.argv[2].split(",")) - set(names):
            sys.stderr.write("chip_smoke: corpora are %s\n"
                             % ",".join(IN_PROCESS))
            return 2
    sys.path.insert(0, ROOT)
    import pangene_tpu_torch.testing  # noqa: F401  (raises outside a checkout)
    # every corpus is drawn in a process of its own, all at once, while the
    # kernels build and the earlier phases run
    draws = {name: start_draw(name) for name in names}
    try:
        return smoke(names, draws)
    finally:
        for p in draws.values():
            if p is not None and p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()


def smoke(names, draws):
    """Phases 1-4 over the corpora `names` (module docstring); `draws`: the
    corpora's draw processes (start_draw)."""
    from pangene_tpu_torch import pipeline, util
    from pangene_tpu_torch.options import PgOpt
    from pangene_tpu_torch.ops import device_engine as de
    from pangene_tpu_torch.ops import dispatch
    from pangene_tpu_torch.ops import loop_kernels as lk
    from pangene_tpu_torch.ops import mesh_kernels as mkk
    from pangene_tpu_torch.ops import step_kernels as stkk
    from pangene_tpu_torch.ops import sweep_kernel as sk
    from pangene_tpu_torch.ops import sweep_native as sn
    from pangene_tpu_torch.ops.sort import hit_sort
    from pangene_tpu_torch.ops import device as tdev
    from pangene_tpu_torch.parallel import device_loop as dl
    from pangene_tpu_torch.parallel import stacked as stk
    from pangene_tpu_torch.testing import (BRANCH_B, EXACT_BRANCH_DIFFS,
                                           EXCHANGE_STATES, ROUND_STATES,
                                           SEEN_SMEM_GENES, STEP_STATES,
                                           SWEEP_EDGE_CASES, WALK_FORMS,
                                           band_genome, branch_table,
                                           deficit_ratios, exchange_calls,
                                           fold_inputs, make_state,
                                           ordcm_locality, random_genome,
                                           round_calls, sector_shares,
                                           stacked_edge_cases, step_calls,
                                           step_state, sweep_edge_case)
    dev = torch.device(DEVICE)

    # 1. the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("card: %s | torch %s cuda %s" % (smi, torch.__version__,
                                         torch.version.cuda))
    # one nvcc for each kernel source, all started together
    t0 = time.monotonic()
    with ThreadPoolExecutor(5) as pool:
        builds = {src: pool.submit(build, True) for src, build in (
            ("shadow_sweep.cu", sk.build), ("loop_blocks.cu", lk.build),
            ("loop_round.cu", lk.build_round),
            ("step_round.cu", stkk.build), ("mesh_round.cu", mkk.build))}
        builds = {src: f.result() for src, f in builds.items()}
    log("build: the five kernel sources in %.2f s"
        % (time.monotonic() - t0))
    for src, (build_s, ptxas) in builds.items():
        log("build: nvcc %s %.2f s" % (src, build_s))
        for line in ptxas.splitlines():
            if "entry function" in line:
                log("  ptxas: " + line.strip().split("'")[1][-60:])
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
    # the native host runtime, built anew from the checkout's source
    so = os.path.join(util.build_dir(), sn.SO_NAME)
    if os.path.exists(so):
        os.remove(so)
    t0 = time.monotonic()
    if not sn.available() or not os.path.exists(so):
        raise AssertionError("the native runtime did not build or load from "
                             "pangene_tpu_torch/native/pgsweep.c")
    log("build: native runtime %s (%d bytes) in %.2f s" % (
        os.path.relpath(so, ROOT), os.path.getsize(so),
        time.monotonic() - t0))

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
    # the batched tile's own edges: bands of exactly W (the loop's 8, the
    # per-round path's 21, the staged halo's 32, the large-W path's 33),
    # genomes at the tile's edges, empty genomes, rows padded past the
    # longest genome (tiles of padding only)
    rows = sk.tile_shape(batched=True)[0]
    for W in (1, 8, 21, 32, 33):
        genomes = [band_genome(np.random.default_rng(10 * W + k), n, W)
                   for k, n in enumerate((rows - 1, 0, rows, rows + 1,
                                          2 * rows + W, 0, 700, 5))]
        compare_batched(sk, de, genomes, dev, False, 0.3, True,
                        H=5 * rows + 3)
        n_cases += 1
        log("  batched band W %d: launch %s" % (W, json.dumps(
            sk.launch_shape_batched(len(genomes), 5 * rows + 3, W))))
    log("batched entry: %d cases, kernel == plain (%.1f s)"
        % (n_cases, time.monotonic() - t0))
    # the fused epilogues on the same genome sets, edge cases and bands
    t0 = time.monotonic()
    n_cases = 0
    for seed0 in (0, 100):
        genomes = [random_genome(np.random.default_rng(seed0 + k), n_hits=n,
                                 weak=True, max_exon=6, max_cs=30 * n + 100)
                   for k, n in enumerate(sizes)]
        for check_strand in (False, True):
            for f in (0.5, 0.3):
                if not compare_fused(sk, genomes, dev, check_strand, f,
                                     H=3100, seed=seed0):
                    raise AssertionError("the fused sweep shadowed nothing")
                n_cases += 2
    for which, genomes in stacked_edge_cases().items():
        compare_fused(sk, [(d, g) for d, g in genomes
                           if int(g.hits.n_exon.max(initial=0)) < 100],
                      dev, False, 0.3, seed=3)
        n_cases += 2
    for W in (1, 8, 21, 32, 33):
        genomes = [band_genome(np.random.default_rng(10 * W + k), n, W)
                   for k, n in enumerate((rows - 1, 0, rows, rows + 1,
                                          2 * rows + W, 0, 700, 5))]
        compare_fused(sk, genomes, dev, False, 0.3, H=5 * rows + 3, seed=W)
        n_cases += 2
        log("  fused band W %d: launch LOOP %s STEP %s" % (W, json.dumps(
            sk.launch_shape_batched(len(genomes), 5 * rows + 3, W,
                                    sk.EPI_LOOP)), json.dumps(
            sk.launch_shape_batched(len(genomes), 5 * rows + 3, W,
                                    sk.EPI_STEP))))
    log("fused sweep: %d cases, LOOP and STEP epilogues == plain (%.1f s)"
        % (n_cases, time.monotonic() - t0))

    # 2d. the per-round device step: random genome sets (one genome's row 0
    # filtered), then the edge cases as one stack (without the 2,000-exon
    # hit, which the split-form plain sweep cannot hold)
    t0 = time.monotonic()
    n_cases = 0
    genomes = [random_genome(np.random.default_rng(60 + k), n_hits=n,
                             weak=True, max_exon=6, max_cs=30 * n + 100)
               for k, n in enumerate(sizes)]
    genomes[1][1].hits.flt[0] = 1
    for check_strand in (False, True):
        for use_ori in (False, True):
            for f in (0.5, 0.3):
                if not compare_step(stk, sk, genomes, dev, check_strand,
                                    use_ori, f):
                    raise AssertionError("the step found no arc")
                n_cases += 1
    for which, genomes in stacked_edge_cases().items():
        compare_step(stk, sk, [(d, g) for d, g in genomes
                               if int(g.hits.n_exon.max(initial=0)) < 100],
                     dev, False, False, 0.3)
        n_cases += 1
    log("per-round step: %d cases, card == CPU, every output "
        "(%.1f s)" % (n_cases, time.monotonic() - t0))
    # the step's kernels on the step states; on the tile states also
    # inside a CUDA graph of repeated launches
    t0 = time.monotonic()
    n_cases = n_graphs = 0
    for k, which in enumerate(STEP_STATES):
        state = step_state(which, 300 + k, torch.device("cpu"))
        for use_ori in (False, True):
            calls = step_calls(state, dev, use_ori)
            if not compare_step_kernels(stkk, calls):
                raise AssertionError("step state %s: no arc" % which)
            n_cases += 2
            if which.startswith("tile") and not use_ori:
                step_graph_equal(stkk, calls)
                n_graphs += 2
    # the seen bits at the most genes the one-block-a-genome walk kept in
    # shared memory, and one past it
    for n_gene in (SEEN_SMEM_GENES, SEEN_SMEM_GENES + 1):
        state = step_state("many_genes", 330, torch.device("cpu"),
                           n_gene=n_gene)
        if not compare_step_kernels(stkk, step_calls(state, dev)):
            raise AssertionError("%d genes: no arc" % n_gene)
        n_cases += 2
    log("step kernels: %d cases on %d states and %d / %d genes, %d in CUDA "
        "graphs of three launches replayed twice; step_walk and step_dedupe "
        "== plain (%.1f s)" % (
            n_cases, len(STEP_STATES), SEEN_SMEM_GENES, SEEN_SMEM_GENES + 1,
            n_graphs, time.monotonic() - t0))

    # 2e. the device loop's block kernels: random arc tables (every group
    # size up to the block path's 64 and one past it, the wide path) and
    # merge keys in the loop's three call shapes
    t0 = time.monotonic()
    n_cases = 0
    on_dev = lambda x: None if x is None else \
        torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    for G in (1, 33, 70):
        rng = np.random.default_rng(G)
        sizes = list(rng.permutation(np.arange(1, 65))) + [65]
        for frag in (False, True):
            for diffs in ((0.02, 0.05, 0.5), EXACT_BRANCH_DIFFS):
                t, _ = branch_table(rng, G, sizes, n_gene=300,
                                    ratios=deficit_ratios(diffs))
                kw = dict(zip(("branch_diff", "branch_diff_dist",
                               "branch_diff_cut"), diffs),
                          B=BRANCH_B, frag_mode=frag, local_dist=1000,
                          local_count=3)
                args = [on_dev(v) for v in t.values()]
                _, got = compare_loop_kernel(lk, "branch_block", args, kw)
                (la, lkw), cls = branch_split_args(args, kw)
                _, (aml, he) = compare_loop_kernel(lk, "branch_locality", la,
                                                   lkw)
                _, split = compare_loop_kernel(lk, "branch_classify",
                                               *cls(aml, he))
                if not all(torch.equal(a, b) for a, b in zip(got, split)):
                    raise AssertionError("branch_block != branch_locality "
                                         "+ branch_classify")
                n_cases += 3
    # branch_classify alone: groups over several warps (the wide path's),
    # its bit planes as the mesh passes them (he the second row of one
    # [2, A] tensor, unaligned)
    rng = np.random.default_rng(5)
    vw = np.concatenate([np.full(n, (2 * k + 1) << BRANCH_B, np.int64)
                         for k, n in enumerate(rng.integers(1, 700, 300))]
                        + [np.full(3, (1 << 62) - 1, np.int64)])
    s1 = rng.integers(0, 3000, len(vw)).astype(np.int32)
    gs_of, mx, branching, _ = lk.arc_groups(on_dev(vw), on_dev(s1),
                                            BRANCH_B)
    aml, he = torch.from_numpy(rng.random((2, len(vw))) < 0.4).to(dev)
    compare_loop_kernel(lk, "branch_classify",
                        [on_dev(s1), mx, branching, aml, he, gs_of],
                        dict(zip(("branch_diff", "branch_diff_dist",
                                  "branch_diff_cut"), (0.02, 0.05, 0.5))))
    n_cases += 1
    # merge_fold lean and full: (N, cap, valid share, out-groups, dist)
    wide = (0, 1 << 20)
    for form in ("jb", "cosorted", "exchange"):
        for N, cap, p_valid, n_vw, dist in (
                (3000, 100, 0.7, 375, wide), (3000, 3077, 0.7, 375, wide),
                (600000, 400000, 0.7, 75000, wide), (500, 64, 0.0, 62, wide),
                (60000, 4000, 0.8, 3, wide), (60000, 4000, 0.8, 47, wide),
                (20000, 20000, 0.8, 2500, ((1 << 30) - 50, (1 << 30) + 50)),
                (20000, 20000, 0.8, 2500, (-(1 << 31), 1 << 31))):
            keys, s1, jb, gb, perm, st = fold_inputs(
                np.random.default_rng(N + cap + n_vw), form, N, n_vw=n_vw,
                p_valid=p_valid, full=True, dist=dist)
            for full in (None, tuple(map(on_dev, st))):
                compare_loop_kernel(
                    lk, "merge_fold", [on_dev(keys), on_dev(s1)],
                    dict(jb=jb, gb=gb, cap=cap, perm=on_dev(perm),
                         full=full))
                n_cases += 1
    # the round kernels on testing.ROUND_STATES
    for k, which in enumerate(ROUND_STATES):
        state = make_state(which, 200 + k)
        for form in WALK_FORMS:
            compare_round_kernel("walk_pairs", round_calls(
                state, dev, form=form, use_ori=form == "cosorted")[
                    "walk_pairs"])
        calls = round_calls(state, dev)
        compare_round_kernel("branch_prep", calls["branch_prep"])
        for propagate in (True, False):
            compare_round_kernel("prop_round", round_calls(
                state, dev, propagate=propagate)["prop_round"])
        for cuts in ((60, 3, 2), None):
            for loci in (True, False):
                compare_round_kernel("occ_round", round_calls(
                    state, dev, cuts=cuts, loci=loci)["occ_round"])
        n_cases += len(WALK_FORMS) + 7
    log("loop block kernels: %d cases, branch_block, branch_locality, "
        "branch_classify, merge_fold, walk_pairs, branch_prep, prop_round "
        "and occ_round == plain (%.1f s)" % (n_cases, time.monotonic() - t0))

    # 3. the main paths, counts zeroed just before and read just after
    # wall and count of the single-genome sweep calls through ops/dispatch
    # (the kernel under --engine device, C under sharded)
    sweep_s = {"s": 0.0, "calls": 0}

    def timed(fn):
        def wrapper(*a, **kw):
            sweep_s["calls"] += 1
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
    loop_launches = {k: 0 for k in LOOP_KERNELS}
    # the fused sweep's launches by epilogue and the step kernels'
    step_launches = {k: 0 for k in FUSED_KERNELS}
    runs = {}
    # the loop's device tensors of each corpus's sharded run, for phase 4
    kept = {}
    schedule_device = dl.schedule_device
    driving = None

    def keep_schedule(*a, **kw):
        capture = {}
        outs = schedule_device(*a, capture=capture, **kw)
        kept[driving] = dict(blocks=a[:5], cfg=kw["cfg"], outs=outs,
                             capture=capture)
        return outs

    dl.schedule_device = keep_schedule

    def draws_running():
        return [n for n, p in draws.items() if p is not None
                and p.poll() is None]

    def drive(key, name, engine, path, env=None):
        """One run of the CLI on cuda over corpus `name`, every count zeroed
        just before and read just after; checks the md5, that no plain
        version ran and that the native entries of `path`
        (NATIVE_ENTRIES) were called; returns (record, final graph)."""
        nonlocal batched_launches, driving
        driving = name
        env = env or {}
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        sweep_s.update(s=0.0, calls=0)
        sk.reset_counts()
        lk.reset_counts()
        stkk.reset_counts()
        mkk.reset_counts()
        sn.reset_counts()
        dl.LAST.clear()
        stk.LAST.clear()
        running = draws_running()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        try:
            gfa, graph = run_cli(corpora[name], engine, CORPORA[name].args)
        finally:
            for k, v in old.items():
                if v is None:
                    del os.environ[k]
                else:
                    os.environ[k] = v
        wall = time.monotonic() - t0
        counts = dict(sk.n_kernel_launches)
        plain = dict(sk.n_plain_calls)
        batched = sk.n_batched()
        loop = {k: c["kernel"] for k, c in lk.n_calls.items()}
        step = fused_counts(sk, stkk)
        native = {k: v for k, v in sn.n_calls.items() if v}
        calls = max(sweep_s["calls"], 1)
        rec = {
            "hits": sum(g.n_hit for g in graph.d.genomes),
            "md5": hashlib.md5(gfa.encode()).hexdigest(),
            "wall_s": round(wall, 3), "stages": dict(util.stage_stats),
            "per_genome_sweep_s": round(sweep_s["s"], 3),
            "per_genome_sweep_calls": sweep_s["calls"],
            "sweep_ms_per_call": round(1e3 * sweep_s["s"] / calls, 4),
            "launches": {sk.MODE_NAMES[m]: counts[m] for m in counts},
            "batched_launches": batched["kernel"],
            "loop_launches": loop,
            "step_launches": step,
            "plain_calls": (sum(plain.values()) + batched["plain"]
                            + sum(c["plain"] for c in lk.n_calls.values())
                            + sum(c["plain"]
                                  for c in stkk.n_calls.values())
                            + sum(c["plain"]
                                  for c in mkk.n_calls.values())),
            "native_calls": native,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "env": env, "draws_running": running}
        if dl.LAST:
            rec["host_syncs_a_round"] = round(
                dl.LAST.get("host_syncs", 0)
                / max(dl.LAST.get("rounds_total", 1), 1), 3)
            rec["LAST"] = dict(dl.LAST)
        if stk.LAST:
            rec["rounds_LAST"] = dict(stk.LAST)
        runs[key] = rec
        log("e2e %s: %s" % (key, json.dumps(rec)))
        if rec["md5"] != CORPORA[name].md5:
            raise AssertionError("%s: GFA md5 %s != %s"
                                 % (key, rec["md5"], CORPORA[name].md5))
        if rec["plain_calls"]:
            raise AssertionError("%s: plain calls on the card path: %s %s %s"
                                 % (key, plain, batched, lk.n_calls))
        # the block kernels: once a branch round, once an in-loop merge and
        # once for the full tail of an engaged loop, never elsewhere
        last = rec.get("LAST", {})
        want = loop_kernels_want(last)
        if loop_kernel_counts(loop, 1) != want:
            raise AssertionError("%s: loop kernel launches %s, expected %s"
                                 % (key, loop, want))
        add_loop_launches(loop_launches, loop)
        add_loop_launches(step_launches, step)
        # the batched kernel runs with the loop's epilogue in the loop, the
        # step's in the per-round path, the step kernels only there
        want = {"sweep_round_loop": batched["kernel"] if path == "sharded"
                else 0}
        if path in ("rounds", "fallback"):
            n = stk.LAST.get("rounds", -1)
            want.update(sweep_round_step=n, step_walk=n, step_dedupe=n)
        if {k: v for k, v in step.items() if v} != \
                {k: v for k, v in want.items() if v} or \
                batched["kernel"] != step["sweep_round_loop"] \
                + step["sweep_round_step"]:
            raise AssertionError("%s: fused sweep and step kernel launches "
                                 "%s, expected %s (batched %d)" % (
                                     key, step, want, batched["kernel"]))
        missing = [e for e in NATIVE_ENTRIES[path] if not native.get(e)]
        if missing:
            raise AssertionError("%s: the native runtime was not called for "
                                 "%s (calls %s)" % (key, missing, native))
        if "rounds_branch_host_s" in rec["stages"]:
            log("  %s host rounds: rounds_branch_host_s %s rounds_gen_arc_s "
                "%s graph_s %s" % (key, rec["stages"]["rounds_branch_host_s"],
                                   rec["stages"]["rounds_gen_arc_s"],
                                   rec["stages"]["graph_s"]))
        if path == "device":
            # the port of the JAX package's "jax" engine: every
            # single-genome sweep on the kernel, none in C
            if any(v == 0 for v in counts.values()):
                raise AssertionError("%s: the per-genome kernel was not "
                                     "launched in both modes: %s"
                                     % (key, counts))
            if any(native.get(e) for e in NATIVE_SWEEPS):
                raise AssertionError("%s: --engine device swept in C: %s"
                                     % (key, native))
        elif sum(counts.values()):
            # sharded sweeps single genomes in C, as the JAX package does
            raise AssertionError("%s: the per-genome kernel was launched "
                                 "under sharded: %s" % (key, counts))
        batched_launches += batched["kernel"]
        for m in launches:
            launches[m] += counts[m]
        return rec, graph

    def check_rounds(key, rec, rounds):
        """The per-round path ran `rounds` device steps, one batched launch
        each, on constant columns uploaded once."""
        last = rec.get("rounds_LAST", {})
        if not (last.get("rounds") == rounds == rec["batched_launches"]
                == last.get("sweep_launches")
                == rec["step_launches"]["sweep_round_step"]
                == last["step_launches"]["step_walk"]
                == last["step_launches"]["step_dedupe"]):
            raise AssertionError("%s: per-round steps %s, batched launches "
                                 "%d, expected %d" % (
                                     key, last.get("rounds"),
                                     rec["batched_launches"], rounds))
        if last["const_uploads"] != 1:
            raise AssertionError("%s: constant columns uploaded %d times"
                                 % (key, last["const_uploads"]))

    opt_cuda = PgOpt(device=DEVICE)
    n_rounds = 2 + opt_cuda.n_branch_flt

    def run_path(name, path):
        """The in-process run of `path` (IN_PROCESS) on corpus `name`, with
        that path's checks; returns its final graph."""
        key = "%s_%s" % (name, path)
        if path == "device":
            # the per-genome engine: host rounds, one launch a sweep
            rec, graph = drive(key, name, "device", "device")
            if rec["batched_launches"] or "LAST" in rec or \
                    "rounds_LAST" in rec:
                raise AssertionError("%s: the per-genome path ran a batched "
                                     "sweep" % key)
        elif path == "sharded":
            # the device-resident loop
            rec, graph = drive(key, name, "sharded", "sharded")
            last = rec.get("LAST", {})
            if last.get("engaged") is not True:
                raise AssertionError("%s: the device loop did not engage: %s"
                                     % (key, last))
            if rec["batched_launches"] == 0 or \
                    rec["batched_launches"] != last["rounds_sweep_run"] or \
                    rec["batched_launches"] != last["sweep_launches"]:
                raise AssertionError("%s: batched launches %d != sweep rounds"
                                     " run %d" % (key, rec["batched_launches"],
                                                  last["rounds_sweep_run"]))
            if "rounds_LAST" in rec:
                raise AssertionError("%s: the per-round path ran beside the "
                                     "loop" % key)
        elif path == "rounds":
            # the per-round device step in place of the loop
            rec, graph = drive(key, name, "sharded", "rounds",
                               env={"PANGENE_DEVICE_LOOP": "0"})
            if "LAST" in rec:
                raise AssertionError("%s: the device loop ran with "
                                     "PANGENE_DEVICE_LOOP=0" % key)
            check_rounds(key, rec, n_rounds)
        else:
            # the fallback a user gets: the loop refuses the graph after
            # phase 1 (an arc table of one slot) and the host rounds take the
            # per-round step
            rec, graph = drive(key, name, "sharded", "fallback",
                               env={"PANGENE_DEVLOOP_MAX_A": "1"})
            if rec.get("LAST", {}).get("engaged") is not False:
                raise AssertionError("%s: the loop did not report a "
                                     "fallback: %s" % (key, rec.get("LAST")))
            check_rounds(key, rec, n_rounds - 1)
        return graph

    # 3c. the builds as a user runs them, each in a process of its own
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)

    def build_process(key, name, path, args=()):
        """One build by BUILD_SCRIPT in a new process, of `path` ("sharded":
        the default engine, or "host"); checks the md5, the parse pool's
        start method and the path the build took, and returns the GFA's
        path and the build's report."""
        gfa = os.path.join(out_dir, key + ".gfa")
        if draws_running():
            raise AssertionError("%s: the draws %s still run beside the "
                                 "build" % (key, draws_running()))
        t0 = time.monotonic()
        with open(gfa, "wb") as fp:
            r = subprocess.run(
                [sys.executable, "-c", BUILD_SCRIPT, "-v", "1"]
                + list(CORPORA[name].args) + list(args) + corpora[name],
                cwd=ROOT, stdout=fp, stderr=subprocess.PIPE, text=True,
                timeout=900)
        wall = time.monotonic() - t0
        if r.returncode:
            raise AssertionError("%s: the build exited %d: %s"
                                 % (key, r.returncode, r.stderr[-2000:]))
        st = json.loads([x for x in r.stderr.splitlines()
                         if x.startswith("STAGES=")][-1][len("STAGES="):])
        with open(gfa, "rb") as fp:
            md5 = hashlib.md5(fp.read()).hexdigest()
        in_process = runs.get("%s_%s" % (name, path), {}).get("stages", {})
        stages_s = sum(st[k] for k in ("parse_s", "post_s", "graph_s",
                                       "emit_s"))
        rec = {"md5": md5, "wall_s": round(wall, 3), "stages": st,
               # cli.main's wall outside the stages (a card engine's torch
               # import and device check), and the wall outside the script's
               # own clock (the interpreter's start and exit)
               "main_outside_stages_s": round(st["main_s"] - stages_s, 3),
               "outside_script_s": round(wall - st["import_s"]
                                         - st["main_s"], 3),
               "in_process_parse_s": in_process.get("parse_s"),
               "args": list(CORPORA[name].args) + list(args)}
        log("process %s: %s" % (key, json.dumps(rec)))
        bad = []
        if md5 != CORPORA[name].md5:
            bad.append("GFA md5 %s != %s" % (md5, CORPORA[name].md5))
        if st.get("parse_pool") != "fork":
            bad.append("the parse pool started by %r, not fork"
                       % st.get("parse_pool"))
        native = st.get("native_calls", {})
        missing = [e for e in NATIVE_ENTRIES[path] if not native.get(e)]
        if missing:
            bad.append("the native runtime was not called for %s" % missing)
        loop = st.get("loop", {})
        if path == "host":
            if st["torch_imported"] or loop:
                bad.append("the host engine imported torch")
        else:
            n = st["launches"]
            if loop.get("engaged") is not True:
                bad.append("the device loop did not engage: %s" % loop)
            elif (n["plain"] or n["per_genome"] or any(n["step"].values())
                  or n["batched"] != loop["rounds_sweep_run"]
                  or n["fused"] != {"loop": n["batched"], "step": 0}
                  or loop_kernel_counts(n["loop"], 1)
                  != loop_kernels_want(loop)):
                bad.append("launches %s" % n)
            else:
                log("  %s loop (cold): shape %s, run_s %.3f, host_syncs %d, "
                    "block_ms %s, peak device bytes %d" % (
                        key, json.dumps(loop["shape"]), loop["run_s"],
                        loop["host_syncs"], json.dumps(loop["block_ms"]),
                        st.get("peak_device_bytes", 0)))
        if bad:
            raise AssertionError("%s: %s" % (key, "; ".join(bad)))
        return gfa, st

    # what a card engine's process pays before its build starts: the
    # torch import, torch.cuda.is_available() (which must leave torch's
    # CUDA state uninitialised, or the parse pool would spawn) and the
    # first context
    r = subprocess.run([sys.executable, "-c", CUDA_START_PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       check=True)
    probe = json.loads(r.stdout.strip().splitlines()[-1])
    log("process start on the card: %s" % json.dumps(probe))
    if probe["initialised_after_is_available"]:
        raise AssertionError("torch.cuda.is_available() initialised CUDA")

    corpora = {}
    big_graphs = {}   # the big corpus's final graph by path, for phase 4
    rounds_graphs = {}   # big's and the north star's per-round graphs
    built = {}

    def take(name):
        """Corpus `name` once its draw has ended."""
        corpora[name], draw_s, wait_s = make_corpus(name, draws[name])
        log("corpus %s: %d files, %s, waited %.3f s here" % (
            name, len(corpora[name]), "cached" if draw_s is None else
            "drawn in %.3f s in a process of its own" % draw_s, wait_s))

    def in_process(name):
        """The in-process runs of corpus `name` (IN_PROCESS)."""
        for path in IN_PROCESS[name]:
            graph = run_path(name, path)
            if name == "big":
                big_graphs[path] = graph
            if path == "rounds" and name in ("big", "northstar"):
                rounds_graphs[name] = graph
            if path == "rounds":
                # the protein-keyed reductions on the card against the host
                # loops
                card_s, host_s = compare_reductions(stk, opt_cuda, graph.d)
                runs[name + "_rounds"]["reductions_s"] = {
                    "card": round(card_s, 4), "host_loops": round(host_s, 4)}
                log("reductions %s: post_reductions_sharded == host loops (%d"
                    " proteins); card %.4f s (stacking, upload, 7 reductions,"
                    " one pull), host loops %.4f s" % (
                        name, graph.d.n_prot, card_s, host_s))
            del graph

    # beside the north star's draw: the in-process runs of the corpora
    # BESIDE_DRAW, each once its draw has ended, then the genome mesh (3e)
    for name in names:
        if name in BESIDE_DRAW:
            take(name)
            in_process(name)
    for name in MESH_CORPORA:
        if name in names and name not in corpora:
            take(name)
    t0 = time.monotonic()
    log("mesh phase beside the draws %s" % draws_running())
    (mesh_runs, mesh_launches, mesh_loop_launches, mesh_step_launches,
     mesh_kernel_launches) = mesh_phase(corpora)
    runs["mesh"] = mesh_runs
    log("mesh phase: %d runs, %d batched launches, loop kernel launches %s, "
        "fused / step kernel launches %s and mesh kernel launches %s over "
        "every rank, %.1f s" % (
            len(mesh_runs), mesh_launches, json.dumps(mesh_loop_launches),
            json.dumps(mesh_step_launches),
            json.dumps(mesh_kernel_launches), time.monotonic() - t0))
    # then, once no draw runs, the other corpora's in-process runs
    for name in names:
        if name not in BESIDE_DRAW:
            if name not in corpora:
                take(name)
            in_process(name)
    dispatch.shadow, dispatch.flt_ov_isoform = untimed
    dl.schedule_device = schedule_device
    # then the builds as a user runs them, every draw ended; small's only
    # when the toolkit needs its GFA (no big corpus in the run)
    for name in names:
        if name == "small" and "big" in names:
            continue
        for kind, path in (("default", "sharded"), ("host", "host")):
            key = "%s_%s_process" % (name, kind)
            built[key], _ = build_process(
                key, name, path, () if kind == "default"
                else ("--engine", "host"))

    # a traced build as a user runs it: its start method says whether
    # starting the profiler's CUDA activity initialised CUDA before parsing;
    # from the trace's device events the device's busy seconds, the idle
    # share of the build and the five device operations with most time
    prof_name = "big" if "big" in names else names[0]
    key = prof_name + "_profile_process"
    prof_dir = os.path.join(out_dir, "profile_process")
    _, st = build_process(key, prof_name, "sharded", ("--profile", prof_dir))
    trace = os.path.join(prof_dir, pipeline.TRACE_NAME)
    trace_bytes = os.path.getsize(trace)
    summary = util.trace_device_summary(trace)
    os.remove(trace)
    if summary["n_events"] == 0 or summary["busy_s"] <= 0:
        raise AssertionError("%s: the trace holds no device event: %s"
                             % (key, summary))
    build_s = sum(st[k] for k in ("parse_s", "post_s", "graph_s", "emit_s"))
    log("%s: the parse pool started by %s; trace %d bytes, %d device events;"
        " device busy %.6f s of a %.3f s build: idle share %.4f%%" % (
            key, st.get("parse_pool"), trace_bytes, summary["n_events"],
            summary["busy_s"], build_s,
            100 * (1.0 - summary["busy_s"] / build_s)))
    for op, secs, n in summary["top"]:
        log("  device op %.6f s in %d calls: %s" % (secs, n, op[:100]))

    # 3d. the toolkit on the card's host, on the GFA the default engine
    # built for the big corpus (else the small one), and on the C4 golden
    tool_name = [n for n in ("big", "small") if n in names][:1]
    if tool_name:
        tool_name = tool_name[0]
        tool_gfa = built[tool_name + "_default_process"]

        def tool(args):
            t0 = time.monotonic()
            r = subprocess.run(
                [sys.executable, "-m", "pangene_tpu_torch.tools.cli"]
                + list(args), cwd=ROOT, capture_output=True, timeout=600)
            if r.returncode:
                raise AssertionError("toolkit %s exited %d: %s" % (
                    args, r.returncode, r.stderr.decode()[-2000:]))
            return r.stdout, time.monotonic() - t0

        for cmd in ("call", "gfa2matrix"):
            out, wall = tool((cmd, tool_gfa))
            md5 = hashlib.md5(out).hexdigest()
            log("toolkit %s on the %s GFA: %d bytes, md5 %s, wall %.3f s"
                % (cmd, tool_name, len(out), md5, wall))
            if md5 != TOOL_MD5[tool_name][cmd]:
                raise AssertionError("toolkit %s: md5 %s != %s" % (
                    cmd, md5, TOOL_MD5[tool_name][cmd]))
        golden = os.path.join(ROOT, "tests", "golden")
        out, wall = tool(("call", os.path.join(golden, "C4.gfa")))
        with open(os.path.join(golden, "bubble", "C4.call.txt"), "rb") as fp:
            if out != fp.read():
                raise AssertionError("toolkit call on C4.gfa != the golden")
        log("toolkit call on tests/golden/C4.gfa == tests/golden/bubble/"
            "C4.call.txt (%.3f s)" % wall)

    if set(names) != set(CORPORA):
        log("partial run (--corpora %s): phase 4 and the result lines are "
            "left out" % ",".join(names))
        return 0

    # 4. the largest big-corpus genome: compare, time, bound
    graph, rounds_graph = big_graphs["sharded"], big_graphs["rounds"]
    g = max(graph.d.genomes, key=lambda x: x.n_hit)
    hit_sort(g, by_cm=False)
    kernels = []
    # the mesh kernels: launches from the mesh's ranks (3e) only
    mesh_recs = {name: {
        "name": name, "route": "cuda",
        "source": "pangene_tpu_torch/csrc/mesh_round.cu",
        "replaces": replaces, "launches": mesh_kernel_launches[name],
        "max_abs_err": 0, "library_ms": None} for name, replaces in (
            ("protein_reduce", "pangene_tpu/parallel/stacked.py:428"),
            ("exchange_pack", "pangene_tpu/parallel/device_loop.py:325"),
            ("exchange_window", "pangene_tpu/parallel/device_loop.py:377"),
            ("exchange_finish", "pangene_tpu/parallel/device_loop.py:393"))}
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

    # the native runtime's shadow sweep on the same genome against the wall
    # of one CUDA dispatch of it (why sharded sweeps single genomes in C):
    # unfiltered with the dominator scores, as parsing's read postpass calls
    # it, and in the final filter state; both must leave the same columns
    def best_ms(fn, reps=5):
        walls = []
        for _ in range(reps):
            t0 = time.monotonic()
            fn()
            walls.append(time.monotonic() - t0)
        return 1e3 * min(walls)
    d_big = graph.d
    runs["native_vs_dispatch_ms"] = {}
    for state, cal_dom_sc in (("unfiltered", True), ("final", False)):
        g.hits.flt[:] = states[state]
        native_ms = best_ms(lambda: sn.shadow(opt_cuda, d_big, g, cal_dom_sc))
        native_cols = (g.hits.shadow.copy(), g.hits.pid_dom.copy(),
                       g.hits.score_dom.copy())
        dispatch_ms = best_ms(lambda: de.shadow(opt_cuda, d_big, g,
                                                cal_dom_sc))
        if not all(np.array_equal(a, b) for a, b in zip(
                native_cols, (g.hits.shadow, g.hits.pid_dom,
                              g.hits.score_dom))):
            raise AssertionError("native shadow sweep != CUDA dispatch on "
                                 "the largest genome (%s)" % state)
        runs["native_vs_dispatch_ms"][state] = {
            "hits": g.n_hit, "native": native_ms,
            "cuda_dispatch": dispatch_ms}
        log("shadow sweep of the largest genome (%d hits, %s state), best "
            "of 5: native runtime %.4f ms, CUDA dispatch (pack, upload, "
            "kernel, download, finalize) %.4f ms; same columns" % (
                g.n_hit, state, native_ms, dispatch_ms))
    g.hits.flt[:] = states["final"]

    # 4b. the batched entry on the big run's device-resident columns: entry
    # state (no kept row filtered) and the loop's final state
    rec = {"name": "shadow_sweep_batched", "route": "cuda",
           "source": "pangene_tpu_torch/csrc/shadow_sweep.cu",
           "replaces": "pangene_tpu/ops/device.py:232",
           "launches": batched_launches + mesh_launches,
           "launches_in_process": batched_launches,
           "launches_mesh_ranks": mesh_launches, "max_abs_err": 0,
           "library_ms": None}
    batched_rec = rec
    rec.update(batched_on_loop(sk, dl, kept["big"], "big"))
    fused_recs = {name: {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": step_launches[name] + mesh_step_launches[name],
        "launches_in_process": step_launches[name],
        "launches_mesh_ranks": mesh_step_launches[name], "max_abs_err": 0,
        "library_ms": None} for name, source, replaces in (
            ("sweep_round_loop", "pangene_tpu_torch/csrc/shadow_sweep.cu",
             "pangene_tpu/parallel/device_loop.py:758"),
            ("sweep_round_step", "pangene_tpu_torch/csrc/shadow_sweep.cu",
             "pangene_tpu/parallel/stacked.py:61"),
            ("step_walk", "pangene_tpu_torch/csrc/step_round.cu",
             "pangene_tpu/parallel/stacked.py:85"),
            ("step_dedupe", "pangene_tpu_torch/csrc/step_round.cu",
             "pangene_tpu/parallel/stacked.py:117"))}
    fused_recs["sweep_round_loop"].update(
        fused_on_loop(sk, dl, kept["big"], "big"))
    # one kernel: every launch has an epilogue (the three planes are STEP
    # on a zeroed shadow plane)
    by_epi = {e: fused_recs["sweep_round_" + e]["launches"]
              for e in ("loop", "step")}
    if sum(by_epi.values()) != batched_rec["launches"]:
        raise AssertionError("batched launches %d != by epilogue %s" % (
            batched_rec["launches"], by_epi))
    batched_rec["launches_by_epilogue"] = by_epi
    cfg = kept["big"]["cfg"]
    G, H = kept["big"]["blocks"][0].shape[1:3]

    # the same entry at the shard shapes of the mesh runs: rank 0's genomes
    # of the big loop's columns at world 4 and 2, entry state
    for g_loc in (G // 4, G // 2):
        scols, sbc = dl.unpack_blocks(*[b[:, :g_loc].contiguous()
                                        for b in kept["big"]["blocks"]])
        sflt = scols["flt"].contiguous()
        sweak = scols["weak_br"].contiguous()
        got = sk.shadow_sweep_batched(sbc, sflt, sweak, cfg.W,
                                      cfg.check_strand, cfg.min_ov_ratio)
        want = sk.shadow_sweep_batched_plain(sbc, sflt, sweak, cfg.W,
                                             cfg.check_strand,
                                             cfg.min_ov_ratio)
        for a, b in zip(got, want):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError("batched kernel != plain at the shard "
                                     "shape G_loc %d" % g_loc)

        def kernel():
            sk.shadow_sweep_batched(sbc, sflt, sweak, cfg.W, cfg.check_strand,
                                    cfg.min_ov_ratio)
        ms = graph_ms(kernel, TIMED_LAUNCHES)
        b_ms, b_by, ops, nbytes = bound_batched_ms(sbc, sflt, cfg.W,
                                                   cfg.check_strand)
        log("BATCHED shard G_loc %d: H %d rows %d W %d ms %.5f bound_ms %.6f "
            "(%s; %d ops, %d bytes) marked %d; kernel == plain" % (
                g_loc, H, int(sbc.n_rows.sum()), cfg.W, ms, b_ms, b_by, ops,
                nbytes, int(got[0].sum())))
        rec.update({"ms_shard%d" % g_loc: ms,
                    "bound_ms_shard%d" % g_loc: b_ms})
        del got, want

    # the same entry at the per-round path's shape: the full [G, H] stack of
    # the big run, filtered rows in place, with every row unfiltered (the
    # most work) and in the run's final filter state
    cache = rounds_graph._stacked_dev_cache
    sbc, sW = cache["cols"].batch, cache["W"]
    sG, sH = cache["G"], cache["H"]
    fin_flt, _, sweak = torch.from_numpy(stk.stack_mutable(
        rounds_graph.d, np.zeros((3, sG, sH), np.uint8))).to(dev)
    for state, sflt in (("unfiltered", torch.zeros_like(fin_flt)),
                        ("final", fin_flt)):
        got = sk.shadow_sweep_batched(sbc, sflt, sweak, sW, False, 0.5)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        want = sk.shadow_sweep_batched_plain(sbc, sflt, sweak, sW, False,
                                             0.5)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.monotonic() - t0)
        for a, b in zip(got, want):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError("batched kernel != plain on the "
                                     "per-round path's big stack (%s)"
                                     % state)
        del want

        def kernel():
            sk.shadow_sweep_batched(sbc, sflt, sweak, sW, False, 0.5)
        ms = graph_ms(kernel, TIMED_LAUNCHES)
        b_ms, b_by, ops, nbytes = bound_batched_ms(sbc, sflt, sW, False)
        rows = int(sbc.n_rows.sum())
        log("BATCHED per-round stack %s: G %d H %d rows %d (unfiltered %d) "
            "W %d E %d launch %s ms %.5f plain_ms %.3f bound_ms %.6f (%s; "
            "%d ops, %d bytes) marked %d" % (
                state, sG, sH, rows,
                int((sflt == 0).sum()) - (sG * sH - rows), sW, cache["E"],
                json.dumps(sk.launch_shape_batched(sG, sH, sW)), ms,
                plain_ms, b_ms, b_by, ops, nbytes, int(got[0].sum())))
        if state == "unfiltered":
            if not got[0].any():
                raise AssertionError("the unfiltered stack marked nothing")
            rec.update(ms_rounds=ms, plain_ms_rounds=plain_ms,
                       bound_ms_rounds=b_ms)
        else:
            rec["ms_rounds_final"] = ms
    kernels.append(rec)
    # the fused STEP sweep and the step's kernels on the per-round stacks
    # in the run's final state, with the round's shadow flags: big's, the
    # north star's, and big's first 16 genomes (a mesh rank's shard)
    for label, cname, g_loc in (("", "big", None),
                                ("_northstar", "northstar", None),
                                ("_shard16", "big", 16)):
        scols, s_flt, s_weak, s_shadow, s_g2s, s_W = step_stack(
            stk, rounds_graphs[cname], dev, g_loc)
        step_recs = step_on_stack(sk, stkk, scols, s_flt, s_weak, s_shadow,
                                  s_g2s, s_W, opt_cuda.use_ori_for_branch)
        G_s, H_s = s_flt.shape
        where = "%s%s" % (cname, "" if g_loc is None
                          else " shard G_loc %d" % g_loc)
        for name in ("sweep_round_step", "step_walk", "step_dedupe"):
            r = step_recs[name]
            extra = ""
            if name == "step_walk":
                extra = ("; counters in PyTorch (scatter_add_ and two sums) "
                         "%.5f ms, %d kept, %d pairs; launch %s" % (
                             r["counters_torch_ms"], r["kept"], r["pairs"],
                             json.dumps(r["launch"])))
            elif name == "step_dedupe":
                extra = "; %d groups, %d arcs; launch %s" % (
                    r["groups"], r["arcs"], json.dumps(r["launch"]))
            log("STEP KERNEL %s, per-round stack %s final (G %d H %d n_gene "
                "%d): ms %.5f plain_ms %.3f bound_ms %.6f (%s; %d bytes)%s; "
                "kernel == plain, also in a CUDA graph" % (
                    name, where, G_s, H_s, s_g2s.shape[0], r["ms"],
                    r["plain_ms"], r["bound_ms"], r["bound_by"],
                    r["nbytes"], extra))
            fused_recs[name].update({k + label: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")})
            if "launch" in r:
                fused_recs[name]["launch" + label] = r["launch"]
        fused_recs["step_walk"]["counters_torch_ms" + label] = \
            step_recs["step_walk"]["counters_torch_ms"]
        log("torch.sort of the step, per-round stack %s final: (cid, cm) key "
            "%.5f ms, arc key %.5f ms (stable, [G, H] and [G, 2H] int64)" % (
                where, step_recs["torch_sort_ms"]["cm_key"],
                step_recs["torch_sort_ms"]["arc_key"]))
        del scols, s_flt, s_weak, s_shadow, s_g2s, step_recs

    # the per-round step and the loop's blocks: measured device time beside
    # the least time their bytes allow
    last = runs["big_rounds"]["rounds_LAST"]
    step_bound = b_ms + sG * sH * STEP_ROW_BYTES / HBM_BYTES_PER_S * 1e3
    log("per-round step, big corpus: %d rounds, device ms summed %s; least "
        "ms a round %.6f (the sweep's bytes + %d bytes a row); pull %d bytes "
        "a round; upload_s %.3f step_s %.3f pull_s %.3f apply_s %.3f "
        "stack_s %.3f" % (
            last["rounds"], json.dumps(last["block_ms"]), step_bound,
            STEP_ROW_BYTES, last["pull_bytes"], last["upload_s"],
            last["step_s"], last["pull_s"], last["apply_s"],
            last["stack_s"]))
    red = runs["big_rounds"]["reductions_s"]
    log("reductions, big corpus: card %.4f s, host loops %.4f s"
        % (red["card"], red["host_loops"]))
    split = reduction_split(stk, opt_cuda, rounds_graph.d)
    runs["big_rounds"]["reductions_split_ms"] = split
    log("REDUCTIONS big (%d rows), best of 5, ms: world 1: host stacking "
        "%.4f, upload %.4f, device %.4f, pull %.4f; rank 0 of 4 (%d rows): "
        "stacking %.4f, upload %.4f, device %.4f, pull %.4f" % (
            split["rows"], split["stacking"], split["upload"],
            split["device"], split["pull"], split["rows_w4_rank0"],
            split["stacking_w4_rank0"], split["upload_w4_rank0"],
            split["device_w4_rank0"], split["pull_w4_rank0"]))
    reduce_recs = reduction_shapes(stk, mkk, {
        "big": rounds_graph.d, "northstar": rounds_graphs["northstar"].d})
    runs["big_rounds"]["protein_reduce_shapes"] = reduce_recs
    for label, r in reduce_recs.items():
        log("REDUCE KERNEL %s (G %d, H %d, %d rows, %d proteins): "
            "protein_reduce %.5f ms (CUDA graph), plain %.3f, one "
            "scatter_reduce_ + one index_add_ %.5f (max %.5f, sums %.5f), "
            "bound %.6f (%d bytes); kernel == plain == library" % (
                label, r["G"], r["H"], r["rows"], r["n_prot"], r["ms"],
                r["plain_ms"], r["library_ms"], r["library_max_ms"],
                r["library_sums_ms"], r["bound_ms"], r["bound_bytes"]))
    main_shape = reduce_recs[next(iter(REDUCE_SHAPES))]
    mesh_recs["protein_reduce"].update(
        ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
        bound_ms=main_shape["bound_ms"], bound_by="bytes",
        library_ms=main_shape["library_ms"],
        shape=next(iter(REDUCE_SHAPES)),
        ms_by_shape={k: r["ms"] for k, r in reduce_recs.items()},
        bound_ms_by_shape={k: r["bound_ms"] for k, r in reduce_recs.items()})

    # 4c. colsort_i64 against torch.sort at the loop's merge key count; its
    # bound: each int64 key read once and written once
    n_keys = G * 2 * H
    c = tdev.colsort_cols(n_keys)
    keys = torch.randperm(n_keys, device=dev, dtype=torch.int64) * 977 - 5
    sort_bound_ms = n_keys * 16 / HBM_BYTES_PER_S * 1e3
    if c:
        if not torch.equal(tdev.colsort_i64(keys, c),
                           torch.sort(keys).values):
            raise AssertionError("colsort_i64 != torch.sort")
        log("sort of %d int64 keys: torch.sort %.4f ms, colsort_i64 (%d "
            "columns) %.4f ms, bound %.6f ms (bytes: %d)" % (
                n_keys, stream_ms(lambda: torch.sort(keys), 20), c,
                stream_ms(lambda: tdev.colsort_i64(keys, c), 20),
                sort_bound_ms, n_keys * 16))
    else:
        log("sort of %d int64 keys: torch.sort %.4f ms, bound %.6f ms; "
            "columnsort has no valid column count here" % (
                n_keys, stream_ms(lambda: torch.sort(keys), 20),
                sort_bound_ms))

    # 4d. the loop's block kernels on the arguments of their first call in
    # the default loop of the big corpus and of the north star; the mesh's
    # branch entries on the same tables; the batched entry on the north
    # star loop's columns (the big loop's were timed in 4b)
    loop_recs = {}
    for cname in ("big", "northstar"):
        loop = runs[cname + "_sharded"]["LAST"]
        calls = {"walk_merge": loop["rounds_sweep_run"] + 1,
                 "branch": loop["rounds_branch_run"],
                 "prop": loop["rounds_branch_run"],
                 "occ": loop["rounds_total"]}
        for block, (least, n) in loop_block_bounds(loop["shape"],
                                                   calls).items():
            log("loop block %s %s: %d calls, %.3f ms measured, least %.6f ms "
                "a call = %.6f ms (bytes)" % (cname, block, n,
                                              loop["block_ms"][block], least,
                                              least * n))
        log("loop, %s corpus: shape %s, run_s %.3f, host_syncs %d over %d "
            "rounds (%d branch rounds), loop kernel launches %s; branch block"
            " %.3f ms a call" % (
                cname, json.dumps(loop["shape"]), loop["run_s"],
                loop["host_syncs"], loop["rounds_total"],
                loop["rounds_branch_run"], json.dumps(loop["loop_launches"]),
                loop["block_ms"]["branch"]
                / max(loop["rounds_branch_run"], 1)))
        sfx = "" if cname == "big" else "_" + cname
        if cname != "big":
            batched_rec.update({k + sfx: v for k, v in batched_on_loop(
                sk, dl, kept[cname], cname).items()})
            fused_recs["sweep_round_loop"].update({
                k + sfx: v for k, v in fused_on_loop(
                    sk, dl, kept[cname], cname).items()})
        capture = kept[cname]["capture"]
        args, kw = capture["branch_block"]
        (loc_args, loc_kw), cls = branch_split_args(args, kw)
        aml, he = lk.branch_locality_plain(*loc_args, **loc_kw)
        cases = (
            ("branch_block", "pangene_tpu/parallel/device_loop.py:525", args,
             kw),
            ("branch_locality", "pangene_tpu/parallel/device_loop.py:578",
             loc_args, loc_kw),
            ("branch_classify", "pangene_tpu/parallel/device_loop.py:627")
            + cls(aml, he),
            ("merge_fold", "pangene_tpu/parallel/device_loop.py:264")
            + tuple(capture["merge_fold"]),
            ("merge_fold_full", "pangene_tpu/parallel/device_loop.py:410")
            + tuple(capture["merge_fold_full"]))
        A = args[4].shape[0]
        for name, replaces, args, kw in cases:
            fn = "merge_fold" if name == "merge_fold_full" else name
            err, got = compare_loop_kernel(lk, fn, args, kw)
            kernel_fn = getattr(lk, fn)
            plain_fn = getattr(lk, fn + "_plain")
            ms = graph_ms(lambda: kernel_fn(*args, **kw), TIMED_LAUNCHES)
            eager_ms = stream_ms(lambda: kernel_fn(*args, **kw),
                                 TIMED_LAUNCHES)
            plain_ms = stream_ms(lambda: plain_fn(*args, **kw), 5)
            if fn == "merge_fold":
                b_ms, b_by, nbytes, n_valid = fold_bound_ms(args, kw)
                shape = "N %d, valid %d, cap %d, jb %d, perm %s" % (
                    args[0].shape[0], n_valid, kw["cap"], kw["jb"],
                    kw.get("perm") is not None)
            elif name == "branch_classify":
                b_ms, b_by, nbytes = classify_bound_ms(args)
                shape = "A %d, branching %d, counts %s, aml/he %s" % (
                    A, int(args[2].sum()), got[2].tolist(),
                    "aligned" if args[4].data_ptr() % 4 == 0
                    else "unaligned")
            else:
                if name == "branch_block":
                    b_ms, b_by, ops, nbytes, nb = branch_block_bound_ms(
                        args, loc_args, loc_kw, aml, he)
                else:
                    b_ms, b_by, ops, nbytes, nb = locality_bound_ms(
                        args, kw, *got)
                shape = "A %d, branching %d, G %d, genes %d, %d forced ops" \
                    % (A, nb, args[0].shape[1], args[0].shape[0], ops)
                if name == "branch_block":
                    n = torch.unique_consecutive(loc_args[5][loc_args[6]],
                                                 return_counts=True)[1]
                    shape += ("; %d groups of %.2f members on average, %d at "
                              "most, %d past 16" % (
                                  n.numel(), nb / max(n.numel(), 1),
                                  int(n.max()) if n.numel() else 0,
                                  int((n > 16).sum())))
            log("LOOP KERNEL %s %s (%s): ms %.5f (eager back-to-back %.5f) "
                "plain_ms %.3f bound_ms %.6f (%s; %d bytes); kernel == plain"
                % (cname, name, shape, ms, eager_ms, plain_ms, b_ms, b_by,
                   nbytes))
            rec = loop_recs.setdefault(name, {
                "name": name, "route": "cuda",
                "source": "pangene_tpu_torch/csrc/loop_blocks.cu",
                "replaces": replaces,
                "launches": loop_launches[name] + mesh_loop_launches[name],
                "launches_in_process": loop_launches[name],
                "launches_mesh_ranks": mesh_loop_launches[name],
                "max_abs_err": 0, "library_ms": None})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms,
                        "bound_ms" + sfx: b_ms, "bound_by" + sfx: b_by})
        # the round kernels: the first in-loop walk and the tail's (its
        # numbers under "_full"), branch_prep's first call, prop_round's
        # first that propagates, occ_round's first with the loci and cuts
        for key, name, replaces in (
                ("walk_pairs", "walk_pairs",
                 "pangene_tpu/parallel/device_loop.py:222"),
                ("walk_pairs_full", "walk_pairs",
                 "pangene_tpu/parallel/device_loop.py:222"),
                ("branch_prep", "branch_prep",
                 "pangene_tpu/parallel/device_loop.py:512"),
                ("prop_round", "prop_round",
                 "pangene_tpu/parallel/device_loop.py:673"),
                ("occ_round", "occ_round",
                 "pangene_tpu/parallel/device_loop.py:693")):
            if key == "occ_round" and key not in capture:
                key = "occ_round_partial"
            args, kw = capture[key]

            def make(args=args, kw=kw):
                return list(dl.copy_args(args)), kw
            err, got = compare_round_kernel(name, make)
            ms, eager_ms, plain_ms = time_round_kernel(lk, make, name)
            b_ms, nbytes, shape = round_bound_ms(lk, name, make, got)
            log("LOOP KERNEL %s %s (%s; %s): ms %.5f (eager back-to-back "
                "%.5f) plain_ms %.3f bound_ms %.6f (bytes; %d bytes); "
                "kernel == plain" % (cname, name, key, shape, ms, eager_ms,
                                     plain_ms, b_ms, nbytes))
            if name == "prop_round":
                # how many sectors a warp's reads through ordcm and the
                # pair slots' arc rows (forward, reverse) touch
                H = args[0].shape[1]
                log("ORDCM LOCALITY %s %s; arc rows one / two sectors: "
                    "forward %s, reverse %s" % (
                        cname, json.dumps(ordcm_locality(args[3])),
                        sector_shares(args[4][:, :H]),
                        sector_shares(args[4][:, H:])))
            rec = loop_recs.setdefault(name, {
                "name": name, "route": "cuda",
                "source": "pangene_tpu_torch/csrc/loop_round.cu",
                "replaces": replaces,
                "launches": loop_launches[name] + mesh_loop_launches[name],
                "launches_in_process": loop_launches[name],
                "launches_mesh_ranks": mesh_loop_launches[name],
                "max_abs_err": 0, "library_ms": None})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            ksfx = sfx + ("_full" if key == "walk_pairs_full" else "")
            rec.update({"ms" + ksfx: ms, "plain_ms" + ksfx: plain_ms,
                        "bound_ms" + ksfx: b_ms, "bound_by" + ksfx: "bytes"})
    kernels.extend(loop_recs.values())
    kernels.extend(fused_recs.values())

    # 4e. the bucket exchange's kernels at the world-4 shape of the big and
    # north-star loops (rank r of 4 holds G_loc = Gp / 4 genomes of the
    # loop's H rows; the loop's S and A): every testing.exchange_calls
    # state, every rank, each kernel == plain, eager and in a CUDA graph
    # replayed twice; timed on rank 0 of the ordinary state
    for cname in ("big", "northstar"):
        cfg = kept[cname]["cfg"]
        G = kept[cname]["blocks"][0].shape[1]
        G_loc = -(-G // 4)
        sfx = "" if cname == "big" else "_" + cname
        t0 = time.monotonic()
        for which in EXCHANGE_STATES:
            meta, calls = exchange_calls(which, 17, dev, nd=4, G_loc=G_loc,
                                         H=cfg.H, S=cfg.S, A=cfg.A)
            for r, call in enumerate(calls):
                for name in ("pack", "window", "finish"):
                    args, kw = call[name]
                    compare_mesh_kernel(mkk, name, args, kw)
            if which != "ordinary":
                continue
            shape = mkk.launch_shape(meta["NL"], meta["nd"], meta["C"],
                                     meta["A"])
            scratch = mkk.exchange_scratch(dev, meta["nd"])
            for name in ("pack", "window", "finish"):
                args, kw = calls[0][name]
                fn = getattr(mkk, "exchange_" + name)
                plain = getattr(mkk, "exchange_%s_plain" % name)
                # the main path's call: pack through the loop's scratch
                if name == "pack":
                    kw = dict(kw, scratch=scratch)
                got = fn(*fresh_args(name, args), **kw)
                ms = graph_ms(lambda: fn(*args, **kw), TIMED_LAUNCHES)
                kw.pop("scratch", None)
                plain_ms = stream_ms(lambda: plain(*fresh_args(name, args),
                                                   **kw), 5)
                nbytes = exchange_bound_bytes(name, args, kw, got)
                b_ms = nbytes / HBM_BYTES_PER_S * 1e3
                launch = ""
                if name == "pack":
                    launch = (
                        "; launch %d threads, %d + %d tiles (key %d x %d, "
                        "fill %d x %d) by ticket over %d blocks (%d a SM "
                        "of %d SMs)" % (
                            shape["threads"], shape["pack_key_tiles"],
                            shape["pack_fill_tiles"], shape["threads"],
                            shape["rows"], shape["threads"],
                            shape["fill_rows"], shape["pack_grid"],
                            shape["pack_blocks_per_sm"], shape["sms"]))
                elif name == "finish":
                    launch = (
                        "; launch %d threads, %d + %d tiles (table + slot, "
                        "%d x %d; the slot tiles past the slots sent "
                        "skipped) over %d blocks (%d a SM of %d SMs)" % (
                            shape["threads"], shape["finish_table_tiles"],
                            shape["finish_slot_tiles"], shape["threads"],
                            shape["rows"], shape["finish_grid"],
                            shape["finish_blocks_per_sm"], shape["sms"]))
                log("MESH KERNEL %s exchange_%s (world 4, rank 0; NL %d, C "
                    "%d, RL %d, A %d, %d keys sent): ms %.5f plain_ms %.3f "
                    "bound_ms %.6f (bytes; %d bytes)%s; kernel == plain" % (
                        cname, name, meta["NL"], meta["C"], 4 * meta["C"],
                        meta["A"], exchange_sent(calls[0]["finish"][0][5],
                                                 meta["C"]), ms, plain_ms,
                        b_ms, nbytes, launch))
                mesh_recs["exchange_" + name].update({
                    "ms" + sfx: ms, "plain_ms" + sfx: plain_ms,
                    "bound_ms" + sfx: b_ms, "bound_by" + sfx: "bytes"})
                if name != "window":
                    mesh_recs["exchange_" + name]["launch" + sfx] = {
                        k: v for k, v in shape.items()
                        if k.startswith(name) or k in (
                            "threads", "rows", "sms")
                        or (name == "pack" and k == "fill_rows")}
            if scratch.any():
                raise AssertionError("exchange_pack left its scratch "
                                     "dirty")
        log("exchange kernels %s (G_loc %d, H %d, S %d, A %d): %d states x 4 "
            "ranks, each kernel == plain, also in a CUDA graph (%.1f s)" % (
                cname, G_loc, cfg.H, cfg.S, cfg.A, len(EXCHANGE_STATES),
                time.monotonic() - t0))
    kernels.extend(mesh_recs.values())
    kept.clear()

    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
