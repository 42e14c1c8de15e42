"""The shadow / isoform overlap sweep: one hand-written CUDA kernel
(csrc/shadow_sweep.cu) and its plain PyTorch version.

Over the cs-sorted hits of one genome, every pair (j, i) with
i - W <= j < i (W = band_width, exact) is gated by: same contig,
ce_j > cs_i, both unfiltered, optionally the same strand, and an exact
CDS intersection ov > 0. Then, by mode:

  SHADOW   (pg_shadow, overlap.c:101-156): a cross-gene pair also needs
           (double)ov / max(min(len_i, len_j), 1) >= min_ov_ratio; the
           loser is picked by weak_br across genes with different weak_br,
           else by packed score then rank.
  ISOFORM  (pg_flt_ov_isoform, overlap.c:58-93): the pair needs the same
           gene; the loser is picked by packed score then rank.

For every loser the sweep returns a mark and its dominator: the candidate
with the largest winner score, ties to the smallest winner index, with the
pair's ov. That lexicographic argmax equals the reference's first-max-wins
chronological scan (ops/sweep.py:149-156 of the JAX package).

The batched entry is the same kernel in SHADOW mode over the H-padded
columns of many genomes at once (the device-resident loop's layout,
parallel/device_loop.py): one launch over (genome, tile), always with the
round's epilogue fused into the kernel: sweep_round_loop (the device
loop's sweep block) and sweep_round_step (the per-round step's sweep and
sort key); their plain versions are shadow_sweep_batched_plain (the split
form of ops/device.py) followed by sweep_epilogue_plain.
shadow_sweep_batched, the sweep's three planes (marks, score, other), is
the STEP launch on a zeroed shadow plane, its key dropped.

The packed score is the reference's uint64 score_adj<<33 | pref<<32 |
hash(pid). torch has poor uint64 support, so it travels as int64
``u ^ (1 << 63)``: an order-preserving bijection, so signed int64
comparisons of the biased values are unsigned comparisons of the raw ones,
and the raw 0 (no dominator) is int64 min (SCORE_NONE).
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import threading
import time
from contextlib import nullcontext
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..util import build_dir

SHADOW = 0
ISOFORM = 1
MODE_NAMES = {SHADOW: "SHADOW", ISOFORM: "ISOFORM"}
SCORE_NONE = -(1 << 63)            # biased encoding of the raw score 0
OTHER_NONE = (1 << 31) - 1
# The batched entry's fused epilogues (csrc/shadow_sweep.cu: kEpi*)
EPI_LOOP = 1
EPI_STEP = 2
STEP_KEY_B = 44                    # the step's sort key: cid << 44 | cm
STEP_KEY_PAD = 1 << 62             # its key past a genome's rows

# Launches of the CUDA kernel and calls of the plain version, per mode.
# reset_counts() zeroes both; chip_smoke.py reads them around the main path.
n_kernel_launches = {SHADOW: 0, ISOFORM: 0}
n_plain_calls = {SHADOW: 0, ISOFORM: 0}
# The same two counts for the batched entry, by its epilogue: "loop"
# (sweep_round_loop), "step" (sweep_round_step and shadow_sweep_batched,
# which launches STEP).
n_fused = {e: {"kernel": 0, "plain": 0} for e in ("loop", "step")}


# Argument checks of the batched entry (one a call of its wrappers, one a
# bind_sweep_round_loop). reset_counts() zeroes it.
n_checks = 0


def n_batched() -> dict:
    """The batched entry's launches and plain calls over both epilogues:
    one a sweep round."""
    return {k: sum(c[k] for c in n_fused.values()) for k in ("kernel",
                                                              "plain")}


def reset_counts() -> None:
    global n_checks
    n_checks = 0
    for m in (SHADOW, ISOFORM):
        n_kernel_launches[m] = 0
        n_plain_calls[m] = 0
    for c in n_fused.values():
        for k in c:
            c[k] = 0


class SweepCols(NamedTuple):
    """Per-hit columns of one cs-sorted genome, all on one device, plus the
    genome's CSR exon pool (exon coordinates relative to the hit's cs)."""
    cid: torch.Tensor       # int32 [n]
    cs: torch.Tensor        # int64 [n]
    ce: torch.Tensor        # int64 [n]
    flt: torch.Tensor       # uint8 [n]
    rev: torch.Tensor       # uint8 [n]
    gid: torch.Tensor       # int32 [n]
    pscore: torch.Tensor    # int64 [n], biased packed score
    rank: torch.Tensor      # int32 [n]
    weak: torch.Tensor      # uint8 [n]
    cds_len: torch.Tensor   # int32 [n]
    off_exon: torch.Tensor  # int32 [n]
    n_exon: torch.Tensor    # int32 [n]
    exon_os: torch.Tensor   # int32 [E]
    exon_oe: torch.Tensor   # int32 [E]


COL_DTYPES = {"cid": torch.int32, "cs": torch.int64, "ce": torch.int64,
              "flt": torch.uint8, "rev": torch.uint8, "gid": torch.int32,
              "pscore": torch.int64, "rank": torch.int32,
              "weak": torch.uint8, "cds_len": torch.int32,
              "off_exon": torch.int32, "n_exon": torch.int32,
              "exon_os": torch.int32, "exon_oe": torch.int32}


def band_width(cid: np.ndarray, cs: np.ndarray, ce: np.ndarray) -> int:
    """Exact band W = max_i (i - min{j : cid_j==cid_i && ce_j > cs_i}) over
    (cid, cs)-sorted hits, via a per-cid prefix max of ce.

    min{j : ce_j > t} within a cid equals searchsorted(prefix_max(ce), t,
    'right') because the running max first exceeds t exactly at that j.
    """
    n = len(cid)
    if n < 2:
        return 1
    seg_start = np.zeros(n, bool)
    seg_start[0] = True
    seg_start[1:] = cid[1:] != cid[:-1]
    starts = np.flatnonzero(seg_start)
    M = ce.copy()
    for s, e in zip(starts, np.append(starts[1:], n)):
        M[s:e] = np.maximum.accumulate(ce[s:e])
    # composite keys keep the search within the right cid block
    B = 44
    assert int(ce.max(initial=0)) < (1 << B) and \
        int(cid.max(initial=0)) < (1 << (62 - B))
    keyM = (cid.astype(np.int64) << B) | M.astype(np.int64)
    keyT = (cid.astype(np.int64) << B) | cs.astype(np.int64)
    J = np.searchsorted(keyM, keyT, side="right")
    w = int(np.maximum(np.arange(n) - J, 0).max(initial=1))
    return max(w, 1)


# Packed buffers: one uint8 buffer per call in each direction, every column
# at a byte offset aligned to PACK_ALIGN (csrc/shadow_sweep.cu reads them in
# this order). The host fills the input in pinned memory and uploads it
# with one copy; the kernel writes the four outputs into one buffer that is
# copied back once.
PACK_ALIGN = 16
EXON_FIELDS = ("exon_os", "exon_oe")
OUT_DTYPES = (("marks", torch.uint8), ("best_score", torch.int64),
              ("best_other", torch.int32), ("best_ov", torch.int32))


def tile_shape(batched: bool = False) -> Tuple[int, int]:
    """(kRows, kBandTile) as csrc/shadow_sweep.cu defines them: the owned
    rows of a tile (kBatchRows for the batched entry) and the largest W
    whose halo is staged. Read from the source, so the kernel alone owns
    its tile shape."""
    with open(_SRC) as fp:
        src = fp.read()
    return tuple(int(re.search(r"constexpr int %s = (\d+);" % name,
                               src).group(1))
                 for name in ("kBatchRows" if batched else "kRows",
                              "kBandTile"))


def _layout(counts_dtypes):
    offs, pos = [], 0
    for count, dtype in counts_dtypes:
        offs.append(pos)
        pos += -(-count * dtype.itemsize // PACK_ALIGN) * PACK_ALIGN
    return offs, pos


def pack_layout(n: int, E: int) -> Tuple[list, int]:
    """Byte offsets of the SweepCols columns (n hits, E exons) in the packed
    input, and its total size."""
    return _layout([(E if name in EXON_FIELDS else n, COL_DTYPES[name])
                    for name in SweepCols._fields])


def out_layout(n: int) -> Tuple[list, int]:
    """Byte offsets of (marks, best_score, best_other, best_ov) in the
    packed output, and its total size."""
    return _layout([(n, dtype) for _, dtype in OUT_DTYPES])


def _views(buf: torch.Tensor, offs, counts_dtypes):
    return [buf[off:off + count * dtype.itemsize].view(dtype)
            for off, (count, dtype) in zip(offs, counts_dtypes)]


def _pack(ts, offs, total) -> torch.Tensor:
    buf = torch.empty(total, dtype=torch.uint8, device=ts[0].device)
    for off, end, t in zip(offs, offs[1:] + [total], ts):
        nbytes = t.numel() * t.element_size()
        buf[off:off + nbytes].view(t.dtype).copy_(t)
        buf[off + nbytes:end].zero_()   # alignment padding
    return buf


def pack_cols(c: SweepCols) -> torch.Tensor:
    """The columns as one packed uint8 buffer on their device."""
    return _pack(c, *pack_layout(c.cid.shape[0], c.exon_os.shape[0]))


def unpack_cols(buf: torch.Tensor, n: int, E: int) -> SweepCols:
    """SweepCols of views into a packed input buffer (no copy)."""
    cd = [(E if name in EXON_FIELDS else n, COL_DTYPES[name])
          for name in SweepCols._fields]
    return SweepCols(*_views(buf, pack_layout(n, E)[0], cd))


def pack_out(outs) -> torch.Tensor:
    """(marks, best_score, best_other, best_ov) as one packed buffer."""
    return _pack(outs, *out_layout(outs[0].shape[0]))


def unpack_out(buf: torch.Tensor, n: int):
    """Views (marks, best_score, best_other, best_ov) of a packed output."""
    return tuple(_views(buf, out_layout(n)[0],
                        [(n, dtype) for _, dtype in OUT_DTYPES]))


def _check_args(W: int, mode: int) -> None:
    if mode not in MODE_NAMES:
        raise ValueError("unknown sweep mode %r" % (mode,))
    if W < 1:
        raise ValueError("band width must be >= 1, got %d" % W)


def _check(c: SweepCols, W: int, mode: int) -> torch.device:
    _check_args(W, mode)
    dev = c.cid.device
    n = c.cid.shape[0]
    for name, t in zip(SweepCols._fields, c):
        if t.dtype != COL_DTYPES[name]:
            raise ValueError("column %s: dtype %s, expected %s"
                             % (name, t.dtype, COL_DTYPES[name]))
        if t.device != dev or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("column %s must be a contiguous 1-D tensor on "
                             "%s" % (name, dev))
        if name not in EXON_FIELDS and t.shape[0] != n:
            raise ValueError("column %s has %d rows, expected %d"
                             % (name, t.shape[0], n))
    if c.exon_os.shape != c.exon_oe.shape:
        raise ValueError("exon_os and exon_oe differ in length")
    return dev


def _check_packed(buf: torch.Tensor, n: int, E: int, W: int,
                  mode: int) -> torch.device:
    _check_args(W, mode)
    if n < 0 or E < 0:
        raise ValueError("negative sizes n=%d E=%d" % (n, E))
    total = pack_layout(n, E)[1]
    if buf.dtype != torch.uint8 or buf.dim() != 1 or \
            not buf.is_contiguous() or buf.shape[0] != total:
        raise ValueError("packed input must be a contiguous uint8 tensor of "
                         "%d bytes for n=%d, E=%d" % (total, n, E))
    return buf.device


def shadow_sweep(c: SweepCols, W: int, mode: int, check_strand: bool,
                 min_ov_ratio: float = 0.0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """shadow_sweep_packed on columns: packs them on their device and
    returns (marks uint8, best_score int64 biased, best_other int32,
    best_ov int32), one row per hit. min_ov_ratio is read in SHADOW mode
    only."""
    _check(c, W, mode)
    n = c.cid.shape[0]
    return unpack_out(shadow_sweep_packed(
        pack_cols(c), n, c.exon_os.shape[0], W, mode, check_strand,
        min_ov_ratio), n)


def shadow_sweep_packed(buf: torch.Tensor, n: int, E: int, W: int, mode: int,
                        check_strand: bool, min_ov_ratio: float = 0.0
                        ) -> torch.Tensor:
    """The sweep on a packed input (pack_layout(n, E)); returns the packed
    output (out_layout(n)) on the same device. The one way into the
    kernel: on cuda it launches the kernel or raises; on the CPU it takes
    the plain version."""
    dev = _check_packed(buf, n, E, W, mode)
    if dev.type == "cpu":
        n_plain_calls[mode] += 1
        return pack_out(shadow_sweep_plain(unpack_cols(buf, n, E), W, mode,
                                           check_strand, min_ov_ratio))
    return _launch(buf, n, E, W, mode, check_strand, min_ov_ratio)


def _launch(buf: torch.Tensor, n: int, E: int, W: int, mode: int,
            check_strand: bool, min_ov_ratio: float) -> torch.Tensor:
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError("shadow_sweep runs on cuda or cpu, not %s" % dev)
    in_off = (ctypes.c_longlong * len(SweepCols._fields))(
        *pack_layout(n, E)[0])
    offs, total = out_layout(n)
    out_off = (ctypes.c_longlong * len(OUT_DTYPES))(*offs)
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pg_shadow_sweep(buf.data_ptr(), in_off, out.data_ptr(),
                                  out_off, n, W, mode,
                                  int(bool(check_strand)),
                                  float(min_ov_ratio), stream)
    if err != 0:
        raise RuntimeError("shadow_sweep kernel launch failed: CUDA error %d"
                           % err)
    n_kernel_launches[mode] += 1
    return out


class BatchCols(NamedTuple):
    """Static sweep columns of G cs-sorted genomes on one device, H-padded:
    genome g's hits are rows [0, n_rows[g]) of its plane, and its exon pool
    is row g of the [G, E] pools (exon coordinates relative to the hit's
    cs). The per-round columns flt and weak travel beside it."""
    n_rows: torch.Tensor    # int32 [G]
    cid: torch.Tensor       # int32 [G, H]
    cs: torch.Tensor        # int64 [G, H]
    ce: torch.Tensor        # int64 [G, H]
    rev: torch.Tensor       # uint8 [G, H]
    gid: torch.Tensor       # int32 [G, H]
    pscore: torch.Tensor    # int64 [G, H], biased packed score
    rank: torch.Tensor      # int32 [G, H]
    cds_len: torch.Tensor   # int32 [G, H]
    off_exon: torch.Tensor  # int32 [G, H]
    n_exon: torch.Tensor    # int32 [G, H]
    exon_os: torch.Tensor   # int32 [G, E]
    exon_oe: torch.Tensor   # int32 [G, E]


def _check_batched(bc: BatchCols, flt: torch.Tensor, weak: torch.Tensor,
                   W: int) -> Tuple[torch.device, int, int, int]:
    """The batched entry's columns, flt and weak checked (counted in
    n_checks)."""
    global n_checks
    n_checks += 1
    if W < 1:
        raise ValueError("band width must be >= 1, got %d" % W)
    dev = bc.cid.device
    G, H = bc.cid.shape
    E = bc.exon_os.shape[1]
    named = list(zip(BatchCols._fields, bc)) + [("flt", flt), ("weak", weak)]
    dtypes = dict(COL_DTYPES, n_rows=torch.int32)
    for name, t in named:
        if t.dtype != dtypes[name]:
            raise ValueError("column %s: dtype %s, expected %s"
                             % (name, t.dtype, dtypes[name]))
        want = ((G,) if name == "n_rows" else
                (G, E) if name in EXON_FIELDS else (G, H))
        if t.device != dev or tuple(t.shape) != want or \
                not t.is_contiguous():
            raise ValueError("column %s must be a contiguous %s tensor on %s"
                             % (name, want, dev))
    return dev, G, H, E


def shadow_sweep_batched(bc: BatchCols, flt: torch.Tensor,
                         weak: torch.Tensor, W: int, check_strand: bool,
                         min_ov_ratio: float, geo: Optional[dict] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SHADOW sweep of every genome of `bc` under the round's flt and
    weak (uint8 [G, H]), with one band W for all: (marks uint8, best_score
    int64 biased, best_other int32), [G, H] each; rows past a genome's
    n_rows come back unmarked with no dominator. On cuda it is one launch
    of the kernel over (genome, tile) with the STEP epilogue on a zeroed
    shadow plane, which then holds the marks (its sort key dropped), or it
    raises; on the CPU it is the plain version (ops/device.py:
    sweep_geo_planes + shadow_round_kernel). `geo`, a dict the caller keeps
    for one `bc`, lets the plain version compute its round-invariant planes
    once. Counted under n_fused["step"]."""
    dev, G, H, E = _check_batched(bc, flt, weak, W)
    if dev.type == "cpu":
        n_fused["step"]["plain"] += 1
        return shadow_sweep_batched_plain(bc, flt, weak, W, check_strand,
                                          min_ov_ratio, geo)
    if dev.type != "cuda":
        raise ValueError("shadow_sweep runs on cuda or cpu, not %s" % dev)
    marks = torch.zeros((G, H), dtype=torch.uint8, device=dev)
    score, other, _ = sweep_round_step(
        bc, flt, weak, W, check_strand, min_ov_ratio, marks,
        torch.zeros((G, H), dtype=torch.int64, device=dev))
    return marks, score, other


def _col_ptrs(bc: BatchCols, flt: torch.Tensor, weak: torch.Tensor):
    """The kNumCols device pointers of the batched entry, in the packed
    input's column order."""
    by_name = dict(zip(BatchCols._fields, bc), flt=flt, weak=weak)
    return (ctypes.c_void_p * len(SweepCols._fields))(
        *[by_name[name].data_ptr() for name in SweepCols._fields])


def shadow_sweep_batched_plain(bc: BatchCols, flt: torch.Tensor,
                               weak: torch.Tensor, W: int,
                               check_strand: bool, min_ov_ratio: float,
                               geo: Optional[dict] = None):
    """Plain PyTorch version of shadow_sweep_batched, through the split
    forms of ops/device.py."""
    from . import device as dv
    if geo is None:
        geo = {}
    if "planes" not in geo:
        H = bc.cid.shape[1]
        valid = (torch.arange(H, dtype=torch.int32, device=bc.cid.device)
                 [None, :] < bc.n_rows[:, None])
        K = max(int(bc.n_exon.max()) if bc.n_exon.numel() else 1, 1)
        ex_os, ex_oe = dv.gather_exons(bc.off_exon, bc.n_exon, bc.cs,
                                       bc.exon_os, bc.exon_oe, K)
        geo["planes"] = dv.sweep_geo_planes(
            dv.RoundCols(valid, bc.cid, bc.cs, bc.ce, bc.rev, bc.rank,
                         bc.gid, bc.pscore, bc.cds_len, ex_os, ex_oe),
            min_ov_ratio, W, check_strand)
    marks, score, other = dv.shadow_round_kernel(
        flt != 0, weak, bc.pscore, geo["planes"], W)
    return marks.to(torch.uint8), score, other


class Bound(NamedTuple):
    """A kernel's arguments checked and bound once (a bind_<name> here or
    in ops/loop_kernels): launch(...) issues it with only what changes
    between calls; out holds the planes every launch writes, the
    binding's own. On cuda the binding keeps the device pointers of the
    tensors it was given, so they must outlive it; it keeps alive what it
    allocated itself."""
    launch: Callable
    out: tuple = ()


def device_guard(dev: torch.device):
    """`dev` made the current CUDA device for a with-block (nothing on the
    CPU). A bound launch goes to the device current when it was bound, so
    it runs inside the guard it was bound in."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def bound_stream(dev: torch.device) -> int:
    """The handle of dev's current stream, for a launch bound now; dev must
    be the current device (device_guard), where the launch goes."""
    if torch.cuda.current_device() != dev.index:
        raise ValueError("a launch on %s bound while cuda:%d is current"
                         % (dev, torch.cuda.current_device()))
    return torch.cuda.current_stream(dev).cuda_stream


def _check_planes(named, dev: torch.device, shape) -> None:
    """Each (name, tensor, dtype) a contiguous `shape` tensor on `dev`."""
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise ValueError("%s: dtype %s, expected %s"
                             % (name, t.dtype, dtype))
        if t.device != dev or tuple(t.shape) != tuple(shape) or \
                not t.is_contiguous():
            raise ValueError("%s must be a contiguous %s tensor on %s"
                             % (name, tuple(shape), dev))


def _launch_round(epi: int, bc: BatchCols, flt, weak, W, check_strand,
                  min_ov_ratio, shadow, ev1=None, pid=None, pid_dom=None,
                  cm=None, score=None, other=None, key=None) -> None:
    G, H = flt.shape
    if G == 0 or H == 0:
        return
    dev = flt.device
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pg_shadow_sweep_round(
            _col_ptrs(bc, flt, weak), bc.n_rows.data_ptr(), G, H, bc.exon_os.shape[1], W,
            int(bool(check_strand)), float(min_ov_ratio), epi, ptr(shadow),
            ptr(ev1), ptr(pid), ptr(pid_dom), ptr(cm), ptr(score),
            ptr(other), ptr(key), stream)
    if err != 0:
        raise RuntimeError("fused shadow_sweep kernel launch failed: CUDA "
                           "error %d" % err)


def sweep_round_loop(bc: BatchCols, flt: torch.Tensor, weak: torch.Tensor,
                     W: int, check_strand: bool, min_ov_ratio: float,
                     shadow: torch.Tensor, pid_dom: torch.Tensor,
                     ev1: torch.Tensor, pid: torch.Tensor,
                     geo: Optional[dict] = None) -> None:
    """The device loop's sweep block (JAX pangene_tpu/parallel/
    device_loop.py:758-775 sweep_block): the batched SHADOW sweep under the
    round's flt and weak, then shadow's stale-flag merge and the dominators'
    pid into pid_dom, both [G, H] planes updated in place (uint8, int32);
    ev1 uint8 [G, H] (the hit's original index >= 1), pid int32 [G, H]. On
    cuda one launch of the kernel with the LOOP epilogue, writing no other
    plane, or it raises; on the CPU shadow_sweep_batched_plain then
    sweep_epilogue_plain (`geo` as for shadow_sweep_batched)."""
    with device_guard(flt.device):
        bind_sweep_round_loop(bc, flt, weak, W, check_strand, min_ov_ratio,
                              shadow, pid_dom, ev1, pid, geo).launch()


def bind_sweep_round_loop(bc: BatchCols, flt: torch.Tensor,
                          weak: torch.Tensor, W: int, check_strand: bool,
                          min_ov_ratio: float, shadow: torch.Tensor,
                          pid_dom: torch.Tensor, ev1: torch.Tensor,
                          pid: torch.Tensor, geo: Optional[dict] = None
                          ) -> Bound:
    """sweep_round_loop's check and launch, every argument bound: launch()
    sweeps the planes as they are at the call (on cuda inside the
    device_guard it was bound in)."""
    dev, G, H, _ = _check_batched(bc, flt, weak, W)
    _check_planes([("shadow", shadow, torch.uint8),
                   ("pid_dom", pid_dom, torch.int32),
                   ("ev1", ev1, torch.uint8), ("pid", pid, torch.int32)],
                  dev, (G, H))
    if dev.type == "cpu":
        def plain():
            n_fused["loop"]["plain"] += 1
            marks, score, other = shadow_sweep_batched_plain(
                bc, flt, weak, W, check_strand, min_ov_ratio, geo)
            sweep_epilogue_plain(marks, score, other, flt, shadow, bc.n_rows,
                                 ev1=ev1, pid=pid, pid_dom=pid_dom)
        return Bound(plain)
    if dev.type != "cuda":
        raise ValueError("shadow_sweep runs on cuda or cpu, not %s" % dev)
    if G == 0 or H == 0:
        def none():
            n_fused["loop"]["kernel"] += 1
        return Bound(none)
    args = (_col_ptrs(bc, flt, weak), bc.n_rows.data_ptr(), G, H,
            bc.exon_os.shape[1], W, int(bool(check_strand)),
            float(min_ov_ratio), EPI_LOOP, shadow.data_ptr(), ev1.data_ptr(),
            pid.data_ptr(), pid_dom.data_ptr(), None, None, None, None,
            bound_stream(dev))
    fn = _kernel_lib().pg_shadow_sweep_round

    def launch():
        err = fn(*args)
        if err != 0:
            raise RuntimeError("fused shadow_sweep kernel launch failed: "
                               "CUDA error %d" % err)
        n_fused["loop"]["kernel"] += 1
    return Bound(launch)


def sweep_round_step(bc: BatchCols, flt: torch.Tensor, weak: torch.Tensor,
                     W: int, check_strand: bool, min_ov_ratio: float,
                     shadow: torch.Tensor, cm: torch.Tensor,
                     geo: Optional[dict] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-round step's sweep (JAX pangene_tpu/parallel/stacked.py:
    61-79): the batched SHADOW sweep, shadow's stale-flag merge in place
    (uint8 [G, H]; hit 0 is never evaluated) and the (cid, cm) sort key of
    the step, from cm int64 [G, H]. Returns (best_score int64 biased,
    best_other int32, key int64), [G, H] each; the key is cid << 44 | cm
    below a genome's n_rows, 2^62 past it. On cuda one launch of the kernel
    with the STEP epilogue or it raises; on the CPU
    shadow_sweep_batched_plain then sweep_epilogue_plain."""
    dev, G, H, _ = _check_batched(bc, flt, weak, W)
    _check_planes([("shadow", shadow, torch.uint8),
                   ("cm", cm, torch.int64)], dev, (G, H))
    if dev.type == "cpu":
        n_fused["step"]["plain"] += 1
        marks, score, other = shadow_sweep_batched_plain(
            bc, flt, weak, W, check_strand, min_ov_ratio, geo)
        key = sweep_epilogue_plain(marks, score, other, flt, shadow,
                                   bc.n_rows, cid=bc.cid, cm=cm)
        return score, other, key
    if dev.type != "cuda":
        raise ValueError("shadow_sweep runs on cuda or cpu, not %s" % dev)
    score = torch.empty((G, H), dtype=torch.int64, device=dev)
    other = torch.empty((G, H), dtype=torch.int32, device=dev)
    key = torch.empty((G, H), dtype=torch.int64, device=dev)
    _launch_round(EPI_STEP, bc, flt, weak, W, check_strand, min_ov_ratio,
                  shadow, cm=cm, score=score, other=other, key=key)
    n_fused["step"]["kernel"] += 1
    return score, other, key


def sweep_epilogue_plain(marks: torch.Tensor, b_score: torch.Tensor,
                         b_other: torch.Tensor, flt: torch.Tensor,
                         shadow: torch.Tensor, n_rows: torch.Tensor, *,
                         ev1: Optional[torch.Tensor] = None,
                         pid: Optional[torch.Tensor] = None,
                         pid_dom: Optional[torch.Tensor] = None,
                         cid: Optional[torch.Tensor] = None,
                         cm: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the fused epilogues, after a batched
    sweep's (marks, b_score, b_other): shadow (uint8 [G, H]) takes the
    reference's stale-flag merge in place (overlap.c:108-116: a row is
    evaluated when unfiltered, below n_rows and, with `ev1`, ev1 != 0, else
    its index >= 1); with `pid_dom` (the loop's) the unfiltered rows take
    their dominator's pid (`pid`, at b_other clamped into the row range)
    or -1, in place; with `cm` (the step's) it returns the sort key
    cid << 44 | cm, 2^62 past n_rows."""
    G, H = flt.shape
    iota = torch.arange(H, dtype=torch.int32, device=flt.device)[None, :]
    valid = iota < n_rows[:, None]
    marks = marks != 0
    nonflt = flt == 0
    ev = (ev1 != 0) if ev1 is not None else iota >= 1
    evaluated = nonflt & ev & valid
    shadow.copy_(torch.where(evaluated, marks, (shadow != 0) | marks))
    if pid_dom is not None:
        has_dom = nonflt & (b_score > SCORE_NONE)
        pid_o = torch.gather(pid, 1, b_other.clamp(0, H - 1).long())
        pid_dom.copy_(torch.where(has_dom, pid_o,
                                  torch.where(nonflt, -1, pid_dom)))
    if cm is not None:
        return torch.where(valid, (cid.to(torch.int64) << STEP_KEY_B) | cm,
                           STEP_KEY_PAD)
    return None


def launch_shape(n: int, W: int) -> dict:
    """The kernel's launch shape for n hits and band W, from the CUDA
    runtime: blocks, threads, dynamic shared bytes, resident blocks per SM,
    registers per thread, staged halo and band chunk."""
    info = (ctypes.c_int * 7)()
    err = _kernel_lib().pg_shadow_sweep_shape(n, W, info)
    if err != 0:
        raise RuntimeError("shadow_sweep shape query failed: CUDA error %d"
                           % err)
    return dict(zip(("blocks", "threads", "smem_bytes", "blocks_per_sm",
                     "registers", "halo", "chunk"), info))


def launch_shape_batched(G: int, H: int, W: int,
                         epi: int = EPI_STEP) -> dict:
    """The batched entry's launch for G genomes of H rows and band W (with
    the fused epilogue `epi`: EPI_LOOP or EPI_STEP), from the CUDA
    runtime: (genome, tile) items, persistent blocks, threads, dynamic
    shared bytes, resident blocks per SM, registers per thread, staged halo
    and band chunk."""
    info = (ctypes.c_longlong * 8)()
    err = _kernel_lib().pg_shadow_sweep_batched_shape(G, H, W, epi, info)
    if err != 0:
        raise RuntimeError("batched shadow_sweep shape query failed: CUDA "
                           "error %d" % err)
    return dict(zip(("items", "blocks", "threads", "smem_bytes",
                     "blocks_per_sm", "registers", "halo", "chunk"), info))


def shadow_sweep_plain(c: SweepCols, W: int, mode: int, check_strand: bool,
                       min_ov_ratio: float = 0.0):
    """Plain PyTorch version: vectorised over hits, one step per band
    offset delta, exons padded to the genome's largest exon count K."""
    dev = c.cid.device
    n = c.cid.shape[0]
    marks = torch.zeros(n, dtype=torch.bool, device=dev)
    b_score = torch.full((n,), SCORE_NONE, dtype=torch.int64, device=dev)
    b_other = torch.full((n,), OTHER_NONE, dtype=torch.int32, device=dev)
    b_ov = torch.zeros(n, dtype=torch.int32, device=dev)
    if n < 2 or c.exon_os.shape[0] == 0:   # no pair, or every ov is 0
        return marks.to(torch.uint8), b_score, b_other, b_ov
    # absolute exon windows [n, K]; padding (0, 0) adds nothing to the
    # intersection because every coordinate is >= 0
    ne = c.n_exon.long()
    K = max(int(ne.max()), 1)
    kk = torch.arange(K, device=dev)
    emask = kk[None, :] < ne[:, None]
    idx = (c.off_exon.long()[:, None] + kk[None, :]).clamp(
        0, max(c.exon_os.shape[0] - 1, 0))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    ex_os = torch.where(emask, c.exon_os.long()[idx] + c.cs[:, None], zero)
    ex_oe = torch.where(emask, c.exon_oe.long()[idx] + c.cs[:, None], zero)
    flt = c.flt != 0
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    for delta in range(1, min(W, n - 1) + 1):
        i = slice(delta, n)       # i-side rows
        j = slice(0, n - delta)   # j = i - delta
        mask = ((c.cid[j] == c.cid[i]) & (c.ce[j] > c.cs[i])
                & ~flt[i] & ~flt[j])
        if check_strand:
            mask &= c.rev[j] == c.rev[i]
        lo = torch.maximum(ex_os[i][:, :, None], ex_os[j][:, None, :])
        hi = torch.minimum(ex_oe[i][:, :, None], ex_oe[j][:, None, :])
        ov = (hi - lo).clamp(min=0).sum(dim=(1, 2))
        mask &= ov > 0
        ps_i, ps_j = c.pscore[i], c.pscore[j]
        same_gene = c.gid[j] == c.gid[i]
        score_i_loses = (ps_i < ps_j) | ((ps_i == ps_j)
                                         & (c.rank[i] > c.rank[j]))
        if mode == ISOFORM:
            mask &= same_gene
            i_loses = score_i_loses
        else:
            minlen = torch.minimum(c.cds_len[i], c.cds_len[j]).clamp(min=1)
            cov_low = ov.double() / minlen.double() < min_ov_ratio
            mask &= same_gene | ~cov_low
            w_i, w_j = c.weak[i], c.weak[j]
            i_loses = torch.where(same_gene | (w_i == w_j), score_i_loses,
                                  w_i > w_j)
        ov32 = ov.to(torch.int32)
        # loser i: candidate (ps_j, other j) on rows delta..n-1
        _absorb(marks[i], b_score[i], b_other[i], b_ov[i], mask & i_loses,
                ps_j, rows[j], ov32)
        # loser j: candidate (ps_i, other i) on rows 0..n-delta-1
        _absorb(marks[j], b_score[j], b_other[j], b_ov[j], mask & ~i_loses,
                ps_i, rows[i], ov32)
    return marks.to(torch.uint8), b_score, b_other, b_ov


def _absorb(marks, b_score, b_other, b_ov, cand, score, other, ov) -> None:
    """In-place lexicographic (max score, min other) update of views."""
    marks |= cand
    upd = cand & ((score > b_score) | ((score == b_score)
                                       & (other < b_other)))
    b_score.copy_(torch.where(upd, score, b_score))
    b_other.copy_(torch.where(upd, other, b_other))
    b_ov.copy_(torch.where(upd, ov, b_ov))


# ---------------------------------------------------------------------------
# building and loading the CUDA kernel
# ---------------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "shadow_sweep.cu")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def nvcc_command(src: str, out: str) -> list:
    """The nvcc command that builds `src` into the shared library `out`
    for sm_90a (IEEE division: never --use_fast_math)."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", out, src]


def build_so(src: str, name: str, force: bool = False
             ) -> Tuple[float, str]:
    """Compile the CUDA source `src` for sm_90a into the shared library
    build/pangene_tpu_torch/`name` (skipped when the library is newer than
    the source, unless `force`). Returns (seconds spent, ptxas report).
    Raises when nvcc fails."""
    so = os.path.join(build_dir(), name)
    if not force and os.path.exists(so) and \
            os.path.getmtime(so) >= os.path.getmtime(src):
        return 0.0, ""
    tmp = "%s.%d.tmp" % (so, os.getpid())
    t0 = time.monotonic()
    r = subprocess.run(nvcc_command(src, tmp), capture_output=True,
                       text=True)
    dt = time.monotonic() - t0
    if r.returncode != 0:
        raise RuntimeError("nvcc failed (%d):\n%s%s"
                           % (r.returncode, r.stdout, r.stderr))
    os.replace(tmp, so)
    return dt, r.stderr


def build(force: bool = False) -> Tuple[float, str]:
    """build_so of csrc/shadow_sweep.cu."""
    return build_so(_SRC, "libshadow_sweep.so", force)


def load(path: str) -> ctypes.CDLL:
    """A built kernel library with its entry points' C signatures."""
    lib = ctypes.CDLL(path)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    fn = lib.pg_shadow_sweep
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, i64p, ctypes.c_void_p, i64p]
                   + [ctypes.c_int] * 4 + [ctypes.c_double, ctypes.c_void_p])
    fn = lib.pg_shadow_sweep_shape
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn = lib.pg_shadow_sweep_round
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_double, ctypes.c_int]
                   + [ctypes.c_void_p] * 9)
    fn = lib.pg_shadow_sweep_batched_shape
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [i64p]
    return lib


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build()
            _lib = load(os.path.join(build_dir(), "libshadow_sweep.so"))
        return _lib
