"""Host <-> device bridge of the per-genome sweeps.

Packs the sweep columns of one genome into one (pinned) host buffer and
uploads it with one copy, runs the shadow / isoform sweep
(ops/sweep_kernel.py: the CUDA kernel on "cuda", its plain version on
"cpu"), copies the packed result back once, and finalizes on the host
exactly as the JAX package does (pangene_tpu/ops/device_engine.py): the
stale shadow flags of hit 0 and of filtered hits, has_dom = best score > 0,
and the +.499 f64 blend of score_dom.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.data import DataSet, Genome
from ..options import PgOpt
from . import sweep_kernel as sk
from .overlap import cds_len_all


def resolve_device(name: str) -> torch.device:
    """The torch device a run asked for. "cuda" without a CUDA device
    raises: the CPU is used only when the caller names it."""
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("device must be cuda or cpu, not %r" % name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "(device='cpu') to run the sweeps on the CPU")
    return dev


def hash_u32_np(keys: np.ndarray) -> np.ndarray:
    """Vectorized pg_hash_uint32 (pgpriv.h:88-97), uint32 wraparound."""
    k = keys.astype(np.uint32)
    with np.errstate(over="ignore"):
        k = (k + np.invert(k << np.uint32(15))).astype(np.uint32)
        k ^= k >> np.uint32(10)
        k = (k + (k << np.uint32(3))).astype(np.uint32)
        k ^= k >> np.uint32(6)
        k = (k + np.invert(k << np.uint32(11))).astype(np.uint32)
        k ^= k >> np.uint32(16)
    return k


_NP_DTYPE = {torch.int32: np.int32, torch.int64: np.int64,
             torch.uint8: np.uint8}


def pack_host(d: DataSet, g: Genome, cds_len: np.ndarray,
              pin: bool) -> torch.Tensor:
    """Sweep columns of one cs-sorted genome packed into one host buffer
    (sweep_kernel.pack_layout), in pinned memory when `pin`. cds_len is
    cds_len_all(g), which the caller may need too."""
    h = g.hits
    gid = np.asarray(d.prot_gid, np.int32)[h.pid]
    pref = np.asarray(d.gene_preferred, np.uint8)[gid]
    pscore = ((h.score_adj.astype(np.int64).astype(np.uint64) << np.uint64(33))
              | (pref.astype(np.uint64) << np.uint64(32))
              | hash_u32_np(h.pid).astype(np.uint64))
    # order-preserving uint64 -> int64 bias (ops/sweep_kernel.py)
    pscore = (pscore ^ np.uint64(1 << 63)).view(np.int64)
    host = {
        "cid": h.cid, "cs": h.cs, "ce": h.ce, "flt": h.flt != 0,
        "rev": h.rev, "gid": gid, "pscore": pscore, "rank": h.rank,
        "weak": h.weak_br, "cds_len": cds_len, "off_exon": h.off_exon,
        "n_exon": h.n_exon, "exon_os": g.exon_os, "exon_oe": g.exon_oe,
    }
    offs, total = sk.pack_layout(len(h), len(g.exon_os))
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    view = buf.numpy()
    for name, off, end in zip(sk.SweepCols._fields, offs, offs[1:] + [total]):
        a = np.asarray(host[name]).astype(_NP_DTYPE[sk.COL_DTYPES[name]],
                                          copy=False)
        view[off:off + a.nbytes].view(a.dtype)[:] = a
        view[off + a.nbytes:end] = 0   # alignment padding
    return buf


def upload(d: DataSet, g: Genome, device: torch.device,
           cds_len=None) -> torch.Tensor:
    """The packed sweep columns of one genome on `device`: one copy from
    pinned host memory, not waited for."""
    if cds_len is None:
        cds_len = cds_len_all(g)
    return pack_host(d, g, cds_len, pin=device.type == "cuda").to(
        device, non_blocking=True)


def build_cols(d: DataSet, g: Genome, device: torch.device) -> sk.SweepCols:
    """Sweep columns of one cs-sorted genome on `device`, as views of its
    packed upload."""
    return sk.unpack_cols(upload(d, g, device), len(g.hits), len(g.exon_os))


def _sweep(opt: PgOpt, d: DataSet, g: Genome, mode: int,
           cds_len: np.ndarray):
    h = g.hits
    n = len(h)
    buf = upload(d, g, resolve_device(opt.device), cds_len)
    W = sk.band_width(h.cid, np.asarray(h.cs), np.asarray(h.ce))
    out = sk.shadow_sweep_packed(buf, n, len(g.exon_os), W, mode,
                                 opt.check_strand, float(opt.min_ov_ratio))
    return [t.numpy() for t in sk.unpack_out(out.cpu(), n)]


def flt_ov_isoform(opt: PgOpt, d: DataSet, g: Genome) -> int:
    """Device pg_flt_ov_isoform (overlap.c:58-93)."""
    if g.n_hit == 0:
        return 0
    marks = _sweep(opt, d, g, sk.ISOFORM, cds_len_all(g))[0]
    h = g.hits
    h.flt_iso_ov[marks != 0] = 1
    got = h.flt_iso_ov != 0
    h.flt[got] = 1
    return int(got.sum())


def shadow(opt: PgOpt, d: DataSet, g: Genome, cal_dom_sc: bool) -> int:
    """Device pg_shadow (overlap.c:101-178); bit-equal to the host oracle."""
    if g.n_hit == 0:
        return 0
    lens = cds_len_all(g)
    marks, b_score, b_other, b_ov = _sweep(opt, d, g, sk.SHADOW, lens)
    marks = marks != 0
    h = g.hits
    n = len(h)
    nonflt = h.flt == 0
    # evaluated (non-flt, index>=1) hits are reset then re-marked; hit 0 and
    # flt hits keep stale values (reference quirk, overlap.c:108-116)
    evaluated = nonflt.copy()
    evaluated[0] = False
    new_shadow = np.where(evaluated, marks,
                          (h.shadow != 0) | marks).astype(np.uint8)
    h.set("shadow", new_shadow)
    # dominator finalize (host f64 for the +.499 blend); a raw best score
    # > 0 is a biased score above SCORE_NONE
    has_dom = nonflt & (b_score > sk.SCORE_NONE)
    pid_dom = np.where(nonflt, -1, h.pid_dom)
    other = np.clip(b_other, 0, max(n - 1, 0))
    pid_dom = np.where(has_dom, h.pid[other], pid_dom)
    h.set("pid_dom", pid_dom.astype(np.int32))
    if cal_dom_sc:
        lens = lens.astype(np.float64)
        li = lens
        lj = lens[other]
        ovf = b_ov.astype(np.float64)
        blend = (h.score_ori * (1.0 - ovf / li)
                 + h.score_ori[other] * (ovf / lj) + 0.499)
        sd = np.where(nonflt, -1, h.score_dom.astype(np.int64))
        sd = np.where(has_dom, blend.astype(np.int64), sd)
        h.set("score_dom", sd.astype(np.int32))
    return int((h.shadow[nonflt] != 0).sum())
