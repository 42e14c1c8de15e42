"""The genome mesh's protein-keyed reductions and the bucket exchange of
the device loop's in-round merge as hand-written CUDA kernels
(csrc/mesh_round.cu), each beside its plain PyTorch version. Both run only
at world > 1: the reductions once a build (graph/post.py), the exchange
once a lean in-loop merge at world > 2.

They replace the XLA forms of the JAX package's mesh:

  protein_reduce   pangene_tpu/parallel/stacked.py:428 reduction_step
                   before its pmax / psum: per protein the largest
                   score_ori over the valid rows (0 at least), and over the
                   rank-0 unfiltered valid rows the single- and multi-exon
                   counts and score_ori sums, the score_adj sum and the row
                   count. [G, H] planes plus n_rows: the padded stack, or
                   every genome's rows end to end in one row (G = 1). One
                   memset and one launch, a thread a row, the grid's rows
                   striding over the genomes.
  exchange_pack    pangene_tpu/parallel/device_loop.py:325-348: each
                   destination's run of the locally sorted lean keys, cut
                   at C, into the [nd, 2, C] send plane (key, s1 of its
                   origin row), the overflow flag, the runs' bounds [nd + 1]
                   (JAX's start, then the valid keys' count); and the pair
                   plane of exchange_finish, zeroed. One launch, ticketed
                   tiles, through a scratch (exchange_scratch) that each
                   launch leaves zeroed.
  exchange_window  device_loop.py:377-401: after the all_gather of every
                   rank's (n_out_l, overflow), the rank's offset and n_out,
                   its [2, A] table plane (its fold's rows at the window
                   clamp(off, 0, A), 0 elsewhere) and the reply (each
                   received slot's global arc row, 0 at a sentinel).
  exchange_finish  device_loop.py:393-405: after the psum and the second
                   all_to_all, the table masked by the live rows, and each
                   returned arc row at the pair slot of the key sent there
                   (an atomicMax on the zeroed plane); only the slots
                   pack's bounds say were sent are read.

The two sorts around the fold stay torch.sort and the fold stays
loop_kernels.merge_fold, as the JAX package sorts with XLA's sort. On cuda
each wrapper launches its kernel or raises; on the CPU it takes the plain
version. None reads a value on the host.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import torch

from ..util import build_dir
from .loop_kernels import KSENT_I, SENT_I, _check, seg_sum
from .sweep_kernel import build_so

I64 = torch.int64
I32 = torch.int32
U8 = torch.uint8

# Launches of each kernel and calls of its plain version. reset_counts()
# zeroes them; the rank reports and chip_smoke.py read them.
n_calls = {name: {"kernel": 0, "plain": 0} for name in (
    "protein_reduce", "exchange_pack", "exchange_window", "exchange_finish")}


def reset_counts() -> None:
    for c in n_calls.values():
        for k in c:
            c[k] = 0


# ---------------------------------------------------------------------------
# building and loading the kernels
# ---------------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "mesh_round.cu")
SO_NAME = "libmesh_round.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> Tuple[float, str]:
    """build_so of csrc/mesh_round.cu."""
    return build_so(_SRC, SO_NAME, force)


_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C entries of csrc/mesh_round.cu: name -> (return type, argument
# types, the stream last where there is one)
ENTRIES = {
    "pg_protein_reduce": (_I, [_VP] * 7 + [_I] * 3 + [_VP] * 2),
    "pg_exchange_scratch": (_LL, [_I]),
    "pg_exchange_pack": (_I, [_VP] * 2 + [_I] * 5 + [_LL] * 2 + [_VP] * 6),
    "pg_exchange_window": (_I, [_VP] * 5 + [_I] * 4 + [_VP] * 4),
    "pg_exchange_finish": (_I, [_VP] * 5 + [_I] * 5 + [_LL] + [_VP] * 4),
    "pg_exchange_shape": (_I, [_I] * 4 + [_VP]),
}


def load(path: str) -> ctypes.CDLL:
    """The built library with its entry points' C signatures (ENTRIES)."""
    lib = ctypes.CDLL(path)
    for name, (res, args) in ENTRIES.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build()
            _lib = load(os.path.join(build_dir(), SO_NAME))
        return _lib


def _launch_device(dev: torch.device, name: str) -> bool:
    """True on cuda (launch), False on the CPU (plain, counted); raises
    elsewhere."""
    if dev.type == "cpu":
        n_calls[name]["plain"] += 1
        return False
    if dev.type != "cuda":
        raise ValueError("%s runs on cuda or cpu, not %s" % (name, dev))
    return True


def _launch(name: str, dev: torch.device, fn, *args) -> None:
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, err))
    n_calls[name]["kernel"] += 1


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


# ---------------------------------------------------------------------------
# the protein-keyed reductions
# ---------------------------------------------------------------------------

def protein_reduce(pid: torch.Tensor, score_ori: torch.Tensor,
                   score_adj: torch.Tensor, n_exon: torch.Tensor,
                   rank: torch.Tensor, flt: torch.Tensor,
                   n_rows: torch.Tensor, *, n_prot: int):
    """The reductions of this rank's rows: pid, score_ori, score_adj,
    n_exon, rank int32 and flt uint8 [G, H], n_rows int32 [G] (the rows
    below it valid). Returns (max_so int32 [n_prot]; sums int64 [6, n_prot]:
    cnt0, cnt1, sum0, sum1, rep_sum, rep_cnt)."""
    dev = pid.device
    G, H = pid.shape
    if n_prot < 1:
        raise ValueError("protein_reduce: n_prot %d" % n_prot)
    _check([(n, t, I32, (G, H)) for n, t in (
        ("pid", pid), ("score_ori", score_ori), ("score_adj", score_adj),
        ("n_exon", n_exon), ("rank", rank))]
        + [("flt", flt, U8, (G, H)), ("n_rows", n_rows, I32, (G,))], dev)
    if not _launch_device(dev, "protein_reduce"):
        return protein_reduce_plain(pid, score_ori, score_adj, n_exon, rank,
                                    flt, n_rows, n_prot=n_prot)
    # one buffer, zeroed by the entry's memset: the int32 maxima in row 0
    out = torch.empty((7, n_prot), dtype=I64, device=dev)
    _launch("protein_reduce", dev, _kernel_lib().pg_protein_reduce,
            *map(_ptr, (pid, score_ori, score_adj, n_exon, rank, flt,
                        n_rows)), G, H, n_prot, _ptr(out))
    return out[0].view(I32)[:n_prot], out[1:]


def protein_reduce_plain(pid, score_ori, score_adj, n_exon, rank, flt,
                         n_rows, *, n_prot: int):
    """Plain PyTorch version of protein_reduce."""
    dev = pid.device
    H = pid.shape[1]
    va = (torch.arange(H, dtype=I32, device=dev)[None, :]
          < n_rows[:, None]).reshape(-1)
    pidc = pid.reshape(-1).clamp(0, n_prot - 1).long()
    so = score_ori.reshape(-1)
    multi = n_exon.reshape(-1) != 1
    r0 = (rank.reshape(-1) == 0) & (flt.reshape(-1) == 0) & va
    max_so = torch.zeros(n_prot, dtype=I32, device=dev).scatter_reduce_(
        0, pidc, torch.where(va, so, 0), "amax", include_self=True)

    def total(mask, vals=None):
        x = mask.to(I64) if vals is None else torch.where(mask, vals.to(I64),
                                                          0)
        return seg_sum(x, pidc, n_prot)

    return max_so, torch.stack([
        total(r0 & ~multi), total(r0 & multi), total(r0 & ~multi, so),
        total(r0 & multi, so), total(r0, score_adj.reshape(-1)), total(r0)])


# ---------------------------------------------------------------------------
# the bucket exchange
# ---------------------------------------------------------------------------

def exchange_scratch(device, nd: int) -> torch.Tensor:
    """The zeroed scratch of exchange_pack for nd destinations on `device`
    (int64, its size from pg_exchange_scratch): its blocks' ticket and the
    published run bounds. Each launch leaves it zeroed (the block that
    takes the launch's last ticket), so one serves every call on one
    stream; a CUDA graph replays right with it."""
    n = int(_kernel_lib().pg_exchange_scratch(max(int(nd), 1)))
    return torch.zeros(n // 8, dtype=I64, device=device)


def launch_shape(NL: int, nd: int, C: int, A: int) -> dict:
    """exchange_pack's and exchange_finish's launch on the current cuda
    device (C entry pg_exchange_shape): threads a block, rows (positions a
    thread in a key, table or slot tile; `tile` positions a tile),
    fill_rows (slots a thread in a fill tile), pack's key and fill tiles
    and finish's table and slot tiles (the most slots; those past the
    slots sent are skipped), each kernel's resident blocks a SM and grid
    (persistent: the tiles or the resident blocks, whichever is fewer; a
    block takes pack's tiles by ticket), the SMs, the scratch bytes."""
    out = (ctypes.c_longlong * 13)()
    err = _kernel_lib().pg_exchange_shape(NL, nd, C, A, out)
    if err:
        raise RuntimeError("pg_exchange_shape: CUDA error %d" % err)
    keys = ("threads", "rows", "pack_key_tiles", "pack_fill_tiles",
            "pack_blocks_per_sm", "finish_table_tiles", "finish_slot_tiles",
            "finish_blocks_per_sm", "sms", "scratch_bytes", "pack_grid",
            "finish_grid", "fill_rows")
    shape = dict(zip(keys, out))
    shape["tile"] = shape["threads"] * shape["rows"]
    return shape


def _exchange_scratch(scratch, dev, nd: int) -> torch.Tensor:
    """`scratch`, checked to be an exchange_scratch for nd on `dev`, or a
    new one."""
    if scratch is None:
        return exchange_scratch(dev, nd)
    n = int(_kernel_lib().pg_exchange_scratch(nd)) // 8
    if scratch.dtype != I64 or scratch.device != dev or scratch.dim() != 1 \
            or not scratch.is_contiguous() or scratch.numel() < n:
        raise ValueError("scratch must be a contiguous int64 tensor of at "
                         "least %d on %s (exchange_scratch(device, %d)), got "
                         "%s %s on %s" % (n, dev, nd, scratch.dtype,
                                          tuple(scratch.shape),
                                          scratch.device))
    return scratch


def exchange_pack(keys: torch.Tensor, s1: torch.Tensor, *, nd: int,
                  cap: int, jb: int, shift: int, two_s: int, rank: int,
                  scratch: Optional[torch.Tensor] = None):
    """The send plane of this rank's NL sorted lean keys (int64, KSENT_I at
    the end; the low jb bits the global row rank * NL + local row) and
    their rows' s1 (int32 [NL], by local row), for nd destinations of `cap`
    slots: dest = clip((key >> shift) * nd // two_s, 0, nd - 1). Returns
    (send int64 [nd, 2, cap]: keys, KSENT_I past each run, and s1, 0 there;
    ovf int64 scalar, 1 when a run is longer than cap; pair int32
    [NL + 1], zeros, exchange_finish's plane; bounds int32 [nd + 1]:
    destination t's run is [bounds[t], bounds[t + 1]), bounds[nd] the
    valid keys). On cuda `scratch` is an exchange_scratch(device, nd) (a
    new one when None); a failed launch zeroes it again."""
    dev = keys.device
    NL = keys.shape[0]
    _check([("keys", keys, I64, (NL,)), ("s1", s1, I32, (NL,))], dev)
    if not (NL >= 1 and nd >= 1 and cap >= 1 and two_s >= 1
            and 1 <= jb <= 62 and 0 <= rank < nd):
        raise ValueError("exchange_pack: NL %d nd %d cap %d jb %d two_s %d "
                         "rank %d" % (NL, nd, cap, jb, two_s, rank))
    if not _launch_device(dev, "exchange_pack"):
        return exchange_pack_plain(keys, s1, nd=nd, cap=cap, jb=jb,
                                   shift=shift, two_s=two_s, rank=rank)
    scratch = _exchange_scratch(scratch, dev, nd)
    send = torch.empty((nd, 2, cap), dtype=I64, device=dev)
    ovf = torch.empty((), dtype=I64, device=dev)
    pair = torch.empty(NL + 1, dtype=I32, device=dev)
    bounds = torch.empty(nd + 1, dtype=I32, device=dev)
    try:
        _launch("exchange_pack", dev, _kernel_lib().pg_exchange_pack,
                _ptr(keys), _ptr(s1), NL, nd, cap, jb, shift, two_s,
                rank * NL, _ptr(send), _ptr(ovf), _ptr(pair), _ptr(bounds),
                _ptr(scratch))
    except RuntimeError:
        scratch.zero_()
        raise
    return send, ovf, pair, bounds


def exchange_pack_plain(keys, s1, *, nd: int, cap: int, jb: int,
                        shift: int, two_s: int, rank: int):
    """Plain PyTorch version of exchange_pack: the runs by a count and a
    cumulative sum, as device_loop.py:325-348 finds them."""
    dev = keys.device
    NL = keys.shape[0]
    dest = ((keys >> shift) * nd // two_s).clamp(0, nd - 1)
    cnt = seg_sum((keys != KSENT_I).to(I32), dest, nd)
    start = torch.cumsum(cnt, 0) - cnt
    cc = torch.arange(cap, dtype=I32, device=dev)[None, :]
    k_g = keys[(start[:, None] + cc).clamp(0, NL - 1)]
    smask = cc < cnt[:, None]                              # [nd, cap]
    orig_row = ((k_g & ((1 << jb) - 1)) - rank * NL).clamp(0, NL - 1)
    send = torch.stack([torch.where(smask, k_g, KSENT_I),
                        torch.where(smask, s1[orig_row], 0).to(I64)], dim=1)
    bounds = torch.cat([start, cnt.sum().reshape(1)]).to(I32)
    return (send, (cnt > cap).any().to(I64),
            torch.zeros(NL + 1, dtype=I32, device=dev), bounds)


def exchange_window(per_rank: torch.Tensor, vw: torch.Tensor,
                    s1: torch.Tensor, reply_loc: torch.Tensor,
                    got_k: torch.Tensor, *, rank: int, A: int):
    """This rank's [2, A] table plane and reply: per_rank int64 [2 nd] (each
    rank's n_out_l and overflow flag, the all_gather's); the fold of the
    received range: vw int64, s1 int32 [RL] (its arc rows), reply_loc int32
    [RL] (each received slot's local out-group row); got_k int64 [RL], the
    received keys. Returns (table int64 [2, A]: vw and s1 of the rows
    below n_out_l at clamp(off, 0, A) + row, 0 elsewhere; reply int32 [RL]:
    reply_loc + off, 0 at a sentinel; n_out int64 scalar: every rank's
    n_out_l summed, A + 1 on any overflow), off being the earlier ranks'
    n_out_l."""
    dev = vw.device
    nd = per_rank.shape[0] // 2
    RL = vw.shape[0]
    _check([("per_rank", per_rank, I64, (2 * nd,)), ("vw", vw, I64, (RL,)),
            ("s1", s1, I32, (RL,)), ("reply_loc", reply_loc, I32, (RL,)),
            ("got_k", got_k, I64, (RL,))], dev)
    if not (nd >= 1 and 0 <= rank < nd and A >= 1):
        raise ValueError("exchange_window: nd %d rank %d A %d"
                         % (nd, rank, A))
    if not _launch_device(dev, "exchange_window"):
        return exchange_window_plain(per_rank, vw, s1, reply_loc, got_k,
                                     rank=rank, A=A)
    table = torch.empty((2, A), dtype=I64, device=dev)
    reply = torch.empty(RL, dtype=I32, device=dev)
    n_out = torch.empty((), dtype=I64, device=dev)
    _launch("exchange_window", dev, _kernel_lib().pg_exchange_window,
            *map(_ptr, (per_rank, vw, s1, reply_loc, got_k)), nd, rank, RL,
            A, _ptr(table), _ptr(reply), _ptr(n_out))
    return table, reply, n_out


def exchange_window_plain(per_rank, vw, s1, reply_loc, got_k, *, rank: int,
                          A: int):
    """Plain PyTorch version of exchange_window: the window's
    index_copy_ into a zero plane of A + RL rows, as dynamic_update_slice
    holds it inside [0, A + RL)."""
    dev = vw.device
    RL = vw.shape[0]
    pr = per_rank.reshape(-1, 2)
    nouts = pr[:, 0]
    off = nouts[:rank].sum()
    n_out = torch.where(pr[:, 1].sum() > 0, A + 1, nouts.sum())
    lv = torch.arange(RL, device=dev) < nouts[rank]
    at = off.clamp(0, A) + torch.arange(RL, device=dev)
    put = lambda x: torch.zeros(A + RL, dtype=I64, device=dev) \
        .index_copy_(0, at, torch.where(lv, x, 0).to(I64))[:A]
    reply = torch.where(got_k != KSENT_I, reply_loc + off, 0).to(I32)
    return torch.stack([put(vw), put(s1)]), reply, n_out


def exchange_finish(table: torch.Tensor, n_out: torch.Tensor,
                    send: torch.Tensor, reply: torch.Tensor,
                    pair: torch.Tensor, bounds: torch.Tensor, *, jb: int,
                    rank: int):
    """The arc table and the pair slots: table int64 [2, A] (the ranks'
    planes summed), n_out int64 scalar, this rank's send plane int64
    [nd, 2, C], reply int32 [nd C] (the arc rows returned to its slots),
    pair int32 [NL + 1] (exchange_pack's, zeros), bounds int32 [nd + 1]
    (exchange_pack's: slot (t, c) was sent iff c < min(bounds[t + 1] -
    bounds[t], C); only those are read). Returns (arc_vw int64 [A]: SENT_I
    past n_out; arc_s1 int32 [A]: 0 there; pair[:NL], each sent key's
    origin row holding its slot's reply, written in place). The kernel
    raises each such row to its reply (atomicMax), which is the store
    because the plane is exchange_pack's zeros, a row takes one key and a
    reply is an arc row (>= 0)."""
    dev = table.device
    A = table.shape[1]
    nd, _, C = send.shape
    NL = pair.shape[0] - 1
    _check([("table", table, I64, (2, A)), ("n_out", n_out, I64, ()),
            ("send", send, I64, (nd, 2, C)), ("reply", reply, I32, (nd * C,)),
            ("pair", pair, I32, (NL + 1,)),
            ("bounds", bounds, I32, (nd + 1,))], dev)
    if not (A >= 1 and NL >= 1 and 1 <= jb <= 62 and 0 <= rank < nd):
        raise ValueError("exchange_finish: A %d NL %d jb %d rank %d"
                         % (A, NL, jb, rank))
    if not _launch_device(dev, "exchange_finish"):
        return exchange_finish_plain(table, n_out, send, reply, pair, bounds,
                                     jb=jb, rank=rank)
    arc_vw = torch.empty(A, dtype=I64, device=dev)
    arc_s1 = torch.empty(A, dtype=I32, device=dev)
    _launch("exchange_finish", dev, _kernel_lib().pg_exchange_finish,
            *map(_ptr, (table, n_out, send, reply, bounds)), A, nd, C, NL,
            jb, rank * NL, _ptr(arc_vw), _ptr(arc_s1), _ptr(pair))
    return arc_vw, arc_s1, pair[:NL]


def exchange_finish_plain(table, n_out, send, reply, pair, bounds, *,
                          jb: int, rank: int):
    """Plain PyTorch version of exchange_finish: the slots sent from the
    bounds (JAX's smask), the pair slots by one scatter_ whose unsent
    slots go to the spare row NL."""
    A = table.shape[1]
    nd, _, C = send.shape
    NL = pair.shape[0] - 1
    dev = table.device
    live = torch.arange(A, dtype=I64, device=dev) < n_out
    cnt = (bounds[1:] - bounds[:-1]).clamp(max=C)
    sent = torch.arange(C, dtype=I32, device=dev)[None, :] < cnt[:, None]
    k = send[:, 0]
    row = ((k & ((1 << jb) - 1)) - rank * NL).clamp(0, NL - 1)
    pair.scatter_(0, torch.where(sent, row, NL).reshape(-1), reply)
    return (torch.where(live, table[0], SENT_I),
            torch.where(live, table[1].to(I32), 0), pair[:NL])
