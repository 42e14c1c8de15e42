"""The per-round device step's walk, gene counters and arc dedupe as
hand-written CUDA kernels (csrc/step_round.cu), each beside its plain
PyTorch version.

They replace the XLA forms of the JAX package's per-genome round
(pangene_tpu/parallel/stacked.py:54 _genome_round, vmapped by round_step
at :152) between and after its two sorts, which stay torch.sort (JAX sorts
with jnp.argsort):

  step_walk    over each genome's rows in the stable (cid, cm) order: the
               kept rows (unfiltered, not shadowed, below n_rows), each
               kept row's previous kept row (a running maximum), the pair
               of the two when they share a contig; per position the
               biased keys of the pair's forward and reverse arcs (int64
               max without a pair), its flag, int32-truncated cm distance
               and the two rows' scores; and the gene counters: each kept
               row adds one to tot[clip(sid)], and each genome one to
               n_genome[clip(sid)] for every segment it has a kept row of
               (stacked.py:85-115, :137-140).
  step_dedupe  over each genome's sorted arc keys: per group of equal keys,
               at its index among the genome's groups, the valid members'
               count, dist sum, largest scores and key (stacked.py:117-135);
               rows past the last group read 0.

On cuda each wrapper launches its kernel or raises; on the CPU it takes the
plain version. Neither reads a value on the host. Both kernels cut each
genome into tiles of TILE positions, one block a tile taken by ticket, the
carry by a decoupled look-back; each call is one memset of its scratch
(sized by the C side, allocated here) and one launch. step_walk takes any
gene count: the genomes' seen bits are a global plane of the scratch,
which follows the counts in one buffer.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import torch

from ..util import build_dir
from .loop_kernels import _check, seg_max, seg_sum
from .sweep_kernel import build_so

I64 = torch.int64
I32 = torch.int32
U8 = torch.uint8
BIAS = -(1 << 63)                 # uint64 order as int64 order (xor)
NO_ARC = (1 << 63) - 1            # the all-ones uint64 key, biased
SCORE_FLOOR = -2**31 + 1          # m1 / m2 of a group's invalid members
# Positions a tile of either kernel holds: kTile of csrc/step_round.cu
# (launch_shape reads it from the built library; a card test holds the two
# equal). testing.STEP_STATES cut their genomes at its multiples.
TILE = 1024

# Launches of each kernel and calls of its plain version. reset_counts()
# zeroes them; stacked.LAST and chip_smoke.py read them.
n_calls = {name: {"kernel": 0, "plain": 0}
           for name in ("step_walk", "step_dedupe")}


def reset_counts() -> None:
    for c in n_calls.values():
        for k in c:
            c[k] = 0


# ---------------------------------------------------------------------------
# building and loading the kernels
# ---------------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "step_round.cu")
SO_NAME = "libstep_round.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> Tuple[float, str]:
    """build_so of csrc/step_round.cu."""
    return build_so(_SRC, SO_NAME, force)


def load(path: str) -> ctypes.CDLL:
    """The built library with its entry points' C signatures."""
    lib = ctypes.CDLL(path)
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.pg_step_walk
    fn.restype = i
    fn.argtypes = [vp] * 12 + [i] * 4 + [vp] * 8
    fn = lib.pg_step_walk_scratch
    fn.restype = ctypes.c_longlong
    fn.argtypes = [i, i, i]
    fn = lib.pg_step_dedupe_scratch
    fn.restype = ctypes.c_longlong
    fn.argtypes = [i, i]
    fn = lib.pg_step_shape
    fn.restype = None
    fn.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_longlong)]
    fn = lib.pg_step_dedupe
    fn.restype = i
    fn.argtypes = [vp] * 6 + [i] * 2 + [vp] * 7
    return lib


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build()
            _lib = load(os.path.join(build_dir(), SO_NAME))
        return _lib


def launch_shape(G: int, H: int, n_gene: int = 1) -> dict:
    """Both kernels' launch for G genomes of H rows and n_gene genes, from
    the built library: threads a block, positions a tile, step_walk's and
    step_dedupe's blocks, and the bytes of their scratch (step_walk's after
    the counts)."""
    info = (ctypes.c_longlong * 6)()
    _kernel_lib().pg_step_shape(G, H, n_gene, info)
    return dict(zip(("threads", "tile", "walk_blocks", "dedupe_blocks",
                     "walk_scratch_bytes", "dedupe_scratch_bytes"), info))


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


# ---------------------------------------------------------------------------
# the walk and the counters
# ---------------------------------------------------------------------------

def step_walk(st, perm: torch.Tensor, flt: torch.Tensor,
              shadow: torch.Tensor, g2s: torch.Tensor, *, use_ori: bool):
    """The walk of the per-round step. `st`: the step's constant columns
    (parallel/stacked.StackCols: batch.n_rows, batch.cid, batch.gid,
    batch.rev, cm, dom_gid, score_ori, score_dom, [G, H]); perm int64
    [G, H], each genome's stable (cid, cm) order; flt, shadow uint8 [G, H]
    (this round's); g2s int32 [n_gene >= 1], gene -> segment or -1.
    Returns (akey int64 [G, 2H]: the biased forward key at a position, the
    reverse at H + the position, int64 max without a pair; pair_ok uint8,
    dist, s1, s2 int32 [G, H] by position, zeros without a pair; counts
    int32 [2, n_gene]: tot and n_genome over this rank's genomes)."""
    bc = st.batch
    dev = flt.device
    G, H = flt.shape
    n_gene = g2s.shape[0]
    if n_gene < 1:
        raise ValueError("g2s needs at least one gene")
    _check([("perm", perm, I64, (G, H)), ("flt", flt, U8, (G, H)),
            ("shadow", shadow, U8, (G, H)), ("n_rows", bc.n_rows, I32, (G,)),
            ("cid", bc.cid, I32, (G, H)), ("gid", bc.gid, I32, (G, H)),
            ("rev", bc.rev, U8, (G, H)),
            ("score_ori", st.score_ori, I32, (G, H)),
            ("score_dom", st.score_dom, I32, (G, H)),
            ("dom_gid", st.dom_gid, I32, (G, H)), ("cm", st.cm, I64, (G, H)),
            ("g2s", g2s, I32, (n_gene,))], dev)
    if not _launch_device(dev, "step_walk"):
        return step_walk_plain(st, perm, flt, shadow, g2s, use_ori=use_ori)
    akey = torch.empty((G, 2 * H), dtype=I64, device=dev)
    pair_ok = torch.empty((G, H), dtype=U8, device=dev)
    dist, s1, s2 = (torch.empty((G, H), dtype=I32, device=dev)
                    for _ in range(3))
    lib = _kernel_lib()
    # the counts, then the scratch (the genomes' seen bits, the tiles'
    # status words, the ticket): one buffer, one memset
    nb = lib.pg_step_walk_scratch(G, H, n_gene)
    buf = torch.empty(2 * n_gene + nb // 4, dtype=I32, device=dev)
    counts = buf[:2 * n_gene].view(2, n_gene)
    p = lambda t: t.data_ptr()
    _launch("step_walk", dev, lib.pg_step_walk, p(perm), p(flt),
            p(shadow), p(bc.n_rows), p(bc.cid), p(bc.gid), p(bc.rev),
            p(st.score_ori), p(st.score_dom), p(st.dom_gid), p(st.cm),
            p(g2s), G, H, n_gene, int(bool(use_ori)), p(akey), p(pair_ok),
            p(dist), p(s1), p(s2), p(counts), p(buf[2 * n_gene:]))
    return akey, pair_ok, dist, s1, s2, counts


def step_walk_plain(st, perm, flt, shadow, g2s, *, use_ori: bool):
    """Plain PyTorch version of step_walk."""
    bc = st.batch
    dev = flt.device
    G, H = flt.shape
    n_gene = g2s.shape[0]
    iota = torch.arange(H, dtype=I32, device=dev)
    valid = iota[None, :] < bc.n_rows[:, None]
    g = lambda a: torch.gather(a, 1, perm)
    kept = g((flt == 0) & (shadow == 0) & valid)
    sid = g2s[g(bc.gid).clamp(0, n_gene - 1).long()].to(I64)
    w = (sid << 1) | g(bc.rev).to(I64)
    so, sd = g(st.score_ori), g(st.score_dom)
    if use_ori:
        scsel = so
    else:
        dom = g(st.dom_gid)
        use_ori_vec = (so > sd) | (dom < 0) \
            | (g2s[dom.clamp(0, n_gene - 1).long()] >= 0)
        scsel = torch.where(use_ori_vec, so, sd)
    cm_s = g(st.cm)
    cid_s = g(bc.cid)
    # the previous kept position: an inclusive running max of kept ones
    run = torch.cummax(torch.where(kept, iota[None, :], -1), dim=1).values
    prev = torch.cat([run.new_full((G, 1), -1), run[:, :-1]], dim=1)
    take = lambda a: torch.gather(a, 1, prev.clamp(0, H - 1).long())
    pair_ok = kept & (prev >= 0) & (take(cid_s) == cid_s)
    v = take(w)
    zero = torch.zeros((), dtype=I32, device=dev)
    # dist truncates to int32 like the reference pg_tmparc_t
    dist = torch.where(pair_ok, (cm_s - take(cm_s)).to(I32), zero)
    s1 = torch.where(pair_ok, take(scsel), zero)
    s2 = torch.where(pair_ok, scsel, zero)
    # v << 32 | w on the full 64 bits: a negative w (a kept hit of a
    # non-vertex gene) sets the high bits as the reference's uint64 does
    ax = torch.cat([(v << 32) | w, ((w ^ 1) << 32) | (v ^ 1)], dim=1)
    akey = torch.where(torch.cat([pair_ok, pair_ok], dim=1), ax ^ BIAS,
                       NO_ARC)
    # sid is clipped, not dropped: a kept hit of a non-vertex gene counts
    # towards segment 0, as in the JAX package
    cnts = torch.zeros((G, n_gene), dtype=I32, device=dev) \
        .scatter_add_(1, sid.clamp(0, n_gene - 1), kept.to(I32))
    counts = torch.stack([cnts.sum(0, dtype=I32),
                          (cnts > 0).sum(0, dtype=I32)])
    return akey, pair_ok.to(U8), dist, s1, s2, counts


# ---------------------------------------------------------------------------
# the dedupe
# ---------------------------------------------------------------------------

def step_dedupe(xs: torch.Tensor, aperm: torch.Tensor,
                pair_ok: torch.Tensor, dist: torch.Tensor, s1: torch.Tensor,
                s2: torch.Tensor):
    """The per-genome arc dedupe: xs int64 [G, 2H] the walk's keys, each
    genome's sorted; aperm int64 [G, 2H] the sort's indices into them;
    pair_ok uint8, dist, s1, s2 int32 [G, H] the walk's. Returns (uniq_x
    int64: the key's raw bits where the group has a valid member, else 0;
    cnt int32; dsum int64; m1, m2 int32), [G, 2H], group k of a genome at
    its row k (the groups in key order); rows past its last group read 0."""
    dev = xs.device
    G, A = xs.shape
    H = A // 2
    _check([("xs", xs, I64, (G, 2 * H)), ("aperm", aperm, I64, (G, 2 * H)),
            ("pair_ok", pair_ok, U8, (G, H)), ("dist", dist, I32, (G, H)),
            ("s1", s1, I32, (G, H)), ("s2", s2, I32, (G, H))], dev)
    if not _launch_device(dev, "step_dedupe"):
        return step_dedupe_plain(xs, aperm, pair_ok, dist, s1, s2)
    uniq_x, dsum = (torch.empty((G, A), dtype=I64, device=dev)
                    for _ in range(2))
    cnt, m1, m2 = (torch.empty((G, A), dtype=I32, device=dev)
                   for _ in range(3))
    lib = _kernel_lib()
    # the tiles' flags, aggregates and inclusive values, the ticket
    scratch = torch.empty(lib.pg_step_dedupe_scratch(G, H) // 8, dtype=I64,
                          device=dev)
    p = lambda t: t.data_ptr()
    _launch("step_dedupe", dev, lib.pg_step_dedupe, p(xs), p(aperm),
            p(pair_ok), p(dist), p(s1), p(s2), G, H, p(uniq_x), p(cnt),
            p(dsum), p(m1), p(m2), p(scratch))
    return uniq_x, cnt, dsum, m1, m2


def step_dedupe_plain(xs, aperm, pair_ok, dist, s1, s2):
    """Plain PyTorch version of step_dedupe: segment sums and maxima over
    the groups' indices."""
    dev = xs.device
    G, A = xs.shape
    H = A // 2
    second = aperm >= H
    row = torch.where(second, aperm - H, aperm)
    at = lambda a: torch.gather(a, 1, row)
    vs = at(pair_ok) != 0
    s1r, s2r = at(s1), at(s2)
    a1 = torch.where(second, s2r, s1r)
    a2 = torch.where(second, s1r, s2r)
    newgrp = torch.cat([xs.new_ones((G, 1), dtype=torch.bool),
                        xs[:, 1:] != xs[:, :-1]], dim=1)
    seg = (torch.cumsum(newgrp, dim=1) - 1
           + A * torch.arange(G, dtype=I64, device=dev)[:, None]).reshape(-1)
    flat = lambda a: a.reshape(-1)
    N = G * A
    cnt = seg_sum(flat(vs.to(I32)), seg, N)
    dsum = seg_sum(flat(torch.where(vs, at(dist).to(I64), 0)), seg, N)
    m1 = seg_max(flat(torch.where(vs, a1, SCORE_FLOOR)), seg, N)
    m2 = seg_max(flat(torch.where(vs, a2, SCORE_FLOOR)), seg, N)
    # the group's key: the unsigned maximum over its valid members
    uniq_x = torch.full((N,), BIAS, dtype=I64, device=dev) \
        .scatter_reduce_(0, seg, flat(torch.where(vs, xs, BIAS)), "amax",
                         include_self=True) ^ BIAS
    sh = lambda a: a.reshape(G, A)
    return sh(uniq_x), sh(cnt), sh(dsum), sh(m1), sh(m2)
