"""The blocks of the device-resident pruning loop as hand-written CUDA
kernels (csrc/loop_blocks.cu: the branch block and the merge's fold;
csrc/loop_round.cu: the walk, the branch block's prelude, weak propagation
and the occ block with the convergence count), each beside its plain
PyTorch version.

The branch block (reference branch.c:48-106; JAX
pangene_tpu/parallel/device_loop.py:525 branch_block, its loc_chunk loop at
:578, the deficit at :627-634, n_dist_loci at :636). The arc table is the
loop's: v-sorted, so the arcs of one source vertex (a group) are
contiguous; a group of >= 2 valid arcs branches, gs_of is its first arc, mx
its largest s1 (at least 0) and is_max marks the members whose s1 is mx.
For every branching arc a and every other member p of its group, whatever
the group's size, the pair is local when some genome has both targets'
representatives present, on the same contig unless frag_mode, within
local_dist bp of cm or local_count kept-hit ranks. Then aml[a] |=
is_max[p], and he[a] is set when p < a (an earlier local partner). The
self pair is never counted.
Each branching arc is then classified by the reference's double deficit
1 - s1 / mx (branch.c:72-78): aw 1 when it exceeds branch_diff, 2 when it
also exceeds branch_diff_cut, or branch_diff_dist without a local max
partner; n_grp, at a group's first arc, counts its members with no earlier
local partner (branch.c:82-90), and counts = (#aw == 1, #aw == 2). Three
entries: branch_block (one rank: the groups found in the arc table,
locality and classification in one launch), and for the mesh
branch_locality (its bits are OR'd over the ranks) then branch_classify.
The first two add into a tally (int64 [4]): valid arcs (branch_locality:
its branching arcs), branching arcs, the groups of more than WIDE_ROWS
members (the kernel's wide path) and the widest branching group.

merge_fold: the merge's fold after its sort (graph.c:87-177; JAX
device_loop.py:264 walk_merge, its bucket exchange and its full tail).
Over sorted int64 keys ((vw << GB | g) << jb) | low, invalid rows holding
KSENT_I at the end, an in-group is a run of equal (vw, g) and an out-group
a run of equal vw.
Per out-group, in order: the arc row (vw, plus499(sum of the in-groups'
largest s1, number of in-groups)); past n_out the rows read (SENT_I, 0).
Each valid row's out-group rank goes to pair[src], src being its origin
row: the low jb key bits, or perm[i] when the keys were sorted with a
permutation; every other pair slot reads 0. s1 values are scores (>= 0).
The full mode (the loop's full=True tail, JAX device_loop.py:410-415 and
:471-500) also takes each origin's s2 (a score) and int32 dist and adds,
per out-group, ng (its in-groups), tot (its rows), the dist average
plus499(sum over its in-groups of plus499(in-group dist sum, rows) * rows,
tot) and the s2 average plus499(sum of the in-groups' largest s2, ng).

walk_pairs, branch_prep, prop_round, occ_round: the rest of a round
(JAX device_loop.py:222 kept_pairs and :264-300, :512-537, :673-690, :693
and :724-740), described at each wrapper and in csrc/loop_round.cu.
prop_round and occ_round update the round state in place.

On cuda each wrapper launches its kernel or raises; on the CPU it takes the
plain version. Neither reads a value on the host on the card. The kernels
that the device loop launches every round (branch_prep, branch_block,
prop_round, occ_round, walk_pairs, merge_fold) are each a check and a
launch: bind_<name> checks the arguments, allocates the outputs and binds
the library symbol, the stream and the device pointers once, and returns a
Bound whose launch(...) takes only what changes between calls; the public
wrapper is bind then launch, one call. A binding's outputs are its own
planes, written anew by every launch (on the CPU from the plain version's
result).
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from ..util import build_dir
from . import softfloat as sf
from .sweep_kernel import Bound, build_so, device_guard
from .sweep_kernel import bound_stream as _stream

I64 = torch.int64
I32 = torch.int32
SENT_I = (1 << 62) - 1                   # empty arc-table slot
KSENT_I = (1 << 62)                      # sort key of an invalid row
_LONG_MAX = (1 << 63) - 1

# Launches of each kernel and calls of its plain version. reset_counts()
# zeroes them; the loop's LAST and chip_smoke.py read them. merge_fold
# counts both modes, merge_fold_full the full mode's alone.
n_calls = {name: {"kernel": 0, "plain": 0} for name in (
    "branch_block", "branch_locality", "branch_classify", "merge_fold",
    "merge_fold_full", "walk_pairs", "branch_prep", "prop_round",
    "occ_round")}


# Argument checks (_check calls) of the wrappers of this module and of the
# modules that share _check (ops/mesh_kernels, ops/step_kernels): one a
# public call, one a bind_<name>. reset_counts() zeroes it.
n_checks = 0


def reset_counts() -> None:
    global n_checks
    n_checks = 0
    for c in n_calls.values():
        for k in c:
            c[k] = 0


# ---------------------------------------------------------------------------
# segment helpers (also the loop's and the per-round step's)
# ---------------------------------------------------------------------------

def seg_sum(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=vals.dtype, device=vals.device) \
        .index_add_(0, ids, vals)


def seg_max(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment maximum; a segment with no member reads 0 (unread)."""
    return torch.zeros(n, dtype=vals.dtype, device=vals.device) \
        .scatter_reduce_(0, ids, vals, "amax", include_self=False)


def seg_min(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=vals.dtype, device=vals.device) \
        .scatter_reduce_(0, ids, vals, "amin", include_self=False)


def plus499_i32(S: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return sf.plus499_trunc(S, n.clamp(min=1)).to(I32)


def prev_row(x: torch.Tensor, first) -> torch.Tensor:
    """[first, x[0], ..., x[-2]]."""
    return torch.cat([x.new_full((1,), first), x[:-1]])


# ---------------------------------------------------------------------------
# building and loading the kernels
# ---------------------------------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SRC = os.path.join(_CSRC, "loop_blocks.cu")
SO_NAME = "libloop_blocks.so"
_SRC_ROUND = os.path.join(_CSRC, "loop_round.cu")
SO_ROUND = "libloop_round.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_round: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> Tuple[float, str]:
    """build_so of csrc/loop_blocks.cu."""
    return build_so(_SRC, SO_NAME, force)


def build_round(force: bool = False) -> Tuple[float, str]:
    """build_so of csrc/loop_round.cu."""
    return build_so(_SRC_ROUND, SO_ROUND, force)


def load(path: str) -> ctypes.CDLL:
    """The built library with its entry points' C signatures."""
    lib = ctypes.CDLL(path)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    d = ctypes.c_double
    fn = lib.pg_branch_locality
    fn.restype = i
    fn.argtypes = [vp] * 4 + [i] + [vp] * 4 + [ll, i, ll, ll] + [vp] * 5
    fn = lib.pg_branch_block
    fn.restype = i
    fn.argtypes = ([vp] * 4 + [i] + [vp] * 3 + [i, ll, i, ll, ll]
                   + [d] * 3 + [vp] * 6)
    lib.pg_branch_scratch.restype = ll
    lib.pg_branch_scratch.argtypes = [ll]
    fn = lib.pg_branch_classify
    fn.restype = i
    fn.argtypes = [vp] * 6 + [ll] + [d] * 3 + [vp] * 4
    fn = lib.pg_merge_fold_tiles
    fn.restype = ll
    fn.argtypes = [ll]
    fn = lib.pg_merge_fold
    fn.restype = i
    fn.argtypes = [vp] * 5 + [ll, i, i, ll] + [vp] * 9 + [ll, vp]
    return lib


def load_round(path: str) -> ctypes.CDLL:
    """The built csrc/loop_round.cu with its entry points' C signatures."""
    lib = ctypes.CDLL(path)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.pg_walk_pairs
    fn.restype = i
    fn.argtypes = [vp] * 13 + [i] * 6 + [ll, i] + [vp] * 8
    fn = lib.pg_branch_prep
    fn.restype = i
    fn.argtypes = [vp] * 6 + [i] * 3 + [vp, ll, vp] + [i] * 2 + [vp] * 7
    for fn in (lib.pg_walk_pairs_scratch, lib.pg_branch_prep_scratch):
        fn.restype = ll
        fn.argtypes = [ll, i, i]
    fn = lib.pg_prop_round
    fn.restype = i
    fn.argtypes = [vp] * 3 + [ll, i, i] + [vp] * 5 + [ll, vp, vp, vp]
    fn = lib.pg_occ_round
    fn.restype = i
    fn.argtypes = ([vp] * 5 + [i, ll, vp, ll, i, i] + [vp] * 3
                   + [i, ll, i, i] + [vp] * 8)
    lib.pg_round_scratch.restype = ll
    lib.pg_round_scratch.argtypes = [i]
    return lib


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build()
            _lib = load(os.path.join(build_dir(), SO_NAME))
        return _lib


def _round_lib() -> ctypes.CDLL:
    global _round
    with _lock:
        if _round is None:
            build_round()
            _round = load_round(os.path.join(build_dir(), SO_ROUND))
        return _round


def _check(named, dev: torch.device) -> None:
    """Each (name, tensor, dtype, shape) contiguous on `dev` (counted in
    n_checks)."""
    global n_checks
    n_checks += 1
    for name, t, dtype, shape in named:
        if t.dtype != dtype:
            raise ValueError("%s: dtype %s, expected %s"
                             % (name, t.dtype, dtype))
        if t.device != dev or tuple(t.shape) != tuple(shape) or \
                not t.is_contiguous():
            raise ValueError("%s must be a contiguous %s tensor on %s, got "
                             "%s on %s" % (name, tuple(shape), dev,
                                           tuple(t.shape), t.device))


def _on_cuda(dev: torch.device, name: str) -> bool:
    """True on cuda (launch), False on the CPU (plain); raises elsewhere."""
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("%s runs on cuda or cpu, not %s" % (name, dev))
    return dev.type == "cuda"


def _launch_device(dev: torch.device, *what: str) -> bool:
    """_on_cuda; on the CPU counts a plain call under each name of
    `what`."""
    if _on_cuda(dev, what[0]):
        return True
    _plain(*what)
    return False


def _plain(*what: str) -> None:
    for name in what:
        n_calls[name]["plain"] += 1


# ---------------------------------------------------------------------------
# the branch block
# ---------------------------------------------------------------------------

def _clip(x) -> int:
    return max(min(int(x), _LONG_MAX), -_LONG_MAX)


def _launch(names, fn, *args) -> None:
    """Calls fn(*args), a launch; raises on its error, else counts one
    launch under `names` (a name or a tuple of them)."""
    names = (names,) if isinstance(names, str) else names
    err = fn(*args)
    if err != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (names[0], err))
    for name in names:
        n_calls[name]["kernel"] += 1


def _check_planes(r_pres, r_cid, r_cm, r_rank, tgt_gid, named, dev):
    ng, G = r_pres.shape
    A = tgt_gid.shape[0]
    _check([("r_pres", r_pres, torch.bool, (ng, G)),
            ("r_cid", r_cid, I32, (ng, G)), ("r_cm", r_cm, I64, (ng, G)),
            ("r_rank", r_rank, I32, (ng, G)),
            ("tgt_gid", tgt_gid, I64, (A,))]
           + [(n, t, dt, (A,)) for n, t, dt in named], dev)
    return G, A


# Members a branch group must pass to take the kernel's wide path
# (csrc/loop_blocks.cu kBrRows); the tally counts such groups.
WIDE_ROWS = 64


def arc_heads(arc_vw: torch.Tensor, B: int):
    """(valid, v, g_new, g_id, n_in_g), [A] each, of the v-sorted arc
    table: a group is a run of valid arcs (vw != SENT_I) of one source
    vertex v = vw >> B; g_new marks its first arc, g_id numbers the groups
    and n_in_g is each arc's group's count of valid arcs."""
    A = arc_vw.shape[0]
    valid = arc_vw != SENT_I
    v = arc_vw >> B
    g_new = valid & (v != prev_row(v, -1))
    g_id = (torch.cumsum(g_new, 0) - 1).clamp(0, max(A - 1, 0))
    return valid, v, g_new, g_id, seg_sum(valid.to(I32), g_id, A)[g_id]


def arc_groups(arc_vw: torch.Tensor, arc_s1: torch.Tensor, B: int):
    """(gs_of int64, mx int32, branching bool, is_max bool), [A] each, of
    the v-sorted arc table's groups (arc_heads)."""
    A = arc_vw.shape[0]
    valid, _, _, g_id, n_in_g = arc_heads(arc_vw, B)
    iota = torch.arange(A, dtype=I64, device=arc_vw.device)
    gs_of = seg_min(torch.where(valid, iota, A), g_id, A)[g_id]
    mx = seg_max(torch.where(valid, arc_s1, 0), g_id, A)[g_id].clamp(min=0)
    branching = valid & (n_in_g >= 2)
    return gs_of, mx, branching, branching & (arc_s1 == mx)


def branch_tally(n_valid: torch.Tensor, gs_of: torch.Tensor,
                 branching: torch.Tensor) -> torch.Tensor:
    """The tally (int64 [4]) of one branch call: n_valid (a count), the
    branching arcs, the groups of more than WIDE_ROWS members, the widest
    group."""
    n = torch.unique_consecutive(gs_of[branching], return_counts=True)[1]
    widest = n.max() if n.numel() else n.new_zeros(())
    return torch.stack([n_valid.to(I64), branching.sum(),
                        (n > WIDE_ROWS).sum(), widest.to(I64)])


def branch_scratch(device, A: int) -> torch.Tensor:
    """The zeroed scratch of the branch kernels over A arcs on `device`
    (int64, its size from pg_branch_scratch): the launch's counters, the
    wide groups and their bits. Every launch that completes leaves it
    zeroed, so one serves every launch on one stream; a failed launch
    leaves it dirty (the wrappers zero it again)."""
    return torch.zeros(-(-int(_kernel_lib().pg_branch_scratch(int(A))) // 8),
                       dtype=I64, device=device)


def _launch_branch(name, fn, scratch, *args) -> None:
    """_launch of a branch kernel; its scratch zeroed after a failure."""
    try:
        _launch(name, fn, *args)
    except RuntimeError:
        scratch.zero_()
        raise


def _tally(tally, dev) -> torch.Tensor:
    """`tally`, checked to be a contiguous int64 [4] on `dev` (not counted
    in n_checks: it rides on its wrapper's check), or a zeroed one."""
    if tally is None:
        return torch.zeros(4, dtype=I64, device=dev)
    if tally.dtype != I64 or tally.device != dev or \
            tuple(tally.shape) != (4,) or not tally.is_contiguous():
        raise ValueError("tally must be a contiguous int64 (4,) tensor on "
                         "%s, got %s %s on %s" % (dev, tally.dtype,
                                                  tuple(tally.shape),
                                                  tally.device))
    return tally


def branch_block(r_pres, r_cid, r_cm, r_rank, tgt_gid, arc_vw, arc_s1, *,
                 B: int, frag_mode: bool, local_dist: int,
                 local_count: int, branch_diff: float,
                 branch_diff_dist: float, branch_diff_cut: float,
                 tally: Optional[torch.Tensor] = None):
    """(aw uint8 [A], n_grp int32 [A], counts int64 [2]) of the arc table
    (arc_vw int64, arc_s1 int32 [A]) with the groups found in it. The
    representative planes are gene-major [n_gene, G]: presence (bool),
    contig (int32), cm (int64) and kept-hit rank (int32) of each gene's last
    kept hit in genome g; tgt_gid (int64 [A], in [0, n_gene)) is each arc's
    target gene. `tally` (int64 [4]), when given, is added into."""
    dev = r_pres.device
    with device_guard(dev):
        return bind_branch_block(
            r_pres, r_cid, r_cm, r_rank, tgt_gid, arc_vw, arc_s1, B=B,
            frag_mode=frag_mode, local_dist=local_dist,
            local_count=local_count, branch_diff=branch_diff,
            branch_diff_dist=branch_diff_dist,
            branch_diff_cut=branch_diff_cut, tally=tally).launch(
                r_pres, r_cid, r_cm, r_rank, tgt_gid, arc_vw, arc_s1,
                torch.zeros(2, dtype=I64, device=dev))


def bind_branch_block(r_pres, r_cid, r_cm, r_rank, tgt_gid, arc_vw, arc_s1,
                      *, B: int, frag_mode: bool, local_dist: int,
                      local_count: int, branch_diff: float,
                      branch_diff_dist: float, branch_diff_cut: float,
                      tally: Optional[torch.Tensor] = None,
                      scratch: Optional[torch.Tensor] = None) -> Bound:
    """branch_block's check and launch: launch(r_pres, r_cid, r_cm, r_rank,
    tgt_gid, arc_vw, arc_s1, counts) -> (aw, n_grp, counts) on arguments
    shaped as the ones checked here, counts a zeroed int64 [2] (a view
    will do) that the launch adds into; aw and n_grp are out. Every launch
    adds into `tally` (int64 [4]; the binding's own zeroed one when None),
    out[2]. On cuda the launches count through `scratch` (branch_scratch
    over A arcs; the binding's own when None)."""
    dev = r_pres.device
    G, A = _check_planes(r_pres, r_cid, r_cm, r_rank, tgt_gid,
                         [("arc_vw", arc_vw, I64), ("arc_s1", arc_s1, I32)],
                         dev)
    if not 0 <= B < 62:
        raise ValueError("branch_block: B %d" % B)
    tally = _tally(tally, dev)
    kw = dict(frag_mode=frag_mode, local_dist=local_dist,
              local_count=local_count, branch_diff=branch_diff,
              branch_diff_dist=branch_diff_dist,
              branch_diff_cut=branch_diff_cut)
    aw = torch.empty(A, dtype=torch.uint8, device=dev)
    n_grp = torch.empty(A, dtype=I32, device=dev)
    if not _on_cuda(dev, "branch_block"):
        def plain(r_pres, r_cid, r_cm, r_rank, tgt_gid, arc_vw, arc_s1,
                  counts):
            _plain("branch_block")
            out = branch_block_plain(r_pres, r_cid, r_cm, r_rank, tgt_gid,
                                     arc_vw, arc_s1, B=B, tally=tally, **kw)
            for t, o in zip((aw, n_grp, counts), out):
                t.copy_(o)
            return aw, n_grp, counts
        return Bound(plain, (aw, n_grp, tally))
    fn = _kernel_lib().pg_branch_block
    if scratch is None:
        scratch = branch_scratch(dev, A)
    elif scratch.dtype != I64 or scratch.device != dev or \
            not scratch.is_contiguous() or \
            scratch.numel() * 8 < _kernel_lib().pg_branch_scratch(A):
        raise ValueError("scratch must be a contiguous int64 "
                         "branch_scratch(%s, %d)" % (dev, A))
    opts = (int(bool(frag_mode)), _clip(local_dist), _clip(local_count),
            float(branch_diff), float(branch_diff_dist),
            float(branch_diff_cut), aw.data_ptr(), n_grp.data_ptr())
    tail = (scratch.data_ptr(), tally.data_ptr(), _stream(dev))

    # _own keeps the binding's tally alive as long as its launch (the
    # caller may hold only the launch, and the tally is read through a
    # pointer)
    def launch(r_pres, r_cid, r_cm, r_rank, tgt_gid, arc_vw, arc_s1, counts,
               _own=(scratch, tally)):
        if A:
            _launch_branch("branch_block", fn, scratch, r_pres.data_ptr(),
                           r_cid.data_ptr(), r_cm.data_ptr(),
                           r_rank.data_ptr(), G, tgt_gid.data_ptr(),
                           arc_vw.data_ptr(), arc_s1.data_ptr(), B, A, *opts,
                           counts.data_ptr(), *tail)
        return aw, n_grp, counts
    return Bound(launch, (aw, n_grp, tally))


def branch_block_plain(r_pres, r_cid, r_cm, r_rank, tgt_gid, arc_vw, arc_s1,
                       *, B: int, frag_mode: bool, local_dist: int,
                       local_count: int, branch_diff: float,
                       branch_diff_dist: float, branch_diff_cut: float,
                       tally: Optional[torch.Tensor] = None):
    """Plain PyTorch version of branch_block: arc_groups, then
    branch_locality_plain and branch_classify_plain; the tally's share
    added into `tally` when given."""
    gs_of, mx, branching, is_max = arc_groups(arc_vw, arc_s1, B)
    aml, he = branch_locality_plain(
        r_pres, r_cid, r_cm, r_rank, tgt_gid, gs_of, branching, is_max,
        frag_mode=frag_mode, local_dist=local_dist, local_count=local_count)
    if tally is not None:
        _add_tally(tally, branch_tally((arc_vw != SENT_I).sum(), gs_of,
                                       branching))
    return branch_classify_plain(
        arc_s1, mx, branching, aml, he, gs_of, branch_diff=branch_diff,
        branch_diff_dist=branch_diff_dist, branch_diff_cut=branch_diff_cut)


def _add_tally(tally: torch.Tensor, t: torch.Tensor) -> None:
    """t added into tally: the counts summed, the widest group a maximum."""
    t = t.to(tally.device)
    tally[:3] += t[:3]
    tally[3] = torch.maximum(tally[3], t[3])


def branch_locality(r_pres, r_cid, r_cm, r_rank, tgt_gid, gs_of, branching,
                    is_max, *, frag_mode: bool, local_dist: int,
                    local_count: int, tally: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(aml, he), bool [A], of the groups given per arc of the v-sorted
    table: the group's first arc gs_of (int64), branching and is_max (bool);
    a group's branching members are contiguous. The planes and tgt_gid are
    branch_block's; `tally` (int64 [4]), when given, is added into (its
    valid arcs are the branching ones)."""
    dev = r_pres.device
    G, A = _check_planes(r_pres, r_cid, r_cm, r_rank, tgt_gid,
                         [("gs_of", gs_of, I64),
                          ("branching", branching, torch.bool),
                          ("is_max", is_max, torch.bool)], dev)
    kw = dict(frag_mode=frag_mode, local_dist=local_dist,
              local_count=local_count)
    if not _launch_device(dev, "branch_locality"):
        out = branch_locality_plain(r_pres, r_cid, r_cm, r_rank, tgt_gid,
                                    gs_of, branching, is_max, **kw)
        if tally is not None:
            _add_tally(tally, branch_tally(branching.sum(), gs_of,
                                           branching))
        return out
    aml = torch.empty(A, dtype=torch.bool, device=dev)
    he = torch.empty(A, dtype=torch.bool, device=dev)
    if A == 0:
        return aml, he
    with torch.cuda.device(dev):
        tally = _tally(tally, dev)
        scratch = branch_scratch(dev, A)
        _launch_branch("branch_locality", _kernel_lib().pg_branch_locality,
                       scratch, r_pres.data_ptr(), r_cid.data_ptr(),
                       r_cm.data_ptr(), r_rank.data_ptr(), G,
                       tgt_gid.data_ptr(), gs_of.data_ptr(),
                       branching.data_ptr(), is_max.data_ptr(), A,
                       int(bool(frag_mode)), _clip(local_dist),
                       _clip(local_count), aml.data_ptr(), he.data_ptr(),
                       scratch.data_ptr(), tally.data_ptr(), _stream(dev))
    return aml, he


def branch_locality_plain(r_pres, r_cid, r_cm, r_rank, tgt_gid, gs_of,
                          branching, is_max, *, frag_mode: bool,
                          local_dist: int, local_count: int):
    """Plain PyTorch version of branch_locality: the branching arcs
    compacted (a group's members stay contiguous, so its partner at
    in-group offset d is index + d), then one pass per offset d below the
    largest group's size, each evaluated once for both members."""
    A = tgt_gid.shape[0]
    dev = tgt_gid.device
    aml = torch.zeros(A, dtype=torch.bool, device=dev)
    he = torch.zeros(A, dtype=torch.bool, device=dev)
    bidx = torch.nonzero(branching).squeeze(1)
    nb = bidx.numel()
    if nb < 2:
        return aml, he
    tg = tgt_gid[bidx]
    pa, ca, ma, ra = r_pres[tg], r_cid[tg], r_cm[tg], r_rank[tg].to(I64)
    gs_b = gs_of[bidx]
    im_b = is_max[bidx]
    max_n = int(torch.unique_consecutive(gs_b, return_counts=True)[1].max())
    aml_b = torch.zeros(nb, dtype=torch.bool, device=dev)
    he_b = torch.zeros(nb, dtype=torch.bool, device=dev)
    for d in range(1, max_n):
        e, l = slice(0, nb - d), slice(d, nb)     # earlier, later
        same = gs_b[e] == gs_b[l]
        if not bool(same.any()):
            continue
        ok = pa[e] & pa[l]
        if not frag_mode:
            ok &= ca[e] == ca[l]
        loc = ok & (((ma[e] - ma[l]).abs() <= local_dist)
                    | ((ra[e] - ra[l]).abs() <= local_count))
        lp = loc.any(dim=1) & same
        aml_b[e] |= lp & im_b[l]                  # a later max
        aml_b[l] |= lp & im_b[e]                  # an earlier max
        he_b[l] |= lp                             # an earlier local
    aml[bidx] = aml_b
    he[bidx] = he_b
    return aml, he


def branch_classify(arc_s1, mx, branching, aml, he, gs_of, *,
                    branch_diff: float, branch_diff_dist: float,
                    branch_diff_cut: float):
    """branch_block's outputs from the groups (mx int32, branching bool,
    gs_of int64) and the locality bits (aml, he bool), [A] each."""
    dev = arc_s1.device
    A = arc_s1.shape[0]
    _check([("arc_s1", arc_s1, I32, (A,)), ("mx", mx, I32, (A,)),
            ("branching", branching, torch.bool, (A,)),
            ("aml", aml, torch.bool, (A,)), ("he", he, torch.bool, (A,)),
            ("gs_of", gs_of, I64, (A,))], dev)
    kw = dict(branch_diff=branch_diff, branch_diff_dist=branch_diff_dist,
              branch_diff_cut=branch_diff_cut)
    if not _launch_device(dev, "branch_classify"):
        return branch_classify_plain(arc_s1, mx, branching, aml, he, gs_of,
                                     **kw)
    aw = torch.empty(A, dtype=torch.uint8, device=dev)
    n_grp = torch.empty(A, dtype=I32, device=dev)
    counts = torch.zeros(2, dtype=I64, device=dev)
    if A == 0:
        return aw, n_grp, counts
    with torch.cuda.device(dev):
        _launch("branch_classify", _kernel_lib().pg_branch_classify,
                arc_s1.data_ptr(), mx.data_ptr(), branching.data_ptr(),
                aml.data_ptr(), he.data_ptr(), gs_of.data_ptr(), A,
                float(branch_diff), float(branch_diff_dist),
                float(branch_diff_cut), aw.data_ptr(), n_grp.data_ptr(),
                counts.data_ptr(), _stream(dev))
    return aw, n_grp, counts


def branch_classify_plain(arc_s1, mx, branching, aml, he, gs_of, *,
                          branch_diff: float, branch_diff_dist: float,
                          branch_diff_cut: float):
    """Plain PyTorch version of branch_classify: the deficit in softfloat
    (ops/softfloat.py, exact for 0 <= s1 <= mx), n_grp by a segment sum
    over the groups' first arcs."""
    A = arc_s1.shape[0]
    rm, rk = sf.one_minus_div(arc_s1.clamp(min=0).to(I64),
                              mx.clamp(min=1).to(I64))
    cand = branching & (mx > 0) & sf.gt_const(rm, rk, branch_diff)
    cut = cand & ((~aml & sf.gt_const(rm, rk, branch_diff_dist))
                  | sf.gt_const(rm, rk, branch_diff_cut))
    aw = cand.to(torch.uint8) + cut.to(torch.uint8)
    n_grp = seg_sum((branching & ~he).to(I32),
                    gs_of.clamp(0, max(A - 1, 0)), A)
    counts = torch.stack([(cand & ~cut).sum(), cut.sum()])
    return aw, n_grp, counts


# ---------------------------------------------------------------------------
# merge_fold
# ---------------------------------------------------------------------------

def merge_fold(keys: torch.Tensor, s1: torch.Tensor, *, jb: int, gb: int,
               cap: int, perm: Optional[torch.Tensor] = None,
               full: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """(arc_vw int64 [cap], arc_s1 int32 [cap], n_out int64 scalar, pair
    int32 [N]) of N sorted int64 keys, the rows' s1 (int32 [N], indexed by
    origin row) and, for keys whose low bits hold no origin, the sort's
    permutation (int64 [N]). full = (s2, dist), int32 [N] by origin, adds
    the output-only statistics (arc_ng, arc_tot, arc_ad, arc_s2), int32
    [cap] each."""
    dev = keys.device
    with device_guard(dev):
        return bind_merge_fold(keys, s1, jb=jb, gb=gb, cap=cap, perm=perm,
                               full=full).launch(
            keys, s1, torch.empty((), dtype=I64, device=dev), perm, full)


def bind_merge_fold(keys: torch.Tensor, s1: torch.Tensor, *, jb: int,
                    gb: int, cap: int, perm: Optional[torch.Tensor] = None,
                    full: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> Bound:
    """merge_fold's check and launch: launch(keys, s1, n_out, perm, full)
    -> (arc_vw, arc_s1, n_out, pair[, the four statistics]) on arguments
    shaped as the ones checked here (perm and full given or not as here),
    n_out an int64 scalar the launch writes (a view will do); arc_vw,
    arc_s1, pair and the statistics are out."""
    dev = keys.device
    N = keys.shape[0]
    named = [("keys", keys, I64, (N,)), ("s1", s1, I32, (N,))]
    if perm is not None:
        named.append(("perm", perm, I64, (N,)))
    if full is not None:
        named += [("s2", full[0], I32, (N,)), ("dist", full[1], I32, (N,))]
    _check(named, dev)
    if not (jb >= 0 and gb >= 0 and jb + gb < 62 and cap >= 1):
        raise ValueError("merge_fold: jb %d gb %d cap %d" % (jb, gb, cap))
    names = ("merge_fold",) + (("merge_fold_full",) if full is not None
                               else ())
    arc_vw = torch.empty(cap, dtype=I64, device=dev)
    arc_s1 = torch.empty(cap, dtype=I32, device=dev)
    stats = tuple(torch.empty(cap, dtype=I32, device=dev)
                  for _ in range(4 if full is not None else 0))
    if not _on_cuda(dev, "merge_fold"):
        pair = torch.empty(N, dtype=I32, device=dev)
        out = (arc_vw, arc_s1, pair) + stats

        def plain(keys, s1, n_out, perm=None, full=None):
            _plain(*names)
            got = merge_fold_plain(keys, s1, jb=jb, gb=gb, cap=cap,
                                   perm=perm, full=full)
            for t, o in zip((arc_vw, arc_s1, n_out, pair) + stats, got):
                t.copy_(o)
            return (arc_vw, arc_s1, n_out, pair) + stats
        return Bound(plain, out)
    lib = _kernel_lib()
    # the pair plane, then the tiles' look-back words and the ticket: one
    # buffer, zeroed by the launch's memset
    n_pair = N + (N & 1)
    n_words = int(lib.pg_merge_fold_tiles(N)) + 1
    zeroed = torch.empty(n_pair + 2 * n_words, dtype=I32, device=dev)
    pair = zeroed[:N]
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = lib.pg_merge_fold
    sizes = (N, jb, gb, cap, arc_vw.data_ptr(), arc_s1.data_ptr(),
             *([t.data_ptr() for t in stats] or [None] * 4))
    tail = (zeroed.data_ptr(), zeroed.data_ptr() + 4 * n_pair,
            4 * zeroed.numel(), _stream(dev))

    def launch(keys, s1, n_out, perm=None, full=None):
        s2, dist = full if full is not None else (None, None)
        _launch(names, fn, keys.data_ptr(), ptr(perm), s1.data_ptr(),
                ptr(s2), ptr(dist), *sizes, n_out.data_ptr(), *tail)
        return (arc_vw, arc_s1, n_out, pair) + stats
    return Bound(launch, (arc_vw, arc_s1, pair) + stats)


def merge_fold_plain(keys: torch.Tensor, s1: torch.Tensor, *, jb: int,
                     gb: int, cap: int, perm: Optional[torch.Tensor] = None,
                     full: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Plain PyTorch version of merge_fold: fold_sorted over the keys with
    their origin bits shifted out, then each row's out-group rank scattered
    to its origin; in the full mode fold_stats on the same fold."""
    N = keys.shape[0]
    k = keys >> jb
    va = k != (KSENT_I >> jb)
    src = perm if perm is not None else \
        torch.where(va, keys & ((1 << jb) - 1), 0)
    f = fold_sorted(k, va, s1[src], gb, cap)
    pair = torch.zeros(N + 1, dtype=I32, device=keys.device).scatter_(
        0, torch.where(va, src, N), f.out_id.to(I32))[:N]
    out = (f.arc_vw, f.arc_s1, f.n_out, pair)
    if full is None:
        return out
    return out + fold_stats(f, full[0][src], full[1][src], cap)


class Fold(NamedTuple):
    va: torch.Tensor        # [N] valid row
    in_new: torch.Tensor    # [N] first row of an in-group
    in_id: torch.Tensor     # [N] in-group rank of each row
    out_id: torch.Tensor    # [N] out-group rank of each row
    n_out: torch.Tensor     # int64 scalar: number of out-groups
    live: torch.Tensor      # [cap] row < n_out
    arc_vw: torch.Tensor    # [cap] int64, SENT_I past n_out
    arc_s1: torch.Tensor    # [cap] int32, 0 past n_out
    arc_ng: torch.Tensor    # [cap] int32 in-groups an out-group, 0 past n_out


def _fit(x: torch.Tensor, cap: int) -> torch.Tensor:
    """The first cap rows of x, zeros past its end."""
    N = x.shape[0]
    return x[:cap] if cap <= N else torch.cat([x, x.new_zeros(cap - N)])


def fold_sorted(k: torch.Tensor, va: torch.Tensor, s: torch.Tensor, gb: int,
                cap: int) -> Fold:
    """The two-level fold in torch ops over N sorted keys k = (vw << gb) | g
    (valid rows `va` first) and the rows' s1 `s` in that order: head flags,
    cumsum ids, the in-group maximum and the sums per out-group."""
    N = k.shape[0]
    last = max(N - 1, 0)
    in_new = va & (k != prev_row(k, KSENT_I))
    in_id = (torch.cumsum(in_new, 0) - 1).clamp(0, last)
    s1_in = seg_max(torch.where(va, s, 0), in_id, N)
    vw = k >> gb
    out_new = va & (vw != prev_row(vw, KSENT_I))
    out_id = (torch.cumsum(out_new, 0) - 1).clamp(0, last)
    ng = seg_sum(in_new.to(I32), out_id, N)
    s1s = seg_sum(torch.where(in_new, s1_in[in_id].to(I64), 0), out_id, N)
    vw_f = seg_max(torch.where(va, vw, 0), out_id, N)
    n_out = out_new.sum()
    live = torch.arange(cap, device=k.device) < n_out
    arc_ng = torch.where(live, _fit(ng, cap), 0)
    return Fold(va, in_new, in_id, out_id, n_out, live,
                torch.where(live, _fit(vw_f, cap), SENT_I),
                torch.where(live, plus499_i32(_fit(s1s, cap),
                                              arc_ng.to(I64)), 0),
                arc_ng)


def fold_stats(f: Fold, s2: torch.Tensor, d: torch.Tensor, cap: int):
    """The full mode's output-only statistics (graph.c:160-172) of the fold
    f, from the rows' s2 and int32 dist in sorted order: (arc_ng, arc_tot,
    arc_ad, arc_s2), int32 [cap] each, 0 past n_out. The averages are
    softfloat's exact plus499_trunc: of each in-group's dist sum over its
    rows, of the out-group's sum of those times the rows over its rows, and
    of the in-groups' largest s2 over their number."""
    N = s2.shape[0]
    va, in_new, in_id, out_id, live = (f.va, f.in_new, f.in_id, f.out_id,
                                       f.live)
    cnt_in = seg_sum(va.to(I64), in_id, N)
    ds_in = seg_sum(torch.where(va, d.to(I64), 0), in_id, N)
    dr_in = sf.plus499_trunc(ds_in, cnt_in.clamp(min=1))
    s2_in = seg_max(torch.where(va, s2, 0), in_id, N)
    tot_f = seg_sum(torch.where(in_new, cnt_in[in_id], 0).to(I32), out_id, N)
    ds_f = seg_sum(torch.where(in_new, dr_in[in_id] * cnt_in[in_id], 0),
                   out_id, N)
    s2s_f = seg_sum(torch.where(in_new, s2_in[in_id].to(I64), 0), out_id, N)
    arc_tot = torch.where(live, _fit(tot_f, cap), 0)
    arc_ad = torch.where(live, sf.plus499_trunc(
        torch.where(live, _fit(ds_f, cap), 0),
        arc_tot.clamp(min=1).to(I64)), 0).to(I32)
    arc_s2 = torch.where(live, plus499_i32(
        torch.where(live, _fit(s2s_f, cap), 0), f.arc_ng.to(I64)), 0)
    return f.arc_ng, arc_tot, arc_ad, arc_s2


# ---------------------------------------------------------------------------
# the rest of a round: walk_pairs, branch_prep, prop_round, occ_round
# ---------------------------------------------------------------------------

U8 = torch.uint8
BOOL = torch.bool


class WalkPlanes(NamedTuple):
    """The walk's round-invariant planes of this rank's genomes in cm order,
    [G, H] each (walk_planes)."""
    ordcm: torch.Tensor      # int32: the cs row of each cm position
    valid: torch.Tensor      # bool
    cid: torch.Tensor        # int32
    cm: torch.Tensor         # int64
    w: torch.Tensor          # int64: the oriented vertex (sid << 1) | rev
    seg: torch.Tensor        # int32: the segment, clamped into [0, S)
    score_ori: torch.Tensor  # int32
    score_dom: torch.Tensor  # int32
    dom_gid: torch.Tensor    # int32
    dom_sid: torch.Tensor    # int32: the dominant gene's segment


WALK_TYPES = (I32, BOOL, I32, I64, I64, I32, I32, I32, I32, I32)


def walk_planes(cols: dict, ordcm: torch.Tensor, sid_of: torch.Tensor,
                S: int) -> WalkPlanes:
    """WalkPlanes from the loop's [G, H] cs-order columns (cid, cm, gid,
    rev, valid, score_ori, score_dom, dom_gid), the cm order `ordcm` and
    each gene's segment `sid_of` (int32 [n_gene])."""
    o = ordcm.long()
    ng = sid_of.shape[0]
    g = lambda n: torch.gather(cols[n], 1, o)
    gid = g("gid")
    dg = g("dom_gid")
    sid = sid_of[gid.clamp(0, ng - 1).long()]
    return WalkPlanes(
        ordcm.to(I32).contiguous(), g("valid") != 0, g("cid"), g("cm"),
        (sid.to(I64) << 1) | g("rev").to(I64), sid.clamp(0, S - 1),
        g("score_ori"), g("score_dom"), dg,
        sid_of[dg.clamp(0, ng - 1).long()])


def walk_pairs(planes: WalkPlanes, flt: torch.Tensor, shadow: torch.Tensor,
               alive: torch.Tensor, *, B: int, GB: int, jb: int, rank: int,
               use_ori: bool, full: bool = False):
    """The merge's input from the round state (flt, shadow uint8 [G, H] in
    cs order, alive bool [S]): (keys int64 [G, 2H], s12 int32 [G, 2H],
    pair_ok bool [G, H], nxt int32 [G, H], seg int32 [2, S]) and in the
    full mode (s21, dist2) int32 [G, 2H]. Per cm position i with previous
    kept row p (kept: valid, flt and shadow 0): pair_ok when p exists on
    i's contig; slot i holds the forward key ((w_p << B | w_i) << GB | g),
    slot H + i the reverse ((w_i ^ 1) << B | w_p ^ 1, likewise), each
    further << jb | its global slot when jb > 0, KSENT_I where the pair is
    not ok; s12 the slots' s1 (score of p, then of i), s21 the swap, dist2
    the int32-truncated cm gap in both; nxt[p] = i (-1 where no kept row
    follows); seg this rank's (kept rows, genomes with a kept row) a
    segment. g is the global genome rank * G + row, a slot rank * G * 2H +
    its index."""
    with device_guard(flt.device):
        return bind_walk_pairs(planes, flt, shadow, alive, B=B, GB=GB, jb=jb,
                               rank=rank, use_ori=use_ori,
                               full=full).launch()


def bind_walk_pairs(planes: WalkPlanes, flt: torch.Tensor,
                    shadow: torch.Tensor, alive: torch.Tensor, *, B: int,
                    GB: int, jb: int, rank: int, use_ori: bool,
                    full: bool = False) -> Bound:
    """walk_pairs' check and launch: launch() -> its outputs from the
    state these planes hold at the call; the outputs are out (seg a view
    of the launch's scratch)."""
    dev = flt.device
    G, H = flt.shape
    S = alive.shape[0]
    _check([(n, t, dt, (G, H)) for n, t, dt in zip(
        WalkPlanes._fields, planes, WALK_TYPES)]
        + [("flt", flt, U8, (G, H)), ("shadow", shadow, U8, (G, H)),
           ("alive", alive, BOOL, (S,))], dev)
    if not (B >= 1 and GB >= 1 and jb >= 0 and 2 * B + GB + jb <= 62
            and S >= 1 and rank >= 0):
        raise ValueError("walk_pairs: B %d GB %d jb %d S %d rank %d"
                         % (B, GB, jb, S, rank))
    kw = dict(B=B, GB=GB, jb=jb, rank=rank, use_ori=use_ori, full=full)
    new = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
    keys, s12 = new((G, 2 * H), I64), new((G, 2 * H), I32)
    pair_ok, nxt = new((G, H), BOOL), new((G, H), I32)
    stats = tuple(new((G, 2 * H), I32) for _ in range(2 if full else 0))
    if not _on_cuda(dev, "walk_pairs"):
        out = (keys, s12, pair_ok, nxt, new((2, S), I32)) + stats

        def plain():
            _plain("walk_pairs")
            for t, o in zip(out, walk_pairs_plain(planes, flt, shadow, alive,
                                                  **kw)):
                t.copy_(o)
            return out
        return Bound(plain, out)
    lib = _round_lib()
    # the segment counters first, then the genome bits and the scan's
    # status words
    scratch = new((lib.pg_walk_pairs_scratch(G, H, S) + 3) // 4, I32)
    out = (keys, s12, pair_ok, nxt, scratch[:2 * S].view(2, S)) + stats
    fn = lib.pg_walk_pairs
    args = (*[t.data_ptr() for t in planes], flt.data_ptr(),
            shadow.data_ptr(), alive.data_ptr(), G, H, S, B, GB, jb, rank,
            int(bool(use_ori)), keys.data_ptr(), s12.data_ptr(),
            pair_ok.data_ptr(), nxt.data_ptr(), scratch.data_ptr(),
            *([t.data_ptr() for t in stats] or [None] * 2), _stream(dev))

    def launch():
        _launch("walk_pairs", fn, *args)
        return out
    return Bound(launch, out)


def walk_pairs_plain(planes: WalkPlanes, flt, shadow, alive, *, B: int,
                     GB: int, jb: int, rank: int, use_ori: bool,
                     full: bool = False):
    """Plain PyTorch version of walk_pairs: the running maximum by cummax,
    the pair planes by gathers at the previous row, nxt by a scatter, the
    segment counters through a [G, S] count plane."""
    p = planes
    dev = flt.device
    G, H = flt.shape
    S = alive.shape[0]
    kept = torch.gather((flt == 0) & (shadow == 0), 1, p.ordcm.long()) \
        & p.valid
    iotaH = torch.arange(H, dtype=I32, device=dev)
    run = torch.cummax(torch.where(kept, iotaH[None, :], -1), dim=1).values
    prev = torch.cat([run.new_full((G, 1), -1), run[:, :-1]], dim=1)
    prevc = prev.clamp(0, H - 1).long()
    take = lambda a: torch.gather(a, 1, prevc)
    pair_ok = kept & (prev >= 0) & (take(p.cid) == p.cid)
    v, w = take(p.w), p.w
    dom_alive = (p.dom_gid >= 0) & (p.dom_sid >= 0) \
        & alive[p.dom_sid.clamp(0, S - 1).long()]
    use = (p.score_ori > p.score_dom) | (p.dom_gid < 0) | dom_alive
    sc = p.score_ori if use_ori else torch.where(use, p.score_ori,
                                                 p.score_dom)
    s1, s2 = take(sc), sc
    keys = torch.cat([(v << B) | w, ((w ^ 1) << B) | (v ^ 1)], dim=1)
    keys = (keys << GB) | (rank * G + torch.arange(
        G, dtype=I64, device=dev))[:, None]
    if jb:
        keys = (keys << jb) | (rank * G * 2 * H + torch.arange(
            G * 2 * H, dtype=I64, device=dev).reshape(G, 2 * H))
    keys = torch.where(torch.cat([pair_ok, pair_ok], dim=1), keys, KSENT_I)
    nxt = torch.full((G, H + 1), -1, dtype=I32, device=dev).scatter_(
        1, torch.where(kept & (prev >= 0), prev, H).long(),
        iotaH.repeat(G, 1))[:, :H].contiguous()
    cnts = torch.zeros((G, S), dtype=I32, device=dev).scatter_add_(
        1, p.seg.long(), kept.to(I32))
    seg = torch.stack([cnts.sum(0, dtype=I32), (cnts > 0).sum(0, dtype=I32)])
    out = (keys, torch.cat([s1, s2], dim=1), pair_ok, nxt, seg)
    if not full:
        return out
    dist = (p.cm - take(p.cm)).to(I32)     # the int32 truncation
    return out + (torch.cat([s2, s1], dim=1), torch.cat([dist, dist], dim=1))


def branch_prep(flt, shadow, valid, gid, cid, cm, arc_vw, seg_gid, *,
                n_gene: int, B: int):
    """branch_block's representative planes and targets from the round
    state (flt, shadow uint8, valid bool, gid, cid int32, cm int64, [G, H]
    in cs order), the v-sorted arc table (arc_vw int64 [A], valid arcs
    first) and each segment's gene (seg_gid int64 [S]): (r_pres bool,
    r_cid int32, r_cm int64, r_rank int32), gene-major [n_gene, G], of each
    gene's last kept hit in a genome (its kept rank: kept rows before it;
    row 0's cid, cm and rank where the gene has none), and tgt_gid int64
    [A] (each arc's target gene, clamped into [0, n_gene))."""
    with device_guard(flt.device):
        return bind_branch_prep(flt, shadow, valid, gid, cid, cm, arc_vw,
                                seg_gid, n_gene=n_gene, B=B).launch(arc_vw)


def bind_branch_prep(flt, shadow, valid, gid, cid, cm, arc_vw, seg_gid, *,
                     n_gene: int, B: int) -> Bound:
    """branch_prep's check and launch: launch(arc_vw) -> its outputs from
    the state these planes hold at the call and that arc table (shaped as
    the one checked here); the outputs are out."""
    dev = flt.device
    G, H = flt.shape
    A, S = arc_vw.shape[0], seg_gid.shape[0]
    _check([("flt", flt, U8, (G, H)), ("shadow", shadow, U8, (G, H)),
            ("valid", valid, BOOL, (G, H)), ("gid", gid, I32, (G, H)),
            ("cid", cid, I32, (G, H)), ("cm", cm, I64, (G, H)),
            ("arc_vw", arc_vw, I64, (A,)), ("seg_gid", seg_gid, I64, (S,))],
           dev)
    if min(H, A, S, n_gene) < 1 or not 1 <= B < 62:
        raise ValueError("branch_prep: H %d A %d S %d n_gene %d B %d"
                         % (H, A, S, n_gene, B))
    new = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
    out = (new((n_gene, G), BOOL), new((n_gene, G), I32),
           new((n_gene, G), I64), new((n_gene, G), I32), new(A, I64))
    if not _on_cuda(dev, "branch_prep"):
        def plain(arc_vw):
            _plain("branch_prep")
            for t, o in zip(out, branch_prep_plain(
                    flt, shadow, valid, gid, cid, cm, arc_vw, seg_gid,
                    n_gene=n_gene, B=B)):
                t.copy_(o)
            return out
        return Bound(plain, out)
    lib = _round_lib()
    scratch = new(lib.pg_branch_prep_scratch(G, H, n_gene), U8)
    fn = lib.pg_branch_prep
    planes = (flt.data_ptr(), shadow.data_ptr(), valid.data_ptr(),
              gid.data_ptr(), cid.data_ptr(), cm.data_ptr(), G, H, n_gene)
    rest = (A, seg_gid.data_ptr(), S, B, *[t.data_ptr() for t in out])
    stream = _stream(dev)

    def launch(arc_vw):
        _launch("branch_prep", fn, *planes, arc_vw.data_ptr(), *rest,
                scratch.data_ptr(), stream)
        return out
    return Bound(launch, out)


def branch_prep_plain(flt, shadow, valid, gid, cid, cm, arc_vw, seg_gid, *,
                      n_gene: int, B: int):
    """Plain PyTorch version of branch_prep: the last kept hit by a scatter
    maximum, the planes by gathers."""
    dev = flt.device
    G, H = flt.shape
    S = seg_gid.shape[0]
    tgt_gid = seg_gid[((arc_vw & ((1 << B) - 1)) >> 1).clamp(0, S - 1)] \
        .clamp(0, n_gene - 1)
    keptc = (flt == 0) & (shadow == 0) & valid
    krank = torch.cumsum(keptc, dim=1, dtype=I32) - 1
    pos = torch.where(keptc, torch.arange(H, dtype=I32, device=dev)[None, :],
                      -1)
    last = torch.full((n_gene, G), -1, dtype=I32, device=dev) \
        .scatter_reduce_(0, gid.clamp(0, n_gene - 1).long().t(), pos.t(),
                         "amax", include_self=True)
    lastc = last.clamp(0, H - 1).long()
    iotaG = torch.arange(G, dtype=I64, device=dev)[None, :]
    return (last >= 0, cid[iotaG, lastc], cm[iotaG, lastc],
            krank[iotaG, lastc], tgt_gid)


def round_scratch(device, S: int = 1) -> torch.Tensor:
    """The zeroed scratch of prop_round and occ_round on `device` (int64,
    its size from pg_round_scratch) for up to S segments: their blocks'
    counts and tickets, and occ_round's alive bits. Every call that
    completes leaves its counters zeroed, so one serves every call on one
    stream (the loop allocates one a schedule); calls on two streams at
    once need one each."""
    return torch.zeros(int(_round_lib().pg_round_scratch(max(int(S), 1)))
                       // 8, dtype=I64, device=device)


def _launch_round(name, fn, scratch, *args) -> None:
    """_launch of a kernel that counts through `scratch`; after a failed
    launch the scratch is zeroed again (a launch that did not complete
    leaves it dirty), then the error is raised."""
    try:
        _launch(name, fn, *args)
    except RuntimeError:
        scratch.zero_()
        raise


def _round_scratch(scratch, dev, S: int = 1) -> torch.Tensor:
    """`scratch`, checked to be a round_scratch for S segments on `dev`,
    or a new one when None."""
    if scratch is None:
        return round_scratch(dev, S)
    n = int(_round_lib().pg_round_scratch(max(int(S), 1))) // 8
    if scratch.dtype != I64 or scratch.device != dev or scratch.dim() != 1 \
            or not scratch.is_contiguous() or scratch.numel() < n:
        raise ValueError("scratch must be a contiguous int64 tensor of at "
                         "least %d on %s (round_scratch(device, %d)), got "
                         "%s %s on %s" % (n, dev, S, scratch.dtype,
                                          tuple(scratch.shape),
                                          scratch.device))
    return scratch


def prop_round(weak, flt, valid, ordcm, pair_arc, nxt, pair_ok, arc_weak,
               word, *, propagate: bool,
               scratch: Optional[torch.Tensor] = None) -> None:
    """Weak propagation (branch.c:108-145) and the weak == 2 filter, in
    place on weak and flt (uint8 [G, H], cs order). When `propagate`: each
    cm position i takes the larger of its pair's reverse mark (arc_weak at
    pair_arc[g, H + i], when pair_ok[i]) and the forward mark of the pair
    whose previous row it is (at pair_arc[g, j], j = nxt[i], when
    pair_ok[j]), and its cs row ordcm[i] keeps the larger of that and its
    weak. Then every row with weak 2 is filtered. word (int64 [2]) is set
    to (rows with weak != 0 that are valid, 1 if a value changed else 0).
    ordcm, nxt (int32), pair_ok (bool) [G, H] and pair_arc (int32 [G, 2H])
    are walk_pairs' pair state and merge_fold's pair plane; arc_weak is
    uint8 [A]. On cuda `scratch` is a round_scratch (a new one when None)."""
    with device_guard(weak.device):
        bind_prop_round(weak, flt, valid, ordcm, pair_arc, nxt, pair_ok,
                        arc_weak, word, scratch=scratch).launch(
            pair_arc, nxt, pair_ok, arc_weak, word, propagate)


def bind_prop_round(weak, flt, valid, ordcm, pair_arc, nxt, pair_ok,
                    arc_weak, word, *,
                    scratch: Optional[torch.Tensor] = None) -> Bound:
    """prop_round's check and launch: launch(pair_arc, nxt, pair_ok,
    arc_weak, word, propagate) on weak, flt, valid and ordcm as they are at
    the call, the rest shaped as the ones checked here (word: a view will
    do)."""
    dev = weak.device
    G, H = weak.shape
    A = arc_weak.shape[0]
    _check([("weak", weak, U8, (G, H)), ("flt", flt, U8, (G, H)),
            ("valid", valid, BOOL, (G, H)), ("ordcm", ordcm, I32, (G, H)),
            ("pair_arc", pair_arc, I32, (G, 2 * H)),
            ("nxt", nxt, I32, (G, H)), ("pair_ok", pair_ok, BOOL, (G, H)),
            ("arc_weak", arc_weak, U8, (A,)), ("word", word, I64, (2,))],
           dev)

    def empty_table(propagate):
        if propagate and A < 1:
            raise ValueError("prop_round: an empty arc table")
    if not _on_cuda(dev, "prop_round"):
        def plain(pair_arc, nxt, pair_ok, arc_weak, word, propagate):
            empty_table(propagate)
            _plain("prop_round")
            prop_round_plain(weak, flt, valid, ordcm, pair_arc, nxt,
                             pair_ok, arc_weak, word, propagate=propagate)
        return Bound(plain)
    scratch = _round_scratch(scratch, dev)
    fn = _round_lib().pg_prop_round
    planes = (weak.data_ptr(), flt.data_ptr(), valid.data_ptr(), G, H)
    sc, stream = scratch.data_ptr(), _stream(dev)
    o = ordcm.data_ptr()

    def launch(pair_arc, nxt, pair_ok, arc_weak, word, propagate):
        empty_table(propagate)
        _launch_round("prop_round", fn, scratch, *planes,
                      int(bool(propagate)), o, pair_arc.data_ptr(),
                      nxt.data_ptr(), pair_ok.data_ptr(),
                      arc_weak.data_ptr(), A, word.data_ptr(), sc, stream)
    return Bound(launch)


def prop_round_plain(weak, flt, valid, ordcm, pair_arc, nxt, pair_ok,
                     arc_weak, word, *, propagate: bool) -> None:
    """Plain PyTorch version of prop_round, in gather form: the marks by
    gathers at the pair rows, scattered to the cs rows through ordcm (a
    permutation: each row once)."""
    weak0 = weak.clone()
    if propagate:
        H = weak.shape[1]
        A = arc_weak.shape[0]
        aw = arc_weak.to(I32)
        rows = pair_arc.long().clamp(0, A - 1)
        fwd = torch.where(pair_ok, aw[rows[:, :H]], 0)
        rev = torch.where(pair_ok, aw[rows[:, H:]], 0)
        nx = nxt.long()
        nxt_fwd = torch.where(nx >= 0,
                              torch.gather(fwd, 1, nx.clamp(0, H - 1)), 0)
        o = ordcm.long()
        mark = torch.maximum(torch.maximum(rev, nxt_fwd),
                             torch.gather(weak, 1, o).to(I32))
        weak.scatter_(1, o, mark.to(U8))
    hit = (weak == 2) & (flt == 0)
    changed = (weak != weak0).any() | hit.any()
    flt.masked_fill_(hit, 1)
    word.copy_(torch.stack([((weak != 0) & valid).sum(), changed.to(I64)]))


def occ_round(alive, flt, valid, gid, sid_of, arc_vw, seg_tot, loci, logs,
              dcap_mask, dcap_deg, dcap_loci, dcap_tot, word, *, r: int,
              B: int, n_grp: Optional[torch.Tensor] = None,
              cuts: Optional[Tuple[int, int, int]] = None,
              scratch: Optional[torch.Tensor] = None) -> None:
    """The occ block of round r (graph.c:237-263) with its #del capture, in
    place. Given n_grp (int32 [A], a branch round), first loci (int32
    [S, 2]) = n_grp summed by each arc's source vertex (segment, strand).
    Given cuts = (occ_cut, deg_cut, loci_cut), an alive segment (alive
    bool [S]) is deleted when its seg_tot (int32 [S]) exceeds occ_cut, a
    strand's out-degree (valid arcs of the v-sorted arc_vw, int64 [A])
    exceeds deg_cut, or its larger loci exceeds loci_cut; then the valid
    hits (flt uint8, valid bool, gid int32 [G, H]) whose gene's segment
    (sid_of int32 [n_gene]) is absent or dead are filtered. Writes
    logs[r, 3:7] (int64 [R, 10]: the three deletion counts, each not
    counted before, and the alive segments) and the capture rows
    dcap_mask[r] (uint8 [R, S]: deleted), dcap_deg[r] (int32 [R, S, 2]:
    the degrees, 0 without cuts), dcap_loci[r] (loci) and dcap_tot[r]
    (seg_tot); sets word[1] (int64 [2]) to 1 when alive or flt changed.
    The arc table is the loop's: v-sorted, its valid arcs first, each
    valid arc's v < 2S, n_grp non-zero only at a vertex's first arc (the
    kernel reads degrees and loci off the runs). On cuda `scratch` is a
    round_scratch for S segments (a new one when None)."""
    with device_guard(alive.device):
        bind_occ_round(alive, flt, valid, gid, sid_of, arc_vw, seg_tot,
                       loci, logs, dcap_mask, dcap_deg, dcap_loci, dcap_tot,
                       word, B=B, n_grp=n_grp, scratch=scratch).launch(
            arc_vw, seg_tot, word, r, n_grp, cuts)


def bind_occ_round(alive, flt, valid, gid, sid_of, arc_vw, seg_tot, loci,
                   logs, dcap_mask, dcap_deg, dcap_loci, dcap_tot, word, *,
                   B: int, n_grp: Optional[torch.Tensor] = None,
                   scratch: Optional[torch.Tensor] = None) -> Bound:
    """occ_round's check and launch: launch(arc_vw, seg_tot, word, r,
    n_grp, cuts) on the other planes as they are at the call, arc_vw,
    seg_tot and word shaped as the ones checked here (word: a view will
    do), n_grp None or as the one checked here."""
    dev = alive.device
    G, H = flt.shape
    S, A, R = alive.shape[0], arc_vw.shape[0], logs.shape[0]
    ng = sid_of.shape[0]
    _check([("alive", alive, BOOL, (S,)), ("flt", flt, U8, (G, H)),
            ("valid", valid, BOOL, (G, H)), ("gid", gid, I32, (G, H)),
            ("sid_of", sid_of, I32, (ng,)), ("arc_vw", arc_vw, I64, (A,)),
            ("seg_tot", seg_tot, I32, (S,)), ("loci", loci, I32, (S, 2)),
            ("logs", logs, I64, (R, 10)),
            ("dcap_mask", dcap_mask, U8, (R, S)),
            ("dcap_deg", dcap_deg, I32, (R, S, 2)),
            ("dcap_loci", dcap_loci, I32, (R, S, 2)),
            ("dcap_tot", dcap_tot, I32, (R, S)), ("word", word, I64, (2,))]
           + ([("n_grp", n_grp, I32, (A,))] if n_grp is not None else []),
           dev)
    if not (S >= 1 and A >= 1 and ng >= 1 and 1 <= B < 62):
        raise ValueError("occ_round: R %d S %d A %d n_gene %d B %d"
                         % (R, S, A, ng, B))

    def round_of(r):
        if not 0 <= r < R:
            raise ValueError("occ_round: r %d R %d" % (r, R))
    if not _on_cuda(dev, "occ_round"):
        def plain(arc_vw, seg_tot, word, r, n_grp, cuts):
            round_of(r)
            _plain("occ_round")
            occ_round_plain(alive, flt, valid, gid, sid_of, arc_vw, seg_tot,
                            loci, logs, dcap_mask, dcap_deg, dcap_loci,
                            dcap_tot, word, r=r, B=B, n_grp=n_grp, cuts=cuts)
        return Bound(plain)
    scratch = _round_scratch(scratch, dev, S)
    fn = _round_lib().pg_occ_round
    head = (alive.data_ptr(), flt.data_ptr(), valid.data_ptr(),
            gid.data_ptr(), sid_of.data_ptr(), ng, G * H)
    lo, dm, dd, dl, dt = (t.data_ptr() for t in (
        logs, dcap_mask, dcap_deg, dcap_loci, dcap_tot))
    lp, sc, stream = loci.data_ptr(), scratch.data_ptr(), _stream(dev)

    def launch(arc_vw, seg_tot, word, r, n_grp, cuts):
        round_of(r)
        occ_cut, deg_cut, loci_cut = cuts if cuts is not None else (0, 0, 0)
        _launch_round("occ_round", fn, scratch, *head, arc_vw.data_ptr(), A,
                      B, S, seg_tot.data_ptr(), lp,
                      None if n_grp is None else n_grp.data_ptr(),
                      int(cuts is not None), _clip(occ_cut),
                      max(min(int(deg_cut), 2**31 - 1), -2**31),
                      max(min(int(loci_cut), 2**31 - 1), -2**31),
                      lo + 8 * (10 * r + 3), dm + r * S, dd + 8 * r * S,
                      dl + 8 * r * S, dt + 4 * r * S, word.data_ptr(), sc,
                      stream)
    return Bound(launch)


def occ_round_plain(alive, flt, valid, gid, sid_of, arc_vw, seg_tot, loci,
                    logs, dcap_mask, dcap_deg, dcap_loci, dcap_tot, word, *,
                    r: int, B: int, n_grp: Optional[torch.Tensor] = None,
                    cuts: Optional[Tuple[int, int, int]] = None) -> None:
    """Plain PyTorch version of occ_round: segment sums over the arcs' head
    flags, the deletion masks, the dead genes' hits by a gather through
    sid_of."""
    dev = alive.device
    S = alive.shape[0]
    ng = sid_of.shape[0]
    v_a = arc_vw >> B
    if n_grp is not None:
        slot = (v_a >> 1).clamp(0, S - 1) * 2 + (v_a & 1)
        loci.copy_(seg_sum(n_grp, slot, 2 * S).reshape(S, 2))
    if cuts is None:
        counts = [torch.zeros((), dtype=I64, device=dev)] * 3
        newdel = torch.zeros(S, dtype=BOOL, device=dev)
        deg_v = torch.zeros(2 * S, dtype=I32, device=dev)
        changed = newdel.any()
    else:
        occ_cut, deg_cut, loci_cut = (int(c) for c in cuts)
        _, _, g_new, _, n_in_g = arc_heads(arc_vw, B)
        occ_del = alive & (seg_tot.to(I64) > occ_cut)
        vc = v_a.clamp(0, 2 * S - 1)
        deg_v = seg_sum(torch.where(g_new, n_in_g, 0), vc, 2 * S)
        degd = seg_sum((g_new & (n_in_g > deg_cut)).to(I32), vc >> 1, S) > 0
        degd &= alive
        locid = alive & (loci.max(dim=1).values > loci_cut)
        counts = [occ_del.sum(), (degd & ~occ_del).sum(),
                  (locid & ~degd & ~occ_del).sum()]
        newdel = occ_del | degd | locid
        alive &= ~newdel
        # hits of dead genes leave the walk (PG_SET_FILTER(vtx==0))
        sid_h = sid_of[gid.clamp(0, ng - 1).long()]
        dead = (sid_h < 0) | ~alive[sid_h.clamp(0, S - 1).long()]
        hit = dead & valid & (flt == 0)
        flt.masked_fill_(hit, 1)
        changed = newdel.any() | hit.any()
    logs[r, 3:7] = torch.stack(counts + [alive.sum()])
    dcap_mask[r] = newdel.to(U8)
    dcap_deg[r] = deg_v.reshape(S, 2)
    dcap_loci[r] = loci
    dcap_tot[r] = seg_tot
    word[1] = torch.maximum(word[1], changed.to(I64))
