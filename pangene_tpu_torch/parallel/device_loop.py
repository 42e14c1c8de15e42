"""Device-resident graph-round schedule: phases 2+3 of pg_graph_gen
(reference graph.c:280-322) on the genome mesh.

The counterpart of pangene_tpu/parallel/device_loop.py. After
the host runs phase 1 (which also settles the physical sort order into its
steady cycle), the remaining (1 + n_branch_flt) rounds run on the device
from one upload to one pull: branch marking (branch.c:48-106), weak
propagation (branch.c:108-145), weak/vertex filtering, the annealed
high-occurrence filter (graph.c:237-263), the shadow sweep (overlap.c:
101-156) and arc regeneration with the two-level exact-integer merge
(graph.c:87-177). The per-hit columns stay on the device; between rounds
only flt, weak, shadow, pid_dom, alive and the arc table change.

The rounds are a Python loop over hand-written CUDA kernels (on the CPU
their plain versions): the shadow sweep of all genomes is one launch a
round (sweep_kernel.sweep_round_loop, its epilogue fused: the stale-flag
merge into shadow and the dominators into pid_dom, in place);
the branch block is branch_prep then branch_block (at world > 1
branch_locality and branch_classify), weak propagation prop_round, the occ
block with the convergence count occ_round, the merge walk_pairs, then
torch.sort, then merge_fold (ops/loop_kernels.py). The round state (flt,
weak, alive, the loci and the logs) is updated in place. One value a round
is read on the host (counted in LAST["host_syncs"]): whether the round
changed anything, which gives the convergence skip.

On a mesh of several ranks (parallel/mesh.py) each rank holds G_loc of the
Gp padded genomes; the arc table, the segment state and the round's
counters are replicated, and collectives join the ranks where the JAX
schedule has lax.psum / all_gather / all_to_all: the segment counters, the
merge's keys (gathered, or at more than two ranks exchanged by v-range: the
bucket exchange), the branch block's locality bits and the round's change
bit. A value read on the host decides a branch of the Python loop, so it
must be the same on every rank, or one rank would enter a collective that
another skips: the change bit is summed over the ranks before it is read;
the overflow flag is reduced once more at the end, so a fallback by one rank
is a fallback by all.

Bit-exactness:
  * Every in-loop IEEE-double expression of the reference is rounded as
    the reference rounds it: the merged s1/s2/dist averages
    ``(int)((double)S/n + .499)`` (graph.c:141,170-172) and the branch
    deficit ``1.0 - (double)s1/max`` compared against -b/-y/-B
    (branch.c:72-78). On cuda they are IEEE double inside the block
    kernels (branch_block / branch_classify and merge_fold,
    csrc/loop_blocks.cu); the kernels' plain versions (ops/loop_kernels.py)
    emulate them exactly in integers with ops/softfloat. The sweep's
    coverage gate is IEEE division in the kernel and softfloat in its plain
    version.
  * Physical hit order: the reference re-sorts every genome cm->cs each
    round; once that round trip is a cycle (ops/sort.py), the cs order is
    a fixed point and the cm order is a fixed gather view, both verified
    on the host before entry (fallback to the host rounds otherwise).
  * Kept-row compaction: only flt==0 rows are uploaded (flt is monotone and
    the reference skips flt rows on both sides of every evaluation).
    Dropped rows keep their entry flt/shadow/weak_br/pid_dom on the host
    (the stale-flag quirks); the reference's "hit 0 is never evaluated"
    rule rides the ev1 plane (original index >= 1), not the compacted row
    index.
  * Segment deletion keeps original seg ids behind an alive mask; the
    reference's hard compaction (graph.c:219-235) is order-preserving, so
    arc keys group and sort identically; ids are compacted once on the
    host after the loop.
  * The arc table's capacity is the one capacity of the rounds: a merge
    with more arcs than it sets a flag and the host falls back to the
    reference-exact host rounds. The branch block tests every pair of a
    group of any size (the JAX package's window of D arcs is not ported).
  * Every reduction is over integers (sums, maxima), so the order in which
    a device adds them cannot change a bit.
"""
from __future__ import annotations

import os
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..options import PgOpt
from ..ops import device as dev
from ..ops import loop_kernels as lk
from ..ops import mesh_kernels as mk
from ..ops import sweep_kernel as sk
from ..ops.loop_kernels import SENT_I
from .. import util
from ..util import log_msg
from . import mesh as M

I64 = torch.int64
I32 = torch.int32
_BIAS = -(1 << 63)                       # uint64 -> biased int64 (xor)

# upload layout, the JAX package's: the per-hit columns ship as five stacked
# blocks [n_col, G, H]. Coordinates (cs/ce/cm) ship as int32 whenever every
# value fits; on the device they are widened to int64 once (the CUDA sweep
# picks int32 arithmetic itself where it is safe).
PACK_I32 = ("cid", "rank", "gid", "dom_gid", "score_ori", "score_dom",
            "cds_len", "n_exon", "off_exon", "pid", "pid_dom", "ordcm")
PACK_C = ("cs", "ce", "cm")      # int32 or int64 (coord32)
# ev1: original hit index >= 1. The reference's "hit 0 is never the
# evaluated side of a shadow pair" rule (overlap.c:101 loop from i=1) must
# survive kept-row compaction, where the first kept row may not be the
# genome's original row 0
PACK_U8 = ("flt", "shadow", "weak_br", "valid", "rev", "ev1")

BLOCKS = ("branch", "prop", "occ", "sweep", "walk_merge")


class Cfg(NamedTuple):
    """Static configuration of the device schedule (the JAX package's Cfg
    less its columnsort switches and its branch window D, which are not
    ported)."""
    H: int          # hit capacity per genome
    K: int          # exon capacity per hit
    W: int          # sweep band width
    S: int          # segment count at entry (original ids)
    A: int          # merged arc-table capacity
    B: int          # bits of a packed vertex (sid<<1|rev < 2^B)
    GB: int         # bits of a genome index
    JB: int         # bits of a global pair-row index packed into the lean
                    # sort key (0 = disabled: 2B+GB+JB would exceed 62)
    n_gene: int
    R: int          # device rounds: 1 (phase 2) + n_branch_flt
    G_loc: int      # genomes per rank
    coord32: bool   # cs/ce/cm uploaded as int32
    check_strand: bool
    use_ori: bool
    frag_mode: bool
    min_ov_ratio: float
    branch_diff: float
    branch_diff_dist: float
    branch_diff_cut: float
    local_dist: int
    local_count: int
    # more than two ranks only: the per-round merge as a bucket exchange
    # (keys partitioned by out-vertex range) in place of the replicated
    # all_gather and full sort; 0 = off. The per-(source, destination)
    # all_to_all chunk capacity; a count above it sets the overflow flag
    a2a_cap: int


def cfg_from(other) -> Cfg:
    """Cfg from any object with the same attributes (a JAX-package Cfg)."""
    return Cfg(**{f: getattr(other, f) for f in Cfg._fields})


def _steady_cm_views(d):
    """Per genome: the cm-order index vector IF the cm->cs round trip from
    the current physical order is a cycle (no mutation); None otherwise."""
    views = []
    for g in d.genomes:
        h = g.hits
        n = len(h)
        if n == 0:
            views.append(np.zeros(0, np.int64))
            continue
        cid = np.asarray(h.cid)
        perm_cm = np.lexsort((np.asarray(h.cm), cid))
        back = np.lexsort((np.asarray(h.cs)[perm_cm], cid[perm_cm]))
        if not np.array_equal(perm_cm[back], np.arange(n)):
            return None
        views.append(perm_cm.astype(np.int64))
    return views


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def schedule(blk_i32, blk_c, blk_ps, blk_u8, blk_ex, seg_gid, sid_of,
             arc0_vw, arc0_s1, seg_tot0, seg_ng0, occ_cut, deg_cut, loci_cut,
             do_branch, do_occ, do_sweep, do_walk, no_skip, *, cfg: Cfg,
             device=None, mesh: Optional[M.Mesh] = None):
    """The round schedule on numpy inputs, exactly those of the JAX
    package's _schedule (the five packed blocks [n_col, Gp, ...], blk_ps as
    the int64 view of the raw uint64 scores; the segment and arc tables of
    phase 1; the per-round cuts and block switches), returning its 20
    outputs as numpy arrays: flt, weak, shadow, pid_dom [Gp, H]; alive,
    seg_tot, seg_ng [S]; arc_vw, arc_s1, arc_ng, arc_tot, arc_ad, arc_s2
    [A]; loci [S, 2]; logs [R, 10]; the four #del capture planes; overflow.
    On `device`, or over the ranks of `mesh` (each takes its genomes of the
    blocks; every rank returns the whole result)."""
    mesh = mesh or M.local(torch.device(device))
    t = lambda a: torch.from_numpy(np.array(a)).to(mesh.device)   # a copy
    blocks = [M.put_sharded(np.array(b), mesh, 1) for b in (
        blk_i32, blk_c, np.asarray(blk_ps).view(np.int64), blk_u8, blk_ex)]
    outs = schedule_device(
        *blocks, t(seg_gid), t(sid_of), t(arc0_vw), t(arc0_s1),
        t(seg_tot0), t(seg_ng0), np.asarray(occ_cut), np.asarray(deg_cut),
        np.asarray(loci_cut), np.asarray(do_branch), np.asarray(do_occ),
        np.asarray(do_sweep), np.asarray(do_walk), bool(no_skip), cfg=cfg,
        mesh=mesh)
    return tuple(M.pull_global(o, mesh) if i < 4 else o.cpu().numpy()
                 for i, o in enumerate(outs))


def unpack_blocks(blk_i32, blk_c, blk_ps, blk_u8, blk_ex):
    """The packed blocks on their device as named [G, H] columns (cs/ce/cm
    widened to int64), and the sweep's static columns in the kernel's types
    and layout (the packed score biased to int64)."""
    cols = {n: blk_i32[i] for i, n in enumerate(PACK_I32)}
    cols.update({n: blk_c[i].to(I64) for i, n in enumerate(PACK_C)})
    cols.update({n: blk_u8[i] for i, n in enumerate(PACK_U8)})
    batch = dict(
        n_rows=(cols["valid"] != 0).sum(dim=1, dtype=I32),
        pscore=blk_ps[0] ^ _BIAS, exon_os=blk_ex[0], exon_oe=blk_ex[1],
        **{n: cols[n] for n in ("cid", "cs", "ce", "rev", "gid", "rank",
                                "cds_len", "off_exon", "n_exon")})
    return cols, sk.BatchCols(**{n: c.contiguous()
                                 for n, c in batch.items()})


def copy_args(x):
    """A copy of a call's tensor arguments, tuples of them included; a
    NamedTuple (the walk's round-invariant planes) is kept as it is."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return tuple(copy_args(v) for v in x)
    return x


def exchange_merge(keys: torch.Tensor, s1: torch.Tensor, *, cfg: Cfg,
                   mesh: M.Mesh, fold, scratch=None):
    """The in-loop merge at more than two ranks as a bucket exchange (JAX
    device_loop.py:301-409). Keys are monotone in the out-vertex v (their
    top bits), so cutting the key space into nd contiguous v-ranges keeps
    every out-group (vw) and in-group (vw, g) whole, and the ranks' sorted
    ranges concatenated are the global sort. Each rank sorts its NL keys
    (walk_pairs' lean form: the global slot in the low JB bits; s1 int32
    [NL] by slot), sends each destination's run (at most C = a2a_cap keys,
    with their s1) by all_to_all, sorts and folds the range it receives
    (`fold`: loop_kernels.merge_fold through the caller's capture), and
    writes its arcs into the replicated [A] table at its global offset (a
    sum over ranks of disjoint windows). Each pair slot's arc row goes back to its origin by a second
    all_to_all aligned with the send slots. A destination count above C
    sets the overflow flag (n_out = A + 1). The packing, the table window
    and reply, and the table's mask and the pair scatter are the three
    kernels of ops/mesh_kernels; around them only the two sorts, the fold
    and the four collectives, in the JAX order (all_to_all, all_gather,
    psum, all_to_all); the packing's run bounds go to the finish, which
    reads only the slots sent. `scratch`: exchange_pack's (a new one a call
    when None). Returns (arc_vw, arc_s1, n_out, pair_loc int32 [NL]: each
    slot's arc row)."""
    nd, rank = mesh.world, mesh.rank
    kps = torch.sort(keys.reshape(-1)).values
    sent, ovf, pair, bounds = mk.exchange_pack(
        kps, s1, nd=nd, cap=cfg.a2a_cap, jb=cfg.JB,
        shift=cfg.JB + cfg.GB + cfg.B, two_s=2 * cfg.S, rank=rank,
        scratch=scratch)
    got = M.all_to_all(sent, mesh)                        # [nd, 2, C]
    got_k = got[:, 0].reshape(-1)
    rk, rpos = torch.sort(got_k, stable=True)
    # the received range's arcs in rows [0, n_out_l), each received
    # slot's local out-group row in `reply_loc`
    vw_f, s1_loc, n_out_l, reply_loc = fold(
        rk, got[:, 1].to(I32).reshape(-1), jb=cfg.JB, gb=cfg.GB,
        cap=got_k.shape[0], perm=rpos)
    per_rank = M.all_gather(torch.stack([n_out_l, ovf]), mesh)
    table, reply, n_out = mk.exchange_window(
        per_rank, vw_f, s1_loc, reply_loc, got_k, rank=rank, A=cfg.A)
    table = M.psum(table, mesh)
    reply = M.all_to_all(reply, mesh)                     # [nd * C]
    arc_vw, arc_s1, pair_loc = mk.exchange_finish(
        table, n_out, sent, reply, pair, bounds, jb=cfg.JB, rank=rank)
    return arc_vw, arc_s1, n_out, pair_loc


def schedule_device(blk_i32, blk_c, blk_ps, blk_u8, blk_ex, seg_gid, sid_of,
                    arc0_vw, arc0_s1, seg_tot0, seg_ng0, occ_cut, deg_cut,
                    loci_cut, do_branch, do_occ, do_sweep, do_walk, no_skip,
                    *, cfg: Cfg, stats: Optional[dict] = None,
                    mesh: Optional[M.Mesh] = None,
                    capture: Optional[dict] = None):
    """schedule() on tensors that already lie on the device, the five blocks
    holding this rank's genomes of `mesh` (the per-round cuts and switches
    stay host arrays); returns device tensors, the first four of them this
    rank's genomes. `stats`, when given, receives host_syncs, block_ms,
    sweep_launches and loop_launches (the launches of each kernel of
    ops/loop_kernels), launch_checks (the kernels' argument checks: the
    launch plan's, once a schedule, and the checked wrappers' calls),
    bound_launches (the launches issued through the plan), the branch
    kernels' tally read once after the closing synchronise
    (branch_valid_arcs and branch_branching_arcs summed over the branch
    launches, branch_wide_groups: the groups of more than
    loop_kernels.WIDE_ROWS members, which took the kernel's wide path,
    summed too, and branch_max_group: the widest branching group), and
    from the schedule's spans (util.Tracer, on only then) host_ms (the
    host's milliseconds in each block's code, its reads included, by
    block, the full=True tail as walk_merge_full), sync_wait_ms (blocked
    on the device: the host reads and, on cuda, the closing synchronise)
    and driver_ms (the rest of the schedule span: the driver's Python,
    dispatch, launches and event records). `capture`,
    when given, receives a copy of the arguments of the first call of each
    of those kernels, by name (the round state is updated in place):
    prop_round's first call that propagates, occ_round's first with the
    loci and the cuts (its first other one under "occ_round_partial"), and
    the full=True tail's calls under "walk_pairs_full" and
    "merge_fold_full"; the round kernels' scratch and the branch tally are
    not kept (a caller passes its own).

    The launch plan: before round 0 each kernel that a round launches is
    bound (ops/loop_kernels bind_<name>, ops/sweep_kernel
    bind_sweep_round_loop): its arguments checked, its outputs allocated,
    its library symbol, stream and pointers read, once; a round passes
    only what changes (the arc table of the last merge, the round's rows,
    the cuts). The schedule runs with its device current (one guard), as
    the bound launches need. Each binding's outputs are planes of this
    call, written anew by every launch of it, so a value carried past a
    round (the marks, n_grp, the walk's pair planes, the arc table) is
    read before the next launch of its kernel writes it again; the
    per-round counts and arc counts go to rows of their own. Nothing bound
    outlives the call. At world > 1 the branch block's locality and
    classification and the bucket exchange stay on the checked
    wrappers."""
    with lk.device_guard(blk_i32.device):
        return _schedule(
            blk_i32, blk_c, blk_ps, blk_u8, blk_ex, seg_gid, sid_of, arc0_vw,
            arc0_s1, seg_tot0, seg_ng0, occ_cut, deg_cut, loci_cut,
            do_branch, do_occ, do_sweep, do_walk, no_skip, cfg=cfg,
            stats=stats, mesh=mesh, capture=capture)


def _schedule(blk_i32, blk_c, blk_ps, blk_u8, blk_ex, seg_gid, sid_of,
              arc0_vw, arc0_s1, seg_tot0, seg_ng0, occ_cut, deg_cut, loci_cut,
              do_branch, do_occ, do_sweep, do_walk, no_skip, *, cfg: Cfg,
              stats: Optional[dict], mesh: Optional[M.Mesh],
              capture: Optional[dict]):
    """schedule_device's body, inside its device guard."""
    device = blk_i32.device
    mesh = mesh or M.local(device)
    nd, rank = mesh.world, mesh.rank
    cols, batch = unpack_blocks(blk_i32, blk_c, blk_ps, blk_u8, blk_ex)
    valid = cols["valid"] != 0
    G, H = valid.shape            # this rank's genomes
    S, A, B, GB = cfg.S, cfg.A, cfg.B, cfg.GB
    ng = cfg.n_gene
    NL = G * 2 * H                # this rank's merge keys
    ga = lambda x: M.all_gather(x.reshape(-1), mesh)
    sid_of = sid_of.to(I32)
    seg_gid = seg_gid.to(I64)
    # the schedule's spans: schedule > round > block > sync
    tr = util.Tracer(stats is not None, device)
    tr.begin("schedule")
    # the walk's round-invariant planes in cm order, once
    planes = lk.walk_planes(cols, cols.pop("ordcm"), sid_of, S)

    def keep(key, args, kw):
        """A copy of a call's arguments, the first under `key` (capture)."""
        if key not in capture:
            capture[key] = (copy_args(args), {
                k: v for k, v in kw.items() if k not in ("scratch", "tally")})

    def captured(fn, *args, key=None, **kw):
        if capture is not None:
            keep(key or fn.__name__, args, kw)
        return fn(*args, **kw)

    def host(x: torch.Tensor):
        """One read of a small tensor on the host (a synchronisation), the
        span "sync" (counted in host_syncs)."""
        with tr.span("sync"):
            return x.tolist()

    geo: dict = {}                # the plain sweep's round-invariant planes
    launches0 = sk.n_batched()["kernel"]
    loop0 = {k: c["kernel"] for k, c in lk.n_calls.items()}
    checks0 = lk.n_checks + sk.n_checks
    n_bound = 0

    def run(bound: lk.Bound, *args):
        """A launch through the plan (counted in bound_launches)."""
        nonlocal n_bound
        n_bound += 1
        return bound.launch(*args)

    fold: Optional[lk.Bound] = None   # the in-loop merge_fold, bound at
                                      # its first call (the sort's outputs)

    def walk_merge(r: int):
        """Walk + two-level merge (graph.c:87-177) from one global sort of
        (vw, genome) keys, gathered from every rank: walk_pairs builds the
        keys from the round state, the sort stays torch.sort, merge_fold
        folds. In the loop (round r) it computes only what the rounds
        consume (group structure + the exact s1 average) and records, per
        pair slot, the arc row its key landed in: the next round's weak
        propagation (branch.c:108-145) is then a gather (the pairs it walks
        are built from the same flt/shadow state this merge consumed)."""
        nonlocal fold
        JB = cfg.JB
        if capture is not None:
            keep("walk_pairs", (planes, flt, shadow, alive), dict(
                B=B, GB=GB, jb=JB, rank=rank, use_ori=cfg.use_ori,
                full=False))
        keys, s1_2, pair_ok, nxt, seg = run(walk)
        seg_tot, seg_ng = M.psum(seg, mesh)
        if JB and cfg.a2a_cap:
            arc_vw, arc_s1, n_out, mine = exchange_merge(
                keys, s1_2.reshape(-1), cfg=cfg, mesh=mesh,
                fold=lambda *a, **kw: captured(lk.merge_fold, *a, **kw),
                scratch=exchange_sc)
            return (arc_vw, arc_s1, n_out, seg_tot, seg_ng,
                    (mine.view(G, 2 * H), nxt, pair_ok))
        if JB:
            # JB low bits of the lean sort key carry the global row index:
            # the merge sorts one int64 tensor of distinct keys and the
            # fold finds each row's origin in them
            kps, so = torch.sort(ga(keys)).values, None
        else:
            # co-sorted form: equal keys keep their row order
            kps, so = torch.sort(ga(keys), stable=True)
        s1_all = ga(s1_2)
        kw = dict(jb=JB, gb=GB, cap=A, perm=so)
        if capture is not None:
            keep("merge_fold", (kps, s1_all),
                 kw if so is not None else dict(jb=JB, gb=GB, cap=A))
        if fold is None:
            fold = lk.bind_merge_fold(kps, s1_all, **kw)
        arc_vw, arc_s1, n_out, pair_arc = run(fold, kps, s1_all,
                                              n_out_rows[r], so)
        # each pair slot's arc row, this rank's window of the replicated
        # plane
        mine = pair_arc[rank * NL:(rank + 1) * NL].view(G, 2 * H)
        return arc_vw, arc_s1, n_out, seg_tot, seg_ng, (mine, nxt, pair_ok)

    def walk_merge_full():
        """walk_merge after the loop, through the checked wrappers: the
        co-sorted form (equal keys keep their row order) with the
        output-only statistics n_genome, tot_cnt, dist and s2 (the reverse
        key's s2 is the pair's s1); it reads no pair plane."""
        out = captured(lk.walk_pairs, planes, flt, shadow, alive, B=B,
                       GB=GB, jb=0, rank=rank, use_ori=cfg.use_ori,
                       full=True, key="walk_pairs_full")
        seg_tot, seg_ng = M.psum(out[4], mesh)
        keys, so = torch.sort(ga(out[0]), stable=True)
        fo = captured(lk.merge_fold, keys, ga(out[1]), jb=0, gb=GB, cap=A,
                      perm=so, full=(ga(out[5]), ga(out[6])),
                      key="merge_fold_full")
        return fo[:3] + (seg_tot, seg_ng) + fo[4:]

    # ---- round state (flt, weak, shadow, alive, loci_st and the logs are
    # updated in place by the kernels) ----
    flt = cols["flt"].clone()
    weak = cols["weak_br"].clone()
    shadow = cols["shadow"].clone()
    pid_dom = cols["pid_dom"].clone()
    alive = torch.ones(S, dtype=torch.bool, device=device)
    seg_tot, seg_ng = seg_tot0.to(I32), seg_ng0.to(I32)
    arc_vw, arc_s1 = arc0_vw.to(I64), arc0_s1.to(I32)
    # the pair state (each pair slot's arc row, nxt, pair_ok): none yet
    pair_st = (torch.zeros((G, 2 * H), dtype=I32, device=device),
               torch.full((G, H), -1, dtype=I32, device=device),
               torch.zeros((G, H), dtype=torch.bool, device=device))
    loci_st = torch.zeros((S, 2), dtype=I32, device=device)
    logs = torch.zeros((cfg.R, 10), dtype=I64, device=device)
    dcap_mask = torch.zeros((cfg.R, S), dtype=torch.uint8, device=device)
    dcap_deg = torch.zeros((cfg.R, S, 2), dtype=I32, device=device)
    dcap_loci = torch.zeros((cfg.R, S, 2), dtype=I32, device=device)
    dcap_tot = torch.zeros((cfg.R, S), dtype=I32, device=device)
    # each round's (n_prop, changed) word, branch counts (zeroed once: the
    # branch block adds into its round's row) and arc count, a row each
    words = torch.zeros((cfg.R, 2), dtype=I64, device=device)
    cnt_rows = torch.zeros((cfg.R, 2), dtype=I64, device=device).unbind(0)
    n_out_rows = torch.empty(cfg.R, dtype=I64, device=device).unbind(0)
    word_rows = words.unbind(0)
    # on the card the scratch that prop_round and occ_round count through
    # (each call leaves its counters zeroed)
    round_sc = lk.round_scratch(device, S) if device.type == "cuda" else None
    # exchange_pack's ticket and run bounds (the bucket exchange at more
    # than two ranks; each launch leaves it zeroed)
    exchange_sc = mk.exchange_scratch(device, nd) \
        if device.type == "cuda" and nd > 2 and cfg.a2a_cap else None
    aw_c = torch.zeros(A, dtype=torch.uint8, device=device)
    cnt_c = torch.zeros(2, dtype=I64, device=device)
    n_out_c = torch.zeros((), dtype=I64, device=device)
    cnt_r, n_out_r, flags = [], [], []
    nc_in = False
    overflow = torch.zeros((), dtype=torch.bool, device=device)
    # the branch kernels' tally over the schedule (valid arcs, branching
    # arcs, groups of the wide path, the widest group), read after the
    # closing synchronise when `stats` is given
    br_tally = torch.zeros(4, dtype=I64, device=device)
    loc_kw = dict(frag_mode=cfg.frag_mode, local_dist=cfg.local_dist,
                  local_count=cfg.local_count)
    cls_kw = dict(branch_diff=cfg.branch_diff,
                  branch_diff_dist=cfg.branch_diff_dist,
                  branch_diff_cut=cfg.branch_diff_cut)

    # ---- the launch plan: every in-loop kernel bound on the round state
    # (the state at round 0 stands for the arguments that change) ----
    prep = lk.bind_branch_prep(flt, shadow, valid, cols["gid"], cols["cid"],
                               cols["cm"], arc_vw, seg_gid, n_gene=ng, B=B)
    block = lk.bind_branch_block(*prep.out, arc_vw, arc_s1, B=B, **loc_kw,
                                 **cls_kw, tally=br_tally) if nd == 1 \
        else None
    prop = lk.bind_prop_round(weak, flt, valid, planes.ordcm, *pair_st, aw_c,
                              word_rows[0], scratch=round_sc)
    occ = lk.bind_occ_round(alive, flt, valid, cols["gid"], sid_of, arc_vw,
                            seg_tot, loci_st, logs, dcap_mask, dcap_deg,
                            dcap_loci, dcap_tot, word_rows[0], B=B,
                            n_grp=block.out[1] if block else None,
                            scratch=round_sc)
    sweep = sk.bind_sweep_round_loop(batch, flt, weak, cfg.W,
                                     cfg.check_strand, cfg.min_ov_ratio,
                                     shadow, pid_dom, cols["ev1"],
                                     cols["pid"], geo)
    walk = lk.bind_walk_pairs(planes, flt, shadow, alive, B=B, GB=GB,
                              jb=cfg.JB, rank=rank, use_ori=cfg.use_ori)

    for r in range(cfg.R):
        tr.begin("round")
        run_br = bool(do_branch[r]) and (not nc_in or no_skip)

        # ===== branch marking on the previous round's arcs =====
        # (branch.c:48-106): for every arc of a branching group, is there a
        # genome in which its target is local to a max arc's target of the
        # group (aml), and to an earlier member's (he); then the deficit
        # classification and the n_dist_loci greedy (branch.c:82-90)
        n_grp = None
        if run_br:
            with tr.block("branch"):
                # each arc's target gene and the representatives
                # (branch.c:6-29): last kept hit per gene in the current cs
                # order, with its kept-rank and cm, as gene-major [ng, G]
                # planes of this rank's genomes
                if capture is not None:
                    keep("branch_prep", (flt, shadow, valid, cols["gid"],
                                         cols["cid"], cols["cm"], arc_vw,
                                         seg_gid), dict(n_gene=ng, B=B))
                rep = run(prep, arc_vw)
                if nd == 1:
                    # one kernel: the groups, the locality, the
                    # classification (no host read)
                    if capture is not None:
                        keep("branch_block", (*rep, arc_vw, arc_s1),
                             dict(B=B, **loc_kw, **cls_kw))
                    arc_weak, n_grp, cnt = run(block, *rep, arc_vw, arc_s1,
                                               cnt_rows[r])
                else:
                    # a genome of any rank: the locality bits OR'd over the
                    # ranks before the classification
                    gs_of, mx, branching, is_max = lk.arc_groups(
                        arc_vw, arc_s1, B)
                    aml, he = captured(lk.branch_locality, *rep, gs_of,
                                       branching, is_max, **loc_kw,
                                       tally=br_tally)
                    aml, he = M.psum(torch.stack([aml, he]).to(I32),
                                     mesh) > 0
                    arc_weak, n_grp, cnt = captured(
                        lk.branch_classify, arc_s1, mx, branching, aml, he,
                        gs_of, **cls_kw)
        else:
            # convergence skip: nc_in certifies the previous round had
            # do_branch and changed nothing in (flt, weak, alive), so this
            # round's branch marking would reproduce the carried values
            # (loci_st among them). At r=0 (no branch round yet) the
            # carries are all zeros.
            arc_weak, cnt = aw_c, cnt_c

        # ===== weak propagation onto hits (branch.c:108-145) =====
        # the pairs walked here are built from the same flt/shadow state as
        # the previous round's walk_merge, which recorded each pair's arc
        # row; then the weak == 2 filter, n_prop and the change bit
        word = word_rows[r]
        with tr.block("prop"):
            if capture is not None and do_branch[r]:
                keep("prop_round", (weak, flt, valid, planes.ordcm,
                                    *pair_st, arc_weak, word),
                     dict(propagate=True))
            run(prop, *pair_st, arc_weak, word, bool(do_branch[r]))

        # ===== annealed high-occurrence filter (graph.c:237-263) =====
        # with n_dist_loci from the branch round's n_grp, the #del capture
        # rows and the convergence count
        with tr.block("occ"):
            cuts = (int(occ_cut[r]), int(deg_cut[r]), int(loci_cut[r])) \
                if do_occ[r] else None
            if capture is not None:
                keep("occ_round" if n_grp is not None and cuts
                     else "occ_round_partial",
                     (alive, flt, valid, cols["gid"], sid_of, arc_vw,
                      seg_tot, loci_st, logs, dcap_mask, dcap_deg,
                      dcap_loci, dcap_tot, word),
                     dict(r=r, B=B, n_grp=n_grp, cuts=cuts))
            run(occ, arc_vw, seg_tot, word, r, n_grp, cuts)
            # The hit state is this rank's, alive is replicated: the word
            # is summed over the ranks before the host reads it
            if nd > 1:
                word = M.psum(word, mesh)
                words[r] = word
            ch = host(word)[1] > 0

        # ===== arc regeneration (graph.c:87-177) =====
        # Skipped entirely when the round changed nothing: shadow, pid_dom
        # and the arc table are consistent with (flt, weak, alive) at every
        # round boundary (round 0 always runs; the updates are idempotent
        # and the walk is a pure function of that state). do_sweep/do_walk
        # exist to time or isolate a block; they claim no exactness.
        recompute = ch or r == 0 or no_skip
        run_sw = recompute and bool(do_sweep[r])
        if run_sw:
            # shadow and pid_dom in place (rows past a genome's kept rows
            # too, as the JAX epilogue: there ev1 & valid is false)
            with tr.block("sweep"):
                run(sweep)

        # walk + lean merge (the rounds only consume group structure, the
        # exact s1 average and the seg counters)
        if recompute and do_walk[r]:
            with tr.block("walk_merge"):
                arc_vw, arc_s1, n_out, seg_tot, seg_ng, pair_st = \
                    walk_merge(r)
        else:
            n_out = n_out_c
        nc_in = bool(do_branch[r]) and not ch
        cnt_r.append(cnt)
        n_out_r.append(n_out)
        flags.append((int(run_br), int(run_sw)))
        aw_c, cnt_c, n_out_c = arc_weak, cnt, n_out
        tr.end()

    # recompute the final arc table with its output-only stats from the
    # final state (identical kept pairs -> identical groups); all averages
    # are rounded exactly: IEEE double in merge_fold's full mode on cuda,
    # softfloat in its plain version
    with tr.block("walk_merge_full", "walk_merge"):
        (arc_vw, arc_s1, n_out, seg_tot, seg_ng, arc_ng, arc_tot, arc_ad,
         arc_s2) = walk_merge_full()
    # the logs' columns the round kernels did not write (occ_round wrote
    # 3-6): the branch counts, n_prop, the arc count, the two run flags
    n_outs = torch.stack(n_out_r)
    overflow |= (n_outs > A).any()
    logs[:, 0:2] = torch.stack(cnt_r)
    logs[:, 2] = words[:, 0]
    logs[:, 7] = n_outs
    logs[:, 8:] = torch.tensor(flags, dtype=I64, device=device)
    # replicated by construction; reduced once more so that every rank
    # falls back, or none
    overflow = M.pmax(overflow.to(I32), mesh) > 0
    block_ms = tr.block_ms(BLOCKS) if stats is not None else None
    tr.end()
    if stats is not None:
        wait = tr.ns("sync", "sync_final")
        # read once, after the closing synchronise (no wait of its own)
        valid_arcs, branching_arcs, wide, widest = br_tally.tolist()
        stats.update(host_syncs=tr.names.count("sync"), block_ms=block_ms,
                     branch_valid_arcs=valid_arcs,
                     branch_branching_arcs=branching_arcs,
                     branch_wide_groups=wide, branch_max_group=widest,
                     host_ms=tr.host_ms(BLOCKS + ("walk_merge_full",)),
                     sync_wait_ms=wait / 1e6,
                     driver_ms=(tr.ns("schedule") - wait) / 1e6,
                     sweep_launches=sk.n_batched()["kernel"] - launches0,
                     loop_launches={k: c["kernel"] - loop0[k]
                                    for k, c in lk.n_calls.items()},
                     launch_checks=lk.n_checks + sk.n_checks - checks0,
                     bound_launches=n_bound)
    return (flt, weak, shadow, pid_dom, alive, seg_tot, seg_ng, arc_vw,
            arc_s1, arc_ng, arc_tot, arc_ad, arc_s2, loci_st, logs,
            dcap_mask, dcap_deg, dcap_loci, dcap_tot, overflow)


# ---------------------------------------------------------------------------
# the host side: pack, upload, run, pull, apply
# ---------------------------------------------------------------------------

# Diagnostics of the most recent graph_gen_device call: engaged flag,
# fallback reason, static shape, wall-clock stage breakdown (pack / upload /
# device run / pull, from the spans of pack_host and run_packed), rounds
# run, host reads, per-block time and schedule_device's other stats.
LAST: dict = {}


def _fallback(reason: str) -> bool:
    LAST.clear()
    LAST.update(engaged=False, reason=reason)
    return False


class Pack(NamedTuple):
    """What pack_host hands to the schedule: its inputs in the order
    schedule() takes them, the static configuration, and what the apply
    step needs (kept row indices per genome, the stale n_prop constant)."""
    inputs: tuple
    cfg: Cfg
    kept_idx: list
    n_prop_stale: int
    E: int


def _host_array(shape, dtype, pin: bool) -> np.ndarray:
    """An uninitialised host array; in pinned memory (a view of a pinned
    torch tensor) when it is to be copied to a CUDA device."""
    if not pin:
        return np.empty(shape, dtype)
    tdt = {np.int32: torch.int32, np.int64: torch.int64,
           np.uint64: torch.int64, np.uint8: torch.uint8}[dtype]
    return torch.empty(shape, dtype=tdt, pin_memory=True).numpy().view(dtype)


@util.stage_span("pack")
def pack_host(opt: PgOpt, q, pin: bool = False):
    """Size and pack the schedule's inputs from the graph after phase 1, in
    NumPy (into pinned memory when `pin`), for the genome mesh of the run:
    the genome axis padded to a multiple of its world. Returns a Pack, or
    the reason (a string) why the device loop cannot take this graph.
    Its wall is the span "pack", util.stage_stats["pack_s"]."""
    d = q.d
    G = d.n_genome
    nd = M.make_mesh(opt.n_devices, opt.device).world
    Gp = ((G + nd - 1) // nd) * nd
    views = _steady_cm_views(d)
    if views is None:
        log_msg("pg_device_loop", "cm/cs sort order not in steady cycle; "
                "falling back to host rounds")
        return "cm/cs sort order not in steady cycle"
    S = q.n_seg
    ngene = d.n_gene
    B = max(int(2 * S - 1).bit_length(), 2)
    GB = max((Gp - 1).bit_length(), 1)
    if 2 * B + GB > 62:
        return "2B+GB=%d > 62 (S=%d, Gp=%d)" % (2 * B + GB, S, Gp)
    # Kept-row compaction: an entry-filtered hit never takes part in any
    # round block (the reference skips flt rows on both sides of every
    # sweep/walk/rep evaluation), so only flt==0 rows are packed. Dropped
    # rows keep their entry flt/shadow/weak_br/pid_dom on the host and are
    # merged back untouched after the pull.
    kept_idx = []
    ex_tot = []
    for g in d.genomes:
        h = g.hits
        n = g.n_hit
        kk = (np.flatnonzero(np.asarray(h.flt)[:n] == 0) if n
              else np.zeros(0, np.int64))
        kept_idx.append(kk)
        ex_tot.append(int(np.asarray(h.n_exon)[kk].sum()) if len(kk) else 0)
    # H is rounded up to 512 rows as in the JAX package (there it bounds the
    # number of compiled shapes), so that both packages pack one graph into
    # equal blocks; here it costs the padded rows and nothing else
    H = max(((max((len(k) for k in kept_idx), default=1) + 511) // 512)
            * 512, 512)
    E = dev.next_pow2(max(max(ex_tot, default=1), 1))
    K = dev.next_pow2(
        max((int(np.asarray(g.hits.n_exon)[k].max(initial=1))
             for g, k in zip(d.genomes, kept_idx) if len(k)), default=1),
        lo=2)
    W = 1
    for g, k in zip(d.genomes, kept_idx):
        if len(k):
            W = max(W, sk.band_width(np.asarray(g.hits.cid)[k],
                                     np.asarray(g.hits.cs)[k],
                                     np.asarray(g.hits.ce)[k]))
    W = min(dev.next_pow2(W, lo=2), H)
    # 25% headroom over the phase-1 arc count, in steps of 4096; overflow
    # falls back to the host rounds. PANGENE_DEVLOOP_MAX_A caps device
    # memory on huge graphs (and lets tests exercise the fallback).
    A = ((q.n_arc + q.n_arc // 4 + 4095) // 4096 + 1) * 4096
    A = min(max(A, 4096), Gp * 2 * H)
    max_a = int(os.environ.get("PANGENE_DEVLOOP_MAX_A", "0"))
    if max_a > 0:
        A = min(A, max_a)
    if q.n_arc > A:
        log_msg("pg_device_loop", "arc capacity %d below phase-1 count %d; "
                "falling back to host rounds", A, q.n_arc)
        return "arc capacity %d < phase-1 count %d" % (A, q.n_arc)
    T = opt.n_branch_flt
    R = T + 1

    from ..ops.device_engine import hash_u32_np
    from ..ops.overlap import cds_len_all
    cmax = 0
    for g, kk in zip(d.genomes, kept_idx):
        if len(kk):
            h = g.hits
            cmax = max(cmax, int(np.asarray(h.ce)[kk].max(initial=0)),
                       int(np.asarray(h.cm)[kk].max(initial=0)),
                       int(np.asarray(h.cs)[kk].max(initial=0)))
    coord32 = cmax < 2**31
    cdt = np.int32 if coord32 else np.int64
    I = {n: i for i, n in enumerate(PACK_I32)}
    U8 = {n: i for i, n in enumerate(PACK_U8)}
    blk_i32 = _host_array((len(PACK_I32), Gp, H), np.int32, pin)
    blk_i32.fill(0)
    blk_i32[I["cid"]].fill(dev.PAD_CID)
    blk_i32[I["dom_gid"]].fill(-1)
    blk_i32[I["pid_dom"]].fill(-1)
    blk_i32[I["cds_len"]].fill(1)
    blk_i32[I["ordcm"]] = np.arange(H, dtype=np.int32)
    blk_c = _host_array((len(PACK_C), Gp, H), cdt, pin)
    blk_c.fill(0)
    blk_c[1].fill(-1)                       # ce pad
    blk_ps = _host_array((1, Gp, H), np.uint64, pin)
    blk_ps.fill(0)
    blk_u8 = _host_array((len(PACK_U8), Gp, H), np.uint8, pin)
    blk_u8.fill(0)
    blk_ex = _host_array((2, Gp, E), np.int32, pin)
    blk_ex.fill(0)
    prot_gid = np.asarray(d.prot_gid, np.int32)
    pref = np.asarray(d.gene_preferred, np.uint8)
    # stale-quirk constant: the reference's per-round n_prop counts all
    # hits with weak_br != 0; entry-filtered rows are not uploaded, so
    # their (constant) contribution is added back to the pulled logs
    n_prop_stale = 0
    for j, g in enumerate(d.genomes):
        h = g.hits
        n = g.n_hit
        kk = kept_idx[j]
        nk = len(kk)
        if n:
            n_prop_stale += int(((np.asarray(h.flt)[:n] != 0)
                                 & (np.asarray(h.weak_br)[:n] != 0)).sum())
        if nk == 0:
            continue
        tk = lambda a: np.asarray(a)[kk]
        pid_k = tk(h.pid)
        gid = prot_gid[pid_k]
        pid_dom0_k = tk(h.pid_dom0)
        blk_i32[I["cid"], j, :nk] = tk(h.cid)
        blk_i32[I["rank"], j, :nk] = tk(h.rank)
        blk_i32[I["gid"], j, :nk] = gid
        blk_i32[I["dom_gid"], j, :nk] = np.where(
            pid_dom0_k >= 0, prot_gid[np.clip(pid_dom0_k, 0, None)], -1)
        blk_i32[I["score_ori"], j, :nk] = tk(h.score_ori)
        blk_i32[I["score_dom"], j, :nk] = tk(h.score_dom)
        blk_i32[I["cds_len"], j, :nk] = np.asarray(cds_len_all(g))[kk]
        blk_i32[I["pid"], j, :nk] = pid_k
        blk_i32[I["pid_dom"], j, :nk] = tk(h.pid_dom)
        # cm-order view of the kept subset: relative order is preserved
        # under subsetting, so filtering + renumbering the full stable
        # perm is the stable perm of the subset
        vk = views[j]
        keptmask = np.zeros(n, bool)
        keptmask[kk] = True
        renum = np.cumsum(keptmask) - 1
        blk_i32[I["ordcm"], j, :nk] = renum[vk[keptmask[vk]]]
        blk_c[0, j, :nk] = tk(h.cs)
        blk_c[1, j, :nk] = tk(h.ce)
        blk_c[2, j, :nk] = tk(h.cm)
        blk_ps[0, j, :nk] = (
            (tk(h.score_adj).astype(np.int64).astype(np.uint64)
             << np.uint64(33))
            | (pref[gid].astype(np.uint64) << np.uint64(32))
            | hash_u32_np(pid_k).astype(np.uint64))
        # flt is 0 for every kept row by construction (plane stays zero)
        blk_u8[U8["shadow"], j, :nk] = tk(h.shadow)
        blk_u8[U8["weak_br"], j, :nk] = tk(h.weak_br)
        blk_u8[U8["valid"], j, :nk] = 1
        blk_u8[U8["rev"], j, :nk] = tk(h.rev)
        blk_u8[U8["ev1"], j, :nk] = kk >= 1
        # exon ranges of kept hits, compacted with rewritten offsets
        cnt = tk(h.n_exon)
        off = tk(h.off_exon).astype(np.int64)
        new_off = np.zeros(nk, np.int64)
        new_off[1:] = np.cumsum(cnt[:-1], dtype=np.int64)
        tot = ex_tot[j]
        pos = (np.arange(tot, dtype=np.int64)
               - np.repeat(new_off, cnt) + np.repeat(off, cnt))
        blk_i32[I["n_exon"], j, :nk] = cnt
        blk_i32[I["off_exon"], j, :nk] = new_off.astype(np.int32)
        blk_ex[0, j, :tot] = np.asarray(g.exon_os)[pos]
        blk_ex[1, j, :tot] = np.asarray(g.exon_oe)[pos]

    # arc init from phase 1 (packed to B-bit vertices)
    a = q.arcs
    v0 = (a.x >> np.uint64(32)).astype(np.int64)
    w0 = (a.x & np.uint64(0xFFFFFFFF)).astype(np.int64)
    arc0_vw = np.full(A, SENT_I, np.int64)
    arc0_vw[:len(a)] = (v0 << B) | w0
    arc0_s1 = np.zeros(A, np.int32)
    arc0_s1[:len(a)] = a.s1

    # per-round thresholds (host IEEE doubles, exact)
    occ_cut = np.zeros(R, np.int64)
    deg_cut = np.zeros(R, np.int32)
    loci_cut = np.zeros(R, np.int32)
    do_branch = np.zeros(R, bool)
    do_occ = np.zeros(R, bool)
    occ_cut[0] = opt.max_avg_occ * 2 * G
    deg_cut[0] = opt.max_degree * 2
    loci_cut[0] = opt.max_dist_loci
    do_occ[0] = True
    for i in range(T):
        rr = 1.0 + (T - 1 - i) / T
        r_ = i + 1
        do_branch[r_] = True
        if i > 0:
            do_occ[r_] = True
            occ_cut[r_] = int(opt.max_avg_occ * rr + 0.499) * G
            deg_cut[r_] = int(opt.max_degree * rr + 0.499)
            loci_cut[r_] = int(opt.max_dist_loci * rr + 0.499)

    # PANGENE_DEVLOOP_DISABLE switches round blocks off to time or isolate
    # them: input values only, and no reference exactness is claimed.
    # "conv" defeats the convergence skip (every round recomputes).
    do_sweep = np.ones(R, bool)
    do_walk = np.ones(R, bool)
    disable = os.environ.get("PANGENE_DEVLOOP_DISABLE", "")
    if "branch" in disable:
        do_branch[:] = False
    if "occ" in disable:
        do_occ[:] = False
    if "sweep" in disable:
        do_sweep[:] = False
    if "walk" in disable:
        do_walk[:] = False
    no_skip = np.asarray("conv" in disable)

    # coord32: clamping local_dist at INT32_MAX is exact (every |cm gap|
    # fits int32, so a clamped threshold admits the same pairs)
    ld = int(opt.local_dist)
    if coord32:
        ld = min(ld, 2**31 - 1)
    lc = min(int(opt.local_count), 2**31 - 1)
    JB = max((Gp * 2 * H - 1).bit_length(), 1)
    if 2 * B + GB + JB > 62 or os.environ.get("PANGENE_DEVLOOP_NO_JB"):
        JB = 0          # lean merge falls back to co-sorted payloads
    # bucket-exchange capacity (more than two ranks; 0 = off): a per-
    # (source, destination) chunk holds up to slack * NL / nd keys, padded
    # to 128. A rank that sends more to one destination sets the overflow
    # flag and the host rounds take over. At two ranks the exchange sorts
    # ~slack * N / 2 received + N / 2 local keys a rank against the
    # replicated form's N (net-negative on the JAX CPU mesh), so it starts
    # at three
    a2a_cap = 0
    if nd > 2 and JB and os.environ.get(
            "PANGENE_DEVLOOP_SHARD_MERGE", "1") != "0":
        NL = (Gp // nd) * 2 * H
        slack = float(os.environ.get("PANGENE_DEVLOOP_A2A_SLACK", "1.5"))
        a2a_cap = min(((int(NL * slack) // nd + 127) // 128) * 128, NL)
    cfg = Cfg(H=H, K=K, W=W, S=S, A=A, B=B, GB=GB, JB=JB,
              n_gene=ngene, R=R, G_loc=Gp // nd, coord32=coord32,
              check_strand=bool(opt.check_strand),
              use_ori=bool(opt.use_ori_for_branch),
              frag_mode=bool(opt.frag_mode),
              min_ov_ratio=float(opt.min_ov_ratio),
              branch_diff=float(opt.branch_diff),
              branch_diff_dist=float(opt.branch_diff_dist),
              branch_diff_cut=float(opt.branch_diff_cut),
              local_dist=ld, local_count=lc, a2a_cap=a2a_cap)
    inputs = (blk_i32, blk_c, blk_ps.view(np.int64), blk_u8, blk_ex,
              np.asarray(q.seg_gid), np.asarray(q.g2s), arc0_vw, arc0_s1,
              q.seg_tot_cnt.astype(np.int32), q.seg_n_genome.astype(np.int32),
              occ_cut, deg_cut, loci_cut, do_branch, do_occ, do_sweep,
              do_walk, no_skip)
    return Pack(inputs, cfg, kept_idx, n_prop_stale, E)


N_DEVICE_INPUTS = 11   # leading inputs of schedule() that live on the device


def run_packed(pk: Pack, mesh: M.Mesh, stats: Optional[dict] = None,
               pull_dcap: bool = False) -> list:
    """pack_host's inputs through the device, as graph_gen_device runs them
    between its pack and its apply: the upload (the five blocks, each rank
    its genomes of `mesh`, then the next six inputs; from pinned memory on
    cuda), schedule_device, the read of its overflow flag, and the pull of
    its 20 outputs (the first four gathered over the ranks; the #del
    capture planes, O(R*S), only when `pull_dcap`, else empty). Returns the
    20 host arrays. `stats`, when given, receives schedule_device's and the
    seconds of the three phases, each a span ended by a synchronise:
    upload_s (the upload's), run_s (the overflow read), pull_s (the
    pull's copies)."""
    device = mesh.device
    tr = util.Tracer(stats is not None)
    with tr.span("upload"):
        # one copy per block
        on_dev = [M.put_sharded(a, mesh, 1) for a in pk.inputs[:5]] \
            + [torch.from_numpy(a).to(device, non_blocking=True)
               for a in pk.inputs[5:N_DEVICE_INPUTS]]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    with tr.span("run"):
        outs = schedule_device(*on_dev, *pk.inputs[N_DEVICE_INPUTS:-1],
                               bool(pk.inputs[-1]), cfg=pk.cfg,
                               stats=stats, mesh=mesh)
        outs[-1].item()
    with tr.span("pull"):
        # the first four outputs are this rank's genomes, the rest
        # replicated
        host = [M.pull_global(o, mesh) if i < 4
                else o.cpu().numpy() if pull_dcap or not 15 <= i < 19
                else np.zeros((0,) + tuple(o.shape[1:]), np.int32)
                for i, o in enumerate(outs)]
    if stats is not None:
        stats.update({k + "_s": tr.seconds(k)
                      for k in ("upload", "run", "pull")})
    return host


def graph_gen_device(opt: PgOpt, q) -> bool:
    """Run phases 2+3 of the schedule on opt.device, over the ranks of the
    genome mesh (parallel/mesh.py; one device without a launch). Returns
    True when the results were applied (bit-identical to the host rounds);
    False, on every rank alike, when a precondition or capacity check failed
    and the caller must run the host rounds instead. Assumes phase 1
    (gen_vtx + first gen_arc) already ran. Raises when opt.device is "cuda"
    and there is no CUDA device."""
    from ..graph.graphdata import ArcTable

    mesh = M.make_mesh(opt.n_devices, opt.device)
    device = mesh.device
    d = q.d
    G = d.n_genome
    if G == 0 or q.n_seg == 0 or q.n_arc == 0:
        return _fallback("empty graph")
    # every rank packs the same host data and uploads its genomes
    pk = pack_host(opt, q, pin=device.type == "cuda")
    if isinstance(pk, str):
        return _fallback(pk)
    cfg = pk.cfg
    coll0 = (sum(M.LAST["calls"].values()), M.LAST["collective_s"],
             M.LAST["staged_bytes"])
    stats: dict = {}
    # the #del capture planes only when the verbosity will replay them
    host = run_packed(pk, mesh, stats, pull_dcap=util.verbose >= 3)
    (flt, weak, shadow, pid_dom, alive, seg_tot, seg_ng, arc_vw, arc_s1,
     arc_ng, arc_tot, arc_ad, arc_s2, loci_fin, logs,
     dmask, ddeg, dloci, dtot, overflow) = host
    overflow_flag = bool(overflow)
    H, S, B, R = cfg.H, cfg.S, cfg.B, cfg.R
    LAST.clear()
    LAST.update(
        engaged=not overflow_flag,
        device=str(device),
        shape=dict(G=G, Gp=cfg.G_loc * mesh.world, H=H, E=pk.E, K=cfg.K,
                   W=cfg.W, S=S, A=cfg.A, R=R,
                   n_devices=mesh.world),
        rank=mesh.rank,
        shard_merge=bool(cfg.a2a_cap),
        coord32=cfg.coord32,
        kept_frac=round(sum(len(k) for k in pk.kept_idx)
                        / max(1, sum(g.n_hit for g in d.genomes)), 3),
        upload_bytes=int(sum(a.nbytes for a in pk.inputs[:5])),
        pack_s=util.stage_stats.get("pack_s"),
        # convergence skipping (logs cols 8/9 = ran_branch / ran_sweep)
        rounds_branch_run=int(logs[:, 8].sum()),
        rounds_sweep_run=int(logs[:, 9].sum()),
        rounds_total=R,
        # collectives of this run: calls, host seconds in them, bytes
        # staged through host memory (gloo with CUDA tensors)
        collective_calls=sum(M.LAST["calls"].values()) - coll0[0],
        collective_s=round(M.LAST["collective_s"] - coll0[1], 3),
        staged_bytes=M.LAST["staged_bytes"] - coll0[2],
        **stats)
    if overflow_flag:
        # the arc table's capacity (at more than two ranks also the bucket
        # exchange's, whose overflow reads as n_out > A)
        LAST["reason"] = "arc capacity overflow" if not cfg.a2a_cap \
            else "arc or bucket-exchange capacity overflow"
        log_msg("pg_device_loop", "%s; falling back to host rounds",
                LAST["reason"])
        return False

    logs = np.array(logs)
    logs[:, 2] += pk.n_prop_stale
    _emit_round_logs(q, logs, dmask, ddeg, dloci, dtot, R)

    # apply hit state: scatter pulled values to the kept rows; dropped
    # (entry-filtered) rows keep their entry values, the stale shadow /
    # pid_dom quirks, identical to what the host rounds leave behind
    for j, g in enumerate(d.genomes):
        h = g.hits
        kk = pk.kept_idx[j]
        nk = len(kk)
        if nk == 0:
            continue
        for name, plane, dt in (("flt", flt, np.uint8),
                                ("weak_br", weak, np.uint8),
                                ("shadow", shadow, np.uint8),
                                ("pid_dom", pid_dom, np.int32)):
            base = np.asarray(getattr(h, name)).astype(dt, copy=True)
            base[kk] = plane[j, :nk].astype(dt)
            h.set(name, base)
    # segment compaction (the reference hard-deleted each round; ids are
    # order-preserving so one final compaction is identical)
    keep = alive.astype(bool)
    q.seg_gid = q.seg_gid[keep]
    q.seg_n_dom = q.seg_n_dom[keep]
    q.seg_n_sub = q.seg_n_sub[keep]
    q.seg_n_genome = seg_ng[keep].astype(np.int32)
    q.seg_tot_cnt = seg_tot[keep].astype(np.int32)
    q.seg_n_dist_loci = loci_fin[keep].astype(np.int32)
    q.seg_del = np.zeros(int(keep.sum()), np.uint8)
    q.gen_g2s()
    q.flag_vtx()
    # rebuild the arc table with original->compacted id remap
    na = int((arc_vw != SENT_I).sum())
    vw = arc_vw[:na]
    remap = np.cumsum(keep) - 1
    v = vw >> B
    w = vw & ((1 << B) - 1)
    newv = (remap[(v >> 1)] << 1) | (v & 1)
    neww = (remap[(w >> 1)] << 1) | (w & 1)
    out = ArcTable.empty(na)
    out.x = (newv.astype(np.uint64) << np.uint64(32)) | neww.astype(np.uint64)
    out.n_genome = arc_ng[:na].astype(np.int32)
    out.tot_cnt = arc_tot[:na].astype(np.int32)
    # averages already rounded exactly (+.499) by the full merge tail
    out.avg_dist = arc_ad[:na].astype(np.int32)
    out.s1 = arc_s1[:na].astype(np.int32)
    out.s2 = arc_s2[:na].astype(np.int32)
    q.arcs = out
    return True


def _emit_round_logs(q, logs, dmask, ddeg, dloci, dtot, R) -> None:
    """Replay the reference's per-round stderr messages from the pulled
    counters (content-exact; timestamps are emission-time)."""
    d = q.d
    for r in range(R):
        n1, n2, nprop, nocc, ndeg, nloci, nseg, narc = (
            int(x) for x in logs[r][:8])
        if r >= 1:
            log_msg("pg_mark_branch_flt_arc",
                    "marked %d locally diverged branches and %d distantly "
                    "diverged branches", n1, n2)
            log_msg("pg_mark_branch_flt_hit", "marked %d diverged hits",
                    nprop)
        if r == 0 or r >= 2:
            log_msg("pg_flt_high_occ",
                    "filtered %d high-occurrence segments, %d high-degree "
                    "segments and %d segments connecting distant loci",
                    nocc, ndeg, nloci)
            if util.verbose >= 3 and dmask.shape[0] == R:
                for i in np.flatnonzero(dmask[r]):
                    s_occ = dtot[r, i] / d.n_genome
                    if r >= 2:
                        sys.stderr.write(
                            "#del\t%s\tavg_occ=%.1f\tdeg=%d,%d\t"
                            "dist_deg=%d,%d\n" % (
                                d.gene_name[q.seg_gid[i]], s_occ,
                                ddeg[r, i, 0], ddeg[r, i, 1],
                                dloci[r, i, 0], dloci[r, i, 1]))
                    else:
                        sys.stderr.write(
                            "#del\t%s\tavg_occ=%.1f\tdeg=*,*\t"
                            "dist_deg=%d,%d\n" % (
                                d.gene_name[q.seg_gid[i]], s_occ,
                                dloci[r, i, 0], dloci[r, i, 1]))
        if r == 0:
            log_msg("pg_graph_gen", "round-2 graph: %d genes and %d arcs",
                    nseg, narc)
