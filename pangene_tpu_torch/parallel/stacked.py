"""The per-round device path: one fused step per arc round over all genomes.

The counterpart of pangene_tpu/parallel/stacked.py. It is what
``--engine sharded`` runs when the device-resident loop
(parallel/device_loop.py) is switched off (PANGENE_DEVICE_LOOP=0) or cannot
take the graph (an arc table over its capacity, an unsettled sort cycle):
every pg_gen_arc (graph.c:87-177) of the
host rounds becomes one device step over the stacked [G, H] hit tables:

  a. the shadow sweep of every genome with the reference's stale-flag merge
     (overlap.c:108-116) and the sort key: one launch of the hand-written
     CUDA kernel (sweep_kernel.sweep_round_step; its plain version on the
     CPU);
  b. the stable (cid, cm) sort of every genome (torch.sort);
  c. the gene walk, the previous kept hit by a running max of kept indices,
     and the gene-indexed occurrence counters summed over genomes: one
     launch (step_kernels.step_walk);
  d. the per-genome arc dedupe: sort by x (torch.sort), then one launch
     that reduces each group (step_kernels.step_dedupe);
  e. over a mesh, the counters' sum over the ranks.

The per-genome deduped arc lists return to the host through one pinned
buffer for the exact global merge (all averaging in host IEEE f64 with the
reference's +.499 rounding, graph.c:141,170-172). The host DataSet stays
the source of truth: after each step the host applies the same stable
permutations (cm then cs) to its tables, so tie orders track the
reference's physical re-sorts.

On a genome mesh of several ranks (parallel/mesh.py) each rank steps its
G_loc of the Gp padded genomes; the occurrence counters are summed over
the ranks, and the per-genome outputs are gathered to every rank, which
merges and applies them alike. The protein-keyed reductions of
post_process (reduction_step) are the same sums and a maximum over the
ranks.

The constant columns (coordinates, scores, exon pools, packed score keys:
frozen after ingest) are uploaded once and stay on the card across the ~17
rounds; only flt / shadow / weak_br go up each round. The cache is keyed on
each genome's sort-state tag (ops/sort.py). When a physical order changes
(the first cm -> cs round trip may reorder cs ties), the rows on the card
are re-ordered by a permutation sent in place of the columns; anything else
that no longer matches drops the cache and uploads again.

uint64 in torch: the arc key x = v << 32 | w and the packed scores are
uint64 in the reference. Their bit patterns travel as int64; wherever their
order matters they are compared as ``u ^ (1 << 63)``, a bijection under
which signed order is unsigned order (ops/sweep_kernel.py), so every
pattern, a negative w of a non-vertex gene included, sorts and groups as
the reference's uint64 does. The all-ones key of an invalid pair is then
int64 max.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import util
from ..options import PgOpt
from ..ops import mesh_kernels as mk
from ..ops import step_kernels as stk
from ..ops import sweep_kernel as sk
from ..ops.device import PAD_CID
from . import mesh as M
from .device_loop import _host_array

I64 = torch.int64
I32 = torch.int32

# host blocks of the constant columns, one upload each
STACK_I32 = ("cid", "rank", "gid", "dom_gid", "score_ori", "score_dom",
             "n_exon", "off_exon", "cds_len")
STACK_I64 = ("cs", "ce", "cm", "pscore")
STACK_U8 = ("rev",)
MUTABLE_COLS = ("flt", "shadow", "weak_br")     # one [3, G, H] upload a round

STEP_BLOCKS = ("sweep", "sort", "walk", "dedupe", "counters")
STEP_OUTPUTS = ("shadow", "b_score", "b_other", "uniq_x", "cnt", "dsum",
                "m1", "m2", "tot_cnt", "n_genome")

# Diagnostics of the per-round path since it first saw the current graph:
# rounds (device steps run), const_uploads / const_permutes (uploads of the
# constant columns; re-orderings of them on the card), shape (G, H, E, W),
# seconds summed over the rounds (stack_s: host stacking; upload_s; step_s:
# the device step; pull_s; apply_s: host apply and merge), pull_bytes (one
# round's pull), sweep_launches (of the batched CUDA kernel, its fused STEP
# form), step_launches (of step_walk and step_dedupe), block_ms (device
# time of the step's parts, summed over the rounds).
LAST: dict = {}


class StackCols(NamedTuple):
    """The constant columns of G cs-sorted genomes, H-padded: the batched
    sweep's columns and the walk's."""
    batch: sk.BatchCols
    cm: torch.Tensor          # int64 [G, H]
    dom_gid: torch.Tensor     # int32 [G, H], -1 = no read-time dominator
    score_ori: torch.Tensor   # int32 [G, H]
    score_dom: torch.Tensor   # int32 [G, H]


class HostStack(NamedTuple):
    """build_stacked's result: the constant columns as five host blocks (one
    upload each) and the sweep band over all rows of all genomes."""
    n_rows: np.ndarray        # int32 [G]
    i32: np.ndarray           # [len(STACK_I32), G, H]
    i64: np.ndarray           # [len(STACK_I64), G, H]; pscore biased
    u8: np.ndarray            # [len(STACK_U8), G, H]
    ex: np.ndarray            # int32 [2, G, E]: exon_os, exon_oe
    W: int


def stack_views(n_rows, i32, i64, u8, ex) -> StackCols:
    """The five blocks (numpy arrays or tensors) as named columns."""
    c = {n: i32[k] for k, n in enumerate(STACK_I32)}
    c.update({n: i64[k] for k, n in enumerate(STACK_I64)})
    c.update({n: u8[k] for k, n in enumerate(STACK_U8)})
    batch = sk.BatchCols(n_rows=n_rows, exon_os=ex[0], exon_oe=ex[1], **{
        n: c[n] for n in sk.BatchCols._fields
        if n not in ("n_rows",) + sk.EXON_FIELDS})
    return StackCols(batch, c["cm"], c["dom_gid"], c["score_ori"],
                     c["score_dom"])


def band_over_genomes(d) -> int:
    """One sweep band for the whole stack: the largest exact band of any
    genome over all its rows. A wider band than a genome's own is exact
    (the candidates beyond it fail ce_j > cs_i)."""
    W = 1
    for g in d.genomes:
        if g.n_hit:
            h = g.hits
            W = max(W, sk.band_width(h.cid, np.asarray(h.cs),
                                     np.asarray(h.ce)))
    return W


def build_stacked(d, pin: bool = False, Gp: Optional[int] = None) -> HostStack:
    """Stack the per-genome tables into [Gp, H] / [Gp, E] host blocks
    (pinned memory when `pin`), padded to the longest genome and the
    largest exon pool and no further: the kernel's tiles need no padding of
    their own. Padding rows, and the genomes past G up to Gp (default G),
    read cid PAD_CID, ce -1, dom_gid -1, cds_len 1, no score."""
    from ..ops.device_engine import hash_u32_np
    from ..ops.overlap import cds_len_all
    G = d.n_genome if Gp is None else Gp
    H = max(max((g.n_hit for g in d.genomes), default=1), 1)
    E = max(max((len(g.exon_os) for g in d.genomes), default=1), 1)
    prot_gid = np.asarray(d.prot_gid, np.int32)
    pref = np.asarray(d.gene_preferred, np.uint8)
    I = {n: k for k, n in enumerate(STACK_I32)}
    L = {n: k for k, n in enumerate(STACK_I64)}
    n_rows = _host_array((G,), np.int32, pin)
    i32 = _host_array((len(STACK_I32), G, H), np.int32, pin)
    i64 = _host_array((len(STACK_I64), G, H), np.int64, pin)
    u8 = _host_array((len(STACK_U8), G, H), np.uint8, pin)
    ex = _host_array((2, G, E), np.int32, pin)
    for blk in (n_rows, i32, i64, u8, ex):
        blk.fill(0)
    i32[I["cid"]].fill(PAD_CID)
    i32[I["dom_gid"]].fill(-1)
    i32[I["cds_len"]].fill(1)
    i64[L["ce"]].fill(-1)
    i64[L["pscore"]].fill(sk.SCORE_NONE)
    for j, g in enumerate(d.genomes):
        h = g.hits
        n = len(h)
        n_rows[j] = n
        gid = prot_gid[h.pid]
        for name in STACK_I32:
            if name == "gid":
                col = gid
            elif name == "dom_gid":
                col = np.where(h.pid_dom0 >= 0,
                               prot_gid[np.clip(h.pid_dom0, 0, None)], -1)
            elif name == "cds_len":
                col = cds_len_all(g)
            else:
                col = h.cols[name]
            i32[I[name], j, :n] = col
        for name in ("cs", "ce", "cm"):
            i64[L[name], j, :n] = h.cols[name]
        raw = ((h.score_adj.astype(np.int64).astype(np.uint64)
                << np.uint64(33))
               | (pref[gid].astype(np.uint64) << np.uint64(32))
               | hash_u32_np(h.pid).astype(np.uint64))
        i64[L["pscore"], j, :n] = (raw ^ np.uint64(1 << 63)).view(np.int64)
        u8[0, j, :n] = h.rev
        ne = len(g.exon_os)
        ex[0, j, :ne] = g.exon_os
        ex[1, j, :ne] = g.exon_oe
    return HostStack(n_rows, i32, i64, u8, ex, band_over_genomes(d))


def stack_mutable(d, out: np.ndarray) -> np.ndarray:
    """The columns that change between rounds (MUTABLE_COLS) into the
    [3, G, H] uint8 block `out`, whose padding rows are zero."""
    for j, g in enumerate(d.genomes):
        h = g.hits
        n = len(h)
        for k, name in enumerate(MUTABLE_COLS):
            out[k, j, :n] = h.cols[name]
    return out


# ---------------------------------------------------------------------------
# the device step
# ---------------------------------------------------------------------------

def round_step(st: StackCols, flt: torch.Tensor, shadow: torch.Tensor,
               weak_br: torch.Tensor, g2s: torch.Tensor, *, W: int,
               min_ov_ratio: float, check_strand: bool, use_ori: bool,
               geo: Optional[dict] = None, timer=None,
               mesh: Optional[M.Mesh] = None):
    """One arc round over all genomes on the device of `st` (the JAX
    package's round_step over _genome_round, batched over the genome axis).

    flt / shadow / weak_br: uint8 [G, H], the round's flags, filtered rows
    in place; shadow takes the sweep's stale-flag merge in place and is
    returned. g2s: int32 [n_gene], gene -> segment or -1. Returns, as
    STEP_OUTPUTS names them: shadow uint8 [G, H]; b_score int64 [G, H]
    (biased; sk.SCORE_NONE = no dominator) and b_other int32 [G, H], the
    sweep's dominators; per genome the deduped arcs in the leading rows of
    [G, 2H] planes, valid where cnt > 0: uniq_x int64 (the uint64 key's bit
    pattern), cnt int32, dsum int64, m1 / m2 int32; tot_cnt and n_genome
    int32 [n_gene], the kept hits per clipped segment id summed over
    genomes and the genomes that have one.

    On cuda three kernel launches and two torch.sort calls; on the CPU the
    kernels' plain versions. `geo` is the plain sweep's cache for this
    `st`; `timer`, a util.Tracer, times the parts as blocks of
    STEP_BLOCKS. Over a `mesh`, `st` and the flags hold this rank's genomes
    and tot_cnt / n_genome sum over every rank's."""
    bc = st.batch
    span = (timer or util.Tracer(False)).block

    # a. shadow sweep on the cs-sorted state, the stale-flag merge (hit 0
    # and filtered hits are never the evaluated side, overlap.c:108-116)
    # and the (cid, cm) sort key
    with span("sweep"):
        b_score, b_other, key = sk.sweep_round_step(
            bc, flt, weak_br, W, check_strand, min_ov_ratio, shadow, st.cm,
            geo)

    # b. stable (cid, cm) sort
    with span("sort"):
        perm = torch.sort(key, dim=1, stable=True).indices

    # c. walk: previous kept hit, the pairs' keys; the gene counters
    with span("walk"):
        akey, pair_ok, dist, s1, s2, counts = stk.step_walk(
            st, perm, flt, shadow, g2s, use_ori=use_ori)

    # d. per-genome dedupe: sort by x (unsigned order), reduce the groups
    with span("dedupe"):
        xs, aperm = torch.sort(akey, dim=1, stable=True)
        uniq_x, cnt, dsum, m1, m2 = stk.step_dedupe(xs, aperm, pair_ok,
                                                    dist, s1, s2)

    # e. the counters over every rank's genomes
    with span("counters"):
        if mesh is not None:
            counts = M.psum(counts, mesh)
    return (shadow, b_score, b_other, uniq_x, cnt, dsum, m1, m2, counts[0],
            counts[1])


def _pull(tensors, host: Optional[torch.Tensor], mesh: M.Mesh,
          n_sharded: int):
    """The tensors packed into one byte buffer on their device, gathered
    from every rank (one collective) and copied to the host once (into the
    pinned buffer `host` when it fits). The first `n_sharded` hold this
    rank's genomes and come back as every rank's, concatenated; the others
    are replicated and come back as this rank's. Returns (numpy arrays,
    the host buffer)."""
    cd = [(t.numel(), t.dtype) for t in tensors]
    offs, total = sk._layout(cd)
    buf = M.all_gather(sk._pack([t.reshape(-1) for t in tensors], offs,
                                total), mesh)
    if buf.device.type == "cuda":
        if host is None or host.shape[0] != buf.shape[0]:
            host = torch.empty(buf.shape[0], dtype=torch.uint8,
                               pin_memory=True)
        host.copy_(buf, non_blocking=True)
        torch.cuda.synchronize(buf.device)
    else:
        host = buf
    ranks = [[v.numpy().reshape(t.shape) for v, t in zip(
        sk._views(host[r * total:(r + 1) * total], offs, cd), tensors)]
        for r in range(mesh.world)]
    if mesh.world == 1:
        return ranks[0], host
    return [np.concatenate([rk[k] for rk in ranks]) if k < n_sharded
            else ranks[mesh.rank][k] for k in range(len(tensors))], host


# ---------------------------------------------------------------------------
# the host side: cache, upload, step, pull, apply
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sort_tags(d):
    return tuple(getattr(g, "_sort_cache", None) and g._sort_cache.state
                 for g in d.genomes)


def _sort_orders(d):
    """Per genome its sort cache and the current order-from-base vector
    (ops/sort.py), or (None, None) where no sort has run yet."""
    caches, orders = [], []
    for g in d.genomes:
        c = getattr(g, "_sort_cache", None)
        caches.append(c)
        orders.append(None if c is None else c.orders[c.state])
    return caches, orders


def _upload_const(d, mesh: M.Mesh) -> dict:
    device = mesh.device
    Gp = M.pad_genomes(d.n_genome, mesh)
    hs = build_stacked(d, pin=device.type == "cuda", Gp=Gp)
    # this rank's genomes of each block (n_rows [Gp]; the others [n, Gp, .])
    blocks = [M.put_sharded(a, mesh, 1 if a.ndim == 3 else 0)
              for a in hs[:5]]
    _sync(device)
    H = hs.i32.shape[2]
    caches, orders = _sort_orders(d)
    mut = _host_array((len(MUTABLE_COLS), Gp, H), np.uint8,
                      device.type == "cuda")
    mut.fill(0)
    return {"tags": _sort_tags(d), "G": d.n_genome, "Gp": Gp, "H": H,
            "E": hs.ex.shape[2], "W": hs.W, "mesh": mesh, "blocks": blocks,
            "cols": stack_views(*blocks), "geo": {}, "mut_host": mut,
            "pull_host": None, "sort_caches": caches, "orders": orders,
            "n_ex": [len(g.exon_os) for g in d.genomes]}


def _repermute(cache: dict, d) -> bool:
    """Bring the cached columns into the host tables' new physical order by
    gathering their rows on the card through a [G, H] permutation. False
    when the change is more than a re-ordering of the same rows (then the
    caller uploads anew)."""
    G, H = cache["G"], cache["H"]
    if d.n_genome != G:
        return False
    caches, orders = _sort_orders(d)
    perm = np.tile(np.arange(H, dtype=np.int64), (cache["Gp"], 1))
    for j, g in enumerate(d.genomes):
        old, new = cache["orders"][j], orders[j]
        if (old is None or new is None or g.n_hit != len(old)
                or caches[j] is not cache["sort_caches"][j]
                or len(g.exon_os) != cache["n_ex"][j]):
            return False
        if new is not old:
            inv = np.empty(len(old), np.int64)
            inv[old] = np.arange(len(old))
            perm[j, :len(old)] = inv[new]
    p = M.put_sharded(perm, cache["mesh"])
    n_rows, i32, i64, u8, ex = cache["blocks"]
    blocks = [n_rows] + [b.gather(2, p.expand(b.shape[0], -1, -1))
                         for b in (i32, i64, u8)] + [ex]
    cache.update(tags=_sort_tags(d), blocks=blocks,
                 cols=stack_views(*blocks), geo={}, orders=orders,
                 W=band_over_genomes(d))
    return True


def _new_last(device: torch.device) -> None:
    LAST.clear()
    LAST.update(device=str(device), rounds=0, const_uploads=0,
                const_permutes=0, shape={}, stack_s=0.0, upload_s=0.0,
                step_s=0.0, pull_s=0.0, apply_s=0.0, pull_bytes=0,
                sweep_launches=0,
                step_launches={k: 0 for k in stk.n_calls},
                block_ms={b: 0.0 for b in STEP_BLOCKS})


def _add(key: str, t0: float) -> float:
    now = time.monotonic()
    LAST[key] = round(LAST[key] + now - t0, 6)
    return now


def gen_arc_sharded(opt: PgOpt, q) -> None:
    """pg_gen_arc as one device step plus the exact host merge:
    byte-equivalent to ops/arcs.gen_arc_loop. Fills LAST."""
    from ..ops import arcs as arcs_host
    from ..ops.sort import cm_cycle_view, hit_sort

    d = q.d
    mesh = M.make_mesh(opt.n_devices, opt.device)
    device = mesh.device
    G = d.n_genome
    cache = getattr(q, "_stacked_dev_cache", None)
    if cache is None:
        _new_last(device)
    if G == 0:
        q.seg_tot_cnt = np.zeros(q.n_seg, np.int32)
        q.seg_n_genome = np.zeros(q.n_seg, np.int32)
        q.arcs = arcs_host.merge_arcs([])
        return
    t = time.monotonic()
    if cache is not None and (cache["mesh"] != mesh or cache["G"] != G):
        cache = None
    if cache is not None and cache["tags"] != _sort_tags(d):
        # a genome's physical order changed: the cached rows are stale
        if _repermute(cache, d):
            LAST["const_permutes"] += 1
        else:
            cache = None
    if cache is None:
        cache = q._stacked_dev_cache = _upload_const(d, mesh)
        LAST["const_uploads"] += 1
    H, W = cache["H"], cache["W"]
    LAST["shape"] = dict(G=G, Gp=cache["Gp"], H=H, E=cache["E"], W=W,
                         n_devices=mesh.world)
    mut = stack_mutable(d, cache["mut_host"])
    t = _add("stack_s", t)
    flt, shadow, weak_br = M.put_sharded(mut, mesh, 1)
    # gene -> segment map, at least one entry so that clipping has a range
    g2s_host = np.full(max(d.n_gene, 1), -1, np.int32)
    g2s_host[:d.n_gene] = q.g2s
    g2s = torch.from_numpy(g2s_host).to(device)
    _sync(device)
    t = _add("upload_s", t)

    timer = util.Tracer(device=device)
    launches0 = sk.n_batched()["kernel"]
    step0 = {k: c["kernel"] for k, c in stk.n_calls.items()}
    outs = round_step(
        cache["cols"], flt, shadow, weak_br, g2s, W=W,
        min_ov_ratio=float(opt.min_ov_ratio),
        check_strand=opt.check_strand, use_ori=opt.use_ori_for_branch,
        geo=cache["geo"], timer=timer, mesh=mesh)
    for name, ms in timer.block_ms(STEP_BLOCKS).items():  # synchronises
        LAST["block_ms"][name] = round(LAST["block_ms"][name] + ms, 3)
    LAST["sweep_launches"] += sk.n_batched()["kernel"] - launches0
    for k, c in stk.n_calls.items():
        LAST["step_launches"][k] += c["kernel"] - step0[k]
    t = _add("step_s", t)
    host, cache["pull_host"] = _pull(outs, cache["pull_host"], mesh, 8)
    LAST["pull_bytes"] = int(cache["pull_host"].shape[0])
    t = _add("pull_s", t)
    (shadow, b_score, b_other, uniq_x, cnt, dsum, m1, m2, tot_cnt,
     n_genome) = host
    # the sums over genomes must describe G genomes: a device that
    # disagrees on the hit tables would corrupt them silently otherwise
    if len(n_genome) and (int(n_genome.max(initial=0)) > G
                          or int(n_genome.min(initial=0)) < 0
                          or int(tot_cnt.min(initial=0)) < 0):
        raise RuntimeError(
            "sharded reduction desync: per-gene genome counts outside "
            "[0, %d]: devices disagree on the hit tables" % G)

    # apply per-genome results to the host tables + the same physical
    # re-sorts
    per_genome = []
    for j, g in enumerate(d.genomes):
        h = g.hits
        n = len(h)
        nonflt = h.flt == 0
        h.set("shadow", shadow[j, :n].copy())
        # pid_dom refresh like the reference final loop (dominator argmax);
        # a raw best score > 0 is a biased score above SCORE_NONE
        has_dom = nonflt & (b_score[j, :n] > sk.SCORE_NONE)
        other = np.clip(b_other[j, :n], 0, max(n - 1, 0))
        pid_dom = np.where(nonflt, -1, h.pid_dom)
        pid_dom = np.where(has_dom, h.pid[other], pid_dom)
        h.set("pid_dom", pid_dom.astype(np.int32))
        # mirror the reference's physical cm->cs resort; once the round
        # trip is a known cycle it is the identity and can be skipped
        if cm_cycle_view(g) is None:
            hit_sort(g, by_cm=True)
            hit_sort(g, by_cm=False)
        sel = cnt[j] > 0
        per_genome.append((uniq_x[j][sel].view(np.uint64), cnt[j][sel],
                           (dsum[j][sel].astype(np.float64) / cnt[j][sel]
                            + 0.499).astype(np.int64).astype(np.int32),
                           m1[j][sel], m2[j][sel]))
    if q.n_seg:
        q.seg_tot_cnt = tot_cnt[:q.n_seg].astype(np.int32)
        q.seg_n_genome = n_genome[:q.n_seg].astype(np.int32)
    q.arcs = arcs_host.merge_arcs(per_genome)
    LAST["rounds"] += 1
    _add("apply_s", t)


# ---------------------------------------------------------------------------
# cross-genome reductions (post-process): protein-indexed accumulators
# ---------------------------------------------------------------------------

REDUCTION_COLS = ("pid", "score_ori", "score_adj", "n_exon", "rank")


def reduction_step(pid: torch.Tensor, score_ori: torch.Tensor,
                   score_adj: torch.Tensor, n_exon: torch.Tensor,
                   rank: torch.Tensor, flt: torch.Tensor,
                   n_rows: torch.Tensor, *, n_prot: int,
                   mesh: Optional[M.Mesh] = None):
    """The protein-keyed reductions feeding pg_cap_score_dom /
    pg_flag_representative / pg_flag_pseudo_joint (hit.c:148-247) over
    stacked [G, H] columns (int32; flt uint8; n_rows int32 [G]: the padded
    stack, or every genome's rows end to end with G = 1). Returns seven
    [n_prot] tensors: max score_ori (int32); then, int64, over rank-0
    unfiltered hits, the counts and score_ori sums of single-exon and of
    multi-exon hits (cnt0, cnt1, sum0, sum1) and the representative's
    score_adj sum and count. Integer sums and maxima: bit-equal to the host
    loops in any order and layout. One launch of mesh_kernels.protein_reduce
    (its plain version on the CPU); over a `mesh` the columns are this
    rank's genomes and the results are over every rank's (a pmax and one
    psum)."""
    max_so, sums = mk.protein_reduce(pid, score_ori, score_adj, n_exon, rank,
                                     flt, n_rows, n_prot=n_prot)
    if mesh is not None:
        max_so, sums = M.pmax(max_so, mesh), M.psum(sums, mesh)
    return (max_so,) + tuple(sums)


def stack_reductions(d, mesh: M.Mesh, pin: bool):
    """This rank's genomes of the padded genome axis (rows [rank G_loc,
    (rank + 1) G_loc), the partition of mesh.put_sharded) in one host
    buffer, their rows end to end: n_rows int32 [1], then REDUCTION_COLS
    int32 [N] each, then flt uint8 [N] (N >= 1 slots, the rows beyond the
    count invalid). Returns (buffer uint8, N)."""
    G_loc = M.pad_genomes(d.n_genome, mesh) // mesh.world
    mine = d.genomes[mesh.rank * G_loc:(mesh.rank + 1) * G_loc]
    n = sum(len(g.hits) for g in mine)
    N = max(n, 1)
    nc = len(REDUCTION_COLS)
    buf = _host_array((4 * (1 + nc * N) + N,), np.uint8, pin)
    i32 = buf[:4 * (1 + nc * N)].view(np.int32)
    i32[0] = n
    cols = i32[1:].reshape(nc, N)
    flt = buf[4 * (1 + nc * N):]
    if n:
        for k, name in enumerate(REDUCTION_COLS):
            np.concatenate([g.hits.cols[name] for g in mine], out=cols[k, :n])
        np.concatenate([g.hits.flt for g in mine], out=flt[:n])
    return buf, N


def reduction_views(buf: torch.Tensor, N: int):
    """stack_reductions' buffer as reduction_step's arguments ([1, N] views
    and n_rows [1])."""
    nc = len(REDUCTION_COLS)
    i32 = buf[:4 * (1 + nc * N)].view(I32)
    cols = i32[1:].view(nc, 1, N)
    return (*cols, buf[4 * (1 + nc * N):].view(1, N), i32[:1])


def post_reductions_sharded(opt: PgOpt, d):
    """The protein-keyed cross-genome reductions of post_process on the
    device: (mx, z, (c, s)) in the formats ops/pseudo.py's cap_score_dom,
    flag_representative and flag_pseudo_joint take, bit-equal to their host
    loops. Each rank of the genome mesh stacks only its own genomes, their
    rows end to end (stack_reductions), uploads them once, launches one
    reduction, takes the pmax and psum over the ranks and pulls once.

    graph/post.py takes it on the main path when more than one device
    shards the genomes, as the JAX package does; on one device it keeps the
    host loops (the tests and chip_smoke.py hold the two against each
    other)."""
    mesh = M.make_mesh(opt.n_devices, opt.device)
    n_prot = max(d.n_prot, 1)
    buf, N = stack_reductions(d, mesh, mesh.device.type == "cuda")
    cols = reduction_views(torch.from_numpy(buf).to(mesh.device,
                                                    non_blocking=True), N)
    outs = reduction_step(*cols, n_prot=n_prot, mesh=mesh)
    arr = torch.cat([o.to(I64) for o in outs]).cpu().numpy()    # one pull
    P = n_prot
    max_so, cnt0, cnt1, sum0, sum1, rep_sum, rep_cnt = (
        arr[P * i:P * (i + 1)] for i in range(7))
    mx = max_so.astype(np.int32)[:d.n_prot]
    z = ((rep_sum.astype(np.uint64) << np.uint64(32))
         + rep_cnt.astype(np.uint64))[:d.n_prot]
    c = np.stack([cnt0, cnt1], axis=1)[:d.n_prot]
    s = np.stack([sum0, sum1], axis=1)[:d.n_prot]
    return mx, z, (c, s)
