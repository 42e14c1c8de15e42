"""A plain reference of the branch marking, pg_mark_branch_flt_arc
(reference branch.c:48-106), in PyTorch, for holding the port's branch
block (ops/loop_kernels.branch_block and its CUDA kernel) to it.

It takes what the device loop's branch block takes: a v-sorted arc table
(arc_vw int64 [A], vw = v << B | w, empty slots SENT at the end; arc_s1
int32 [A]), the representative planes of the genes, gene-major
[n_gene, G] (presence bool, contig int32, cm int64, kept-hit rank int32 of
each gene's last kept hit in each genome), each arc's target gene (tgt_gid
int64 [A]) and the options. A group is a run of valid arcs of one source
vertex v; a group of two or more branches. Every pair of members of every
group is tested, whatever the group's size: the pair is local when some
genome holds both targets' representatives, on one contig unless
frag_mode, within local_dist of cm or local_count of rank (pg_n_local,
branch.c:31-46). Each branching arc's deficit is 1.0 - s1 / mx in torch
float64, mx the group's largest s1 (at least 0), as the C code computes it
(branch.c:61-78): above branch_diff a weak candidate (class 1), cut (class
2) when it is also above branch_diff_cut, or above branch_diff_dist with no
local partner of score mx. n_grp, at a group's first arc, is the vertex's
count of distant loci (branch.c:82-90): its members with no earlier local
partner. counts are the marked locally and distantly diverged branches
(classes 1 and 2).

Written from the reference's description alone: it imports only torch and
numpy, and nothing of the port's kernels, their plain versions or
softfloat.
"""
from __future__ import annotations

import numpy as np
import torch

SENT = (1 << 62) - 1          # an empty slot of the arc table
PAIR_CHUNK = 1 << 14          # pairs tested at a time


def groups_of(arc_vw: torch.Tensor, B: int):
    """(start, size) of each group of the v-sorted table, int64 numpy: runs
    of valid arcs of one source vertex."""
    vw = arc_vw.cpu().numpy()
    valid = np.flatnonzero(vw != SENT)
    if not len(valid):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    v = vw[valid] >> B
    head = np.flatnonzero(np.r_[True, (v[1:] != v[:-1])
                                | (valid[1:] != valid[:-1] + 1)])
    size = np.diff(np.r_[head, len(valid)])
    return valid[head].astype(np.int64), size.astype(np.int64)


def all_pairs(start: np.ndarray, size: np.ndarray):
    """Arc indices (a, b), a < b, of every pair of members of each group."""
    a, b = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for s, n in zip(start.tolist(), size.tolist()):
        if n >= 2:
            i, j = np.triu_indices(n, 1)
            a.append(s + i)
            b.append(s + j)
    return np.concatenate(a), np.concatenate(b)


def n_local(r_pres, r_cid, r_cm, r_rank, ta, tb, *, frag_mode: bool,
            local_dist: int, local_count: int) -> torch.Tensor:
    """The genomes in which genes ta and tb (int64 [P]) are local, [P]."""
    ok = r_pres[ta] & r_pres[tb]
    if not frag_mode:
        ok &= r_cid[ta] == r_cid[tb]
    near = ((r_cm[ta] - r_cm[tb]).abs() <= local_dist) \
        | ((r_rank[ta].to(torch.int64) - r_rank[tb].to(torch.int64)).abs()
           <= local_count)
    return (ok & near).sum(dim=1)


def mark_branch(r_pres, r_cid, r_cm, r_rank, tgt_gid, arc_vw, arc_s1, *,
                B: int, frag_mode: bool, local_dist: int, local_count: int,
                branch_diff: float, branch_diff_dist: float,
                branch_diff_cut: float):
    """(aw uint8 [A]: each arc's class, n_grp int32 [A]: each group's
    distant-loci count at its first arc and 0 elsewhere, counts int64 [2]:
    the arcs of class 1 and of class 2)."""
    dev = arc_vw.device
    A = arc_vw.shape[0]
    start, size = groups_of(arc_vw, B)
    s1 = arc_s1.cpu().numpy().astype(np.int64)
    # each member's group's largest s1 (at least 0); the branching members
    member = np.concatenate([np.arange(s, s + n) for s, n in
                             zip(start.tolist(), size.tolist())]
                            or [np.zeros(0, np.int64)]).astype(np.int64)
    first = np.cumsum(np.r_[0, size[:-1]]).astype(np.int64)
    mx_np = np.zeros(A, np.int64)
    br_np = np.zeros(A, bool)
    if len(member):
        mx_np[member] = np.repeat(
            np.maximum(np.maximum.reduceat(s1[member], first), 0), size)
        br_np[member] = np.repeat(size >= 2, size)
    mx = torch.from_numpy(mx_np).to(dev)
    branching = torch.from_numpy(br_np).to(dev)
    s1 = arc_s1.to(torch.int64)
    is_max = branching & (s1 == mx)
    aml = torch.zeros(A, dtype=torch.bool, device=dev)
    he = torch.zeros(A, dtype=torch.bool, device=dev)
    pa, pb = all_pairs(start, size)
    for c in range(0, len(pa), PAIR_CHUNK):
        a = torch.from_numpy(pa[c:c + PAIR_CHUNK]).to(dev)
        b = torch.from_numpy(pb[c:c + PAIR_CHUNK]).to(dev)
        loc = n_local(r_pres, r_cid, r_cm, r_rank, tgt_gid[a], tgt_gid[b],
                      frag_mode=frag_mode, local_dist=local_dist,
                      local_count=local_count) > 0
        aml[a[loc & is_max[b]]] = True
        aml[b[loc & is_max[a]]] = True
        he[b[loc]] = True
    pos = mx > 0
    deficit = 1.0 - s1.to(torch.float64) / torch.where(pos, mx, 1) \
        .to(torch.float64)
    cand = branching & pos & (deficit > branch_diff)
    cut = cand & ((~aml & (deficit > branch_diff_dist))
                  | (deficit > branch_diff_cut))
    aw = cand.to(torch.uint8) + cut.to(torch.uint8)
    n_grp = np.zeros(A, np.int32)
    if len(member):
        free = ~he.cpu().numpy()[member]
        n_grp[start] = np.where(size >= 2,
                                np.add.reduceat(free.astype(np.int32), first),
                                0)
    counts = torch.stack([(cand & ~cut).sum(), cut.sum()]).to(torch.int64)
    return aw, torch.from_numpy(n_grp).to(dev), counts
