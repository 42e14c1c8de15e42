"""The split forms of the shadow sweep, batched over genomes, in plain torch.

The counterpart of pangene_tpu/ops/device.py for the device-resident loop
(parallel/device_loop.py): the once-per-schedule geometry pass
(sweep_geo_planes) and the per-round pass (shadow_round_kernel). Every
tensor carries a leading genome axis; the JAX package vmaps the same
functions over it. Together they are the plain version of the batched CUDA
sweep (sweep_kernel.shadow_sweep_batched): the CPU tests and ``--device
cpu`` run them, and with a CUDA device nothing on the main path does.

The packed score travels as int64 ``u ^ (1 << 63)`` (ops/sweep_kernel.py),
so "no dominator" is SCORE_NONE where the JAX package has the raw 0.

colsort_i64 is Leighton's columnsort as the JAX package has it: a layout
workaround of another machine, held bitwise against torch.sort by the tests
and timed by chip_smoke.py; nothing on the main path calls it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import softfloat as sf
from .sweep_kernel import OTHER_NONE, SCORE_NONE

PAD_CID = np.int32(1 << 30)


def next_pow2(n: int, lo: int = 8) -> int:
    n = max(n, lo)
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# columnsort: a 1-D sort as batched row sorts
# ---------------------------------------------------------------------------

def colsort_cols(n: int) -> int:
    """Largest power-of-2 column count c (<= 64) for which Leighton's
    columnsort is valid on n keys: c | n, c | (n/c) and n/c >= 2(c-1)^2.
    0 when no c >= 8 qualifies."""
    for c in (64, 32, 16, 8):
        r = n // c
        if n % c == 0 and r % c == 0 and r >= 2 * (c - 1) ** 2:
            return c
    return 0


def colsort_i64(x: torch.Tensor, c: int) -> torch.Tensor:
    """Ascending sort of a flat int64 tensor via Leighton's 8-step
    columnsort: 4 row-sorts of [c, r] + 1 of [c+1, r] + 2 transposes + one
    shifted pass. Columnsort is a proven oblivious sorting network, so the
    values come out in the one ascending order: bitwise what torch.sort
    gives. The flat tensor is read as the column-major layout of the
    classical r x c matrix; each row of the [c, r] working tensor is one
    classical column. Needs c | r and r >= 2(c-1)^2 (colsort_cols)."""
    n = x.shape[0]
    r = n // c
    R = x.reshape(c, r)
    R = torch.sort(R, dim=1).values                   # 1. sort columns
    R = R.reshape(r, c).T                             # 2. transpose
    R = torch.sort(R, dim=1).values                   # 3. sort columns
    R = R.T.reshape(c, r)                             # 4. untranspose
    R = torch.sort(R, dim=1).values                   # 5. sort columns
    info = torch.iinfo(torch.int64)
    lo = x.new_full((r // 2,), info.min)
    hi = x.new_full((r - r // 2,), info.max)
    z = torch.cat([lo, R.reshape(-1), hi])            # 6. shift r/2
    z = torch.sort(z.reshape(c + 1, r), dim=1).values  # 7. sort columns
    return z.reshape(-1)[r // 2:r // 2 + n]           # 8. unshift


# ---------------------------------------------------------------------------
# the split sweep
# ---------------------------------------------------------------------------

class RoundCols(NamedTuple):
    """H-padded static per-hit columns of G cs-sorted genomes."""
    valid: torch.Tensor     # bool [G, H]
    cid: torch.Tensor       # int32 [G, H] (pad PAD_CID)
    cs: torch.Tensor        # int64 [G, H]
    ce: torch.Tensor        # int64 [G, H] (pad -1)
    rev: torch.Tensor       # uint8 [G, H]
    rank: torch.Tensor      # int32 [G, H]
    gid: torch.Tensor       # int32 [G, H]
    pscore: torch.Tensor    # int64 [G, H], biased packed score
    cds_len: torch.Tensor   # int32 [G, H]
    ex_os: torch.Tensor     # int64 [G, H, K] absolute exon starts (pad 0)
    ex_oe: torch.Tensor     # int64 [G, H, K]


def gather_exons(off_exon: torch.Tensor, n_exon: torch.Tensor,
                 cs: torch.Tensor, exon_os: torch.Tensor,
                 exon_oe: torch.Tensor, K: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute exon windows [G, H, K] from each genome's CSR exon pool
    [G, E] (coordinates relative to the hit's cs); slots past n_exon are
    the empty window (0, 0)."""
    G, H = off_exon.shape
    E = exon_os.shape[1]
    kk = torch.arange(K, device=cs.device)
    emask = kk[None, None, :] < n_exon.long()[:, :, None]
    if E == 0:
        z = torch.zeros((G, H, K), dtype=torch.int64, device=cs.device)
        return z, z.clone()
    idx = (off_exon.long()[:, :, None] + kk).clamp(0, E - 1).reshape(G, -1)
    zero = torch.zeros((), dtype=torch.int64, device=cs.device)
    out = []
    for pool in (exon_os, exon_oe):
        a = torch.gather(pool.long(), 1, idx).reshape(G, H, K)
        out.append(torch.where(emask, a + cs.long()[:, :, None], zero))
    return out[0], out[1]


def _shift_prev(arr: torch.Tensor, delta: int, fill) -> torch.Tensor:
    """out[:, i] = arr[:, i - delta] (fill outside)."""
    out = torch.full_like(arr, fill)
    H = arr.shape[1]
    if delta < H:
        out[:, delta:] = arr[:, :H - delta]
    return out


def _shift_next(arr: torch.Tensor, delta: int, fill) -> torch.Tensor:
    """out[:, j] = arr[:, j + delta] (fill outside)."""
    out = torch.full_like(arr, fill)
    H = arr.shape[1]
    if delta < H:
        out[:, :H - delta] = arr[:, delta:]
    return out


def _pair_geo(c: RoundCols, delta: int, check_strand: bool):
    """Round-invariant pair gates + exact CDS intersection for
    (j = i - delta, i): everything except the flt terms."""
    jvalid = _shift_prev(c.valid, delta, False)
    cid_j = _shift_prev(c.cid, delta, int(PAD_CID))
    ce_j = _shift_prev(c.ce, delta, -1)
    mask = c.valid & jvalid & (cid_j == c.cid) & (ce_j > c.cs)
    if check_strand:
        # a row shifted in from outside is already masked by jvalid
        mask &= _shift_prev(c.rev, delta, 0) == c.rev
    # exact intersection: sum over exon pairs of relu(min(end)-max(start))
    os_j = _shift_prev(c.ex_os, delta, 0)
    oe_j = _shift_prev(c.ex_oe, delta, 0)
    lo = torch.maximum(c.ex_os[:, :, :, None], os_j[:, :, None, :])
    hi = torch.minimum(c.ex_oe[:, :, :, None], oe_j[:, :, None, :])
    ov = (hi - lo).clamp(min=0).sum(dim=(2, 3))
    mask &= ov > 0
    return mask, ov


def sweep_geo_planes(c: RoundCols, min_ov_ratio: float, W: int,
                     check_strand: bool) -> torch.Tensor:
    """The round-invariant part of the shadow sweep (overlap.c:101-156):
    for each delta = 1..W one uint8 plane, [G, W, H] in all, with
      bit0  pair passes every flt/weak-independent gate (valid, same cid,
            ce_j > cs_i, strand, ov > 0, and the exact cov_short gate
            ``same_gene | !(ov/min(li,lj) < min_ov_ratio)``),
      bit1  same_gene,
      bit2  score_i_loses (packed-score/rank tie order, overlap.c:139-142).
    The exon K^2 intersection, the softfloat division and the score
    compares run once per schedule; shadow_round_kernel is left with
    bitwise work."""
    planes = []
    for delta in range(1, W + 1):
        geo, ov = _pair_geo(c, delta, check_strand)
        gid_j = _shift_prev(c.gid, delta, -1)
        ps_j = _shift_prev(c.pscore, delta, SCORE_NONE)
        rank_j = _shift_prev(c.rank, delta, 0)
        len_j = _shift_prev(c.cds_len, delta, 1)
        same_gene = gid_j == c.gid
        minlen = torch.minimum(c.cds_len, len_j).clamp(min=1)
        qm, qk = sf.div_rn(ov, minlen.long())
        cov_ok = ~sf.lt_const(qm, qk, min_ov_ratio)
        geo &= same_gene | cov_ok
        s_il = (c.pscore < ps_j) | ((c.pscore == ps_j) & (c.rank > rank_j))
        planes.append(geo.to(torch.uint8) | (same_gene.to(torch.uint8) << 1)
                      | (s_il.to(torch.uint8) << 2))
    return torch.stack(planes, dim=1)


def shadow_round_kernel(flt: torch.Tensor, weak: torch.Tensor,
                        pscore: torch.Tensor, planes: torch.Tensor, W: int):
    """Per-round shadow sweep over precomputed geometry planes: the flt
    mask, the weak_br loser selection (overlap.c:143-147) and the dominator
    argmax. flt bool [G, H], weak any integer type [G, H]. Returns (marks
    bool, best_score int64 biased, best_other int32), [G, H] each."""
    G, H = flt.shape
    dev = flt.device
    weak = weak.to(torch.int32)
    marks = torch.zeros_like(flt)
    b_score = torch.full((G, H), SCORE_NONE, dtype=torch.int64, device=dev)
    b_other = torch.full((G, H), OTHER_NONE, dtype=torch.int32, device=dev)
    rows = torch.arange(H, dtype=torch.int32, device=dev)[None, :]
    for delta in range(1, W + 1):
        plane = planes[:, delta - 1]
        geo = (plane & 1) != 0
        same_gene = (plane & 2) != 0
        s_il = (plane & 4) != 0
        flt_j = _shift_prev(flt, delta, True)
        weak_j = _shift_prev(weak, delta, 0)
        mask = geo & ~flt & ~flt_j
        i_loses = torch.where(same_gene | (weak == weak_j), s_il,
                              weak > weak_j)
        ps_j = _shift_prev(pscore, delta, SCORE_NONE)
        other_j = rows - delta
        cand_i = mask & i_loses
        marks = marks | cand_i
        upd = cand_i & ((ps_j > b_score) | ((ps_j == b_score)
                                            & (other_j < b_other)))
        b_score = torch.where(upd, ps_j, b_score)
        b_other = torch.where(upd, other_j, b_other)
        cand_j_at_i = mask & ~i_loses
        cand_j = _shift_next(cand_j_at_i, delta, False)
        marks = marks | cand_j
        sc_j = _shift_next(pscore.masked_fill(~cand_j_at_i, SCORE_NONE),
                           delta, SCORE_NONE)
        other_i = rows + delta
        upd = cand_j & ((sc_j > b_score) | ((sc_j == b_score)
                                            & (other_i < b_other)))
        b_score = torch.where(upd, sc_j, b_score)
        b_other = torch.where(upd, other_i, b_other)
    return marks, b_score, b_other
