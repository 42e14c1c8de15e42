"""The batched sweep's fused epilogues (pangene_tpu_torch/ops/sweep_kernel.py:
sweep_round_loop, sweep_round_step; here on the CPU, their plain versions:
shadow_sweep_batched_plain then sweep_epilogue_plain) against the JAX
package:

  LOOP  the device loop's sweep block: pangene_tpu/ops/device.py
        sweep_geo_planes + shadow_round_kernel, vmapped over the genomes,
        then the epilogue of pangene_tpu/parallel/device_loop.py:758-775
        written out in jnp below (the stale-flag merge into shadow, the
        dominators' pid into pid_dom), on every row of the [G, H] planes.
  STEP  the per-round step's sweep: the shadow, dominator score and index
        of pangene_tpu/parallel/stacked.py:_genome_round, vmapped, and its
        (cid, cm) sort key (stacked.py:78-79) in jnp.

Cases: random genome sets (an empty genome and a one-hit genome among
them, rows padded past the longest genome, whose flt is 0), every genome's
hit 0 filtered, a genome all filtered, a sparse genome whose rows mostly
have no dominator, both strand gates and two coverage ratios. Inputs come
from numpy seeds; every comparison is exact (tolerance 0).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangene_tpu.ops import device as jdev
from pangene_tpu.parallel import stacked as jst
from pangene_tpu_torch import testing as ptesting
from pangene_tpu_torch.ops import sweep_kernel as sk

from test_torch_step_kernels import CPU, jax_genome_round, port_round_step

# small tensors: one torch thread per test process, so that several test
# workers on one machine do not contend for its cores
torch.set_num_threads(1)

H, K, W = 256, 4, 32       # one XLA compile per option set
BIAS = np.uint64(1 << 63)


@functools.lru_cache(maxsize=None)
def jax_loop_sweep(f, check_strand):
    """The loop's sweep block in JAX over [G, H] columns: the vmapped split
    sweep forms, then the epilogue of device_loop.py:767-775."""
    def one(cols, off, ne, ex_os, ex_oe, flt, weak):
        abs_os, abs_oe = jst._gather_exons(off, ne, cols["cs"], ex_os, ex_oe,
                                           K)
        sc = jdev.SweepCols(
            valid=cols["valid"], cid=cols["cid"], cs=cols["cs"],
            ce=cols["ce"], flt=flt != 0, rev=cols["rev"].astype(jnp.int32),
            rank=cols["rank"], gid=cols["gid"], pscore=cols["pscore"],
            weak_br=weak.astype(jnp.int32), cds_len=cols["cds_len"],
            ex_os=abs_os, ex_oe=abs_oe)
        planes = jdev.sweep_geo_planes(sc, f, W=W, check_strand=check_strand)
        return jdev.shadow_round_kernel(flt != 0, weak.astype(jnp.int32),
                                        cols["pscore"], planes, W)

    def block(cols, off, ne, ex_os, ex_oe, flt, weak, shadow, pid_dom):
        marks, b_score, b_other = jax.vmap(one)(cols, off, ne, ex_os, ex_oe,
                                                flt, weak)
        nonflt = flt == 0
        evaluated = nonflt & (cols["ev1"] != 0) & cols["valid"]
        shadow_n = jnp.where(evaluated, marks,
                             (shadow != 0) | marks).astype(jnp.uint8)
        otherc = jnp.clip(b_other, 0, H - 1)
        has_dom = nonflt & (b_score > jnp.uint64(0))
        pid_o = jnp.take_along_axis(cols["pid"], otherc, axis=1)
        pid_n = jnp.where(nonflt, -1, pid_dom)
        pid_n = jnp.where(has_dom, pid_o, pid_n).astype(jnp.int32)
        return shadow_n, pid_n, b_score

    return jax.jit(block)


def genome_set(case, seed):
    sizes = (150, 40, 0, 90, 1)
    max_cs = (lambda n: 10 ** 7) if case == "sparse" else \
        (lambda n: 30 * n + 100)
    genomes = [ptesting.random_genome(np.random.default_rng(seed + k),
                                      n_hits=n, weak=True,
                                      max_cs=max_cs(n))
               for k, n in enumerate(sizes)]
    for d, g in genomes:
        if case == "hit0_filtered" and g.n_hit:
            g.hits.flt[0] = 1
    if case == "all_filtered":
        genomes[0][1].hits.flt[:] = 1
    return genomes


LOOP_CASES = ("random", "hit0_filtered", "all_filtered", "sparse")


@pytest.mark.parametrize("f", [0.5, 0.3])
@pytest.mark.parametrize("check_strand", [False, True])
@pytest.mark.parametrize("case", LOOP_CASES)
def test_loop_epilogue_equals_jax(case, check_strand, f):
    """sweep_round_loop (shadow and pid_dom in place) against the JAX
    sweep block, every row of both planes."""
    seed = 10 * LOOP_CASES.index(case)
    args = ptesting.loop_sweep_args(genome_set(case, seed), CPU, seed=seed,
                                    H=H)
    bc, flt, weak, Wb, shadow, pid_dom, ev1, pid = args
    assert Wb <= W and int(bc.n_exon.max()) <= K
    n = lambda t: t.numpy()
    cols = {"valid": np.arange(H)[None, :] < n(bc.n_rows)[:, None],
            "cid": n(bc.cid), "cs": n(bc.cs), "ce": n(bc.ce),
            "rev": n(bc.rev), "rank": n(bc.rank), "gid": n(bc.gid),
            "pscore": n(bc.pscore).view(np.uint64) ^ BIAS,
            "cds_len": n(bc.cds_len), "ev1": n(ev1), "pid": n(pid)}
    j = jnp.asarray
    want_sh, want_pd, j_score = jax_loop_sweep(f, check_strand)(
        {k: j(v) for k, v in cols.items()}, j(n(bc.off_exon)),
        j(n(bc.n_exon)), j(n(bc.exon_os)), j(n(bc.exon_oe)), j(n(flt)),
        j(n(weak)), j(n(shadow)), j(n(pid_dom)))
    sh, pd = shadow.clone(), pid_dom.clone()
    sk.reset_counts()
    sk.sweep_round_loop(bc, flt, weak, W, check_strand, f, sh, pd, ev1, pid)
    assert sk.n_fused["loop"] == {"kernel": 0, "plain": 1}
    assert sk.n_batched() == {"kernel": 0, "plain": 1}
    assert np.array_equal(sh.numpy(), np.asarray(want_sh))
    assert np.array_equal(pd.numpy(), np.asarray(want_pd))
    # what the case holds: padded unfiltered rows, rows with and without a
    # dominator, a stale flag that survives
    nonflt = n(flt) == 0
    has_dom = np.asarray(j_score) > 0
    assert (nonflt & ~cols["valid"]).any()
    assert (nonflt & cols["valid"] & ~has_dom).any()
    if case != "sparse":
        assert (has_dom & nonflt).any()
    assert (n(shadow) == 2).any() and sh.numpy().max() <= 1
    assert not np.array_equal(pd.numpy(), n(pid_dom))
    sk.reset_counts()


@pytest.mark.parametrize("which", ["random", "hit0_filtered", "all_filtered",
                                   "empty", "cm_gap"])
def test_step_epilogue_equals_jax(which):
    """sweep_round_step (shadow in place, dominators, sort key) against
    JAX _genome_round's shadow, b_score and b_other, and the key of
    stacked.py:78-79, every row."""
    state = ptesting.step_state(which, 21, CPU)
    cols, flt, shadow, weak, g2s, _ = state
    bc = cols.batch
    sh = shadow.clone()
    sk.reset_counts()
    score, other, key = sk.sweep_round_step(bc, flt, weak, 16, False, 0.3,
                                            sh, cols.cm)
    assert sk.n_fused["step"] == {"kernel": 0, "plain": 1}
    want = jax_genome_round(state)
    assert np.array_equal(sh.numpy(), want[0])
    assert np.array_equal(score.numpy().view(np.uint64) ^ BIAS, want[1])
    assert np.array_equal(other.numpy(), want[2])
    Hs = flt.shape[1]
    valid = jnp.arange(Hs)[None, :] < jnp.asarray(bc.n_rows.numpy())[:, None]
    jkey = jnp.where(valid, (jnp.asarray(bc.cid.numpy()).astype(jnp.int64)
                             << jst.KEY_B) | jnp.asarray(cols.cm.numpy()),
                     jnp.int64(2 ** 62))
    assert np.array_equal(key.numpy(), np.asarray(jkey))
    # the same epilogue inside the whole step
    assert np.array_equal(port_round_step(state)["shadow"], want[0])
    sk.reset_counts()


def test_epilogue_plain_keeps_filtered_rows_pid_dom():
    """The loop's epilogue on hand-made planes: a filtered row keeps its
    pid_dom and its stale flag; an unfiltered one without a dominator gets
    -1; with one, the pid at its clamped index; a row past n_rows is never
    evaluated."""
    G, Hh = 1, 4
    marks = torch.tensor([[0, 1, 1, 0]], dtype=torch.uint8)
    score = torch.tensor([[sk.SCORE_NONE, 5, 7, sk.SCORE_NONE]])
    other = torch.tensor([[sk.OTHER_NONE, 3, 0, sk.OTHER_NONE]],
                         dtype=torch.int32)
    flt = torch.tensor([[0, 0, 1, 0]], dtype=torch.uint8)
    shadow = torch.tensor([[1, 0, 1, 1]], dtype=torch.uint8)
    pid_dom = torch.tensor([[9, 9, 9, 9]], dtype=torch.int32)
    pid = torch.tensor([[40, 41, 42, 43]], dtype=torch.int32)
    ev1 = torch.tensor([[1, 1, 1, 1]], dtype=torch.uint8)
    n_rows = torch.tensor([3], dtype=torch.int32)
    sk.sweep_epilogue_plain(marks, score, other, flt, shadow, n_rows,
                            ev1=ev1, pid=pid, pid_dom=pid_dom)
    assert shadow.tolist() == [[0, 1, 1, 1]]
    assert pid_dom.tolist() == [[-1, 43, 9, -1]]
    assert (G, Hh) == tuple(shadow.shape)
