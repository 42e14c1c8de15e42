"""The per-round step's kernels (pangene_tpu_torch/ops/step_kernels.py:
step_walk, step_dedupe; their plain versions here on the CPU), composed in
parallel/stacked.round_step with the fused sweep's STEP epilogue, against
the JAX package's per-genome round (pangene_tpu/parallel/stacked.py:
_genome_round, vmapped over the genomes), on the step states of
pangene_tpu_torch.testing (STEP_STATES: random genome sets, non-vertex
genes, cm gaps past 2^31, empty genomes, a genome all filtered, every hit 0
filtered, long runs of equal arcs, 300,000 genes, the kernels' tile edges),
with use_ori on and off.
Inputs are made from numpy seeds; every comparison is exact (tolerance 0:
the outputs are integers).

The card tests (tests/test_torch_cuda.py -m cuda) hold each kernel against
these plain versions.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangene_tpu.parallel import stacked as jst
from pangene_tpu_torch.ops import step_kernels as stk
from pangene_tpu_torch.ops import sweep_kernel as sk
from pangene_tpu_torch.parallel import stacked as st
from pangene_tpu_torch.testing import (GAP_TILE, STEP_STATES, step_calls,
                                       step_state)

# small tensors: one torch thread per test process, so that several test
# workers on one machine do not contend for its cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
BIAS = np.uint64(1 << 63)
W_STEP = 16          # one band for every state (>= each state's own): one
K_STEP = 4           # XLA compile per H, gene count and option set
F = 0.3


@functools.lru_cache(maxsize=None)
def jax_round(n_gene, W, K, check_strand, use_ori):
    """The JAX package's per-genome round, vmapped over genomes, jitted."""
    fn = functools.partial(jst._genome_round, min_ov_ratio=F, W=W, K=K,
                           check_strand=check_strand, use_ori=use_ori,
                           n_gene=n_gene)
    return jax.jit(jax.vmap(fn, in_axes=(0, 0, 0, None)))


def jax_genome_round(state, check_strand=False, use_ori=False):
    """_genome_round on a step state (testing.step_state's tuple, on the
    CPU), its inputs built from the port's columns: (shadow, b_score,
    b_other, uniq_x, cnt, dsum, m1, m2, cnts) as numpy arrays."""
    cols, flt, shadow, weak, g2s, W = state
    bc = cols.batch
    assert W <= W_STEP and int(bc.n_exon.max()) <= K_STEP
    n = lambda t: t.numpy()
    H = flt.shape[1]
    jc = {
        "valid": np.arange(H)[None, :] < n(bc.n_rows)[:, None],
        "cid": n(bc.cid), "cs": n(bc.cs), "ce": n(bc.ce), "flt": n(flt),
        "rev": n(bc.rev), "rank": n(bc.rank), "gid": n(bc.gid),
        "pscore": n(bc.pscore).view(np.uint64) ^ BIAS, "weak_br": n(weak),
        "cds_len": n(bc.cds_len), "off_exon": n(bc.off_exon),
        "n_exon": n(bc.n_exon), "shadow": n(shadow), "cm": n(cols.cm),
        "dom_gid": n(cols.dom_gid), "score_ori": n(cols.score_ori),
        "score_dom": n(cols.score_dom)}
    fn = jax_round(g2s.shape[0], W_STEP, K_STEP, check_strand, use_ori)
    outs = fn({k: jnp.asarray(v) for k, v in jc.items()},
              jnp.asarray(n(bc.exon_os)), jnp.asarray(n(bc.exon_oe)),
              jnp.asarray(n(g2s)))
    return [np.asarray(o) for o in outs]


def port_round_step(state, check_strand=False, use_ori=False):
    cols, flt, shadow, weak, g2s, W = state
    outs = st.round_step(cols, flt, shadow.clone(), weak, g2s, W=W_STEP,
                         min_ov_ratio=F, check_strand=check_strand,
                         use_ori=use_ori)
    return {name: o.numpy() for name, o in zip(st.STEP_OUTPUTS, outs)}


def assert_groups_equal(got, want):
    """The [G, 2H] group planes: every group row equal to JAX's (its m1 is
    at least -2^31 + 1; JAX's segment maximum of a row past the last group
    is int32 min), every row past them 0 in the port, as its plain segment
    sums and maxima leave them."""
    j_ux, j_cnt, j_dsum, j_m1, j_m2 = want
    groups = j_m1 > np.iinfo(np.int32).min
    for name, w in (("uniq_x", j_ux.view(np.int64)), ("cnt", j_cnt),
                    ("dsum", j_dsum), ("m1", j_m1), ("m2", j_m2)):
        g = got[name]
        assert np.array_equal(g[groups], w[groups].astype(g.dtype)), name
        assert not g[~groups].any(), name
    return groups


@pytest.mark.parametrize("use_ori", [False, True])
@pytest.mark.parametrize("which", STEP_STATES)
def test_round_step_equals_jax_genome_round(which, use_ori):
    """The port's step (the fused sweep's plain STEP epilogue, torch.sort,
    the plain step_walk, torch.sort, the plain step_dedupe) against the
    JAX round on the same state: the sweep's outputs on every row, every
    group row of the dedupe and the rows past it, the gene counters."""
    state = step_state(which, 11, CPU)
    sk.reset_counts()
    stk.reset_counts()
    got = port_round_step(state, use_ori=use_ori)
    assert sk.n_fused["step"] == {"kernel": 0, "plain": 1}
    assert stk.n_calls == {"step_walk": {"kernel": 0, "plain": 1},
                           "step_dedupe": {"kernel": 0, "plain": 1}}
    want = jax_genome_round(state, use_ori=use_ori)
    assert np.array_equal(got["shadow"], want[0])
    assert np.array_equal(got["b_score"].view(np.uint64) ^ BIAS, want[1])
    assert np.array_equal(got["b_other"], want[2])
    groups = assert_groups_equal(got, want[3:8])
    cnts = want[8]
    assert np.array_equal(got["tot_cnt"], cnts.sum(0))
    assert np.array_equal(got["n_genome"], (cnts > 0).sum(0))
    # each state holds what it is meant to
    assert got["cnt"].sum() > 0 and groups.any()
    if which in ("non_vertex", "random"):
        assert (got["uniq_x"][got["cnt"] > 0] < 0).any()
    if which == "repeats":
        assert got["cnt"].max() > 1024
    if which == "cm_gap":
        assert (np.abs(state[0].cm.numpy()[:, 1:]
                       - state[0].cm.numpy()[:, :-1]) > 2 ** 31).any()
    sk.reset_counts()
    stk.reset_counts()


@pytest.mark.parametrize("check_strand", [False, True])
def test_round_step_strand_equals_jax(check_strand):
    state = step_state("random", 12, CPU)
    got = port_round_step(state, check_strand=check_strand)
    want = jax_genome_round(state, check_strand=check_strand)
    assert np.array_equal(got["shadow"], want[0])
    assert np.array_equal(got["b_other"], want[2])
    assert_groups_equal(got, want[3:8])
    assert np.array_equal(got["tot_cnt"], want[8].sum(0))


@pytest.mark.parametrize("which", ["random", "repeats", "empty"])
def test_step_kernel_entries_on_the_cpu(which):
    """On the CPU each wrapper is its plain version, counted as a plain
    call; the dedupe's rows past each genome's groups are 0 and its groups
    are the distinct keys in order."""
    calls = step_calls(step_state(which, 13, CPU), CPU)
    stk.reset_counts()
    for name, (args, kw) in calls.items():
        got = getattr(stk, name)(*args, **kw)
        want = getattr(stk, name + "_plain")(*args, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert stk.n_calls == {"step_walk": {"kernel": 0, "plain": 1},
                           "step_dedupe": {"kernel": 0, "plain": 1}}
    xs = calls["step_dedupe"][0][0]
    uniq_x, cnt, dsum, m1, m2 = got
    for g in range(xs.shape[0]):
        keys = torch.unique_consecutive(xs[g])
        k = keys.shape[0]
        assert (m1[g, :k] >= stk.SCORE_FLOOR).all()
        for plane in got:
            assert not plane[g, k:].any()
        valid = cnt[g, :k] > 0
        assert torch.equal(uniq_x[g, :k][valid], keys[valid] ^ stk.BIAS)
    stk.reset_counts()


def test_step_walk_pairs_and_counters():
    """step_walk's contract on one state: each pair's two keys, its flag
    and its dist / scores at the same position; no pair, no key, no dist
    and no scores; the counters count the kept rows."""
    state = step_state("random", 14, CPU)
    (cols, perm, flt, shadow, g2s), kw = step_calls(state, CPU)["step_walk"]
    akey, pair_ok, dist, s1, s2, counts = stk.step_walk(
        cols, perm, flt, shadow, g2s, **kw)
    G, H = flt.shape
    ok = pair_ok != 0
    assert ok.any()
    # (a pair's key may itself be all ones: a non-vertex gene's, reverse)
    for half in (akey[:, :H], akey[:, H:]):
        assert not ((half != stk.NO_ARC) & ~ok).any()
    assert not dist[~ok].any() and not s1[~ok].any() and not s2[~ok].any()
    kept = ((flt == 0) & (shadow == 0)
            & (torch.arange(H)[None, :] < cols.batch.n_rows[:, None]))
    assert int(counts[0].sum()) == int(kept.sum())
    assert (counts[1] <= G).all() and (counts[1] <= counts[0]).all()


def test_step_wrappers_check_their_columns():
    calls = step_calls(step_state("random", 15, CPU), CPU)
    (cols, perm, flt, shadow, g2s), kw = calls["step_walk"]
    with pytest.raises(ValueError):
        stk.step_walk(cols, perm.to(torch.int32), flt, shadow, g2s, **kw)
    with pytest.raises(ValueError):
        stk.step_walk(cols, perm, flt, shadow[:, :-1], g2s, **kw)
    with pytest.raises(ValueError):
        stk.step_walk(cols, perm, flt, shadow, g2s[:0], **kw)
    args, _ = calls["step_dedupe"]
    with pytest.raises(ValueError):
        stk.step_dedupe(args[0].to(torch.int32), *args[1:])
    with pytest.raises(ValueError):
        stk.step_dedupe(*args[:3], args[3][:, :-1], *args[4:])
    with pytest.raises(ValueError):
        stk.step_walk(cols, perm.to("meta"), flt, shadow, g2s, **kw)


@pytest.mark.parametrize("which", [w for w in STEP_STATES
                                   if w.startswith("tile")])
def test_step_states_hold_their_edges(which):
    """Each tile state holds the edge it is named for at the kernels' tile
    (stk.TILE), on every seed the tests and chip_smoke.py draw it from:
    tile_gap a genome of at least four tiles with a whole tile of
    positions without a kept row between kept ones, and a group of valid
    arcs spanning at least three whole tiles of keys; tiles_4T*: H of
    4 TILE + d with genome 0 of H rows."""
    T = stk.TILE
    for seed in (5, 6, 8, 11, 300 + STEP_STATES.index(which)):
        calls = step_calls(step_state(which, seed, CPU), CPU)
        (cols, perm, flt, shadow, g2s), kw = calls["step_walk"]
        G, H = flt.shape
        n_rows = cols.batch.n_rows
        if which == "tile_gap":
            valid = torch.arange(H)[None, :] < n_rows[:, None]
            kept = torch.gather((flt == 0) & (shadow == 0) & valid, 1,
                                perm)[0]
            n = int(n_rows[0])
            assert n >= 4 * T
            tiles = kept[:n // T * T].view(-1, T).any(1)
            assert not tiles[GAP_TILE]
            assert tiles[:GAP_TILE].all() and tiles[GAP_TILE + 1:].all()
            cnt = stk.step_dedupe(*calls["step_dedupe"][0])[1]
            assert int(cnt[0].max()) >= 4 * T - 1
        else:
            d = int(which[len("tiles_4T"):] or 0)
            assert H == 4 * T + d and int(n_rows[0]) == H


def test_tile_mirrors_the_source():
    """stk.TILE is the kernels' tile in csrc/step_round.cu (kThreads x
    kRows); the card test test_step_tile_matches_the_library asks the
    built library."""
    import re
    with open(stk._SRC) as f:
        src = f.read()
    const = lambda name: int(re.search(
        r"constexpr int %s = (\d+);" % name, src).group(1))
    assert const("kThreads") * const("kRows") == stk.TILE
