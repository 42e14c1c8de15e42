"""The port's split sweep forms (pangene_tpu_torch/ops/device.py) against
the JAX package's (pangene_tpu/ops/device.py), and the batched sweep's
plain version against the per-genome plain version.

The same H-padded columns, made from a numpy seed, go through
sweep_geo_planes and shadow_round_kernel of both packages; planes, marks,
dominator scores and indices must be exactly equal (tolerance 0). The
port's functions carry a leading genome axis where the JAX package vmaps.
colsort_i64 is held bitwise against torch.sort and against the JAX one.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pangene_tpu.ops import device as jdev
from pangene_tpu.ops import device_engine as jde
from pangene_tpu_torch import testing as ptesting
from pangene_tpu_torch.ops import device as tdev
from pangene_tpu_torch.ops import device_engine as tde
from pangene_tpu_torch.ops import sweep_kernel as sk

from test_device_engine import random_genome

# small tensors: one torch thread per test process, so that several test
# workers on one machine do not contend for its cores
torch.set_num_threads(1)

H, K, W = 256, 4, 32       # common static shapes: one XLA compile per option
SEEDS = (0, 1, 2, 3)

jax_geo = jax.jit(jdev.sweep_geo_planes,
                  static_argnames=("min_ov_ratio", "W", "check_strand"))
jax_round = jax.jit(jdev.shadow_round_kernel, static_argnames=("W",))


@functools.lru_cache(maxsize=None)
def jax_cols(seed, weak):
    d, g = random_genome(np.random.default_rng(seed), n_hits=150, weak=weak)
    h, k, w = jde._shapes(d, g)
    assert h <= H and k <= K and w <= W
    return jde.build_cols(d, g, H, K)


def T(a):
    return torch.from_numpy(np.array(a))


def biased(ps):
    return T(np.asarray(ps).view(np.int64) ^ np.int64(-(1 << 63)))


def round_cols(cs_list):
    """JAX SweepCols of several genomes -> one batched RoundCols."""
    st = lambda f: torch.stack([f(c) for c in cs_list])
    return tdev.RoundCols(
        valid=st(lambda c: T(c.valid)), cid=st(lambda c: T(c.cid)),
        cs=st(lambda c: T(c.cs)), ce=st(lambda c: T(c.ce)),
        rev=st(lambda c: T(c.rev).to(torch.uint8)),
        rank=st(lambda c: T(c.rank)), gid=st(lambda c: T(c.gid)),
        pscore=st(lambda c: biased(c.pscore)),
        cds_len=st(lambda c: T(c.cds_len)),
        ex_os=st(lambda c: T(c.ex_os)), ex_oe=st(lambda c: T(c.ex_oe)))


def raw(score):
    return score.numpy().view(np.uint64) ^ np.uint64(1 << 63)


@pytest.mark.parametrize("f", [0.5, 0.3])
@pytest.mark.parametrize("check_strand", [False, True])
def test_geo_planes_and_round_kernel_equal_jax(check_strand, f):
    cs_list = [jax_cols(seed, True) for seed in SEEDS]
    planes = tdev.sweep_geo_planes(round_cols(cs_list), f, W, check_strand)
    assert planes.dtype == torch.uint8 and planes.shape == (len(SEEDS), W, H)
    rng = np.random.default_rng(17)
    flt = np.stack([np.asarray(c.flt) | (rng.random(H) < 0.1)
                    for c in cs_list])
    weak = np.stack([np.asarray(c.weak_br) for c in cs_list])
    marks, score, other = tdev.shadow_round_kernel(
        T(flt), T(weak), torch.stack([biased(c.pscore) for c in cs_list]),
        planes, W)
    assert marks.any() and (weak > 0).any() and flt.any()
    for j, c in enumerate(cs_list):
        jp = jax_geo(c, min_ov_ratio=f, W=W, check_strand=check_strand)
        np.testing.assert_array_equal(planes[j].numpy(), np.asarray(jp))
        jm, js, jo = jax_round(jnp.asarray(flt[j]), jnp.asarray(weak[j]),
                               c.pscore, jp, W=W)
        np.testing.assert_array_equal(marks[j].numpy(), np.asarray(jm))
        np.testing.assert_array_equal(raw(score[j]), np.asarray(js))
        np.testing.assert_array_equal(other[j].numpy(), np.asarray(jo))


def test_round_kernel_equals_jax_fused_kernel():
    """Unsplit check: geo planes + round pass equal the JAX package's fused
    shadow_kernel on the genome's own flt and weak."""
    c = jax_cols(5, True)
    jm, js, jo, _ = jdev.shadow_kernel(c, 0.5, W, False)
    rc = round_cols([c])
    planes = tdev.sweep_geo_planes(rc, 0.5, W, False)
    m, s, o = tdev.shadow_round_kernel(T(c.flt)[None], T(c.weak_br)[None],
                                       rc.pscore, planes, W)
    np.testing.assert_array_equal(m[0].numpy(), np.asarray(jm))
    np.testing.assert_array_equal(raw(s[0]), np.asarray(js))
    np.testing.assert_array_equal(o[0].numpy(), np.asarray(jo))


def test_gather_exons_equals_jax_columns():
    d, g = ptesting.random_genome(np.random.default_rng(3), n_hits=150)
    bc, _, _, _ = ptesting.batch_cols([(d, g)], torch.device("cpu"), H=H)
    os_, oe_ = tdev.gather_exons(bc.off_exon, bc.n_exon, bc.cs, bc.exon_os,
                                 bc.exon_oe, K)
    c = jax_cols(3, False)
    np.testing.assert_array_equal(os_[0].numpy(), np.asarray(c.ex_os))
    np.testing.assert_array_equal(oe_[0].numpy(), np.asarray(c.ex_oe))


def genome_set(seeds, weak=True, sizes=(150, 40, 0, 90, 1)):
    out = []
    for seed, n in zip(seeds, sizes):
        out.append(ptesting.random_genome(np.random.default_rng(seed),
                                          n_hits=n, weak=weak))
    return out


@pytest.mark.parametrize("f", [0.5, 0.3])
@pytest.mark.parametrize("check_strand", [False, True])
@pytest.mark.parametrize("seed0", [0, 10])
def test_batched_plain_equals_per_genome_plain(seed0, check_strand, f):
    """Two plain versions of one function: the batched split form and the
    per-genome fused form, genome by genome (an empty genome and a one-hit
    genome among them), under a second filter state too."""
    genomes = genome_set(range(seed0, seed0 + 5))
    cpu = torch.device("cpu")
    bc, flt, weak, Wb = ptesting.batch_cols(genomes, cpu)
    geo = {}
    rng = np.random.default_rng(seed0)
    for state in range(2):
        if state:
            flt = flt | T(rng.random(flt.shape) < 0.2).to(torch.uint8)
        sk.reset_counts()
        marks, score, other = sk.shadow_sweep_batched(
            bc, flt, weak, Wb, check_strand, f, geo)
        assert sk.n_batched() == {"kernel": 0, "plain": 1}
        assert marks.dtype == torch.uint8 and score.dtype == torch.int64 \
            and other.dtype == torch.int32
        for j, (d, g) in enumerate(genomes):
            n = g.n_hit
            cols = tde.build_cols(d, g, cpu)._replace(
                flt=flt[j, :n].contiguous())
            m, s, o, _ = sk.shadow_sweep_plain(cols, Wb, sk.SHADOW,
                                               check_strand, f)
            assert torch.equal(marks[j, :n], m)
            assert torch.equal(score[j, :n], s)
            assert torch.equal(other[j, :n], o)
            assert not marks[j, n:].any()
            assert (score[j, n:] == sk.SCORE_NONE).all()
            assert (other[j, n:] == sk.OTHER_NONE).all()
        assert marks.any()
    sk.reset_counts()


# "2000 exons" is left to the card test: the split form's [G, H, K, K] exon
# block with K = 2000 takes gigabytes
@pytest.mark.parametrize("case", [c for c in ptesting.SWEEP_EDGE_CASES
                                  if c != "2000 exons"])
def test_batched_plain_on_stacked_edge_cases(case):
    """The kernel's edge-case genomes, each stacked with a random genome
    and an empty one: batched plain == per-genome plain."""
    genomes = [ptesting.sweep_edge_case(case),
               ptesting.random_genome(np.random.default_rng(1), n_hits=70),
               ptesting.random_genome(np.random.default_rng(2), n_hits=0)]
    cpu = torch.device("cpu")
    bc, flt, weak, Wb = ptesting.batch_cols(genomes, cpu)
    marks, score, other = sk.shadow_sweep_batched(bc, flt, weak, Wb, False,
                                                  0.3)
    for j, (d, g) in enumerate(genomes):
        n = g.n_hit
        m, s, o, _ = sk.shadow_sweep_plain(tde.build_cols(d, g, cpu), Wb,
                                           sk.SHADOW, False, 0.3)
        assert torch.equal(marks[j, :n], m) and torch.equal(score[j, :n], s)
        assert torch.equal(other[j, :n], o)
    sk.reset_counts()


def test_batched_checks():
    genomes = genome_set(range(3))
    bc, flt, weak, Wb = ptesting.batch_cols(genomes, torch.device("cpu"))
    with pytest.raises(ValueError):
        sk.shadow_sweep_batched(bc, flt, weak, 0, False, 0.5)
    with pytest.raises(ValueError):
        sk.shadow_sweep_batched(bc, flt.to(torch.int32), weak, Wb, False, 0.5)
    with pytest.raises(ValueError):
        sk.shadow_sweep_batched(bc, flt[:, :-1], weak, Wb, False, 0.5)
    with pytest.raises(ValueError):
        sk.shadow_sweep_batched(bc._replace(cs=bc.cs.to(torch.int32)), flt,
                                weak, Wb, False, 0.5)
    sk.reset_counts()


@pytest.mark.parametrize("n,c", [(8 * 8 * 13, 8), (16 * 16 * 29, 16),
                                 (1 << 16, 0)])
def test_colsort_equals_sort_and_jax(n, c):
    c = c or tdev.colsort_cols(n)
    assert c == jdev.colsort_cols(n) and c >= 8
    rng = np.random.default_rng(n)
    x = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
    x[:n // 4] = x[n // 4:n // 2]          # ties
    got = tdev.colsort_i64(T(x), c)
    assert torch.equal(got, torch.sort(T(x)).values)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jdev.colsort_i64(jnp.asarray(x),
                                                              c)))


def test_next_pow2_and_pad_cid_equal_jax():
    for n in (0, 1, 2, 7, 8, 9, 1000, 1 << 20):
        for lo in (2, 8):
            assert tdev.next_pow2(n, lo) == jdev.next_pow2(n, lo)
    assert tdev.PAD_CID == jdev.PAD_CID
    for n in (64, 4096, 1 << 20, 1310720, 1000):
        assert tdev.colsort_cols(n) == jdev.colsort_cols(n)
