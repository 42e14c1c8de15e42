"""The port's overlap sweep (pangene_tpu_torch/ops/sweep_kernel.py) against
the JAX package's sweeps on random genomes made from numpy seeds.

On the CPU the wrapper takes the kernel's plain PyTorch version; it is held
against the XLA kernels pangene_tpu.ops.device.shadow_kernel /
ov_isoform_kernel and, for dyadic overlap ratios, against the Pallas kernel
in interpret mode. Everything is integer or byte equality: tolerance 0.
tests/test_torch_cuda.py holds the CUDA kernel against the plain version.
"""
import numpy as np
import pytest
import torch

from pangene_tpu.core import data as jdata
from pangene_tpu.ops import device as jdev
from pangene_tpu.ops import device_engine as jde
from pangene_tpu.ops.pallas_sweep import dyadic_ratio, shadow_pallas_genome
from pangene_tpu_torch import testing as ptesting
from pangene_tpu_torch.core import data as pdata
from pangene_tpu_torch.ops import device_engine as tde
from pangene_tpu_torch.ops import sweep_kernel as sk
from pangene_tpu_torch.ops.overlap import cds_len_all

from test_device_engine import random_genome
from test_pallas import build_cols as pallas_cols

CPU = torch.device("cpu")


def port_genome(d, g, data=pdata):
    """Copy a (DataSet, Genome) into the classes of `data`: by default a
    JAX-package genome into the port's own classes."""
    d2 = data.DataSet.new()
    d2.__dict__.update({k: v for k, v in d.__dict__.items()
                        if k != "genomes"})
    g2 = data.Genome(g.label, list(g.ctg_names), g.ctg_len.copy(),
                     data.HitTable({k: v.copy()
                                    for k, v in g.hits.cols.items()}),
                     g.exon_os.copy(), g.exon_oe.copy())
    d2.genomes = [g2]
    return d2, g2


def raw_score(biased: torch.Tensor) -> np.ndarray:
    """Biased int64 packed score -> the reference's uint64."""
    return biased.numpy().view(np.uint64) ^ np.uint64(1 << 63)


def port_sweep(d, g, mode, check_strand, f, device=CPU):
    cols = tde.build_cols(d, g, device)
    W = sk.band_width(g.hits.cid, g.hits.cs, g.hits.ce)
    return cols, W, sk.shadow_sweep(cols, W, mode, check_strand, f)


@pytest.mark.parametrize("seed", range(3))
def test_random_genome_matches_jax_test_generator(seed):
    d, g = random_genome(np.random.default_rng(seed), weak=True)
    d2, g2 = ptesting.random_genome(np.random.default_rng(seed), weak=True)
    for k, v in g.hits.cols.items():
        np.testing.assert_array_equal(v, g2.hits.cols[k], err_msg=k)
    np.testing.assert_array_equal(g.exon_os, g2.exon_os)
    np.testing.assert_array_equal(g.exon_oe, g2.exon_oe)
    np.testing.assert_array_equal(np.asarray(d.gene_preferred),
                                  np.asarray(d2.gene_preferred))


@pytest.mark.parametrize("f", [0.5, 0.3, 0.9])
@pytest.mark.parametrize("weak", [False, True])
@pytest.mark.parametrize("check_strand", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_plain_shadow_vs_xla(seed, check_strand, weak, f):
    d, g = random_genome(np.random.default_rng(seed), n_hits=150, weak=weak)
    n = g.n_hit
    H, K, W = jde._shapes(d, g)
    jm, js, jo, jv = (np.asarray(a)[:n] for a in jdev.shadow_kernel(
        jde.build_cols(d, g, H, K), f, W, check_strand))
    d2, g2 = port_genome(d, g)
    cols, W2, (m, s, o, v) = port_sweep(d2, g2, sk.SHADOW, check_strand, f)
    assert W2 <= W
    np.testing.assert_array_equal(
        cols.pscore.numpy().view(np.uint64) ^ np.uint64(1 << 63),
        np.asarray(jde.build_cols(d, g, H, K).pscore)[:n])
    np.testing.assert_array_equal(m.numpy(), jm.astype(np.uint8))
    np.testing.assert_array_equal(raw_score(s), js)
    np.testing.assert_array_equal(o.numpy(), jo)
    np.testing.assert_array_equal(v.numpy(), jv)
    assert m.numpy().any()


@pytest.mark.parametrize("check_strand", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_plain_isoform_vs_xla(seed, check_strand):
    d, g = random_genome(np.random.default_rng(100 + seed), n_hits=150)
    n = g.n_hit
    H, K, W = jde._shapes(d, g)
    jm = np.asarray(jdev.ov_isoform_kernel(jde.build_cols(d, g, H, K), W,
                                           check_strand))[:n]
    d2, g2 = port_genome(d, g)
    _, _, (m, s, o, v) = port_sweep(d2, g2, sk.ISOFORM, check_strand, 0.0)
    np.testing.assert_array_equal(m.numpy(), jm.astype(np.uint8))
    assert m.numpy().any()


@pytest.mark.parametrize("check_strand", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_plain_shadow_vs_pallas(seed, check_strand):
    d, g = random_genome(np.random.default_rng(seed), n_hits=150,
                         weak=(seed % 2 == 0))
    n = g.n_hit
    cols_np, K = pallas_cols(d, g)
    W = jdev.band_width(g.hits.cid, np.asarray(g.hits.cs),
                        np.asarray(g.hits.ce))
    p, k = dyadic_ratio(0.5)
    pm, has, po, pv = shadow_pallas_genome(cols_np, K, W, n, check_strand,
                                           p, k, interpret=True)
    d2, g2 = port_genome(d, g)
    _, _, (m, s, o, v) = port_sweep(d2, g2, sk.SHADOW, check_strand, 0.5)
    np.testing.assert_array_equal(m.numpy().astype(bool), pm)
    got_has = s.numpy() > sk.SCORE_NONE
    np.testing.assert_array_equal(got_has, has)
    np.testing.assert_array_equal(o.numpy()[has], po[has])
    np.testing.assert_array_equal(v.numpy()[has], pv[has])


def test_plain_counts_and_checks():
    d, g = ptesting.random_genome(np.random.default_rng(5), n_hits=80)
    sk.reset_counts()
    cols, W, _ = port_sweep(d, g, sk.SHADOW, False, 0.5)
    port_sweep(d, g, sk.ISOFORM, False, 0.0)
    assert sk.n_plain_calls == {sk.SHADOW: 1, sk.ISOFORM: 1}
    assert sk.n_kernel_launches == {sk.SHADOW: 0, sk.ISOFORM: 0}
    with pytest.raises(ValueError):
        sk.shadow_sweep(cols._replace(cs=cols.cs.to(torch.int32)), W,
                        sk.SHADOW, False, 0.5)
    with pytest.raises(ValueError):
        sk.shadow_sweep(cols, W, 7, False, 0.5)
    sk.reset_counts()


def test_band_width_matches_jax():
    rng = np.random.default_rng(7)
    for _ in range(50):
        n = int(rng.integers(2, 80))
        cid = np.sort(rng.integers(0, 3, n)).astype(np.int32)
        cs = np.zeros(n, np.int64)
        for c in np.unique(cid):
            m = cid == c
            cs[m] = np.sort(rng.integers(0, 1000, int(m.sum())))
        ce = cs + rng.integers(1, 400, n)
        assert sk.band_width(cid, cs, ce) == jdev.band_width(cid, cs, ce)


def host_pack(d, g):
    return tde.pack_host(d, g, cds_len_all(g), pin=False)


def _assert_cols_equal(a, b):
    for name, x, y in zip(sk.SweepCols._fields, a, b):
        assert x.dtype == y.dtype == sk.COL_DTYPES[name], name
        assert torch.equal(x, y), name


@pytest.mark.parametrize("n_hits", [1, 63, 200])
def test_pack_round_trip(n_hits):
    d, g = ptesting.random_genome(np.random.default_rng(n_hits),
                                  n_hits=n_hits, weak=True)
    cols = tde.build_cols(d, g, CPU)
    # extreme biased scores survive the byte packing
    cols = cols._replace(pscore=cols.pscore.clone())
    cols.pscore[0] = sk.SCORE_NONE
    cols.pscore[-1] = (1 << 63) - 1
    buf = sk.pack_cols(cols)
    offs, total = sk.pack_layout(n_hits, cols.exon_os.shape[0])
    assert buf.dtype == torch.uint8 and buf.shape[0] == total
    assert all(off % sk.PACK_ALIGN == 0 for off in offs)
    _assert_cols_equal(sk.unpack_cols(buf, n_hits, cols.exon_os.shape[0]),
                       cols)
    # the host pack of the main path gives the same bytes as pack_cols
    assert torch.equal(host_pack(d, g),
                       sk.pack_cols(tde.build_cols(d, g, CPU)))


def test_pack_empty_exon_pool():
    """An empty exon pool packs, unpacks and sweeps to no candidate (the
    plain version used to index the empty pool and raise)."""
    d, g = ptesting.sweep_edge_case("no exons")
    n = g.n_hit
    cols = tde.build_cols(d, g, CPU)
    assert cols.exon_os.shape == (0,) and cols.exon_oe.shape == (0,)
    _assert_cols_equal(sk.unpack_cols(sk.pack_cols(cols), n, 0), cols)
    W = sk.band_width(g.hits.cid, g.hits.cs, g.hits.ce)
    out = sk.shadow_sweep_packed(host_pack(d, g), n, 0, W,
                                 sk.SHADOW, False, 0.5)
    marks, score, other, ov = sk.unpack_out(out, n)
    assert not marks.any() and (score == sk.SCORE_NONE).all()
    assert (other == sk.OTHER_NONE).all() and not ov.any()


@pytest.mark.parametrize("mode", [sk.SHADOW, sk.ISOFORM])
def test_plain_on_unpacked_equals_original(mode):
    d, g = ptesting.random_genome(np.random.default_rng(11), n_hits=300,
                                  weak=True)
    cols = tde.build_cols(d, g, CPU)
    W = sk.band_width(g.hits.cid, g.hits.cs, g.hits.ce)
    # columns that are not views of one buffer
    own = sk.SweepCols(*[t.clone() for t in cols])
    want = sk.shadow_sweep_plain(own, W, mode, True, 0.5)
    got = sk.shadow_sweep_plain(
        sk.unpack_cols(sk.pack_cols(own), g.n_hit, len(g.exon_os)),
        W, mode, True, 0.5)
    sk.reset_counts()
    packed = sk.unpack_out(sk.shadow_sweep_packed(
        host_pack(d, g), g.n_hit, len(g.exon_os), W, mode,
        True, 0.5), g.n_hit)
    assert sk.n_plain_calls[mode] == 1 and sk.n_kernel_launches[mode] == 0
    sk.reset_counts()
    assert want[0].any()
    for a, b, c in zip(want, got, packed):
        assert a.dtype == b.dtype == c.dtype
        assert torch.equal(a, b) and torch.equal(a, c)
    # the packed output round-trips too
    for a, b in zip(sk.unpack_out(sk.pack_out(want), g.n_hit), want):
        assert torch.equal(a, b)


def test_packed_checks():
    d, g = ptesting.random_genome(np.random.default_rng(5), n_hits=30)
    buf = host_pack(d, g)
    E = len(g.exon_os)
    with pytest.raises(ValueError):
        sk.shadow_sweep_packed(buf[:-16], 30, E, 4, sk.SHADOW, False, 0.5)
    with pytest.raises(ValueError):
        sk.shadow_sweep_packed(buf.view(torch.int32), 30, E, 4, sk.SHADOW,
                               False, 0.5)
    with pytest.raises(ValueError):
        sk.shadow_sweep_packed(buf, 30, E, 0, sk.SHADOW, False, 0.5)
    with pytest.raises(ValueError):
        sk.shadow_sweep_packed(buf, 30, E, 4, 5, False, 0.5)


@pytest.mark.parametrize("case", ["n=B-1", "n=B", "n=B+1", "n=2B+W",
                                  "W>tile", "all filtered", "cs>2^31"])
def test_plain_edge_cases_vs_xla(case):
    """The kernel's edge-case genomes: the plain version equals the JAX
    package's XLA sweep, and band_genome's band is the W it was asked for."""
    d2, g2 = ptesting.sweep_edge_case(case)
    W2 = sk.band_width(g2.hits.cid, g2.hits.cs, g2.hits.ce)
    band_tile = sk.tile_shape()[1]
    assert W2 == {"W>tile": 3 * band_tile + 7}.get(case, 15)
    assert W2 > band_tile or case != "W>tile"
    if case == "cs>2^31":
        assert int(g2.hits.cs[1:].min()) > 1 << 32
        assert int(g2.exon_os.max()) > 1 << 29
        assert int(g2.hits.cs[1] - g2.hits.cs[0]) > 1 << 31
    d, g = port_genome(d2, g2, jdata)
    n = g.n_hit
    H, K, W = jde._shapes(d, g)
    jm, js, jo, jv = (np.asarray(a)[:n] for a in jdev.shadow_kernel(
        jde.build_cols(d, g, H, K), 0.3, W, False))
    _, _, (m, s, o, v) = port_sweep(d2, g2, sk.SHADOW, False, 0.3)
    np.testing.assert_array_equal(m.numpy(), jm.astype(np.uint8))
    np.testing.assert_array_equal(raw_score(s), js)
    np.testing.assert_array_equal(o.numpy(), jo)
    np.testing.assert_array_equal(v.numpy(), jv)
    assert m.numpy().any() == (case != "all filtered")
    if case == "cs>2^31":   # the far exons' overlap, exact in int64
        assert (int(o[n - 9]), int(v[n - 9])) == (n - 10, 590)
        # hit 0 overlaps nothing; hit 1 is not its dominator or loser
        assert int(m[0]) == 0 and int(o[1]) != 0
