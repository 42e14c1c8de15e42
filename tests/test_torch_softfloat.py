"""pangene_tpu_torch.ops.softfloat against pangene_tpu.ops.softfloat.

Same inputs, made from a seed with numpy, through both; every output is an
integer or a bool and must be exactly equal (tolerance 0). The value sets
are those of tests/test_softfloat.py (which holds the JAX module against
CPython doubles) plus a fuzz over the stated domain 0 <= S < 2^62,
1 <= n < 2^31. One more group records where native torch.float64 gives the
same answers as the int64 form.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pangene_tpu.ops import softfloat as jsf
from pangene_tpu_torch.ops import softfloat as sf

# small tensors: one torch thread per test process, so that several test
# workers on one machine do not contend for its cores
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def boundary_set():
    """S/n + .499 within ~1e-3 of an integer (test_plus499_boundaries)."""
    Ss, ns = [], []
    for n in list(range(1, 50)) + [100, 125, 1000, 1024, 999, 2000, 10**6]:
        for k in (0, 1, 2, 7, 1000, 123456):
            for base in (k * n + n // 2, k * n + (501 * n) // 1000):
                for d in range(-3, 4):
                    if base + d >= 0:
                        Ss.append(base + d)
                        ns.append(n)
    return np.asarray(Ss, np.int64), np.asarray(ns, np.int64)


def random_set(seed, mags, nmax_bits=31, count=20000):
    rng = np.random.default_rng(seed)
    out = []
    for mag in mags:
        S = rng.integers(0, 1 << mag, count).astype(np.int64)
        n = rng.integers(1, 1 << min(mag, nmax_bits), count).astype(np.int64)
        out.append((S, n))
    return out


def deficit_set():
    """s1 <= mx with tie mass and ratios near the constants
    (test_branch_deficit_predicate)."""
    rng = np.random.default_rng(2)
    consts = [0.02, 0.05, 0.5, 0.25, 1e-9, 0.999, 0.1 + 0.2]
    N = 30000
    s1 = rng.integers(0, 1 << 31, N).astype(np.int64)
    mx = np.maximum(s1, rng.integers(1, 1 << 31, N).astype(np.int64))
    s1[:2000] = mx[:2000]
    s1[2000:4000] = np.maximum(mx[2000:4000] - 1, 0)
    for i, c in enumerate(consts):
        lo, hi = 4000 + 3000 * i, 7000 + 3000 * i
        if hi <= N:
            tgt = np.round((1.0 - c) * mx[lo:hi]).astype(np.int64)
            s1[lo:hi] = np.clip(tgt + rng.integers(-1, 2, hi - lo), 0,
                                mx[lo:hi])
    return s1, mx, consts + [-0.5, 0.0]


def cov_set():
    """ov <= l with boundary mass at ov ~ ratio * l (test_cov_lt_predicate)."""
    rng = np.random.default_rng(3)
    N = 20000
    l = rng.integers(1, 1 << 31, N).astype(np.int64)
    ov = rng.integers(0, 1 << 31, N).astype(np.int64) % (l + 1)
    for i, c in enumerate([0.5, 0.05, 0.3]):
        lo, hi = 1000 + 4000 * i, 5000 + 4000 * i
        tgt = np.round(c * l[lo:hi]).astype(np.int64)
        ov[lo:hi] = np.clip(tgt + rng.integers(-1, 2, hi - lo), 0, l[lo:hi])
    return ov, l, (0.5, 0.05, 0.3, 0.9999999, 1e-12, 0.0, -1.0)


def both(name, *arrays):
    got = getattr(sf, name)(*[T(a) for a in arrays])
    want = jax.jit(getattr(jsf, name))(*[jnp.asarray(a) for a in arrays])
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("x", [0.499, 0.02, 0.05, 0.5, 1.0 - 2**-53,
                               2**-1022, 1e300, 0.0])
def test_decompose_equals_jax(x):
    assert sf.decompose(x) == jsf.decompose(x)
    assert sf.C499_M54 == jsf.C499_M54


def test_bitlen_equals_jax():
    rng = np.random.default_rng(4)
    x = np.concatenate([[0, 1, 2, 3, (1 << 62) - 1], 1 << np.arange(62),
                        (1 << np.arange(1, 63)) - 1,
                        rng.integers(0, 1 << 62, 5000)]).astype(np.int64)
    assert_same(*both("bitlen", x))


def test_plus499_boundaries_equal_jax():
    assert_same(*both("plus499_trunc", *boundary_set()))


@pytest.mark.parametrize("mag", [10, 20, 31, 40, 45, 52])
def test_plus499_random_equals_jax(mag):
    rng = np.random.default_rng(mag)
    S = rng.integers(0, 1 << mag, 20000).astype(np.int64)
    n = rng.integers(1, min(1 << mag, 1 << 31) + 1, 20000).astype(np.int64)
    got, want = both("plus499_trunc", S, n)
    assert_same(got, want)
    truth = np.asarray([int(int(a) / int(b) + 0.499) for a, b in zip(S, n)])
    assert np.array_equal(got[0], truth)


@pytest.mark.parametrize("mag", [5, 16, 31, 45, 61])
def test_div_rn_equals_jax(mag):
    (S, n), = random_set(1 + mag, [mag])
    assert_same(*both("div_rn", S, n))


def test_fuzz_whole_domain_equals_jax():
    """0 <= S < 2^62 and 1 <= n < 2^31, magnitudes drawn log-uniformly."""
    rng = np.random.default_rng(7)
    N = 60000
    S = rng.integers(0, 1 << 62, N) >> rng.integers(0, 62, N)
    n = np.maximum(rng.integers(0, 1 << 31, N) >> rng.integers(0, 31, N), 1)
    S, n = S.astype(np.int64), n.astype(np.int64)
    assert_same(*both("div_rn", S, n))
    assert_same(*both("plus499_trunc", S, n))


def test_one_minus_div_and_gt_const_equal_jax():
    s1, mx, consts = deficit_set()
    got, want = both("one_minus_div", s1, mx)
    assert_same(got, want)
    m, k = T(got[0]), T(got[1])
    for c in consts:
        g = sf.gt_const(m, k, c).numpy()
        w = np.asarray(jsf.gt_const(jnp.asarray(want[0]),
                                    jnp.asarray(want[1]), c))
        assert g.dtype == np.bool_ and np.array_equal(g, w), c
    truth = np.asarray([(1.0 - int(a) / int(b)) > 0.02
                        for a, b in zip(s1, mx)])
    assert np.array_equal(sf.gt_const(m, k, 0.02).numpy(), truth)


def test_div_rn_and_lt_const_equal_jax():
    ov, l, consts = cov_set()
    got, want = both("div_rn", ov, l)
    assert_same(got, want)
    m, k = T(got[0]), T(got[1])
    for c in consts:
        g = sf.lt_const(m, k, c).numpy()
        w = np.asarray(jsf.lt_const(jnp.asarray(want[0]),
                                    jnp.asarray(want[1]), c))
        assert np.array_equal(g, w), c
    truth = np.asarray([(int(a) / int(b)) < 0.3 for a, b in zip(ov, l)])
    assert np.array_equal(sf.lt_const(m, k, 0.3).numpy(), truth)


def native_plus499(S, n):
    return (T(S).double() / T(n).double() + 0.499).long().numpy()


@pytest.mark.parametrize("which", ["boundaries", "random", "deficit", "cov"])
def test_native_float64_record(which):
    """Where native torch.float64 equals the int64 form on the same sets.
    Equality is asserted only where S < 2^53 (both operands convert to
    double exactly, so IEEE division is the reference's own arithmetic);
    above that (double)S rounds and the two may differ. On the CPU every
    set below 2^53 agrees; the loop keeps the int64 form, which does not
    depend on a device's float64 division."""
    if which == "boundaries":
        S, n = boundary_set()
        got, want = native_plus499(S, n), sf.plus499_trunc(T(S), T(n)).numpy()
    elif which == "random":
        sets = random_set(0, (10, 31, 45, 52, 61))
        S = np.concatenate([s for s, _ in sets])
        n = np.concatenate([m for _, m in sets])
        got, want = native_plus499(S, n), sf.plus499_trunc(T(S), T(n)).numpy()
        assert (S >= (1 << 53)).any()
    elif which == "deficit":
        S, n, _ = deficit_set()
        m, k = sf.one_minus_div(T(S), T(n))
        got = ((1.0 - T(S).double() / T(n).double()) > 0.02).numpy()
        want = sf.gt_const(m, k, 0.02).numpy()
    else:
        S, n, _ = cov_set()
        m, k = sf.div_rn(T(S), T(n))
        got = ((T(S).double() / T(n).double()) < 0.3).numpy()
        want = sf.lt_const(m, k, 0.3).numpy()
    exact = S < (1 << 53)
    assert np.array_equal(got[exact], want[exact])
    # the record: run with -s to read it
    print("native float64 vs int64 form, %s: %d of %d pairs with S >= 2^53 "
          "differ" % (which, int((got != want)[~exact].sum()),
                      int((~exact).sum())))
