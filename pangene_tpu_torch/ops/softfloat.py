"""Exact software emulation of the reference's IEEE-double predicates.

The counterpart of pangene_tpu/ops/softfloat.py in torch int64. The three
double expressions that live inside the pruning-round loop
(parallel/device_loop.py) are reproduced bit-exactly in integer arithmetic,
so they give the same answer on the CPU and on CUDA whatever the device's
float division does:

  1. ``(int)((double)S / n + .499)``      - per-genome arc dist average
     (reference graph.c:141) and the merged-arc s1/s2/dist averages
     (graph.c:170-172): :func:`plus499_trunc`.
  2. ``1.0 - (double)s1 / max_s1  <cmp>  branch_diff``  - the branch-arc
     deficit predicate (reference branch.c:72-78): :func:`one_minus_div`
     + :func:`gt_const`.
  3. ``(double)ov / min(li, lj) < min_ov_ratio``  - the shadow-sweep
     coverage gate (reference overlap.c:134-136): :func:`div_rn` +
     :func:`lt_const`.

All helpers are elementwise int64 tensor programs (no float anywhere).
Doubles are represented as (m, k) with value = m * 2^-k and m in
[2^52, 2^53) (m == 0 encodes 0.0); the host-side :func:`decompose` turns a
Python float into that form.

The core primitive is :func:`div_rn`: correctly-rounded (round-to-nearest,
ties-to-even) division of two non-negative integers to a 53-bit significand,
done with a chunked long division entirely in int64. Domain: 0 <= S < 2^62,
1 <= n < 2^31 (asserted by callers' data ranges, not at runtime). Every
``//`` and ``%`` below has non-negative operands, where torch's floor
division and remainder are the C ones; ``>>`` on int64 is arithmetic.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

I64 = torch.int64
# plain Python ints, as in the JAX module: no tensor is made at import
_TWO52 = 1 << 52
_TWO53 = 1 << 53
_TWO54 = 1 << 54


def decompose(x: float) -> Tuple[int, int]:
    """Host-side: positive double x -> (m, k) with x = m * 2^-k,
    m in [2^52, 2^53); (0, 0) for 0.0."""
    if x == 0.0:
        return 0, 0
    assert x > 0.0 and math.isfinite(x)
    f, e = math.frexp(x)           # x = f * 2^e, f in [0.5, 1)
    m = int(f * (1 << 53))         # in [2^52, 2^53)
    return m, 53 - e


# significand of double(0.499), scaled so that 0.499... = C499_M54 * 2^-54
C499_M54 = decompose(0.499)[0]
assert decompose(0.499)[1] == 54


def _fdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def bitlen(x: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 (0 for 0), branch-free."""
    x = x.to(I64)
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        big = x >= (1 << s)
        n = n + big * s
        x = torch.where(big, x >> s, x)
    return n + (x > 0)


def div_rn(S: torch.Tensor, n: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, k) = round-to-nearest-even of S/n: RN(S/n) = m * 2^-k with
    m in [2^52, 2^53); S == 0 -> (0, 0). Exact for 0 <= S < 2^62,
    1 <= n < 2^31 (the reference's (double)S / n is correctly rounded
    because both convert exactly: S < 2^53 in all call sites)."""
    S = S.to(I64)
    n = n.to(I64)
    bS = bitlen(S)
    bn = bitlen(n)
    k0 = 52 - bS + bn
    # fold negative shifts into the divisor: Q = floor(S*2^s / n'), s >= 0
    neg = (-k0).clamp(min=0)
    npr = torch.bitwise_left_shift(n, neg)   # n' < 2^31 * 2^10
    s = k0.clamp(min=0)
    Q = _fdiv(S, npr)
    R = torch.remainder(S, npr)
    # chunked left shift of the remainder: R < n' <= 2^41, chunk <= 20 bits
    for i in range(5):             # 5*20 = 100 >= max shift (83)
        c = (s - 20 * i).clamp(0, 20)
        Rc = torch.bitwise_left_shift(R, c)
        Q = torch.bitwise_left_shift(Q, c) + _fdiv(Rc, npr)
        R = torch.remainder(Rc, npr)
    # normalize to [2^52, 2^53): the estimate can be one bit low
    low = (Q < _TWO52) & (S > 0)
    up = (2 * R >= npr)
    Q = torch.where(low, 2 * Q + up, Q)
    R = torch.where(low, 2 * R - up * npr, R)
    k = torch.where(low, k0 + 1, k0)
    # round to nearest, ties to even
    rup = (2 * R > npr) | ((2 * R == npr) & ((Q & 1) == 1))
    m = Q + rup
    ovf = m == _TWO53
    m = torch.where(ovf, _TWO52, m)
    k = torch.where(ovf, k - 1, k)
    zero = S == 0
    m = torch.where(zero, 0, m)
    k = torch.where(zero, 0, k)
    return m, k


def plus499_trunc(S: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Exact ``(int64)((double)S / n + .499)`` for S >= 0, n >= 1
    (reference graph.c:141,170-172; all casts there are value-preserving).

    trunc(RN(RN(S/n) + c)) with c = double(0.499): the result is floor(d)
    or floor(d)+1; the carry happens iff the exact sum d + c clears the
    round-up threshold of the integer above floor(d)."""
    m, k = div_rn(S, n)
    # k <= 0: d = m << -k is an integer >= 2^52; +0.499 can never carry
    # (spacing >= 1 and c < 0.5 keeps d+c strictly below the midpoint)
    big = torch.bitwise_left_shift(m, (-k).clamp(0, 10))
    # k >= 54: d < 0.5 so d + c < 1 -> 0
    kc = k.clamp(1, 53)
    F = torch.bitwise_right_shift(m, kc)
    frac = m - torch.bitwise_left_shift(F, kc)
    # T = 2^54 * (d + c - (F+1)), exact in int64
    T = torch.bitwise_left_shift(frac, 54 - kc) + C499_M54 - _TWO54
    P = F + 1
    blP = bitlen(P)
    thr = torch.where((P & (P - 1)) == 0, P,
                      torch.bitwise_left_shift(torch.ones_like(P), blP))
    carry = T >= -thr
    res = torch.where(k <= 0, big,
                      torch.where(k >= 54, 0, F + carry))
    return torch.where(S.to(I64) == 0, 0, res)


def one_minus_div(s1: torch.Tensor, mx: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, k) of ``RN(1.0 - RN(s1/mx))`` for 0 <= s1 <= mx, mx >= 1
    (the reference branch deficit, branch.c:72). Returns m == 0 for an
    exact zero (s1 == mx)."""
    mq, kq = div_rn(s1, mx)        # q in [0, 1]; s1==0 -> (0,0)
    # k == 53 (q in [0.5, 1)): Sterbenz, 1 - q exact: num = 2^53 - m
    num53 = _TWO53 - mq
    b53 = bitlen(num53)
    m_a = torch.bitwise_left_shift(num53, 53 - b53)
    k_a = 53 + (53 - b53)
    # k >= 54 (q < 0.5): r in (0.5, 1): mantissa = 2^53 - RN_int(m * 2^(53-k))
    sh = (kq - 53).clamp(0, 30)
    t_int = torch.bitwise_right_shift(mq, sh)
    rem = mq - torch.bitwise_left_shift(t_int, sh)
    one_t = torch.ones_like(mq)
    half = torch.where(sh > 0,
                       torch.bitwise_left_shift(one_t, (sh - 1).clamp(min=0)),
                       one_t)
    # round t = t_int + rem/2^sh half-to-even OF THE RESULT (2^53 - t):
    # result parity == t parity, so ties round t to even as well
    t_up = (rem > half) | ((rem == half) & ((t_int & 1) == 1))
    t_r = t_int + (t_up & (sh > 0))
    m_b = _TWO53 - t_r
    k_b = torch.full_like(mq, 53)
    ovf = m_b == _TWO53            # rounds to exactly 1.0
    m_b = torch.where(ovf, _TWO52, m_b)
    k_b = torch.where(ovf, 52, k_b)
    small = kq >= 54
    m = torch.where(small, m_b, m_a)
    k = torch.where(small, k_b, k_a)
    # q == 0 -> r = 1.0 exactly
    m = torch.where(mq == 0, _TWO52, m)
    k = torch.where(mq == 0, 52, k)
    # q == 1 (m=2^52, k=52) -> r = 0.0
    one = (mq == _TWO52) & (kq == 52)
    m = torch.where(one, 0, m)
    k = torch.where(one, 0, k)
    return m, k


def gt_const(m: torch.Tensor, k: torch.Tensor, c: float) -> torch.Tensor:
    """value(m, k) > c for a non-negative normalized double value and a
    host-side double constant c (any sign)."""
    if c < 0.0:
        return torch.ones(m.shape, dtype=torch.bool, device=m.device)
    if c == 0.0:
        return m > 0
    cm, ck = decompose(c)
    return (m > 0) & ((k < ck) | ((k == ck) & (m > cm)))


def lt_const(m: torch.Tensor, k: torch.Tensor, c: float) -> torch.Tensor:
    """value(m, k) < c for a non-negative normalized double value and a
    host-side double constant c (any sign)."""
    if c <= 0.0:
        return torch.zeros(m.shape, dtype=torch.bool, device=m.device)
    cm, ck = decompose(c)
    return (m == 0) | (k > ck) | ((k == ck) & (m < cm))
