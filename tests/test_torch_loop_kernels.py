"""The plain versions of the device loop's two hand-written kernels
(pangene_tpu_torch/ops/loop_kernels.py) against independent numpy oracles,
on the CPU. Every output is an integer or a bit: tolerance 0 (exact).

  branch_locality  a scalar walk of branch.c:48-106 over explicit group
                   lists: for each arc of a branching group and each other
                   member of its group, whatever the group's size,
                   pg_n_local (branch.c:31-46) over the genomes; aml = a
                   local max partner, he = an earlier local partner.
  branch_block     the same walk plus the reference's classification of
                   every branching arc in Python doubles (1 - s1 / mx against
                   the three branch constants, branch.c:72-78) and the
                   n_dist_loci count of each group (branch.c:82-90); the
                   split entries (arc_groups, branch_locality,
                   branch_classify) give the same. The softfloat deficit of
                   the JAX package (pangene_tpu/ops/softfloat.py) is held
                   against the same doubles on the same ratios.
  merge_fold       a dict of out-groups (vw) of in-groups ((vw, g)) with
                   their rows' s1 (s2, dist), in key order: the arc rows,
                   n_out and each row's out-group rank, in the three call
                   shapes of the loop (row index in the key's low bits; keys
                   sorted with a permutation; the bucket exchange's received
                   range, low bits and a permutation), and in the full mode
                   the statistics of the loop's full=True tail, averages in
                   Python doubles.

The loop itself goes through these functions in
tests/test_torch_device_loop.py and tests/test_torch_mesh.py, which hold its
outputs against the JAX package's schedule bit for bit; the kernels are held
against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangene_tpu.ops import softfloat as jsf
from pangene_tpu_torch import plain_branch
from pangene_tpu_torch.ops import loop_kernels as lk
from pangene_tpu_torch.testing import (BRANCH_B, EXACT_BRANCH_DIFFS,
                                       ROUND_EDGE_CASES, ROUND_STATES,
                                       WALK_FORMS,
                                       branch_table, deficit_ratios,
                                       fold_inputs, locality_table,
                                       make_state, round_calls,
                                       round_outputs, round_state)

torch.set_num_threads(1)

KSENT = lk.KSENT_I
SENT = lk.SENT_I
# the largest group of the kernels' block path; larger ones take the wide
# path
D = lk.WIDE_ROWS


# ---------------------------------------------------------------------------
# branch_locality
# ---------------------------------------------------------------------------

def n_local(t, ga, gb, frag_mode, local_dist, local_count):
    """pg_n_local (branch.c:31-46): genomes in which genes ga and gb are
    local."""
    n = 0
    for g in range(t["r_pres"].shape[1]):
        if not (t["r_pres"][ga, g] and t["r_pres"][gb, g]):
            continue
        if not frag_mode and t["r_cid"][ga, g] != t["r_cid"][gb, g]:
            continue
        if abs(int(t["r_cm"][ga, g]) - int(t["r_cm"][gb, g])) <= local_dist \
                or abs(int(t["r_rank"][ga, g])
                       - int(t["r_rank"][gb, g])) <= local_count:
            n += 1
    return n


def oracle_locality(t, groups, frag_mode, local_dist, local_count):
    A = len(t["tgt_gid"])
    aml = np.zeros(A, bool)
    he = np.zeros(A, bool)
    memo = {}
    for grp in groups:
        if len(grp) < 2:
            continue
        for a in grp:
            for p in grp:
                if p == a:
                    continue
                key = (min(a, p), max(a, p))
                if key not in memo:
                    memo[key] = n_local(t, t["tgt_gid"][a], t["tgt_gid"][p],
                                        frag_mode, local_dist, local_count)
                if memo[key]:
                    aml[a] |= t["is_max"][p]
                    he[a] |= p < a
    return aml, he


def run_locality(t, frag_mode, local_dist, local_count):
    args = [torch.from_numpy(np.ascontiguousarray(t[k])) for k in (
        "r_pres", "r_cid", "r_cm", "r_rank", "tgt_gid", "gs_of",
        "branching", "is_max")]
    aml, he = lk.branch_locality(*args, frag_mode=frag_mode,
                                 local_dist=local_dist,
                                 local_count=local_count)
    assert aml.dtype == he.dtype == torch.bool
    return aml.numpy(), he.numpy()


@pytest.mark.parametrize("frag_mode", [False, True])
@pytest.mark.parametrize("G,seed", [(1, 0), (3, 1), (8, 2)])
def test_branch_locality_plain_equals_oracle(G, seed, frag_mode):
    """Groups of every size 1..D and one of D + 1 (the kernels' wide path:
    every pair tested all the same), absent targets."""
    rng = np.random.default_rng(seed)
    sizes = list(rng.permutation(np.arange(1, D + 1))) + [D + 1]
    t, groups = locality_table(rng, G, sizes)
    kw = dict(frag_mode=frag_mode, local_dist=1000, local_count=3)
    got = run_locality(t, **kw)
    want = oracle_locality(t, groups, **kw)
    assert got[0].any() and got[1].any() and not got[1].all()
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("case", ["no_branching", "all_absent",
                                  "one_pair"])
def test_branch_locality_plain_edges(case):
    rng = np.random.default_rng(7)
    sizes = {"no_branching": [1] * 30, "all_absent": [3, 5, 2],
             "one_pair": [1, 2, 1]}[case]
    t, groups = locality_table(rng, 4, sizes,
                               p_absent=1.0 if case == "all_absent" else 0.0)
    if case == "one_pair":
        t["r_cid"][:] = 0
        t["r_cm"][:] = 0               # every pair local in every genome
    kw = dict(frag_mode=False, local_dist=1000, local_count=3)
    got = run_locality(t, **kw)
    want = oracle_locality(t, groups, **kw)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    if case == "one_pair":
        assert got[1].tolist() == [False, False, True, False, False, False,
                                   False, False, False]
    else:
        assert not got[0].any() and not got[1].any()


# ---------------------------------------------------------------------------
# branch_block: the locality, the classification, n_grp
# ---------------------------------------------------------------------------

DEFAULT_DIFFS = (0.02, 0.05, 0.5)
DIFFS = {"default": DEFAULT_DIFFS, "exact": EXACT_BRANCH_DIFFS}


def classify_double(s1, mx, aml, diffs):
    """branch.c:72-78 in Python doubles: 0 kept, 1 weak candidate, 2 cut."""
    bd, bdd, bdc = diffs
    d = 1.0 - max(s1, 0) / max(mx, 1)      # correctly rounded, as in C
    cand = mx > 0 and d > bd
    cut = cand and ((not aml and d > bdd) or d > bdc)
    return int(cand) + int(cut)


def oracle_branch(t, groups, frag_mode, local_dist, local_count, diffs):
    """(aw, n_grp, counts) of branch_table's arc table: each group's max,
    the locality walk, the classification in doubles, n_dist_loci at each
    group's first arc."""
    A = len(t["arc_s1"])
    is_max = np.zeros(A, bool)
    mx = np.zeros(A, np.int64)
    for grp in groups:
        m = max(0, max(int(t["arc_s1"][a]) for a in grp))
        mx[grp] = m
        if len(grp) >= 2:
            is_max[grp] = t["arc_s1"][grp] == m
    aml, he = oracle_locality(dict(t, is_max=is_max), groups, frag_mode,
                              local_dist, local_count)
    aw = np.zeros(A, np.uint8)
    n_grp = np.zeros(A, np.int32)
    for grp in groups:
        if len(grp) < 2:
            continue
        for a in grp:
            aw[a] = classify_double(int(t["arc_s1"][a]), int(mx[a]), aml[a],
                                    diffs)
        n_grp[grp[0]] = sum(1 for a in grp if not he[a])
    return aw, n_grp, np.array([(aw == 1).sum(), (aw == 2).sum()])


def run_branch(t, frag_mode, diffs, split=False, **kw):
    args = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in t.items()}
    kw = dict(dict(frag_mode=frag_mode, local_dist=1000, local_count=3),
              **kw)
    cls = dict(zip(("branch_diff", "branch_diff_dist", "branch_diff_cut"),
                   diffs))
    if split:
        gs_of, mx, branching, is_max = lk.arc_groups(
            args["arc_vw"], args["arc_s1"], BRANCH_B)
        planes = [args[k] for k in ("r_pres", "r_cid", "r_cm", "r_rank",
                                    "tgt_gid")]
        aml, he = lk.branch_locality(*planes, gs_of, branching, is_max, **kw)
        out = lk.branch_classify(args["arc_s1"], mx, branching, aml, he,
                                 gs_of, **cls)
    else:
        out = lk.branch_block(*args.values(), B=BRANCH_B, **kw, **cls)
    aw, n_grp, counts = out
    assert (aw.dtype, n_grp.dtype, counts.dtype) == (
        torch.uint8, torch.int32, torch.int64) and counts.shape == (2,)
    return aw.numpy(), n_grp.numpy(), counts.numpy()


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("diffs", list(DIFFS))
@pytest.mark.parametrize("frag_mode", [False, True])
@pytest.mark.parametrize("G,seed", [(1, 0), (3, 1), (8, 2)])
def test_branch_block_plain_equals_oracle(G, seed, frag_mode, diffs, split):
    """Groups of every size 1..D and one of D + 1 (the kernels' wide path:
    every pair tested all the same); ratios whose deficit lies on
    or beside each branch constant, s1 == mx, s1 == 0; the fused entry and
    the mesh's split entries."""
    rng = np.random.default_rng(seed)
    sizes = list(rng.permutation(np.arange(1, D + 1))) + [D + 1]
    t, groups = branch_table(rng, G, sizes,
                             ratios=deficit_ratios(DIFFS[diffs]))
    got = run_branch(t, frag_mode, DIFFS[diffs], split)
    want = oracle_branch(t, groups, frag_mode, 1000, 3, DIFFS[diffs])
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    aw, n_grp, counts = got
    assert counts[0] > 0 and counts[1] > 0 and (aw == 0).sum() > 0
    assert n_grp.sum() > 0


@pytest.mark.parametrize("case", ["no_branching", "pairs", "one_group_D",
                                  "all_equal_s1", "all_zero_s1"])
def test_branch_block_plain_edges(case):
    rng = np.random.default_rng(11)
    sizes = {"no_branching": [1] * 30, "pairs": [2] * 40,
             "one_group_D": [D], "all_equal_s1": [5, 7, 3],
             "all_zero_s1": [5, 7, 3]}[case]
    t, groups = branch_table(rng, 4, sizes)
    if case == "all_equal_s1":
        t["arc_s1"][:] = 77
    if case == "all_zero_s1":
        t["arc_s1"][:] = 0
    for diffs in DIFFS.values():
        got = run_branch(t, False, diffs)
        want = oracle_branch(t, groups, False, 1000, 3, diffs)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        if case in ("no_branching", "all_equal_s1", "all_zero_s1"):
            assert not got[0].any()


def test_deficit_softfloat_equals_doubles():
    """On every ratio of the tests and 20,000 random ones: the port's
    classification (softfloat), the JAX package's softfloat predicates and
    the reference's double arithmetic agree, under both constant sets and
    a negative and a zero constant."""
    rng = np.random.default_rng(5)
    mx = rng.integers(1, 1 << 31, 20000)
    s1 = (mx * rng.random(20000)).astype(np.int64)
    small = rng.integers(1, 100, 2000)
    r = np.array(deficit_ratios(DEFAULT_DIFFS)
                 + deficit_ratios(EXACT_BRANCH_DIFFS), np.int64)
    s1 = np.concatenate([r[:, 0], s1, small - rng.integers(0, 2, 2000)])
    mx = np.concatenate([r[:, 1], mx, small])
    rm, rk = jsf.one_minus_div(jnp.asarray(s1), jnp.asarray(mx))
    A = len(s1)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    for diffs in (DEFAULT_DIFFS, EXACT_BRANCH_DIFFS, (-1.0, 0.0, 0.0)):
        for c in diffs:
            want = np.array([1.0 - a / b > c for a, b in zip(s1, mx)])
            assert np.array_equal(np.asarray(jsf.gt_const(rm, rk, c)), want)
        aml = rng.random(A) < 0.5
        aw, _, _ = lk.branch_classify(
            t(s1.astype(np.int32)), t(mx.astype(np.int32)),
            torch.ones(A, dtype=torch.bool), t(aml), t(aml),
            torch.arange(A), branch_diff=diffs[0],
            branch_diff_dist=diffs[1], branch_diff_cut=diffs[2])
        want = [classify_double(int(a), int(b), m, diffs)
                for a, b, m in zip(s1, mx, aml)]
        assert aw.tolist() == want


# ---------------------------------------------------------------------------
# merge_fold
# ---------------------------------------------------------------------------

def avg499(S, n):
    """(int)((double)S / n + .499): Python's int / int is the correctly
    rounded double quotient. Below 0 (a dist sum of int32 gaps that
    wrapped) the value the plain version's softfloat gives there (see
    test_plus499_below_zero)."""
    if S < 0:
        return ((S & 0x7ff) ^ 0x400) - 0x400 if n == 1 else 0
    return int(S / n + 0.499)


def oracle_fold(keys, s1, jb, gb, cap, perm=None, full=None):
    """Out-groups (vw) of in-groups ((vw, g)) with their rows' (s1, s2,
    dist), in key order: the arc rows with their largest-s1 average, n_out,
    each valid row's out-group rank at its origin; with full = (s2, dist)
    also each out-group's in-groups, rows, dist average (of the in-groups'
    rounded averages times their rows) and largest-s2 average."""
    groups = {}
    rows = []
    s2, dist = full if full is not None else (s1, np.zeros_like(s1))
    for i, k in enumerate(int(x) for x in keys):
        if k >> jb == KSENT >> jb:
            continue
        src = int(perm[i]) if perm is not None else k & ((1 << jb) - 1)
        vw = (k >> jb) >> gb
        groups.setdefault(vw, {}).setdefault(k >> jb, []).append(
            (int(s1[src]), int(s2[src]), int(dist[src])))
        rows.append((src, vw))
    rank = {vw: i for i, vw in enumerate(groups)}
    arc_vw = np.full(cap, SENT, np.int64)
    stats = np.zeros((5, cap), np.int64)     # s1, ng, tot, ad, s2
    for vw, i in rank.items():
        if i < cap:
            ins = list(groups[vw].values())
            ng = len(ins)
            tot = sum(len(r) for r in ins)
            ad = sum(avg499(sum(x[2] for x in r), len(r)) * len(r)
                     for r in ins)
            arc_vw[i] = vw
            stats[:, i] = (avg499(sum(max(x[0] for x in r) for r in ins), ng),
                           ng, tot, avg499(ad, tot),
                           avg499(sum(max(x[1] for x in r) for r in ins), ng))
    stats = stats.astype(np.int32)    # the int32 planes wrap as the cast
    pair = np.zeros(len(keys), np.int32)
    for src, vw in rows:
        pair[src] = rank[vw]
    out = (arc_vw, stats[0], len(groups), pair)
    return out if full is None else out + tuple(stats[1:])


def run_fold(keys, s1, jb, gb, cap, perm, full=None):
    t = lambda x: None if x is None else torch.from_numpy(x)
    out = lk.merge_fold(t(keys), t(s1), jb=jb, gb=gb, cap=cap, perm=t(perm),
                        full=None if full is None else tuple(map(t, full)))
    assert len(out) == (4 if full is None else 8)
    arc_vw, arc_s1, n_out, pair = out[:4]
    assert (arc_vw.dtype, arc_s1.dtype, n_out.dtype, pair.dtype) == (
        torch.int64, torch.int32, torch.int64, torch.int32)
    assert n_out.shape == ()
    assert all(x.dtype == torch.int32 and x.shape == (cap,)
               for x in out[4:])
    return (arc_vw.numpy(), arc_s1.numpy(), int(n_out), pair.numpy()) \
        + tuple(x.numpy() for x in out[4:])


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("cap", ["A", "small", "large"])
@pytest.mark.parametrize("form", ["jb", "cosorted", "exchange"])
def test_merge_fold_plain_equals_oracle(form, cap, full):
    """cap "small" leaves n_out > cap (the overflow the loop falls back on);
    "large" is more rows than keys; full adds the statistics."""
    rng = np.random.default_rng(["jb", "cosorted", "exchange"].index(form))
    N = 3000
    keys, s1, jb, gb, perm, st = fold_inputs(rng, form, N, n_vw=400,
                                             full=True)
    st = st if full else None
    c = {"A": N, "small": 100, "large": N + 77}[cap]
    got = run_fold(keys, s1, jb, gb, c, perm, st)
    want = oracle_fold(keys, s1, jb, gb, c, perm, st)
    assert got[2] == want[2] > 100
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


FOLD_EDGES = ["all_sentinel", "one_row", "large_s1", "one_group",
              "every_row_one_group", "dist_near_2_31", "dist_wrapped"]


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("case", FOLD_EDGES)
@pytest.mark.parametrize("form", ["jb", "cosorted", "exchange"])
def test_merge_fold_plain_edges(form, case, full):
    """large_s1: s1 and s2 up to 2^31 - 1; every_row_one_group: one
    out-group holds every row; dist_near_2_31: gaps near 2^30, so in-group
    and out-group dist sums near and past 2^31; dist_wrapped: int32 gaps of
    either sign (gaps that wrapped), so sums below 0."""
    rng = np.random.default_rng(3)
    N = {"one_row": 1}.get(case, 500)
    kw = dict(n_vw=1 if "one_group" in case else 60,
              p_valid={"all_sentinel": 0.0, "one_row": 1.0,
                       "every_row_one_group": 1.0}.get(case, 0.8),
              smax=(1 << 31) - 1 if case == "large_s1" else 1000,
              dist={"dist_near_2_31": ((1 << 30) - 50, (1 << 30) + 50),
                    "dist_wrapped": (-(1 << 31), 1 << 31)}.get(
                        case, (0, 1 << 20)))
    if case in ("dist_near_2_31", "dist_wrapped"):
        kw["n_g"] = 2       # in-groups of several rows
    keys, s1, jb, gb, perm, st = fold_inputs(rng, form, N, full=True, **kw)
    st = st if full else None
    got = run_fold(keys, s1, jb, gb, 64, perm, st)
    want = oracle_fold(keys, s1, jb, gb, 64, perm, st)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    if case == "all_sentinel":
        assert got[2] == 0 and (got[0] == SENT).all() and not got[3].any()
        assert all(not x.any() for x in got[4:])
    if case == "every_row_one_group":
        assert got[2] == 1 and not got[3].any()
        if full:
            assert got[5][0] == N
    if case == "large_s1" and full:
        assert got[1].max() > (1 << 30) and got[7].max() > (1 << 30)


def test_plus499_below_zero():
    """softfloat's plus499_trunc, stated for S >= 0, below 0 (a dist sum
    of int32 gaps that wrapped): the low 11 bits of S sign-extended for
    n == 1, else 0, in the port and in the JAX package alike. The fold's
    kernel (csrc/loop_blocks.cu plus499) and the oracle (avg499) follow it
    there; the reference's double would give other values."""
    rng = np.random.default_rng(12)
    S = -np.concatenate([rng.integers(1, 1 << 11, 3000),
                         rng.integers(1, 1 << 33, 3000),
                         rng.integers(1, 1 << 52, 3000)]).astype(np.int64)
    n = np.concatenate([np.ones(4500, np.int64),
                        rng.integers(2, 1 << 31, 4500)])
    want = np.array([avg499(int(a), int(b)) for a, b in zip(S, n)])
    got = lk.sf.plus499_trunc(torch.from_numpy(S), torch.from_numpy(n))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(np.asarray(jsf.plus499_trunc(jnp.asarray(S),
                                                       jnp.asarray(n))), want)
    assert (want[:4500] != 0).any() and not want[4500:].any()


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def test_wrappers_count_plain_calls_on_cpu():
    rng = np.random.default_rng(0)
    lk.reset_counts()
    t, _ = locality_table(rng, 2, [3, 1, 4])
    run_locality(t, False, 1000, 3)
    keys, s1, jb, gb, perm = fold_inputs(rng, "jb", 100, n_vw=10)
    run_fold(keys, s1, jb, gb, 50, perm)
    run_fold(keys, s1, jb, gb, 50, perm)
    keys, s1, jb, gb, perm, st = fold_inputs(rng, "cosorted", 100, n_vw=10,
                                             full=True)
    run_fold(keys, s1, jb, gb, 50, perm, st)
    assert lk.n_calls == dict(
        {k: {"kernel": 0, "plain": 0} for k in lk.n_calls},
        branch_locality={"kernel": 0, "plain": 1},
        merge_fold={"kernel": 0, "plain": 3},
        merge_fold_full={"kernel": 0, "plain": 1})
    lk.reset_counts()
    assert all(v == 0 for c in lk.n_calls.values() for v in c.values())


def test_wrappers_reject_bad_inputs():
    rng = np.random.default_rng(1)
    t, _ = locality_table(rng, 2, [3, 2])
    args = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in t.items()}
    kw = dict(frag_mode=False, local_dist=10, local_count=3)
    bad = dict(args, r_cid=args["r_cid"].long())
    with pytest.raises(ValueError, match="r_cid"):
        lk.branch_locality(*bad.values(), **kw)
    bad = dict(args, gs_of=args["gs_of"][:-1])
    with pytest.raises(ValueError, match="gs_of"):
        lk.branch_locality(*bad.values(), **kw)
    bad = dict(args, r_cm=args["r_cm"].t())
    with pytest.raises(ValueError, match="r_cm"):
        lk.branch_locality(*bad.values(), **kw)
    keys = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="s1"):
        lk.merge_fold(keys, torch.zeros(8, dtype=torch.int64), jb=3, gb=1,
                      cap=4)
    with pytest.raises(ValueError, match="perm"):
        lk.merge_fold(keys, torch.zeros(8, dtype=torch.int32), jb=0, gb=1,
                      cap=4, perm=torch.zeros(7, dtype=torch.int64))
    with pytest.raises(ValueError, match="cap"):
        lk.merge_fold(keys, torch.zeros(8, dtype=torch.int32), jb=3, gb=1,
                      cap=0)


def chip_smoke():
    """chip_smoke.py as a module (its bounds are plain functions)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("perm", [False, True])
@pytest.mark.parametrize("full", [False, True])
def test_fold_bound_counts_valid_rows_only(full, perm):
    """chip_smoke.fold_bound_ms, merge_fold's least bytes: an invalid row
    (its key sorts last, its pair slot reads 0) costs its 4-byte pair slot
    and a binary search's reads, no key, permutation or score read."""
    cs = chip_smoke()
    jb = 21
    valid = torch.arange(1000, dtype=torch.int64) << jb
    nbytes = []
    for keys in (valid, torch.cat([valid, torch.full((3000,), lk.KSENT_I)])):
        kw = dict(jb=jb, cap=500, full=(None, None) if full else None,
                  perm=torch.arange(keys.numel()) if perm else None)
        _, by, n, n_valid = cs.fold_bound_ms((keys, None), kw)
        assert (by, n_valid) == ("bytes", 1000)
        nbytes.append(n)
    assert nbytes[1] - nbytes[0] == 4 * 3000 + 8 * (12 - 10)


def round_bytes(cs, name, st, **kw):
    make = round_calls(st, "cpu", **kw)[name]
    return cs.round_bound_ms(lk, name, make, round_outputs(name, *make()))[1]


@pytest.mark.parametrize("case", ["random", "far", "hit0_filtered"])
def test_walk_bound_counts_what_is_read(case):
    """chip_smoke.round_bound_ms of walk_pairs: cm is read only in the full
    mode (8 bytes a valid row more, beside s21 and dist2's 16 a row out),
    and cid, w and the segment (16 bytes) only at kept rows."""
    cs = chip_smoke()
    st = make_state(case, 3)
    G, H = st["cid"].shape
    n_valid = int(st["valid"].sum())
    kept = (st["flt"] == 0) & (st["shadow"] == 0) & st["valid"]
    assert kept.any() and not kept.all()
    lean, full = (round_bytes(cs, "walk_pairs", st, form=f)
                  for f in ("cosorted", "full"))
    assert full - lean == 16 * G * H + 8 * n_valid
    unkept = dict(st, flt=st["valid"].astype(np.uint8))
    for form in ("cosorted", "full"):
        assert (round_bytes(cs, "walk_pairs", st, form=form)
                - round_bytes(cs, "walk_pairs", unkept, form=form)
                == 16 * int(kept.sum()))


@pytest.mark.parametrize("cuts", [(1 << 20,) * 3, None])
def test_occ_bound_reads_loci_or_n_grp(cuts):
    """chip_smoke.round_bound_ms of occ_round: with n_grp the loci plane is
    rebuilt from it (4 bytes an arc, and its vw when the cuts do not read
    it already) and written, not read. (Cuts that delete no segment: the
    same values change with and without the loci.)"""
    cs = chip_smoke()
    st = make_state("random", 5)
    A = len(st["arc_vw"])
    got = [round_bytes(cs, "occ_round", st, cuts=cuts, loci=loci)
           for loci in (False, True)]
    assert got[1] - got[0] == 4 * A + (8 * A if cuts is None else 0)


@pytest.mark.parametrize("use_ori", [False, True])
@pytest.mark.parametrize("which", ["random", "hit0_filtered", "repeats"])
def test_step_bound_counts_what_is_read(which, use_ori):
    """chip_smoke.step_bound_bytes: step_walk reads a row's columns (21
    bytes; 25 with use_ori off, and dom_gid's 4 where score_ori <=
    score_dom) only at a kept row, flt and shadow only below n_rows, and
    nothing of a row past n_rows; step_dedupe reads dist, s1 and s2 only
    at a pair's row."""
    from pangene_tpu_torch.testing import step_calls, step_state
    cs = chip_smoke()
    cpu = torch.device("cpu")
    calls = step_calls(step_state(which, 4, cpu), cpu, use_ori)
    (cols, perm, flt, shadow, g2s), _ = calls["step_walk"]
    pair_ok = calls["step_dedupe"][0][2]
    G, H = flt.shape
    n_gene = g2s.shape[0]
    valid = torch.arange(H)[None, :] < cols.batch.n_rows[:, None]
    kept = valid & (flt == 0) & (shadow == 0)
    n_pairs = int((pair_ok != 0).sum())
    assert kept.any() and not kept[valid].all() and n_pairs > 0
    got = cs.step_bound_bytes(cols, perm, flt, shadow, g2s, use_ori,
                              pair_ok)
    # every row shadowed: no kept row's columns
    hidden = cs.step_bound_bytes(cols, perm, flt, torch.ones_like(shadow),
                                 g2s, use_ori, pair_ok)
    col = (21 if use_ori else 25) * int(kept.sum())
    if not use_ori:
        col += 4 * int((kept & (cols.score_ori <= cols.score_dom)).sum())
    assert got["step_walk"] - hidden["step_walk"] == col
    # no row below n_rows: perm, the outputs, n_rows, g2s and the counters
    empty = cols._replace(batch=cols.batch._replace(
        n_rows=torch.zeros_like(cols.batch.n_rows)))
    none = cs.step_bound_bytes(empty, perm, flt, shadow, g2s, use_ori,
                               torch.zeros_like(pair_ok))
    assert none["step_walk"] == (8 + 29) * G * H + 4 * G + 12 * n_gene
    assert none["step_dedupe"] == 2 * G * H * 44 + G * H
    assert got["step_dedupe"] - none["step_dedupe"] == 12 * n_pairs


# ---------------------------------------------------------------------------
# the rest of a round: walk_pairs, branch_prep, prop_round, occ_round
# against numpy oracles written from the JAX blocks' formulas
# (pangene_tpu/parallel/device_loop.py:222 kept_pairs and :264-300,
# :512-537, :673-690 in its scatter form, :693 occ_block and :724-740),
# row by row
# ---------------------------------------------------------------------------

def _clip(x, lo, hi):
    return min(max(int(x), lo), hi)


def _i64(x):
    return ((int(x) + (1 << 63)) % (1 << 64)) - (1 << 63)


def _i32(x):
    return ((int(x) + (1 << 31)) % (1 << 32)) - (1 << 31)


def oracle_walk(st, B, GB, jb, rank, use_ori):
    """The walk and key build row by row: (keys, s12, pair_ok, nxt, seg,
    s21, dist2, prev), prev per cm position."""
    G, H = st["cid"].shape
    S, ng = len(st["alive"]), len(st["sid_of"])
    keys = np.full((G, 2 * H), KSENT, np.int64)
    s12, s21, dist2 = (np.zeros((G, 2 * H), np.int32) for _ in range(3))
    pair_ok = np.zeros((G, H), bool)
    nxt = np.full((G, H), -1, np.int32)
    prevs = np.zeros((G, H), np.int64)
    seg = np.zeros((2, S), np.int32)
    sid = lambda gene: int(st["sid_of"][_clip(gene, 0, ng - 1)])
    for g in range(G):
        o = st["ordcm"][g]
        col = lambda n, i: st[n][g, o[i]]

        def score(i):
            so, sd = int(col("score_ori", i)), int(col("score_dom", i))
            dg = int(col("dom_gid", i))
            ds = sid(dg)
            dom_alive = dg >= 0 and ds >= 0 and st["alive"][_clip(ds, 0,
                                                                  S - 1)]
            return so if use_ori or so > sd or dg < 0 or dom_alive else sd

        w = lambda i: (sid(col("gid", i)) << 1) | int(col("rev", i))
        prev, present = -1, set()
        for i in range(H):
            h = o[i]
            kept = bool(st["valid"][g, h] and st["flt"][g, h] == 0
                        and st["shadow"][g, h] == 0)
            pc = max(prev, 0)
            ok = kept and prev >= 0 and col("cid", pc) == col("cid", i)
            v, wi, jg = w(pc), w(i), rank * G + g
            kf = (((v << B) | wi) << GB) | jg
            kr = ((((wi ^ 1) << B) | (v ^ 1)) << GB) | jg
            if jb:
                slot = rank * G * 2 * H + g * 2 * H
                kf, kr = (kf << jb) | (slot + i), (kr << jb) | (slot + H + i)
            if ok:
                keys[g, i], keys[g, H + i] = _i64(kf), _i64(kr)
            s1, s2 = score(pc), score(i)
            s12[g, i], s12[g, H + i] = s1, s2
            s21[g, i], s21[g, H + i] = s2, s1
            dist2[g, i] = dist2[g, H + i] = _i32(col("cm", i) - col("cm", pc))
            pair_ok[g, i] = ok
            prevs[g, i] = prev
            if kept:
                if prev >= 0:
                    nxt[g, prev] = i
                s = _clip(sid(col("gid", i)), 0, S - 1)
                seg[0, s] += 1
                present.add(s)
                prev = i
        for s in present:
            seg[1, s] += 1
    return keys, s12, pair_ok, nxt, seg, s21, dist2, prevs


def as_np(outs):
    return [o.numpy() for o in outs]


@pytest.mark.parametrize("use_ori", [False, True])
@pytest.mark.parametrize("form", list(WALK_FORMS))
@pytest.mark.parametrize("case", ROUND_EDGE_CASES)
def test_walk_pairs_plain_equals_oracle(case, form, use_ori):
    st = make_state(case, 7)
    args, kw = round_calls(st, "cpu", form=form,
                           use_ori=use_ori)["walk_pairs"]()
    got = as_np(lk.walk_pairs(*args, **kw))
    want = oracle_walk(st, kw["B"], kw["GB"], kw["jb"], kw["rank"], use_ori)
    names = ("keys", "s12", "pair_ok", "nxt", "seg", "s21", "dist2")
    assert len(got) == (7 if kw["full"] else 5)
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    if case == "all_filtered":
        assert (got[0] == KSENT).all() and not got[4].any()
    elif case != "empty_genomes":
        assert got[2].any()
    if case == "far" and kw["full"]:
        gaps = [int(st["cm"][g, st["ordcm"][g, i]])
                - int(st["cm"][g, st["ordcm"][g, want[7][g, i]]])
                for g, i in zip(*np.nonzero(want[2]))]
        assert max(abs(x) for x in gaps) >= 1 << 31


def oracle_prep(st, B):
    """The branch block's prelude: planes and targets."""
    G, H = st["cid"].shape
    S, ng = len(st["alive"]), len(st["sid_of"])
    r_pres = np.zeros((ng, G), bool)
    r_cid = np.zeros((ng, G), np.int32)
    r_cm = np.zeros((ng, G), np.int64)
    r_rank = np.zeros((ng, G), np.int32)
    for g in range(G):
        kept = (st["flt"][g] == 0) & (st["shadow"][g] == 0) & st["valid"][g]
        krank = np.cumsum(kept) - 1
        last = {}
        for h in np.flatnonzero(kept):
            last[_clip(st["gid"][g, h], 0, ng - 1)] = h
        for q in range(ng):
            lc = last.get(q, 0)
            r_pres[q, g] = q in last
            r_cid[q, g], r_cm[q, g] = st["cid"][g, lc], st["cm"][g, lc]
            r_rank[q, g] = krank[lc]
    vw = [int(x) for x in st["arc_vw"]]
    tgt = np.array([_clip(st["seg_gid"][_clip((x & ((1 << B) - 1)) >> 1, 0,
                                               S - 1)], 0, ng - 1)
                    for x in vw], np.int64)
    return r_pres, r_cid, r_cm, r_rank, tgt


BLOCK_KW = dict(frag_mode=False, local_dist=1000, local_count=3,
                branch_diff=0.02, branch_diff_dist=0.05, branch_diff_cut=0.5)


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("case", ROUND_EDGE_CASES)
def test_branch_prep_plain_equals_oracle(case, seed):
    """branch_prep's planes and targets equal the oracle's; the branch
    block on them equals the plain reference (plain_branch), groups of 64
    and 65 arcs (the wide path) in the window states included."""
    st = make_state(case, seed)
    args, kw = round_calls(st, "cpu")["branch_prep"]()
    out = round_outputs("branch_prep", args, kw)
    got = as_np(out)
    want = oracle_prep(st, kw["B"])
    assert len(got) == len(want) == 5
    for name, a, b in zip(("r_pres", "r_cid", "r_cm", "r_rank", "tgt_gid"),
                          got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    if case == "all_filtered":
        assert not got[0].any()
    vw = args[6]
    s1 = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 900, vw.shape[0]).astype(np.int32))
    block = lk.branch_block(*out, vw, s1, B=kw["B"], **BLOCK_KW)
    ref = plain_branch.mark_branch(*out, vw, s1, B=kw["B"], **BLOCK_KW)
    for a, b in zip(block, ref):
        assert torch.equal(a, b)


def wide_table(rng, G, band, n_groups, n_gene=400):
    """A v-sorted branch table (branch_table's, BRANCH_B) of n_groups
    groups of sizes drawn in [band - 3, band + 3] and a few small ones,
    on G genomes; cm spread so that about half the pairs are local."""
    sizes = list(rng.integers(max(band - 3, 1), band + 4, n_groups)) \
        + list(rng.integers(1, 6, 4))
    rng.shuffle(sizes)
    t, groups = branch_table(rng, G, sizes, n_gene=n_gene, p_absent=0.5)
    t["r_cm"][:] = rng.integers(0, 3000, t["r_cm"].shape)
    return t, sizes


@pytest.mark.parametrize("band", [64, 66, 150, 300])
@pytest.mark.parametrize("seed", range(4))
def test_wide_path_equals_plain_reference(seed, band):
    """Groups around the kernels' wide path (more than WIDE_ROWS members)
    and far past it: the plain branch block, and the mesh's split entries,
    equal the plain reference (every pair of every group, plain_branch)
    bit for bit, on 1-152 genomes, frag_mode both ways; the tally counts
    the groups of more than WIDE_ROWS members and the widest."""
    rng = np.random.default_rng(500 + seed)
    G = int(rng.choice([1, 7, 40, 152]))
    t, sizes = wide_table(rng, G, band, 2 if band < 150 else 1)
    args = [torch.from_numpy(np.ascontiguousarray(t[k])) for k in (
        "r_pres", "r_cid", "r_cm", "r_rank", "tgt_gid", "arc_vw", "arc_s1")]
    kw = dict(BLOCK_KW, frag_mode=bool(seed % 2))
    tally = torch.zeros(4, dtype=torch.int64)
    got = lk.branch_block(*args, B=BRANCH_B, **kw, tally=tally)
    want = plain_branch.mark_branch(*args, B=BRANCH_B, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    gs_of, mx, branching, is_max = lk.arc_groups(args[5], args[6], BRANCH_B)
    loc = {k: kw[k] for k in ("frag_mode", "local_dist", "local_count")}
    aml, he = lk.branch_locality(*args[:5], gs_of, branching, is_max, **loc)
    split = lk.branch_classify(args[6], mx, branching, aml, he, gs_of,
                               **{k: kw[k] for k in kw if k not in loc})
    for a, b in zip(split, want):
        assert torch.equal(a, b)
    sizes = np.array(sizes)
    assert tally.tolist() == [int(sizes.sum()), int(sizes[sizes >= 2].sum()),
                              int((sizes > lk.WIDE_ROWS).sum()),
                              int(sizes.max())]
    assert got[2].sum() > 0 and (~he & branching).any() and he.any()


# The scans' tile and the arc pass's block (csrc/loop_round.cu kScanTile,
# kArcRows * kScanThreads), and the seeds the scans' edge states are drawn
# from: the CPU oracle tests' and the card tests' (tests/test_torch_cuda.py);
# chip_smoke's is 200 + the state's place in ROUND_STATES.
SCAN_TILE = ARC_BLOCK = 1024
SCAN_EDGE_STATES = ("sparse_tiles", "tile_edges", "window_D_edge",
                    "window_D+1_edge")


def empty_tile_run(kept):
    """The most tiles in a row that hold no kept row and are followed, in
    their genome, by a tile that holds one."""
    G, H = kept.shape
    best = 0
    for g in range(G):
        run = 0
        for t in range(0, H, SCAN_TILE):
            if kept[g, t:t + SCAN_TILE].any():
                best, run = max(best, run), 0
            else:
                run += 1
    return best


@pytest.mark.parametrize("seed", [3, 5, 7, 9, 11, 13, 17, "chip_smoke"])
@pytest.mark.parametrize("which", SCAN_EDGE_STATES)
def test_scan_edge_states_hold_their_edges(which, seed):
    """Each state of ROUND_STATES made for the tiled scans holds its edge on
    every seed it is drawn from: sparse_tiles a genome whose kept rows skip
    two or more tiles in a row, in cs order (branch_prep's tiles) and in cm
    order (walk_pairs'); tile_edges kept rows only at tiles' first and last
    rows, both in use; the window states a group of exactly D = 64 or
    D + 1 arcs across an arc block's end."""
    if seed == "chip_smoke":
        seed = 200 + list(ROUND_STATES).index(which)
    st = make_state(which, seed)
    kept = (st["flt"] == 0) & (st["shadow"] == 0) & st["valid"]
    kept_cm = np.take_along_axis(kept, st["ordcm"].astype(np.int64), 1)
    if which == "sparse_tiles":
        assert empty_tile_run(kept) >= 2 and empty_tile_run(kept_cm) >= 2
    elif which == "tile_edges":
        for k in (kept, kept_cm):
            assert set(np.nonzero(k)[1] % SCAN_TILE) == {0, SCAN_TILE - 1}
    else:
        vw = st["arc_vw"]
        v = vw[vw != SENT] >> st["B"]
        heads = np.flatnonzero(np.r_[True, v[1:] != v[:-1]])
        sizes = np.diff(np.r_[heads, len(v)])
        n = 64 + ("D+1" in which)
        assert any(size == n and a // ARC_BLOCK != (a + n - 1) // ARC_BLOCK
                   for a, size in zip(heads, sizes))


def test_wide_rows_mirror_the_source():
    """WIDE_ROWS is csrc/loop_blocks.cu's kBrRows (kBrWarps x
    kBrWarpRows), the largest group of the kernels' block path."""
    import re
    src = open(lk._SRC).read()
    val = {k: int(re.search(r"constexpr int %s = (\d+);" % k, src).group(1))
           for k in ("kBrWarps", "kBrWarpRows")}
    assert re.search(r"constexpr int kBrRows = kBrWarps \* kBrWarpRows;",
                     src)
    assert lk.WIDE_ROWS == val["kBrWarps"] * val["kBrWarpRows"]


def test_branch_tally_counts_wide_groups():
    """The branch block's tally on the window states: a group of 64 arcs
    stays on the block path, one of 65 takes the wide path; both are the
    widest group there."""
    for which, wide in (("window_D", 0), ("window_D+1", 1)):
        st = make_state(which, 3)
        args, kw = round_calls(st, "cpu")["branch_prep"]()
        out = round_outputs("branch_prep", args, kw)
        vw = args[6]
        tally = torch.zeros(4, dtype=torch.int64)
        lk.branch_block(*out, vw, torch.ones(vw.shape[0], dtype=torch.int32),
                        B=kw["B"], **BLOCK_KW, tally=tally)
        valid = int((vw != SENT).sum())
        assert tally.tolist()[0] == valid and tally.tolist()[2:] == \
            [wide, 64 + wide]


def oracle_prop(st, prevs, pair_ok, propagate):
    """Weak propagation in the JAX block's scatter form (the earlier hit
    of a pair takes the forward arc's mark, the later the reverse's), the
    weak == 2 filter, (n_prop, changed)."""
    G, H = st["cid"].shape
    A = len(st["arc_weak"])
    weak, flt = st["weak"].copy(), st["flt"].copy()
    aw = lambda row: int(st["arc_weak"][_clip(row, 0, A - 1)])
    if propagate:
        for g, i in zip(*np.nonzero(pair_ok)):
            o = st["ordcm"][g]
            t = o[_clip(prevs[g, i], 0, H - 1)]
            weak[g, t] = max(weak[g, t], aw(st["pair_arc"][g, i]))
            weak[g, o[i]] = max(weak[g, o[i]], aw(st["pair_arc"][g, H + i]))
    hit = (weak == 2) & (flt == 0)
    flt[hit] = 1
    changed = (weak != st["weak"]).any() or hit.any()
    return weak, flt, np.array([((weak != 0) & st["valid"]).sum(),
                                int(changed)], np.int64)


@pytest.mark.parametrize("propagate", [True, False])
@pytest.mark.parametrize("case", ROUND_EDGE_CASES)
def test_prop_round_plain_equals_oracle(case, propagate):
    st = make_state(case, 13)
    calls = round_calls(st, "cpu", propagate=propagate)
    _, wkw = calls["walk_pairs"]()
    walk = oracle_walk(st, wkw["B"], wkw["GB"], wkw["jb"], 0, False)
    pair_ok, prevs = walk[2], walk[7]
    args, kw = calls["prop_round"]()
    got = as_np(round_outputs("prop_round", args, kw))
    want = oracle_prop(st, prevs, pair_ok, propagate)
    for name, a, b in zip(("weak", "flt", "word"), got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("seed", range(6))
def test_prop_gather_form_claims(seed):
    """prop_round's gather form rests on two claims, checked on random
    states: each genome's ordcm is a permutation of its rows, and each kept
    row is the previous row of at most one pair (nxt inverts prev), so the
    scatter maximum of the JAX block has no two writers of one row but a
    row's own reverse mark and its next pair's forward mark."""
    st = round_state(np.random.default_rng(100 + seed), 6, 64,
                     p_flt=0.1 * seed)
    G, H = st["cid"].shape
    for g in range(G):
        assert np.array_equal(np.sort(st["ordcm"][g]), np.arange(H))
    args, kw = round_calls(st, "cpu")["walk_pairs"]()
    _, _, pair_ok, nxt = as_np(lk.walk_pairs(*args, **kw)[:4])
    prevs = oracle_walk(st, kw["B"], kw["GB"], kw["jb"], 0, False)[7]
    for g in range(G):
        o = st["ordcm"][g]
        kept = st["valid"][g, o] & (st["flt"][g, o] == 0) \
            & (st["shadow"][g, o] == 0)
        followers = [i for i in range(H) if kept[i] and prevs[g, i] >= 0]
        targets = [prevs[g, i] for i in followers]
        assert len(set(targets)) == len(targets)
        assert all(kept[p] for p in targets)
        assert all(nxt[g, prevs[g, i]] == i for i in followers)
        assert (nxt[g][~np.isin(np.arange(H), targets)] == -1).all()
        assert not (pair_ok[g] & ~kept).any()


def oracle_occ(st, r, B, n_grp, cuts, R=4):
    """The occ block of round r with the loci from n_grp, the degrees of
    the arc table's runs, the capture rows and the change bit."""
    G, H = st["cid"].shape
    S, ng = len(st["alive"]), len(st["sid_of"])
    alive, flt, loci = st["alive"].copy(), st["flt"].copy(), \
        st["loci"].copy()
    logs = np.zeros((R, 10), np.int64)
    mask = np.zeros((R, S), np.uint8)
    deg_r = np.zeros((R, S, 2), np.int32)
    loci_r = np.zeros((R, S, 2), np.int32)
    tot_r = np.zeros((R, S), np.int32)
    vw = [int(x) for x in st["arc_vw"]]
    if n_grp is not None:
        loci[:] = 0
        for x, n in zip(vw, n_grp):
            v = x >> B
            loci.reshape(-1)[_clip(v >> 1, 0, S - 1) * 2 + (v & 1)] += n
    counts = [0, 0, 0]
    newdel = np.zeros(S, bool)
    changed = False
    if cuts is not None:
        occ_cut, deg_cut, loci_cut = cuts
        runs = {}
        for x in vw:
            if x != SENT:
                runs[x >> B] = runs.get(x >> B, 0) + 1
        deg = np.zeros(2 * S, np.int32)
        degd = np.zeros(S, bool)
        for v, n in runs.items():
            deg[_clip(v, 0, 2 * S - 1)] += n
            if n > deg_cut:
                degd[_clip(v >> 1, 0, S - 1)] = True
        deg_r[r] = deg.reshape(S, 2)
        occ_del = alive & (st["seg_tot"].astype(np.int64) > occ_cut)
        degd &= alive
        locid = alive & (loci.max(axis=1) > loci_cut)
        counts = [occ_del.sum(), (degd & ~occ_del).sum(),
                  (locid & ~degd & ~occ_del).sum()]
        newdel = occ_del | degd | locid
        alive &= ~newdel
        for g, h in zip(*np.nonzero(st["valid"] & (flt == 0))):
            sh = st["sid_of"][_clip(st["gid"][g, h], 0, ng - 1)]
            if sh < 0 or not alive[_clip(sh, 0, S - 1)]:
                flt[g, h] = 1
                changed = True
        changed |= newdel.any()
    logs[r, 3:7] = counts + [alive.sum()]
    mask[r] = newdel
    loci_r[r] = loci
    tot_r[r] = st["seg_tot"]
    return (alive, flt, loci, logs, mask, deg_r, loci_r, tot_r,
            np.array([0, int(changed)], np.int64))


@pytest.mark.parametrize("loci", [True, False])
@pytest.mark.parametrize("cuts", [(60, 3, 2), (4, 50, 1), None])
@pytest.mark.parametrize("case", ROUND_EDGE_CASES)
def test_occ_round_plain_equals_oracle(case, cuts, loci):
    st = make_state(case, 17)
    args, kw = round_calls(st, "cpu", r=2, cuts=cuts, loci=loci)[
        "occ_round"]()
    got = as_np(round_outputs("occ_round", args, kw))
    want = oracle_occ(st, 2, kw["B"], st["n_grp"] if loci else None, cuts)
    for name, a, b in zip(("alive", "flt", "loci", "logs", "dcap_mask",
                           "dcap_deg", "dcap_loci", "dcap_tot", "word"),
                          got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    if case == "window_D+1" and cuts is not None:
        assert got[5].max() == 65


def test_round_wrappers_reject_bad_inputs():
    st = make_state("random", 1)
    calls = round_calls(st, "cpu")
    for name, pos, bad, match in (
            ("walk_pairs", 1, lambda t: t.to(torch.int32), "flt"),
            ("walk_pairs", 3, lambda t: t.to(torch.uint8), "alive"),
            ("branch_prep", 6, lambda t: t.to(torch.int32), "arc_vw"),
            ("branch_prep", 7, lambda t: t.to(torch.int32), "seg_gid"),
            ("prop_round", 4, lambda t: t[:, :-1], "pair_arc"),
            ("prop_round", 8, lambda t: t.to(torch.int32), "word"),
            ("occ_round", 8, lambda t: t[:, :9], "logs"),
            ("occ_round", 3, lambda t: t.t(), "gid")):
        args, kw = calls[name]()
        args[pos] = bad(args[pos])
        with pytest.raises(ValueError, match=match):
            getattr(lk, name)(*args, **kw)
    args, kw = calls["occ_round"]()
    with pytest.raises(ValueError, match="occ_round"):
        lk.occ_round(*args, **dict(kw, r=4))
    args, kw = calls["walk_pairs"]()
    with pytest.raises(ValueError, match="walk_pairs"):
        lk.walk_pairs(*args, **dict(kw, jb=50))


# ---------------------------------------------------------------------------
# prop_round and occ_round on Hopper: the preconditions their designs rest
# on, held on every round state the CPU loop produces, and the designs'
# claims on the plain tensors
# ---------------------------------------------------------------------------

# (genomes, genes, isoforms, seed, single exon, options): the small
# synthetic corpus of tests/test_torch_device_loop.py, the single-exon
# shape under -J (tests/test_torch_single_exon.py), and two option sets of
# tests/test_torch_pressure.py
LOOP_RUNS = {"small": (10, 250, 3, 17, False, []),
             "single_exon_J": (20, 120, 1, 77, True, ["-J"]),
             "pressure_c1": (16, 1200, 3, 5, False, ["-c1"]),
             "pressure_T7-c3": (16, 1200, 3, 5, False, ["-T7", "-c3"])}
_loop_calls = {}


def loop_round_calls(run, tmp_path_factory, monkeypatch):
    """Every call of prop_round and occ_round in one engaged run of the
    port's loop on the CPU (--engine sharded --device cpu), by name: lists
    of (args cloned before the call, kw)."""
    if run in _loop_calls:
        return _loop_calls[run]
    from pangene_tpu_torch import cli, pipeline, util
    from pangene_tpu_torch.parallel import device_loop as dl
    from pangene_tpu_torch.testing import synth_paf_files
    ng, ngene, n_iso, seed, single, argv = LOOP_RUNS[run]
    files = synth_paf_files(str(tmp_path_factory.mktemp("loop_" + run)),
                            n_genome=ng, n_gene=ngene, n_iso=n_iso,
                            seed=seed, single_exon=single)
    calls = {"prop_round": [], "occ_round": []}
    # the loop launches both through their bindings: a launch's arguments
    # (a) with the bound ones (b, kw) in the wrapper's order
    order = {"prop_round": lambda b, kw, a: (
                 list(b[:4]) + list(a[:5]), dict(propagate=a[5])),
             "occ_round": lambda b, kw, a: (
                 list(b[:5]) + list(a[:2]) + list(b[7:13]) + [a[2]],
                 dict(r=a[3], B=kw["B"], n_grp=a[4], cuts=a[5]))}

    def spy(name):
        bind = getattr(lk, "bind_" + name)

        def bound(*b, **kw):
            out = bind(*b, **kw)

            def launch(*a):
                # n_grp too: the binding's plane, rewritten every round
                args, akw = order[name](b, kw, a)
                copy = lambda x: x.clone() if torch.is_tensor(x) else x
                calls[name].append(([copy(x) for x in args],
                                    {k: copy(v) for k, v in akw.items()}))
                return out.launch(*a)
            return lk.Bound(launch, out.out)
        return bound

    for name in calls:
        monkeypatch.setattr(lk, "bind_" + name, spy(name))
    monkeypatch.setenv("PANGENE_PARSE_WORKERS", "1")
    opt, files, extras = cli.parse_args(
        argv + ["--engine", "sharded", "--device", "cpu"] + files)
    util.verbose = 0
    try:
        pipeline.run(opt, files, out=io.StringIO(), **extras)
    finally:
        util.verbose = 3
    assert dl.LAST["engaged"], dl.LAST
    assert len(calls["prop_round"]) == len(calls["occ_round"]) \
        == dl.LAST["rounds_total"]
    _loop_calls[run] = calls
    return calls


def state_calls(source, tmp_path_factory, monkeypatch):
    """The prop_round and occ_round calls of a LOOP_RUNS run, or ("edge
    states") of every state of ROUND_EDGE_CASES through round_calls."""
    if source in LOOP_RUNS:
        return loop_round_calls(source, tmp_path_factory, monkeypatch)
    calls = {"prop_round": [], "occ_round": []}
    for which in ROUND_EDGE_CASES:
        c = round_calls(make_state(which, 21), "cpu")
        for name in calls:
            calls[name].append(c[name]())
    return calls


def check_arcs_sorted(prop, occ):
    for args, kw in occ:
        vw = args[5]
        sent = vw == SENT
        assert bool((vw[1:] >= vw[:-1]).all())
        # the empty slots only at the end
        assert not bool((sent[:-1] & ~sent[1:]).any())


def check_v_below_2S(prop, occ):
    for args, kw in occ:
        vw, S = args[5], args[0].numel()
        v = vw[vw != SENT] >> kw["B"]
        assert bool(((v >= 0) & (v < 2 * S)).all())


def check_n_grp_at_heads(prop, occ):
    seen = 0
    for args, kw in occ:
        if kw["n_grp"] is None:
            continue
        seen += 1
        _, _, g_new, _, _ = lk.arc_heads(args[5], kw["B"])
        # zero off the groups' first arcs, the empty slots among them
        assert not bool(((kw["n_grp"] != 0) & ~g_new).any())
    assert seen


def check_ordcm_permutation(prop, occ):
    for args, kw in prop:
        ordcm = args[3]
        H = ordcm.shape[1]
        assert torch.equal(ordcm.sort(dim=1).values,
                           torch.arange(H, dtype=ordcm.dtype).expand_as(
                               ordcm))


def check_nxt_forward(prop, occ):
    for args, kw in prop:
        nxt = args[5]
        G, H = nxt.shape
        row = torch.arange(H, dtype=nxt.dtype)
        assert bool(((nxt == -1) | (nxt > row)).all())
        for g in range(G):
            # over the kept rows that have a next pair: increasing
            n = nxt[g][nxt[g] >= 0]
            assert bool((n[1:] > n[:-1]).all())


PRECONDITIONS = {"arcs_sorted": check_arcs_sorted,
                 "v_below_2S": check_v_below_2S,
                 "n_grp_at_heads": check_n_grp_at_heads,
                 "ordcm_permutation": check_ordcm_permutation,
                 "nxt_forward": check_nxt_forward}


@pytest.mark.parametrize("check", list(PRECONDITIONS))
@pytest.mark.parametrize("source", list(LOOP_RUNS) + ["edge_states"])
def test_round_kernel_preconditions(source, check, tmp_path_factory,
                                    monkeypatch):
    """What the redesigned prop_round and occ_round rely on (the kernels
    equal their plain versions only where it holds), on every round state
    the CPU loop produces on four corpora and option sets, and on the
    edge states the card tests take: the arc table v-sorted with its empty
    slots at the end, every valid arc's v < 2S, n_grp zero off the groups'
    first arcs, ordcm a permutation of each genome's rows, nxt -1 or
    forward and increasing over the rows that have a next pair."""
    calls = state_calls(source, tmp_path_factory, monkeypatch)
    assert calls["prop_round"] and calls["occ_round"]
    PRECONDITIONS[check](calls["prop_round"], calls["occ_round"])


def run_lengths(arc_vw, n_grp, B, S):
    """occ_round's design on the plain tensors: a vertex's arcs found by
    lower bounds in the v-sorted table (the empty slots past every vertex);
    its degree is the run's length, its loci the n_grp at the run's first
    arc (0 without arcs). Returns (deg, loci), int32 [S, 2] each."""
    vw = arc_vw.numpy()
    key = np.where(vw == SENT, np.iinfo(np.int64).max, vw >> B)
    lb = np.searchsorted(key, np.arange(2 * S + 1), side="left")
    deg = (lb[1:] - lb[:-1]).astype(np.int32)
    loci = np.zeros(2 * S, np.int32)
    if n_grp is not None:
        has = deg > 0
        loci[has] = n_grp.numpy()[lb[:-1][has]]
    return deg.reshape(S, 2), loci.reshape(S, 2)


@pytest.mark.parametrize("source", list(LOOP_RUNS) + ["edge_states"])
def test_run_lengths_equal_scatter_sums(source, tmp_path_factory,
                                        monkeypatch):
    """The run-length degrees and head loci equal occ_round_plain's
    scatter sums (its dcap_deg row with the cuts, its loci with n_grp) on
    every occ_round call of the source."""
    calls = state_calls(source, tmp_path_factory, monkeypatch)
    for args, kw in calls["occ_round"]:
        args = [a.clone() for a in args]
        r, S = kw["r"], args[0].numel()
        deg, loci = run_lengths(args[5], kw["n_grp"], kw["B"], S)
        lk.occ_round_plain(*args, **kw)
        if kw["cuts"] is not None:
            assert np.array_equal(args[10][r].numpy(), deg)
        if kw["n_grp"] is not None:
            assert np.array_equal(args[7].numpy(), loci)


def prop_tiled(args, propagate, tile):
    """prop_round's design on the plain tensors, tile by tile of `tile`
    cm positions of a genome: the tile's forward marks and the state at its
    own cs rows staged as the kernel stages them (from the state before
    the call); nxt resolved from the tile when it falls inside it, else
    from the whole plane; a cs row outside the window read from the whole
    plane. Returns (weak, flt, word) as numpy."""
    weak, flt, valid, ordcm, pair_arc, nxt, pair_ok, arc_weak, _ = \
        [a.numpy() for a in args]
    w0, f0 = weak.copy(), flt.copy()
    weak, flt = weak.copy(), flt.copy()
    G, H = weak.shape
    A = len(arc_weak)
    ok2 = np.concatenate([pair_ok, pair_ok], axis=1)
    marks = np.where(ok2, arc_weak[np.clip(pair_arc, 0, A - 1)], 0)
    if propagate:
        for g in range(G):
            for i0 in range(0, H, tile):
                i = np.arange(i0, min(i0 + tile, H))
                n = len(i)
                s_fwd = marks[g, i]
                s_w, s_f = w0[g, i], f0[g, i]
                m = marks[g, H + i]
                j = nxt[g, i]
                jc = np.minimum(j, H - 1)
                inside = (j >= 0) & (jc >= i0) & (jc < i0 + n)
                outside = (j >= 0) & ~inside
                m = np.maximum(m, np.where(
                    inside, s_fwd[np.clip(jc - i0, 0, n - 1)], 0))
                m = np.maximum(m, np.where(
                    outside, marks[g, np.clip(jc, 0, H - 1)], 0))
                r = ordcm[g, i]
                x = r - i0
                win = (x >= 0) & (x < n)
                xc = np.clip(x, 0, n - 1)
                w = np.where(win, s_w[xc], w0[g, r])
                weak[g, r] = np.maximum(m, w)
                flt[g, r] = np.where(win, s_f[xc], f0[g, r])
    hit = (weak == 2) & (flt == 0)
    flt[hit] = 1
    changed = bool((weak != w0).any() or hit.any())
    return weak, flt, np.array([((weak != 0) & valid).sum(), int(changed)],
                               np.int64)


@pytest.mark.parametrize("propagate", [True, False])
@pytest.mark.parametrize("H_off", [-1, 0, 1])
@pytest.mark.parametrize("tile", [32, 64, 1024])
def test_prop_tile_resolution_equals_plain(tile, H_off, propagate):
    """The tile-wise resolution of nxt (from the tile's forward marks when
    the next pair falls inside it, else from the whole plane) and of the
    cs rows (the tile's own window, else the whole plane) equals
    prop_round_plain, at H = tile - 1, tile, tile + 1, with a cm order
    that moves rows across tiles, next pairs that cross them, and clamped
    arc rows."""
    H = tile + H_off
    rng = np.random.default_rng(tile + H_off + 7)
    st = round_state(rng, 3, H, S=60, n_gene=80, p_flt=0.3,
                     sizes=tuple(range(1, 12)), min_valid=H)
    # a local cm order as the loop's, with some rows moved across tiles
    for g in range(3):
        o = np.arange(H, dtype=np.int32)
        for a in rng.integers(0, H - 5, H // 8):
            o[[a, a + int(rng.integers(1, 5))]] = \
                o[[a + int(rng.integers(1, 5)), a]]
        st["ordcm"][g] = o
    st["pair_arc"][0, :5] = -3
    args, kw = round_calls(st, "cpu", propagate=propagate)["prop_round"]()
    # next pairs that cross a tile (the kept rows are a chain)
    nxt = args[5].numpy()
    crossing = ((nxt // tile) != (np.arange(H) // tile)) & (nxt >= 0)
    assert crossing.any() == (H > tile)
    want = as_np(round_outputs("prop_round", [a.clone() for a in args],
                               kw, plain=True))
    got = prop_tiled(args, propagate, tile)
    for name, a, b in zip(("weak", "flt", "word"), got, want):
        assert np.array_equal(a, b), name


def test_ordcm_locality_helper():
    """testing.ordcm_locality, which PERF.md quotes, on permutations with
    known answers: the identity (every word one sector when H is a
    multiple of 32; a genome that starts mid-sector takes two), a reversed
    genome, rows swapped across a word's and a tile's edge."""
    from pangene_tpu_torch.testing import ordcm_locality
    ident = torch.arange(64, dtype=torch.int32).repeat(2, 1)
    out = ordcm_locality(ident, tile=32)
    assert out == {"warps": 4, "one_sector": 1.0, "two_sectors": 1.0,
                   "identity": 1.0, "in_tile": 1.0, "max_shift": 0}
    # genome 1 of 40 rows starts at byte 40: its words span two sectors
    out = ordcm_locality(torch.arange(40, dtype=torch.int32).repeat(2, 1))
    assert out["warps"] == 4 and out["one_sector"] == 0.75
    assert out["two_sectors"] == 1.0
    rev = torch.arange(63, -1, -1, dtype=torch.int32)[None, :]
    out = ordcm_locality(rev, tile=32)
    assert out["one_sector"] == 1.0 and out["identity"] == 0.0
    assert out["in_tile"] == 0.0 and out["max_shift"] == 63
    sw = torch.arange(96, dtype=torch.int32)
    sw[[31, 32]] = sw[[32, 31]]       # across a word's and a tile's edge
    out = ordcm_locality(sw[None, :], tile=32)
    assert out["one_sector"] == pytest.approx(1 / 3)
    assert out["two_sectors"] == 1.0
    assert out["identity"] == pytest.approx(94 / 96)
    assert out["in_tile"] == pytest.approx(94 / 96)
    assert out["max_shift"] == 1


def test_sector_shares_helper():
    """testing.sector_shares, which chip_smoke.py prints for the arc rows
    prop_round gathers through: a word of 32 indices in one sector, in two,
    in 32, and a short last word."""
    from pangene_tpu_torch.testing import sector_shares
    rows = torch.tensor([list(range(32)) + list(range(16, 48))
                         + [64 * k for k in range(32)] + [7, 9]])
    assert sector_shares(rows) == (0.5, 0.75)
    assert sector_shares(torch.zeros((3, 5), dtype=torch.int32)) == \
        (1.0, 1.0)
