"""The plain versions of the device loop's two hand-written kernels
(pangene_tpu_torch/ops/loop_kernels.py) against independent numpy oracles,
on the CPU. Every output is an integer or a bit: tolerance 0 (exact).

  branch_locality  a scalar walk of branch.c:48-106 over explicit group
                   lists: for each arc of a branching group and each other
                   member within the branch window, pg_n_local (branch.c:
                   31-46) over the genomes; aml = a local max partner, he =
                   an earlier local partner.
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
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangene_tpu.ops import softfloat as jsf
from pangene_tpu_torch.ops import loop_kernels as lk
from pangene_tpu_torch.testing import (BRANCH_B, EXACT_BRANCH_DIFFS,
                                       branch_table, deficit_ratios,
                                       fold_inputs, locality_table)

torch.set_num_threads(1)

KSENT = lk.KSENT_I
SENT = lk.SENT_I
D = 64


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
                if p == a or abs(p - a) >= D:
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
    aml, he = lk.branch_locality(*args, D=D, frag_mode=frag_mode,
                                 local_dist=local_dist,
                                 local_count=local_count)
    assert aml.dtype == he.dtype == torch.bool
    return aml.numpy(), he.numpy()


@pytest.mark.parametrize("frag_mode", [False, True])
@pytest.mark.parametrize("G,seed", [(1, 0), (3, 1), (8, 2)])
def test_branch_locality_plain_equals_oracle(G, seed, frag_mode):
    """Groups of every size 1..D and one of D + 1 (its run falls back; the
    window must still give the oracle's bits), absent targets."""
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
    kw = dict(dict(D=D, frag_mode=frag_mode, local_dist=1000, local_count=3),
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
    """Groups of every size 1..D and one of D + 1 (its run falls back; the
    window must still give the oracle's bits); ratios whose deficit lies on
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
    assert lk.n_calls == {"branch_block": {"kernel": 0, "plain": 0},
                          "branch_locality": {"kernel": 0, "plain": 1},
                          "branch_classify": {"kernel": 0, "plain": 0},
                          "merge_fold": {"kernel": 0, "plain": 3},
                          "merge_fold_full": {"kernel": 0, "plain": 1}}
    lk.reset_counts()
    assert all(v == 0 for c in lk.n_calls.values() for v in c.values())


def test_wrappers_reject_bad_inputs():
    rng = np.random.default_rng(1)
    t, _ = locality_table(rng, 2, [3, 2])
    args = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in t.items()}
    kw = dict(D=D, frag_mode=False, local_dist=10, local_count=3)
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


@pytest.mark.parametrize("perm", [False, True])
@pytest.mark.parametrize("full", [False, True])
def test_fold_bound_counts_valid_rows_only(full, perm):
    """chip_smoke.fold_bound_ms, merge_fold's least bytes: an invalid row
    (its key sorts last, its pair slot reads 0) costs its 4-byte pair slot
    and a binary search's reads, no key, permutation or score read."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
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
