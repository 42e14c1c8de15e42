"""The CUDA sweep kernel and its batched entry (its fused LOOP and STEP
epilogues too) against their plain PyTorch versions, the per-round device
step and its kernels (ops/step_kernels.py: step_walk, step_dedupe), and
the device loop's block kernels (ops/loop_kernels.py: the branch block,
merge_fold, and the round kernels walk_pairs, branch_prep, prop_round and
occ_round) and the mesh's kernels (ops/mesh_kernels.py: protein_reduce and
the bucket exchange's pack, window and finish) against theirs, on the
card.

These tests need an NVIDIA GPU (the kernel has no CPU mode) and skip
without one. The file imports neither jax nor pangene_tpu, so it runs on a
machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda

Outputs are integers and must be exactly equal (tolerance 0).
"""
import numpy as np
import pytest
import torch

from pangene_tpu_torch import plain_branch
from pangene_tpu_torch.ops import device_engine as de
from pangene_tpu_torch.ops import loop_kernels as lk
from pangene_tpu_torch.ops import step_kernels as stk
from pangene_tpu_torch.ops import sweep_kernel as sk
from pangene_tpu_torch.parallel import stacked as st
from pangene_tpu_torch.ops.loop_kernels import SENT_I
from pangene_tpu_torch.testing import (BRANCH_B, EXACT_BRANCH_DIFFS,
                                       EXCHANGE_STATES,
                                       REDUCE_CASES, ROUND_STATES,
                                       SWEEP_EDGE_CASES,
                                       WALK_FORMS, band_genome, batch_cols,
                                       branch_table, deficit_ratios,
                                       fold_inputs, locality_table,
                                       make_state, random_genome,
                                       ROUND_INPLACE, round_calls,
                                       round_outputs,
                                       round_state, stack_cols,
                                       stacked_edge_cases, sweep_edge_case,
                                       SEEN_SMEM_GENES, STEP_STATES,
                                       loop_sweep_args, step_calls,
                                       step_state)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def sweep_both(d, g, device, mode, check_strand, f):
    """The kernel through the main path's entry, on the main path's packed
    upload, and the plain version on views of the same buffer."""
    n, E = g.n_hit, len(g.exon_os)
    buf = de.upload(d, g, device)
    W = sk.band_width(g.hits.cid, g.hits.cs, g.hits.ce)
    got = sk.unpack_out(sk.shadow_sweep_packed(buf, n, E, W, mode,
                                               check_strand, f), n)
    want = sk.shadow_sweep_plain(sk.unpack_cols(buf, n, E), W, mode,
                                 check_strand, f)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("f", [0.5, 0.3, 0.9])
@pytest.mark.parametrize("weak", [False, True])
@pytest.mark.parametrize("check_strand", [False, True])
@pytest.mark.parametrize("mode", [sk.SHADOW, sk.ISOFORM])
def test_kernel_vs_plain(cuda_device, mode, check_strand, weak, f):
    for seed in range(4):
        d, g = random_genome(np.random.default_rng(seed), n_hits=2000,
                             weak=weak, max_exon=6, max_cs=60000)
        got, want = sweep_both(d, g, cuda_device, mode, check_strand, f)
        assert got[0].any()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n_hits", [1, 2, 255, 256, 257])
def test_kernel_edges(cuda_device, n_hits):
    d, g = random_genome(np.random.default_rng(n_hits), n_hits=n_hits,
                         n_ctg=1, max_cs=500)
    got, want = sweep_both(d, g, cuda_device, sk.SHADOW, False, 0.5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [sk.SHADOW, sk.ISOFORM])
@pytest.mark.parametrize("case", SWEEP_EDGE_CASES)
def test_kernel_tile_cases(cuda_device, case, mode):
    """Tile edges, the large-W path, exons that outgrow shared memory,
    every hit filtered, one dense cluster: kernel == plain exactly."""
    d, g = sweep_edge_case(case)
    got, want = sweep_both(d, g, cuda_device, mode, False, 0.3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if case in ("all filtered", "no exons"):
        assert not got[0].any()


@pytest.mark.cuda
def test_cols_entry_matches_plain(cuda_device):
    """shadow_sweep on SweepCols (packed again on the card) equals the
    plain version."""
    d, g = random_genome(np.random.default_rng(9), n_hits=500, weak=True)
    cols = de.build_cols(d, g, cuda_device)
    W = sk.band_width(g.hits.cid, g.hits.cs, g.hits.ce)
    for a, b in zip(sk.shadow_sweep(cols, W, sk.SHADOW, True, 0.5),
                    sk.shadow_sweep_plain(cols, W, sk.SHADOW, True, 0.5)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_counts(cuda_device):
    d, g = random_genome(np.random.default_rng(1), n_hits=300)
    sk.reset_counts()
    sweep_both(d, g, cuda_device, sk.ISOFORM, False, 0.0)
    assert sk.n_kernel_launches == {sk.SHADOW: 0, sk.ISOFORM: 1}
    assert sk.n_plain_calls == {sk.SHADOW: 0, sk.ISOFORM: 0}
    sk.reset_counts()


def assert_batched_equals_per_genome(genomes, device, check_strand, f,
                                     split_form, H=None):
    """The batched kernel against the per-genome plain version, genome by
    genome, and (split_form) against its own plain version, the split
    forms of ops/device.py, on the whole batch (rows padded to H)."""
    bc, flt, weak, W = batch_cols(genomes, device, H)
    sk.reset_counts()
    marks, score, other = sk.shadow_sweep_batched(bc, flt, weak, W,
                                                  check_strand, f)
    assert sk.n_batched() == {"kernel": 1, "plain": 0}
    if split_form:
        want = sk.shadow_sweep_batched_plain(bc, flt, weak, W, check_strand,
                                             f)
        for a, b in zip((marks, score, other), want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    for j, (d, g) in enumerate(genomes):
        n = g.n_hit
        m, s, o, _ = sk.shadow_sweep_plain(de.build_cols(d, g, device), W,
                                           sk.SHADOW, check_strand, f)
        assert torch.equal(marks[j, :n], m)
        assert torch.equal(score[j, :n], s)
        assert torch.equal(other[j, :n], o)
        assert not marks[j, n:].any()
        assert (score[j, n:] == sk.SCORE_NONE).all()
        assert (other[j, n:] == sk.OTHER_NONE).all()
    sk.reset_counts()
    return marks


@pytest.mark.cuda
@pytest.mark.parametrize("f", [0.5, 0.3])
@pytest.mark.parametrize("check_strand", [False, True])
@pytest.mark.parametrize("seed0", [0, 20])
def test_batched_kernel_vs_plain(cuda_device, seed0, check_strand, f):
    sizes = (2000, 700, 0, 64, 65, 1, 1300)
    genomes = [random_genome(np.random.default_rng(seed0 + k), n_hits=n,
                             weak=True, max_exon=6, max_cs=30 * n + 100)
               for k, n in enumerate(sizes)]
    marks = assert_batched_equals_per_genome(genomes, cuda_device,
                                             check_strand, f, True)
    assert marks.any()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["tile", "wide"])
def test_batched_kernel_stacked_edge_cases(cuda_device, which):
    """The edge cases as genomes of one batch, with an empty genome and a
    genome whose row 0 is filtered. The split form's exon block does not
    fit the 2,000-exon hit, so the whole-batch comparison leaves it out."""
    genomes = stacked_edge_cases()[which]
    assert_batched_equals_per_genome(genomes, cuda_device, False, 0.3, False)
    small = [(d, g) for d, g in genomes if int(g.hits.n_exon.max(
        initial=0)) < 100]
    assert len(small) == len(genomes) - 1
    assert_batched_equals_per_genome(small, cuda_device, False, 0.3, True)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 8, 21, 32, 33])
def test_batched_kernel_band_widths(cuda_device, W):
    """Genomes whose band is exactly W (the loop's 8, the per-round path's
    21, the staged halo's 32, the large-W path past it) at the batched
    tile's edges, empty genomes, and rows padded past the longest genome:
    tiles of padding only."""
    rows = sk.tile_shape(batched=True)[0]
    sizes = (rows - 1, 0, rows, rows + 1, 2 * rows + W, 0, 700, 5)
    genomes = [band_genome(np.random.default_rng(10 * W + k), n, W)
               for k, n in enumerate(sizes)]
    marks = assert_batched_equals_per_genome(genomes, cuda_device, False,
                                             0.3, True, H=5 * rows + 3)
    assert marks.any()
    shape = sk.launch_shape_batched(len(sizes), 5 * rows + 3, W)
    assert shape["items"] == len(sizes) * 6 and shape["blocks"] >= 1
    assert shape["halo"] == (W if W <= sk.tile_shape()[1] else 0)


@pytest.mark.cuda
def test_batched_wrapper_raises_on_bad_columns(cuda_device):
    genomes = [random_genome(np.random.default_rng(3), n_hits=100)]
    bc, flt, weak, W = batch_cols(genomes, cuda_device)
    with pytest.raises(ValueError):
        sk.shadow_sweep_batched(bc, flt.cpu(), weak, W, False, 0.5)
    with pytest.raises(ValueError):
        sk.shadow_sweep_batched(bc._replace(ce=bc.ce.to(torch.int32)), flt,
                                weak, W, False, 0.5)


def assert_step_equals_plain(genomes, device, check_strand, use_ori, f):
    """The per-round step on the card (one launch of the fused sweep)
    against the whole step on the CPU (the plain versions): every output
    equal."""
    cols, flt, shadow, weak, g2s, W = stack_cols(genomes, device, seed=1)
    kw = dict(W=W, min_ov_ratio=f, check_strand=check_strand,
              use_ori=use_ori)
    sk.reset_counts()
    got = st.round_step(cols, flt, shadow, weak, g2s, **kw)
    assert sk.n_batched() == {"kernel": 1, "plain": 0}
    cpu = torch.device("cpu")
    c_cols, c_flt, c_shadow, c_weak, c_g2s, c_W = stack_cols(genomes, cpu,
                                                             seed=1)
    assert c_W == W
    host = st.round_step(c_cols, c_flt, c_shadow, c_weak, c_g2s, **kw)
    for name, a, c in zip(st.STEP_OUTPUTS, got, host):
        assert a.dtype == c.dtype, name
        assert torch.equal(a.cpu(), c), name
    sk.reset_counts()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("f", [0.5, 0.3])
@pytest.mark.parametrize("use_ori", [False, True])
@pytest.mark.parametrize("check_strand", [False, True])
def test_round_step_kernel_vs_plain(cuda_device, check_strand, use_ori, f):
    sizes = (2000, 700, 0, 64, 65, 1, 1300)
    genomes = [random_genome(np.random.default_rng(60 + k), n_hits=n,
                             weak=True, max_exon=6, max_cs=30 * n + 100)
               for k, n in enumerate(sizes)]
    genomes[1][1].hits.flt[0] = 1
    got = assert_step_equals_plain(genomes, cuda_device, check_strand,
                                   use_ori, f)
    assert got[0].any() and got[4].any()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["tile", "wide"])
def test_round_step_stacked_edge_cases(cuda_device, which):
    """The edge cases as one stack (the split-form plain sweep cannot hold
    the 2,000-exon hit, which is left out)."""
    genomes = [(d, g) for d, g in stacked_edge_cases()[which]
               if int(g.hits.n_exon.max(initial=0)) < 100]
    assert_step_equals_plain(genomes, cuda_device, False, False, 0.3)


@pytest.mark.cuda
def test_reduction_step_on_card(cuda_device):
    rng = np.random.default_rng(4)
    G, H, P = 5, 3000, 700
    cols = [torch.from_numpy(rng.integers(0, P if k == 0 else 900, (G, H))
                             .astype(np.int32)) for k in range(4)]
    cols.append(torch.from_numpy(rng.integers(0, 2, (G, H)).astype(np.int32)))
    flt = torch.from_numpy(rng.integers(0, 2, (G, H)).astype(np.uint8))
    n_rows = torch.tensor([H, 0, 17, H - 1, 1000], dtype=torch.int32)
    want = st.reduction_step(*cols, flt, n_rows, n_prot=P)
    got = st.reduction_step(*[c.to(cuda_device) for c in cols],
                            flt.to(cuda_device), n_rows.to(cuda_device),
                            n_prot=P)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_mesh_two_ranks_share_the_card(cuda_device, tmp_path):
    """Two gloo ranks on cuda:0 (PANGENE_MESH_SHARE_DEVICE=1), each a process
    of its own, build the small corpus's GFA of one rank on the card, and
    both launch the batched kernel on their shard."""
    import hashlib
    import io
    import os
    import pathlib
    from pangene_tpu_torch import pipeline, util
    from pangene_tpu_torch.options import PgOpt
    from pangene_tpu_torch.testing import run_ranks, synth_paf_files
    files = synth_paf_files(str(tmp_path), n_genome=8, n_gene=300, n_iso=3,
                            seed=11)
    util.verbose = 0
    out = io.StringIO()
    pipeline.run(PgOpt(device="cuda"), files, out=out)
    util.verbose = 3
    reports = run_ranks(
        2, ["--engine", "sharded", "--devices", "2", "-v", "1"] + files,
        env=dict(os.environ, PANGENE_MESH_SHARE_DEVICE="1"),
        cwd=str(pathlib.Path(__file__).resolve().parent.parent))
    for rep in reports:
        assert rep["md5"] == hashlib.md5(out.getvalue().encode()).hexdigest()
        assert rep["LAST"]["engaged"] is True
        assert rep["mesh"]["backend"] == "gloo"
        assert rep["mesh"]["staged_bytes"] > 0
        assert rep["batched_launches"] > 0 and rep["plain_calls"] == 0
        ll = rep["loop_launches"]
        assert ll["branch_block"] == 0 and ll["merge_fold"] > 0
        assert ll["merge_fold_full"] == 1
        assert ll["branch_locality"] == ll["branch_classify"] \
            == rep["LAST"]["rounds_branch_run"] > 0


# ---------------------------------------------------------------------------
# the device loop's block kernels (csrc/loop_blocks.cu)
# ---------------------------------------------------------------------------

def locality_both(t, device, **kw):
    """branch_locality through its wrapper (the kernel) and its plain
    version, on the same tensors on the card."""
    args = [torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for v in t.values()]
    kw = dict(dict(frag_mode=False, local_dist=1000, local_count=3), **kw)
    before = dict(lk.n_calls["branch_locality"])
    got = lk.branch_locality(*args, **kw)
    want = lk.branch_locality_plain(*args, **kw)
    torch.cuda.synchronize()
    assert lk.n_calls["branch_locality"] == dict(
        before, kernel=before["kernel"] + 1)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("frag_mode", [False, True])
@pytest.mark.parametrize("G", [1, 8, 33, 64, 70])
def test_branch_locality_kernel_vs_plain(cuda_device, G, frag_mode):
    """Groups of every size 1..64 and one of 65, genomes in one, two and
    three lane passes."""
    rng = np.random.default_rng(G)
    sizes = list(rng.permutation(np.arange(1, 65))) + [65]
    t, _ = locality_table(rng, G, sizes, n_gene=300)
    got, want = locality_both(t, cuda_device, frag_mode=frag_mode)
    assert got[0].any() and got[1].any()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.bool and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["no_branching", "all_absent", "one_pair",
                                  "wide_130"])
def test_branch_locality_kernel_edges(cuda_device, case):
    rng = np.random.default_rng(5)
    sizes = {"no_branching": [1] * 40, "all_absent": [3, 5, 2],
             "one_pair": [1, 2, 1], "wide_130": [130, 9, 66, 3]}[case]
    t, _ = locality_table(rng, 5, sizes,
                          p_absent=1.0 if case == "all_absent" else 0.3)
    got, want = locality_both(t, cuda_device)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


DIFFS = {"default": (0.02, 0.05, 0.5), "exact": EXACT_BRANCH_DIFFS}


def branch_block_both(t, device, diffs="default", **kw):
    """branch_block through its wrapper (the kernel) and its plain version,
    and the mesh's split entries (branch_locality, branch_classify
    kernels), on the same tensors on the card: (kernel, plain, split)."""
    args = [torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for v in t.values()]
    kw = dict(dict(frag_mode=False, local_dist=1000, local_count=3), **kw)
    cls = dict(zip(("branch_diff", "branch_diff_dist", "branch_diff_cut"),
                   DIFFS[diffs]))
    before = {k: dict(lk.n_calls[k]) for k in lk.n_calls}
    got = lk.branch_block(*args, B=BRANCH_B, **kw, **cls)
    want = lk.branch_block_plain(*args, B=BRANCH_B, **kw, **cls)
    gs_of, mx, branching, is_max = lk.arc_groups(args[5], args[6], BRANCH_B)
    aml, he = lk.branch_locality(*args[:5], gs_of, branching, is_max, **kw)
    split = lk.branch_classify(args[6], mx, branching, aml, he, gs_of, **cls)
    torch.cuda.synchronize()
    for k in ("branch_block", "branch_locality", "branch_classify"):
        assert lk.n_calls[k] == dict(before[k],
                                     kernel=before[k]["kernel"] + 1)
    return got, want, split


def assert_branch_equal(got, want, split):
    for a, b, c in zip(got, want, split):
        assert a.dtype == b.dtype == c.dtype and a.shape == b.shape
        assert torch.equal(a, b) and torch.equal(c, b)


@pytest.mark.cuda
@pytest.mark.parametrize("diffs", list(DIFFS))
@pytest.mark.parametrize("frag_mode", [False, True])
@pytest.mark.parametrize("G", [1, 8, 33, 64, 70])
def test_branch_block_kernel_vs_plain(cuda_device, G, frag_mode, diffs):
    """Groups of every size 1..64 (the warp's, the block's) and one of 65
    (the wide path); ratios on and beside each branch constant, s1 == mx,
    s1 == 0; genomes in one, two and three chunks."""
    rng = np.random.default_rng(G)
    sizes = list(rng.permutation(np.arange(1, 65))) + [65]
    t, _ = branch_table(rng, G, sizes, n_gene=300,
                        ratios=deficit_ratios(DIFFS[diffs]))
    got, want, split = branch_block_both(t, cuda_device, diffs,
                                         frag_mode=frag_mode)
    assert int(got[2][0]) > 0 and int(got[2][1]) > 0
    assert_branch_equal(got, want, split)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["no_branching", "pairs", "one_group_D",
                                  "all_equal_s1", "all_absent", "wide_130",
                                  "many_groups"])
def test_branch_block_kernel_edges(cuda_device, case):
    """No branching arc; groups of two; one group of D = 64 (the block
    path's largest); one s1 for all; no representative present; groups of
    130 and 66 (the wide path) among small ones; and 20,000 groups of 2-20
    members (many blocks, many warps' heads)."""
    rng = np.random.default_rng(6)
    sizes = {"no_branching": [1] * 40, "pairs": [2] * 50,
             "one_group_D": [64], "all_equal_s1": [5, 7, 3, 17],
             "all_absent": [3, 5, 2], "wide_130": [130, 9, 66, 3],
             "many_groups": list(rng.integers(2, 21, 20000))}[case]
    t, _ = branch_table(rng, 64, sizes, n_gene=2000,
                        p_absent=1.0 if case == "all_absent" else 0.3)
    if case == "all_equal_s1":
        t["arc_s1"][:] = 77
    got, want, split = branch_block_both(t, cuda_device)
    assert_branch_equal(got, want, split)


def wide_args(seed, G, sizes, device, n_gene=600):
    """branch_block's arguments on the card: a branch_table of `sizes`
    with cm spread so that about half the pairs are local."""
    rng = np.random.default_rng(seed)
    t, _ = branch_table(rng, G, sizes, n_gene=n_gene, p_absent=0.5)
    t["r_cm"][:] = rng.integers(0, 3000, t["r_cm"].shape)
    return [torch.from_numpy(np.ascontiguousarray(t[k])).to(device)
            for k in ("r_pres", "r_cid", "r_cm", "r_rank", "tgt_gid",
                      "arc_vw", "arc_s1")]


WIDE_CASES = {
    "65": (1, [65]), "66_152": (152, [3, 66, 2]), "96": (40, [96, 7]),
    "128_33": (33, [128]), "129": (70, [5, 129, 64, 65]),
    "200": (152, [200, 1, 2]), "300": (152, [300]),
    "many_65_70": (16, [65, 66, 67, 68, 69, 70] * 40),
}


@pytest.mark.cuda
@pytest.mark.parametrize("frag_mode", [False, True])
@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_wide_path_kernel_vs_reference(cuda_device, case, frag_mode):
    """Groups of 65-300 members on 1-152 genomes (the kernels' wide path):
    the kernel equals the plain reference (plain_branch: every pair of
    every group) and the plain version bit for bit, and so do the split
    entries; the tally equals the plain version's; launched twice on one
    scratch, which each launch leaves zeroed."""
    G, sizes = WIDE_CASES[case]
    args = wide_args(len(case), G, sizes, cuda_device)
    kw = dict(B=BRANCH_B, frag_mode=frag_mode, local_dist=1000,
              local_count=3, branch_diff=0.02, branch_diff_dist=0.05,
              branch_diff_cut=0.5)
    tally = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    sc = lk.branch_scratch(cuda_device, args[5].shape[0])
    bound = lk.bind_branch_block(*args, **kw, tally=tally, scratch=sc)
    for _ in range(2):
        got = bound.launch(*args, torch.zeros(2, dtype=torch.int64,
                                              device=cuda_device))
        torch.cuda.synchronize()
        want = plain_branch.mark_branch(*args, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert not sc.any()
    ptally = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    plain = lk.branch_block_plain(*args, **kw, tally=ptally)
    for a, b in zip(plain, want):
        assert torch.equal(a, b)
    assert tally.tolist() == [2 * x for x in ptally.tolist()[:3]] \
        + ptally.tolist()[3:]
    assert ptally.tolist()[2] == sum(n > lk.WIDE_ROWS for n in sizes)
    loc = {k: kw[k] for k in ("frag_mode", "local_dist", "local_count")}
    gs_of, mx, branching, is_max = lk.arc_groups(args[5], args[6], BRANCH_B)
    aml, he = lk.branch_locality(*args[:5], gs_of, branching, is_max, **loc)
    split = lk.branch_classify(args[6], mx, branching, aml, he, gs_of,
                               **{k: kw[k] for k in ("branch_diff",
                                                     "branch_diff_dist",
                                                     "branch_diff_cut")})
    torch.cuda.synchronize()
    for a, b in zip(split, want):
        assert torch.equal(a, b)


def fold_both(keys, s1, jb, gb, cap, perm, device, full=None):
    """merge_fold through its wrapper (the kernel, exactly one launch) and
    its plain version on the same tensors on the card."""
    on = lambda x: None if x is None else torch.from_numpy(x).to(device)
    args = (on(keys), on(s1))
    kw = dict(jb=jb, gb=gb, cap=cap, perm=on(perm),
              full=None if full is None else tuple(map(on, full)))
    names = ("merge_fold", "merge_fold_full")
    before = {k: dict(lk.n_calls[k]) for k in names}
    got = lk.merge_fold(*args, **kw)
    after = {k: dict(lk.n_calls[k]) for k in names}
    want = lk.merge_fold_plain(*args, **kw)
    torch.cuda.synchronize()
    assert after["merge_fold"] == dict(
        before["merge_fold"], kernel=before["merge_fold"]["kernel"] + 1)
    assert after["merge_fold_full"] == dict(
        before["merge_fold_full"], kernel=before["merge_fold_full"]["kernel"]
        + (full is not None))
    assert len(got) == len(want) == (4 if full is None else 8)
    return got, want


def assert_fold_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("N,cap", [(1000, 1000), (3000, 3000), (3000, 100),
                                   (3000, 3077), (600000, 400000),
                                   (1310720, 327680)])
@pytest.mark.parametrize("form", ["jb", "cosorted", "exchange"])
def test_merge_fold_kernel_vs_plain(cuda_device, form, N, cap, full):
    """N below one tile (1,024 rows), not a multiple of the tile, and the
    big loop's 1,310,720 keys; cap below n_out (the overflow the loop falls
    back on) and above N; out-groups of ~8 rows, many crossing a tile's
    end."""
    rng = np.random.default_rng(N + cap)
    keys, s1, jb, gb, perm, st = fold_inputs(rng, form, N, n_vw=N // 8,
                                             full=True)
    got, want = fold_both(keys, s1, jb, gb, cap, perm, cuda_device,
                          st if full else None)
    assert int(got[2]) > 0
    assert_fold_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("case", ["all_sentinel", "one_row", "large_s1",
                                  "one_group", "long_groups",
                                  "tile_edge_groups", "every_row_one_group",
                                  "dist_near_2_31", "dist_wrapped"])
@pytest.mark.parametrize("form", ["jb", "cosorted", "exchange"])
def test_merge_fold_kernel_edges(cuda_device, form, case, full):
    """long_groups: out-groups of ~6,700 rows, each over several tiles;
    tile_edge_groups: out-groups of ~1,020 rows (near one tile's 1,024),
    nearly all crossing a tile's end, their in-groups of ~130 rows too;
    every_row_one_group: one out-group of 40,000 rows over 20 tiles;
    dist_near_2_31: sums near and past 2^31; dist_wrapped: int32 gaps of
    either sign, sums below 0."""
    rng = np.random.default_rng(9)
    N = {"one_row": 1, "long_groups": 20000, "tile_edge_groups": 60000,
         "every_row_one_group": 40000}.get(case, 500)
    kw = dict(n_vw={"one_group": 1, "every_row_one_group": 1,
                    "long_groups": 3, "tile_edge_groups": 47}.get(case, 60),
              p_valid={"all_sentinel": 0.0, "one_row": 1.0,
                       "every_row_one_group": 1.0}.get(case, 0.8),
              smax=(1 << 31) - 1 if case == "large_s1" else 1000,
              dist={"dist_near_2_31": ((1 << 30) - 50, (1 << 30) + 50),
                    "dist_wrapped": (-(1 << 31), 1 << 31)}.get(
                        case, (0, 1 << 20)))
    if case.startswith("dist") or case == "tile_edge_groups":
        kw["n_g"] = 2 if case.startswith("dist") else 8
    keys, s1, jb, gb, perm, st = fold_inputs(rng, form, N, full=True, **kw)
    got, want = fold_both(keys, s1, jb, gb, 64, perm, cuda_device,
                          st if full else None)
    assert_fold_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sizes", ["random", "warp_edges", "past_D"])
def test_branch_classify_kernel_vs_plain(cuda_device, sizes, aligned):
    """branch_classify alone on groups of every size up to D = 64 (random),
    groups crossing the warps' 128-arc boundaries (warp_edges), and groups
    of 100-700 members over several warps (past_D, which the loop falls
    back on); the bit planes as the mesh passes them (he the second row
    of one [2, A] tensor, so unaligned unless A % 4 == 0) or fresh.
    Exactly one launch a call."""
    rng = np.random.default_rng(len(sizes) + aligned)
    sz = {"random": list(rng.integers(1, 65, 3000)),
          "warp_edges": [125, 3, 1, 126, 130, 2, 127, 129] * 40,
          "past_D": list(rng.integers(100, 700, 60))}[sizes]
    vw, s1 = [], []
    for k, n in enumerate(sz):
        vw += [(2 * k + 1) << BRANCH_B] * int(n)
        mx = int(rng.integers(1, 3000))
        s1 += list(rng.integers(0, mx + 1, int(n)))
    vw = np.array(vw + [SENT_I] * 7, np.int64)
    s1 = np.array(s1 + [0] * 7, np.int32)
    if aligned:
        vw, s1 = vw[:len(vw) // 4 * 4], s1[:len(s1) // 4 * 4]
    A = len(vw)
    assert (A % 4 == 0) == aligned
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
    gs_of, mx, branching, is_max = lk.arc_groups(on(vw), on(s1), BRANCH_B)
    bits = torch.from_numpy(rng.random((2, A)) < 0.4).to(cuda_device)
    aml, he = (bits[0].clone(), bits[1].clone()) if aligned else bits
    cls = dict(zip(("branch_diff", "branch_diff_dist", "branch_diff_cut"),
                   DIFFS["default"]))
    args = (on(s1), mx, branching, aml, he, gs_of)
    before = dict(lk.n_calls["branch_classify"])
    got = lk.branch_classify(*args, **cls)
    after = dict(lk.n_calls["branch_classify"])
    want = lk.branch_classify_plain(*args, **cls)
    torch.cuda.synchronize()
    assert after == dict(before, kernel=before["kernel"] + 1)
    assert int(want[1].sum()) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_plus499_equals_softfloat(cuda_device):
    """The fold's IEEE (int)((double)s / n + .499) against softfloat's
    integer form (the plain version's), on out-groups of 1 to ~100
    in-groups whose s1 reach the int32 maximum."""
    rng = np.random.default_rng(11)
    n = 200000
    vw = rng.integers(0, n // 50, n)
    g = rng.integers(0, 1024, n)
    keys = np.sort((((vw << 10) | g) << 18) | np.arange(n)).astype(np.int64)
    s1 = rng.integers(0, (1 << 31) - 1, n).astype(np.int32)
    s1[rng.random(n) < 0.2] = (1 << 31) - 1
    got, want = fold_both(keys, s1, 18, 10, n, None, cuda_device)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_loop_kernel_wrappers_raise_on_bad_inputs(cuda_device):
    """A CUDA tensor of the wrong type, shape or layout, or on the CPU
    beside CUDA tensors, raises; the plain version is never taken."""
    t, _ = locality_table(np.random.default_rng(2), 4, [3, 2, 5])
    args = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda_device)
            for k, v in t.items()}
    kw = dict(frag_mode=False, local_dist=10, local_count=3)
    lk.reset_counts()
    for bad in (dict(args, r_rank=args["r_rank"].long()),
                dict(args, tgt_gid=args["tgt_gid"][:-1]),
                dict(args, r_cm=args["r_cm"].t()),
                dict(args, is_max=args["is_max"].cpu())):
        with pytest.raises(ValueError):
            lk.branch_locality(*bad.values(), **kw)
    bt, _ = branch_table(np.random.default_rng(3), 4, [3, 2, 5])
    bargs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda_device)
             for k, v in bt.items()}
    cls = dict(branch_diff=0.02, branch_diff_dist=0.05, branch_diff_cut=0.5)
    for bad in (dict(bargs, arc_s1=bargs["arc_s1"].long()),
                dict(bargs, arc_vw=bargs["arc_vw"][:-1]),
                dict(bargs, r_pres=bargs["r_pres"].cpu())):
        with pytest.raises(ValueError):
            lk.branch_block(*bad.values(), B=BRANCH_B, **kw, **cls)
    gs_of, mx, branching, is_max = lk.arc_groups(bargs["arc_vw"],
                                                 bargs["arc_s1"], BRANCH_B)
    ok = dict(arc_s1=bargs["arc_s1"], mx=mx, branching=branching,
              aml=is_max, he=is_max, gs_of=gs_of)
    for bad in (dict(ok, mx=mx.long()), dict(ok, he=is_max.cpu()),
                dict(ok, gs_of=gs_of[:-1])):
        with pytest.raises(ValueError):
            lk.branch_classify(*bad.values(), **cls)
    keys = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    s1 = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    for bad in (dict(s1=s1.long()), dict(s1=s1[:7]),
                dict(perm=torch.zeros(8, dtype=torch.int32,
                                      device=cuda_device)),
                dict(keys=keys.cpu())):
        a = dict(dict(keys=keys, s1=s1, perm=None), **bad)
        with pytest.raises(ValueError):
            lk.merge_fold(a["keys"], a["s1"], jb=3, gb=1, cap=4,
                          perm=a["perm"])
    assert all(c["plain"] == 0 and c["kernel"] == 0
               for c in lk.n_calls.values())


# ---------------------------------------------------------------------------
# the round kernels (walk_pairs, branch_prep, prop_round, occ_round)
# ---------------------------------------------------------------------------

def round_both(name, which, form, seed, **kw):
    """Kernel `name` and its plain version on one round_state on the card:
    both outputs (returned values, then the arguments updated in place)."""
    calls = round_calls(make_state(which, seed), torch.device("cuda"),
                        form=form, **kw)
    args, akw = calls[name]()
    got = round_outputs(name, args, akw)
    args, akw = calls[name]()
    want = round_outputs(name, args, akw, plain=True)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(WALK_FORMS))
@pytest.mark.parametrize("which", list(ROUND_STATES))
def test_walk_pairs_kernel_vs_plain(cuda_device, which, form):
    lk.reset_counts()
    for use_ori in (False, True):
        got, want = round_both("walk_pairs", which, form, 3,
                               use_ori=use_ori)
        assert len(got) == len(want) == (7 if form == "full" else 5)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert lk.n_calls["walk_pairs"] == {"kernel": 2, "plain": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 6])
@pytest.mark.parametrize("which", list(ROUND_STATES))
def test_branch_prep_kernel_vs_plain(cuda_device, which, seed):
    got, want = round_both("branch_prep", which, "lean", seed)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("propagate", [True, False])
@pytest.mark.parametrize("which", list(ROUND_STATES))
def test_prop_round_kernel_vs_plain(cuda_device, which, propagate):
    got, want = round_both("prop_round", which, "lean", 7,
                           propagate=propagate)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("loci", [True, False])
@pytest.mark.parametrize("cuts", [(60, 3, 2), (4, 50, 1), None])
@pytest.mark.parametrize("which", list(ROUND_STATES))
def test_occ_round_kernel_vs_plain(cuda_device, which, cuts, loci):
    got, want = round_both("occ_round", which, "lean", 9, cuts=cuts,
                           loci=loci, r=3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_round_kernel_wrappers_raise_on_bad_inputs(cuda_device):
    """A wrong type or shape, or a CPU tensor beside CUDA tensors, raises;
    the plain version is never taken."""
    state = round_state(np.random.default_rng(4), 3, 40)
    calls = round_calls(state, cuda_device)
    lk.reset_counts()
    for name, pos, bad in (
            ("walk_pairs", 1, lambda t: t.cpu()),
            ("walk_pairs", 3, lambda t: t.to(torch.uint8)),
            ("branch_prep", 5, lambda t: t.to(torch.int32)),
            ("branch_prep", 7, lambda t: t.cpu()),
            ("prop_round", 4, lambda t: t[:, :-1]),
            ("prop_round", 7, lambda t: t.cpu()),
            ("occ_round", 7, lambda t: t.reshape(-1)),
            ("occ_round", 13, lambda t: t.cpu())):
        args, kw = calls[name]()
        args[pos] = bad(args[pos])
        with pytest.raises(ValueError):
            getattr(lk, name)(*args, **kw)
    assert all(c["plain"] == 0 and c["kernel"] == 0
               for c in lk.n_calls.values())


# prop_round and occ_round: one launch each, counting through a scratch that
# every completed call leaves zeroed

def prop_occ_edge(name, which):
    """make() of prop_round ("prop_*") or occ_round ("occ_*") on an edge
    state: prop_nxt_none (no next pair anywhere), prop_ok_false_at_j
    (pair_ok false at every next pair), prop_arc_rows_clamped (arc rows
    below 0 and past A - 1), prop_A1 (a one-arc table), prop_H_tile+-1
    (H = 1,024 +- 1, every row valid); occ_S1 (one segment), occ_v_edges
    (arcs at vertices 0, 1, 2S - 2 and 2S - 1: the ends the plain
    version's clamps hold), occ_A1 (a one-arc table)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(len(name) + 31)
    if name in ("prop_H_tile-1", "prop_H_tile+1"):
        H = 1023 if name.endswith("-1") else 1025
        st = round_state(rng, 3, H, min_valid=H, p_flt=0.05, p_shadow=0.02)
    elif name in ("prop_A1", "occ_A1"):
        st = round_state(rng, 4, 70, sizes=(1,), n_invalid=0)
    elif name == "occ_S1":
        st = round_state(rng, 4, 40, S=1, n_gene=3, sizes=(2, 1),
                         p_dead=0.0)
    elif name == "occ_v_edges":
        st = round_state(rng, 4, 40, S=30, n_gene=20, sizes=(3, 1, 2, 4))
        B, S = st["B"], 30
        vs = np.repeat([0, 1, 2 * S - 2, 2 * S - 1], (3, 1, 2, 4))
        st["arc_vw"][:10] = np.sort((vs << B) | rng.integers(0, 2 * S, 10))
    else:
        st = make_state(which, 41)
    st["sid_of"][:2] = (0, -1)
    make = round_calls(st, dev, r=2)[
        "occ_round" if name.startswith("occ") else "prop_round"]

    def edged():
        args, akw = make()
        if name == "prop_nxt_none":
            args[5] = torch.full_like(args[5], -1)
        elif name == "prop_ok_false_at_j":
            nxt = args[5].long()
            ok = args[6].clone()
            ok.scatter_(1, nxt.clamp(min=0), False)
            args[6] = torch.where((nxt >= 0).any(1, keepdim=True), ok,
                                  args[6])
        elif name == "prop_arc_rows_clamped":
            A = args[7].numel()
            args[4][:, ::3] = -7
            args[4][:, 1::3] = A + 11
        return args, akw
    return edged


PROP_EDGES = ("prop_nxt_none", "prop_ok_false_at_j", "prop_arc_rows_clamped",
              "prop_A1", "prop_H_tile-1", "prop_H_tile+1")
OCC_EDGES = ("occ_S1", "occ_v_edges", "occ_A1")


@pytest.mark.cuda
@pytest.mark.parametrize("propagate", [True, False])
@pytest.mark.parametrize("name", PROP_EDGES)
def test_prop_round_edges_kernel_vs_plain(cuda_device, name, propagate):
    make = prop_occ_edge(name, "tile_edges")
    args, kw = make()
    kw["propagate"] = propagate
    got = round_outputs("prop_round", args, kw)
    args, _ = make()
    want = round_outputs("prop_round", args, kw, plain=True)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("loci", [True, False])
@pytest.mark.parametrize("cuts", [(60, 3, 2), (4, 1, 1), None])
@pytest.mark.parametrize("name", OCC_EDGES)
def test_occ_round_edges_kernel_vs_plain(cuda_device, name, cuts, loci):
    make = prop_occ_edge(name, "random")
    args, kw = make()
    kw = dict(kw, cuts=cuts, n_grp=kw["n_grp"] if loci else None)
    got = round_outputs("occ_round", args, kw)
    args, _ = make()
    want = round_outputs("occ_round", args, kw, plain=True)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


ROUND_COUNTERS = 16     # the scratch's counters (pg_round_scratch), zeroed


def twice(name, which, plain, graph=False, scratch=None):
    """The round kernel `name` (or its plain version) called three times
    (graph: captured in one CUDA graph, then replayed twice) on one state:
    the outputs after the first call and after the last."""
    make = round_calls(make_state(which, 43), torch.device("cuda"), r=1)[
        name]
    args, kw = make()
    fn = getattr(lk, name + ("_plain" if plain else ""))
    if not plain:
        kw = dict(kw, scratch=scratch)
    pick = lambda: tuple(args[i].clone() for i in ROUND_INPLACE[name])
    if not graph:
        fn(*args, **kw)
        first = pick()
        fn(*args, **kw)
        fn(*args, **kw)
        return first, pick()
    warm, _ = make()
    fn(*warm, **kw)                 # builds and loads the library
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn(*args, **kw)
    g.replay()
    first = pick()
    g.replay()
    g.replay()
    return first, pick()


@pytest.mark.cuda
@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("which", ["random", "tiles", "hit0_filtered"])
@pytest.mark.parametrize("name", ["prop_round", "occ_round"])
def test_round_kernels_called_again(cuda_device, name, which, graph):
    """Called three times in a row on the state the calls before left
    (eagerly, or as one call captured in a CUDA graph and replayed), each
    kernel equals its plain version called as often, its word too: the
    change bit is 0 after the first call and n_prop stays; the scratch's
    counters are zero after every call."""
    scratch = lk.round_scratch(cuda_device, ROUND_STATES[which].get("S", 40))
    got = twice(name, which, False, graph, scratch)
    want = twice(name, which, True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert not bool(scratch[:ROUND_COUNTERS].any())
    if name == "prop_round":
        assert int(got[1][2][1]) == 0 and int(got[0][2][1]) == 1
        assert int(got[1][2][0]) == int(got[0][2][0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["prop_round", "occ_round"])
def test_round_scratch_zeroed_after_failed_launch(cuda_device, name,
                                                  monkeypatch):
    """A launch that fails leaves its scratch dirty (an aborted launch); the
    wrapper zeroes it again and raises, counts no launch, and the next
    call on that scratch equals the plain version."""
    make = round_calls(make_state("random", 47), cuda_device)[name]
    lib = lk._round_lib()

    class Failing:
        def __getattr__(self, attr):
            if attr == "pg_" + name:
                return lambda *a: 700      # cudaErrorIllegalAddress
            return getattr(lib, attr)

    scratch = lk.round_scratch(cuda_device, 40)
    scratch.fill_(5)
    lk.reset_counts()
    monkeypatch.setattr(lk, "_round", Failing())
    args, kw = make()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        getattr(lk, name)(*args, **dict(kw, scratch=scratch))
    assert not bool(scratch.any())
    assert lk.n_calls[name] == {"kernel": 0, "plain": 0}
    monkeypatch.setattr(lk, "_round", lib)
    args, kw = make()
    got = round_outputs(name, args, dict(kw, scratch=scratch))
    args, kw = make()
    want = round_outputs(name, args, kw, plain=True)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not bool(scratch[:ROUND_COUNTERS].any())


# ---------------------------------------------------------------------------
# the fused sweep epilogues and the per-round step's kernels
# ---------------------------------------------------------------------------

def fused_both(args, mode, check_strand=False, f=0.3):
    """The fused sweep (`mode` "loop" or "step") on the card and its plain
    version on copies of the same arguments (loop_sweep_args' for "loop";
    for "step" the same less pid_dom, ev1, pid, with cm): the outputs and
    the planes updated in place, each pair (kernel, plain)."""
    bc, flt, weak, W, shadow, pid_dom, ev1, pid = args
    G, H = flt.shape
    cm = torch.arange(G * H, dtype=torch.int64,
                      device=flt.device).reshape(G, H) * 7919 % 100003
    out = []
    for fn in ("kernel", "plain"):
        sh, pd = shadow.clone(), pid_dom.clone()
        if mode == "loop":
            if fn == "kernel":
                sk.sweep_round_loop(bc, flt, weak, W, check_strand, f, sh,
                                    pd, ev1, pid)
            else:
                marks, score, other = sk.shadow_sweep_batched_plain(
                    bc, flt, weak, W, check_strand, f)
                sk.sweep_epilogue_plain(marks, score, other, flt, sh,
                                        bc.n_rows, ev1=ev1, pid=pid,
                                        pid_dom=pd)
            out.append((sh, pd))
        else:
            if fn == "kernel":
                res = sk.sweep_round_step(bc, flt, weak, W, check_strand, f,
                                          sh, cm)
            else:
                marks, score, other = sk.shadow_sweep_batched_plain(
                    bc, flt, weak, W, check_strand, f)
                res = (score, other, sk.sweep_epilogue_plain(
                    marks, score, other, flt, sh, bc.n_rows, cid=bc.cid,
                    cm=cm))
            out.append((sh,) + tuple(res))
    torch.cuda.synchronize()
    return out


def assert_fused_equal(args, check_strand=False, f=0.3):
    for mode in ("loop", "step"):
        sk.reset_counts()
        got, want = fused_both(args, mode, check_strand, f)
        assert sk.n_batched() == {"kernel": 1, "plain": 0}
        assert sk.n_fused[mode]["kernel"] == 1
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), mode
    sk.reset_counts()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("f", [0.5, 0.3])
@pytest.mark.parametrize("check_strand", [False, True])
@pytest.mark.parametrize("seed0", [0, 20])
def test_fused_sweep_vs_plain(cuda_device, seed0, check_strand, f):
    """Both fused epilogues on random genome sets (an empty genome, a
    one-hit genome, rows padded past the longest genome)."""
    sizes = (2000, 700, 0, 64, 65, 1, 1300)
    genomes = [random_genome(np.random.default_rng(seed0 + k), n_hits=n,
                             weak=True, max_exon=6, max_cs=30 * n + 100)
               for k, n in enumerate(sizes)]
    args = loop_sweep_args(genomes, cuda_device, seed=seed0, H=2100)
    got = assert_fused_equal(args, check_strand, f)
    assert got[0].any() and (got[1] > sk.SCORE_NONE).any()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["tile", "wide"])
def test_fused_sweep_stacked_edge_cases(cuda_device, which):
    """The kernel's edge cases as one batch, through both epilogues (the
    2,000-exon hit, which the split-form plain sweep cannot hold, left
    out)."""
    genomes = [(d, g) for d, g in stacked_edge_cases()[which]
               if int(g.hits.n_exon.max(initial=0)) < 100]
    assert_fused_equal(loop_sweep_args(genomes, cuda_device, seed=3))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 8, 21, 32, 33])
def test_fused_sweep_band_widths(cuda_device, W):
    """The batched tile's edges (test_batched_kernel_band_widths' genomes)
    through both epilogues: items wholly past a genome's rows get the
    epilogue too."""
    rows = sk.tile_shape(batched=True)[0]
    sizes = (rows - 1, 0, rows, rows + 1, 2 * rows + W, 0, 700, 5)
    genomes = [band_genome(np.random.default_rng(10 * W + k), n, W)
               for k, n in enumerate(sizes)]
    assert_fused_equal(loop_sweep_args(genomes, cuda_device, seed=W,
                                       H=5 * rows + 3))
    for epi in (sk.EPI_LOOP, sk.EPI_STEP):
        shape = sk.launch_shape_batched(len(sizes), 5 * rows + 3, W, epi)
        assert shape["items"] == len(sizes) * 6 and shape["blocks"] >= 1


@pytest.mark.cuda
def test_fused_sweep_wrappers_raise_on_bad_columns(cuda_device):
    genomes = [random_genome(np.random.default_rng(3), n_hits=100)]
    bc, flt, weak, W, shadow, pid_dom, ev1, pid = loop_sweep_args(
        genomes, cuda_device)
    cm = torch.zeros_like(pid_dom, dtype=torch.int64)
    with pytest.raises(ValueError):
        sk.sweep_round_loop(bc, flt, weak, W, False, 0.5, shadow.cpu(),
                            pid_dom, ev1, pid)
    with pytest.raises(ValueError):
        sk.sweep_round_loop(bc, flt, weak, W, False, 0.5, shadow,
                            pid_dom.to(torch.int64), ev1, pid)
    with pytest.raises(ValueError):
        sk.sweep_round_loop(bc, flt, weak, W, False, 0.5, shadow, pid_dom,
                            ev1[:, :-1], pid)
    with pytest.raises(ValueError):
        sk.sweep_round_step(bc, flt, weak, W, False, 0.5, shadow,
                            cm.to(torch.int32))
    with pytest.raises(ValueError):
        sk.sweep_round_step(bc, flt, weak, W, False, 0.5,
                            shadow.repeat(1, 2)[:, ::2], cm)


@pytest.mark.cuda
@pytest.mark.parametrize("use_ori", [False, True])
@pytest.mark.parametrize("which", STEP_STATES)
def test_step_kernels_vs_plain(cuda_device, which, use_ori):
    """step_walk and step_dedupe against their plain versions on the step
    states (testing.STEP_STATES), every output equal."""
    calls = step_calls(step_state(which, 5, torch.device("cpu")),
                       cuda_device, use_ori)
    stk.reset_counts()
    for name, (args, kw) in calls.items():
        got = getattr(stk, name)(*args, **kw)
        want = getattr(stk, name + "_plain")(*args, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert stk.n_calls == {"step_walk": {"kernel": 1, "plain": 0},
                           "step_dedupe": {"kernel": 1, "plain": 0}}
    stk.reset_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("use_ori", [False, True])
@pytest.mark.parametrize("which", STEP_STATES)
def test_round_step_on_step_states(cuda_device, which, use_ori):
    """The whole step on the card (three launches, two sorts) against the
    whole step on the CPU, on the step states."""
    kw = dict(min_ov_ratio=0.3, check_strand=False, use_ori=use_ori)
    cpu = torch.device("cpu")
    cols, flt, shadow, weak, g2s, W = step_state(which, 6, cuda_device)
    sk.reset_counts()
    stk.reset_counts()
    got = st.round_step(cols, flt, shadow, weak, g2s, W=W, **kw)
    assert sk.n_fused["step"] == {"kernel": 1, "plain": 0}
    assert all(c == {"kernel": 1, "plain": 0} for c in stk.n_calls.values())
    c_cols, c_flt, c_shadow, c_weak, c_g2s, _ = step_state(which, 6, cpu)
    want = st.round_step(c_cols, c_flt, c_shadow, c_weak, c_g2s, W=W, **kw)
    for name, a, b in zip(st.STEP_OUTPUTS, got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), name
    sk.reset_counts()
    stk.reset_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("past", [0, 1])
def test_step_walk_seen_bits_past_shared_memory(cuda_device, past):
    """At the most genes whose seen bits a block's shared memory held in
    the one-block-a-genome walk, and one past it, step_walk equals its
    plain version, in a call and in a graph replay: the genomes' bits are
    one global plane of the scratch ([(G + 31) / 32, n_gene] words), the
    tiles' status words and the ticket after it."""
    n_gene = SEEN_SMEM_GENES + past
    lib = stk._kernel_lib()
    state = step_state("many_genes", 12, torch.device("cpu"), n_gene=n_gene)
    (args, kw) = step_calls(state, cuda_device)["step_walk"]
    G, H = args[2].shape
    tiles = G * -(-H // stk.TILE)
    assert lib.pg_step_walk_scratch(G, H, n_gene) == \
        -(-4 * n_gene * -(-G // 32) // 8) * 8 + 8 * (tiles + 1)
    want = stk.step_walk_plain(*args, **kw)
    got = [t.clone() for t in stk.step_walk(*args, **kw)]
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = stk.step_walk(*args, **kw)
    g.replay()
    g.replay()
    torch.cuda.synchronize()
    assert int(want[5][1].sum()) > 0
    for a, b, c in zip(got, want, outs):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert torch.equal(c, b)


@pytest.mark.cuda
@pytest.mark.parametrize("G,H", [(1, 1), (6, 4 * stk.TILE - 1),
                                 (64, 20933), (16, 20933), (100, 40000)])
def test_step_tile_matches_the_library(cuda_device, G, H):
    """stk.TILE is the built library's tile (pg_step_shape), and the launch
    shape is one block a tile: step_walk G x ceil(H / TILE) blocks,
    step_dedupe (G + 1) x ceil(2H / TILE) (the last T zero the last
    genome's rows past its groups), their scratch as the C entries size
    it."""
    shape = stk.launch_shape(G, H, 1000)
    lib = stk._kernel_lib()
    T = stk.TILE
    assert shape == {
        "threads": 256, "tile": T, "walk_blocks": G * -(-H // T),
        "dedupe_blocks": (G + 1) * -(-2 * H // T),
        "walk_scratch_bytes": lib.pg_step_walk_scratch(G, H, 1000),
        "dedupe_scratch_bytes": lib.pg_step_dedupe_scratch(G, H)}
    nt = G * -(-2 * H // T)
    assert shape["dedupe_scratch_bytes"] == 48 * nt + -(-4 * nt // 8) * 8 + 8


@pytest.mark.cuda
def test_step_kernels_more_tiles_than_resident_blocks(cuda_device):
    """The tile_gap state's genomes repeated 40 times (240 genomes: some
    2,900 dedupe tiles, past the blocks the card holds at once): both
    kernels equal their plain versions, so no tile waits on one that no
    running block holds."""
    calls = step_calls(step_state("tile_gap", 7, torch.device("cpu")),
                       cuda_device)
    (cols, perm, flt, shadow, g2s), kw = calls["step_walk"]
    G = flt.shape[0]
    rep = lambda t: t.repeat(40, *[1] * (t.dim() - 1)) \
        if t.dim() and t.shape[0] == G else t
    cols = type(cols)(type(cols.batch)(*map(rep, cols.batch)),
                      *map(rep, cols[1:]))
    args = (cols, rep(perm), rep(flt), rep(shadow), g2s)
    got = stk.step_walk(*args, **kw)
    want = stk.step_walk_plain(*args, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    dargs = [rep(t) for t in calls["step_dedupe"][0]]
    shape = stk.launch_shape(*dargs[2].shape)
    assert shape["dedupe_blocks"] > 132 * 8
    for a, b in zip(stk.step_dedupe(*dargs), stk.step_dedupe_plain(*dargs)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_step_wrappers_raise_on_bad_columns(cuda_device):
    calls = step_calls(step_state("random", 2, torch.device("cpu")),
                       cuda_device)
    (cols, perm, flt, shadow, g2s), kw = calls["step_walk"]
    with pytest.raises(ValueError):
        stk.step_walk(cols, perm.to(torch.int32), flt, shadow, g2s, **kw)
    with pytest.raises(ValueError):
        stk.step_walk(cols, perm, flt.cpu(), shadow, g2s, **kw)
    with pytest.raises(ValueError):
        stk.step_walk(cols, perm, flt, shadow, g2s[:0], **kw)
    with pytest.raises(ValueError):
        stk.step_walk(cols._replace(cm=cols.cm.to(torch.int32)), perm, flt,
                      shadow, g2s, **kw)
    args, _ = calls["step_dedupe"]
    with pytest.raises(ValueError):
        stk.step_dedupe(args[0][:, :-1].contiguous(), *args[1:])
    with pytest.raises(ValueError):
        stk.step_dedupe(*args[:2], args[2].to(torch.int32), *args[3:])
    with pytest.raises(ValueError):
        stk.step_dedupe(args[0], args[1].t().contiguous().t(), *args[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("which", ["random", "repeats", "many_genes",
                                   "tile_gap", "tiles_4T-1", "tiles_4T",
                                   "tiles_4T+1"])
def test_step_kernels_called_again(cuda_device, which, graph):
    """A second call, and a CUDA graph of one call replayed twice, give the
    first call's outputs (each call's one memset zeroes the counters and
    the scratch: the tickets, the tiles' status, the seen bits)."""
    calls = step_calls(step_state(which, 8, torch.device("cpu")),
                       cuda_device)
    for name, (args, kw) in calls.items():
        fn = getattr(stk, name)
        first = [t.clone() for t in fn(*args, **kw)]
        if graph:
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                outs = fn(*args, **kw)
            g.replay()
            g.replay()
        else:
            outs = fn(*args, **kw)
        torch.cuda.synchronize()
        for a, b in zip(first, outs):
            assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("graph", [False, True])
def test_fused_sweep_called_again(cuda_device, graph):
    """The fused epilogues are idempotent on their in-place planes: a
    second call (or a graph replayed twice) leaves them as the first did."""
    genomes = [random_genome(np.random.default_rng(9 + k), n_hits=n,
                             weak=True, max_cs=30 * n + 100)
               for k, n in enumerate((900, 0, 300))]
    bc, flt, weak, W, shadow, pid_dom, ev1, pid = loop_sweep_args(
        genomes, cuda_device, seed=9)
    cm = torch.zeros_like(pid, dtype=torch.int64)

    def calls():
        sk.sweep_round_loop(bc, flt, weak, W, False, 0.3, shadow, pid_dom,
                            ev1, pid)
        return sk.sweep_round_step(bc, flt, weak, W, False, 0.3, shadow, cm)
    first = [t.clone() for t in calls()] + [shadow.clone(), pid_dom.clone()]
    if graph:
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            outs = calls()
        g.replay()
        g.replay()
    else:
        outs = calls()
    torch.cuda.synchronize()
    for a, b in zip(first, list(outs) + [shadow, pid_dom]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the mesh kernels (ops/mesh_kernels.py)
# ---------------------------------------------------------------------------

def reduce_inputs(which, device, flat=False):
    """testing.reduction_inputs on `device`: the seven arguments and
    n_prot."""
    from pangene_tpu_torch.testing import reduction_inputs
    cols, flt, n_rows, P = reduction_inputs(which, flat)
    t = lambda a: torch.from_numpy(a).to(device)
    return [t(c) for c in cols] + [t(flt), t(n_rows)], P


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["padded", "flat"])
@pytest.mark.parametrize("which", REDUCE_CASES)
def test_protein_reduce_vs_plain(cuda_device, which, layout):
    from pangene_tpu_torch.ops import mesh_kernels as mk
    args, P = reduce_inputs(which, cuda_device, layout == "flat")
    mk.reset_counts()
    got = mk.protein_reduce(*args, n_prot=P)
    want = mk.protein_reduce_plain(*args, n_prot=P)
    torch.cuda.synchronize()
    assert mk.n_calls["protein_reduce"] == {"kernel": 1, "plain": 0}
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert want[1].any() or which == "all_filtered"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["padded", "flat"])
@pytest.mark.parametrize("which", ["random", "ascending_scores", "n_prot_1"])
def test_protein_reduce_graph_replays_on_new_inputs(cuda_device, which,
                                                     layout):
    """One protein_reduce captured in a CUDA graph (its memset and its
    launch), replayed three times, each after new rows are written into the
    captured input buffers (the case's rows shuffled): every replay equals
    the plain version."""
    from pangene_tpu_torch.ops import mesh_kernels as mk
    args, P = reduce_inputs(which, cuda_device, layout == "flat")
    first = [a.clone() for a in args]
    mk.protein_reduce(*args, n_prot=P)  # built and loaded
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = mk.protein_reduce(*args, n_prot=P)
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        perm = torch.randperm(args[0].numel(), generator=gen).to(cuda_device)
        for a, f in zip(args[:6], first[:6]):
            a.copy_(f.reshape(-1)[perm].reshape(f.shape))
        g.replay()
        torch.cuda.synchronize()
        want = mk.protein_reduce_plain(*args, n_prot=P)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_protein_reduce_edge_shapes(cuda_device):
    """protein_reduce against its plain version at one row, at n_prot 1
    (every row's atomics on one protein), on more genomes than a grid's
    y dimension holds (70,000 of 3 rows: its rows stride over them), and
    with 200,000 proteins."""
    from pangene_tpu_torch.ops import mesh_kernels as mk
    rng = np.random.default_rng(8)

    def check(G, H, P, n_rows):
        cols = [rng.integers(-3, P + 3, (G, H))] + [
            rng.integers(-5, 900, (G, H)) for _ in range(2)] + [
            rng.integers(1, 4, (G, H)), rng.integers(0, 2, (G, H))]
        t = lambda a, dt: torch.from_numpy(a.astype(dt)).to(cuda_device)
        args = [t(c, np.int32) for c in cols] + [
            t(rng.random((G, H)) < 0.3, np.uint8), t(n_rows, np.int32)]
        got = mk.protein_reduce(*args, n_prot=P)
        want = mk.protein_reduce_plain(*args, n_prot=P)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (G, H, P)
    check(1, 1, 5, np.array([1]))
    check(1, 1, 1, np.array([1]))
    check(4, 5000, 1, np.array([5000, 17, 0, 4999]))
    check(70000, 3, 40, rng.integers(0, 4, 70000))
    check(2, 3000, 200_000, np.array([3000, 2999]))


@pytest.mark.cuda
def test_protein_reduce_on_a_rank_share(cuda_device, tmp_path):
    """Each rank's share at world 4, stacked by stacked.stack_reductions
    as post_reductions_sharded stacks it, through protein_reduce (one
    launch, no plain call) against the plain version."""
    from pangene_tpu_torch import pipeline
    from pangene_tpu_torch.ops import mesh_kernels as mk
    from pangene_tpu_torch.options import PgOpt
    from pangene_tpu_torch.parallel import mesh as M
    from pangene_tpu_torch.testing import synth_paf_files
    files = synth_paf_files(str(tmp_path), n_genome=7, n_gene=400, seed=5)
    d = pipeline.read_all(PgOpt(engine="sharded", device="cpu"), files)
    P = max(d.n_prot, 1)
    for r in range(4):
        buf, N = st.stack_reductions(d, M.Mesh(4, r, cuda_device, None,
                                               None), False)
        args = st.reduction_views(torch.from_numpy(buf).to(cuda_device), N)
        mk.reset_counts()
        got = mk.protein_reduce(*args, n_prot=P)
        assert mk.n_calls["protein_reduce"] == {"kernel": 1, "plain": 0}
        want = mk.protein_reduce_plain(*args, n_prot=P)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), r


@pytest.mark.cuda
@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("shape", ["small", "loop"])
@pytest.mark.parametrize("which", EXCHANGE_STATES)
def test_exchange_kernels_vs_plain(cuda_device, which, shape, graph):
    """Each exchange kernel on each rank's arguments against its plain
    version, exactly; with `graph`, from a CUDA graph replayed twice."""
    from pangene_tpu_torch.ops import mesh_kernels as mk
    from pangene_tpu_torch.testing import exchange_calls
    kw = dict(G_loc=16, H=1024, S=3000) if shape == "loop" else {}
    _, calls = exchange_calls(which, 5, cuda_device, **kw)
    mk.reset_counts()
    n = 0
    for call in calls:
        for name in ("pack", "window", "finish"):
            args, kwargs = call[name]
            fn = getattr(mk, "exchange_" + name)
            plain = getattr(mk, "exchange_%s_plain" % name)
            fresh = lambda: [a.clone() if i == 4 and name == "finish" else a
                             for i, a in enumerate(args)]
            want = plain(*fresh(), **kwargs)
            a = fresh()
            if graph:
                fn(*fresh(), **kwargs)          # built and loaded
                n += 1
                torch.cuda.synchronize()
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    got = fn(*a, **kwargs)
                g.replay()
                g.replay()
            else:
                got = fn(*a, **kwargs)
            n += 1
            torch.cuda.synchronize()
            for x, y in zip(got, want):
                assert x.dtype == y.dtype and torch.equal(x, y), name
    assert sum(c["kernel"] for c in mk.n_calls.values()) == n
    assert sum(c["plain"] for c in mk.n_calls.values()) == 0


@pytest.mark.cuda
def test_mesh_wrappers_raise_on_bad_columns(cuda_device):
    from pangene_tpu_torch.ops import mesh_kernels as mk
    from pangene_tpu_torch.testing import exchange_calls
    args, P = reduce_inputs("random", cuda_device)
    with pytest.raises(ValueError):
        mk.protein_reduce(*args[:5], args[5].to(torch.int32), args[6],
                          n_prot=P)
    with pytest.raises(ValueError):
        mk.protein_reduce(*args, n_prot=0)
    _, calls = exchange_calls("ordinary", 1, cuda_device)
    (keys, s1), kw = calls[0]["pack"]
    with pytest.raises(ValueError):
        mk.exchange_pack(keys.cpu(), s1, **kw)
    with pytest.raises(ValueError):
        mk.exchange_pack(keys, s1.long(), **kw)
    args, kw = calls[0]["window"]
    with pytest.raises(ValueError):
        mk.exchange_window(*args, rank=kw["rank"], A=0)
    with pytest.raises(ValueError):
        mk.exchange_pack(keys, s1, **calls[0]["pack"][1],
                         scratch=torch.zeros(1, dtype=torch.int32,
                                             device=cuda_device))
    args, kw = calls[0]["finish"]
    with pytest.raises(ValueError):
        mk.exchange_finish(*args[:4], args[4].long(), args[5], **kw)
    with pytest.raises(ValueError):
        mk.exchange_finish(*args[:3], args[3][:-1], *args[4:], **kw)
    with pytest.raises(ValueError):
        mk.exchange_finish(*args[:5], args[5][:-1], **kw)
    with pytest.raises(ValueError):
        mk.exchange_finish(*args[:5], args[5].long(), **kw)


def exchange_equal(name, args, kw, got=None):
    """exchange_`name` on `args` (the plane finish writes in place copied)
    against its plain version, exactly; `got`: outputs already made."""
    from pangene_tpu_torch.ops import mesh_kernels as mk
    fresh = lambda: [a.clone() if i == 4 and name == "finish" else a
                     for i, a in enumerate(args)]
    if got is None:
        got = getattr(mk, "exchange_" + name)(*fresh(), **kw)
    want = getattr(mk, "exchange_%s_plain" % name)(*fresh(), **kw)
    torch.cuda.synchronize()
    for k, (x, y) in enumerate(zip(got, want)):
        assert x.dtype == y.dtype and torch.equal(x, y), (name, k)


@pytest.mark.cuda
def test_exchange_more_tickets_than_resident_blocks(cuda_device):
    """NL 1,048,576 keys a rank (G_loc 64, H 8,192; S 20,000, so the lean
    keys keep within 62 bits): pack's tiles (key tiles, then fill tiles,
    by ticket) and finish's are several times the blocks the card holds at
    once, which each take many; every rank's pack and finish equal their
    plain versions."""
    from pangene_tpu_torch.ops import mesh_kernels as mk
    from pangene_tpu_torch.testing import exchange_calls
    meta, calls = exchange_calls("ordinary", 9, cuda_device, G_loc=64,
                                 H=8192, S=20000)
    shape = mk.launch_shape(meta["NL"], meta["nd"], meta["C"], meta["A"])
    resident = shape["sms"] * shape["pack_blocks_per_sm"]
    assert shape["pack_grid"] == resident
    assert shape["pack_key_tiles"] + shape["pack_fill_tiles"] > 2 * resident
    assert shape["finish_table_tiles"] + shape["finish_slot_tiles"] > \
        2 * shape["finish_grid"]
    scratch = mk.exchange_scratch(cuda_device, meta["nd"])
    for call in calls:
        args, kw = call["pack"]
        exchange_equal("pack", args, kw, mk.exchange_pack(*args, **kw,
                                                          scratch=scratch))
        exchange_equal("finish", *call["finish"])
    assert not scratch.any()


@pytest.mark.cuda
def test_exchange_graph_replays_reset_the_scratch(cuda_device):
    """exchange_pack and exchange_finish captured once in a CUDA graph on
    rank 0's arguments of one state, replayed three times, each time on
    rank 0's arguments of another state (the same shapes) copied into the
    captured inputs: each replay equals the plain versions on those
    arguments (the block done last left pack's scratch zeroed for the
    next, so its tickets and bounds are that replay's), and the scratch is
    zero after the last."""
    from pangene_tpu_torch.ops import mesh_kernels as mk
    from pangene_tpu_torch.testing import exchange_calls
    shape = dict(G_loc=8, H=1024, S=3000)
    meta, calls = exchange_calls("ordinary", 4, cuda_device, **shape)
    scratch = mk.exchange_scratch(cuda_device, meta["nd"])
    (keys, s1), kw = calls[0]["pack"]
    pk_in = (keys.clone(), s1.clone())
    fargs, fkw = calls[0]["finish"]
    fin_in = [a.clone() for a in fargs]
    mk.exchange_pack(*pk_in, **kw, scratch=scratch)       # built and loaded
    mk.exchange_finish(*[a.clone() if i == 4 else a
                         for i, a in enumerate(fin_in)], **fkw)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        pk_out = mk.exchange_pack(*pk_in, **kw, scratch=scratch)
        fin_out = mk.exchange_finish(*fin_in, **fkw)
    for k, which in enumerate(("empty_middle", "overflow", "ordinary")):
        m, c = exchange_calls(which, 5 + k, cuda_device, **shape)
        assert (m["NL"], m["C"], m["A"]) == (meta["NL"], meta["C"],
                                             meta["A"])
        for dst, src in zip(pk_in, c[0]["pack"][0]):
            dst.copy_(src)
        for dst, src in zip(fin_in, c[0]["finish"][0]):
            dst.copy_(src)
        want_bounds = mk.exchange_pack_plain(*pk_in, **kw)[3]
        g.replay()
        torch.cuda.synchronize()
        exchange_equal("pack", pk_in, kw, pk_out)
        assert torch.equal(pk_out[3], want_bounds), which
        want = mk.exchange_finish_plain(*fin_in[:4],
                                        torch.zeros_like(fin_in[4]),
                                        *fin_in[5:], **fkw)
        for x, y in zip(fin_out, want):
            assert torch.equal(x, y), which
    assert not scratch.any()


def one_key_call(valid, device):
    """exchange_pack's and exchange_finish's arguments at NL = 1 (rank 1 of
    nd 4, S 12): the one key (to destination 2) or a sentinel."""
    from pangene_tpu_torch.ops.loop_kernels import KSENT_I
    nd, S, B, GB, JB = 4, 12, 5, 2, 2
    key = ((((13 << B) | 14) << GB | 1) << JB) | 1
    keys = torch.tensor([key if valid else KSENT_I], dtype=torch.int64,
                        device=device)
    s1 = torch.tensor([42], dtype=torch.int32, device=device)
    kw = dict(nd=nd, cap=1, jb=JB, shift=JB + GB + B, two_s=2 * S, rank=1)
    return (keys, s1), kw


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [True, False])
def test_exchange_one_key(cuda_device, valid):
    """NL = 1: one key tile of one position, its bounds published at 0 and
    at NL; pack and finish equal their plain versions."""
    from pangene_tpu_torch.ops import mesh_kernels as mk
    args, kw = one_key_call(valid, cuda_device)
    got = mk.exchange_pack(*args, **kw)
    exchange_equal("pack", args, kw, got)
    send, _, pair, bounds = got
    assert bounds.tolist() == ([0, 0, 0, 1, 1] if valid else [0] * 5)
    g = torch.Generator().manual_seed(3)
    table = torch.randint(0, 1 << 40, (2, 8), generator=g).to(cuda_device)
    n_out = torch.tensor(5, dtype=torch.int64, device=cuda_device)
    reply = torch.arange(4, dtype=torch.int32, device=cuda_device) + 7
    exchange_equal("finish", (table, n_out, send, reply, pair, bounds),
                   dict(jb=kw["jb"], rank=kw["rank"]))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["ordinary", "empty_middle", "overflow"])
def test_exchange_ragged_tiles(cuda_device, which):
    """NL = 2,406 (G_loc 3, H 401), not a multiple of the 1,024-position
    tile, and C = 1,024: every rank's three kernels equal their plain
    versions."""
    from pangene_tpu_torch.testing import exchange_calls
    meta, calls = exchange_calls(which, 8, cuda_device, H=401)
    assert meta["NL"] % 1024 and meta["NL"] == 2406
    for call in calls:
        for name in ("pack", "window", "finish"):
            exchange_equal(name, *call[name])
