"""mtb152.loop on the CPU at a tiny size: the port's schedule (its plain
PyTorch versions) equals the reference (reference/answer.loop) with the
overflow check at 0, on a corpus whose branch rounds meet a group wider
than the branch kernels' block path (64 arcs). A tiny draw of the
configuration's shape holds no such group (its widest out-vertex grows
with the genes a strain holds: 25 at 400 genes a strain, 47 at 1,000, 54
at 2,000), so each genome's draw gets, for the corpus's writer and for the
reference alike, runs of a separator gene, a gene X, a hub gene P and one
of 80 genes Y: the first round deletes P as a high-degree segment, and its
merge links X to every Y. Also the new cell's two readers."""
import copy

import numpy as np
import pytest

from gpubench import roofline, run as R
from gpubench.harness import Run
from gpubench.inputs import synth

TINY = dict(n_genome=152, n_gene=421, n_core=377, per_genome=400)
N_SLOT, N_WIDE = 8, 80
HUB_AT = 53_000_000          # past every gene's paralog copy on contig 0


def with_hub(draw):
    """draw_genome with the hub runs appended to each genome's records."""
    def hub_draw(shape, seed, gi, lay=None, order=None):
        g = draw(shape, seed, gi, lay, order)
        X, P = shape.n_gene, shape.n_gene + 1
        sep = lambda j: shape.n_gene + 2 + N_WIDE + j
        genes = []
        for j in range(N_SLOT):
            genes += [sep(j), X, P,
                      shape.n_gene + 2 + (gi * N_SLOT + j) % N_WIDE]
        genes.append(sep(N_SLOT))
        n = len(genes)
        rng = np.random.default_rng(1000 + gi)
        aa = rng.integers(100, 400, n).astype(np.int64)
        cs = HUB_AT + 30_000 * np.arange(n, dtype=np.int64) \
            + rng.integers(0, 2000, n)
        mlen = (aa * 0.95).astype(np.int64)
        extra = dict(
            gene=np.array(genes, np.int32), iso=np.zeros(n, np.int32),
            qlen=aa + 5, qs=np.zeros(n, np.int64), qe=aa,
            rev=np.zeros(n, np.uint8), ctg=np.zeros(n, np.int32), cs=cs,
            ce=cs + 3 * aa, mlen=mlen, blen=aa + 2, ms=2 * mlen,
            n_exon=np.ones(n, np.int64), exon_aa=aa,
            intron=np.full(n, -1, np.int64))
        return synth.GenomeDraw(**{k: np.concatenate(
            [getattr(g, k), extra[k].astype(getattr(g, k).dtype)])
            for k in synth.GenomeDraw._fields})
    return hub_draw


def cell_of(name="mtb152.loop"):
    bench = R.load_json(R.ROOT, "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    cfg = copy.deepcopy(R.load_json(R.HERE, "configs",
                                    cell["config"] + ".json"))
    cfg["draw"].update(TINY)
    traffic = R.load_json(R.HERE, "traffic", cell["traffic"] + ".json")
    return bench, cell, cfg, traffic


@pytest.mark.parametrize("seed,trace", [(2**31 + 11, False),
                                        (2**32 + 7, True)])
def test_mtb152_port_equals_reference(tmp_path, monkeypatch, seed, trace):
    monkeypatch.setattr(synth, "draw_genome", with_hub(synth.draw_genome))
    bench, cell, cfg, traffic = cell_of()
    traffic = dict(traffic, warm_reps=1, trace_reps=2)
    files = synth.write_corpus(synth.shape_of(cfg), seed,
                               str(tmp_path / "paf"))
    run = Run()
    res = R.run_cell(bench, cell, cfg, traffic, seed, 0.8, trace, files,
                     run, device="cpu", tmp=str(tmp_path))
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert res["checks"]["overflow"]["value"] == 0
    assert res["info"]["compared"] >= 1
    st = run.stats[0]
    assert st["branch_max_group"] >= N_WIDE > 64
    assert st["branch_wide_groups"] >= 1
    assert all(s["host_syncs"] == 16 for s in run.stats)
    if trace:
        m = res["metrics"]
        assert m["branch_wide_groups.loop"]["value"] >= 1
        # no CUDA kernel in a CPU trace: nothing to read
        assert "branch_roofline.loop" not in m


def test_branch_readers():
    rd = R.metric_reader
    run = Run()
    assert rd("branch_wide_groups.loop")(run) is None
    assert rd("branch_roofline.loop")(run) is None
    run.stats = [dict(branch_wide_groups=3, branch_valid_arcs=1000,
                      branch_branching_arcs=600)] * 2 \
        + [dict(branch_wide_groups=5, branch_valid_arcs=1000,
                branch_branching_arcs=600)]
    assert rd("branch_wide_groups.loop")(run) == pytest.approx(11 / 3)
    assert rd("branch_roofline.loop")(run) is None
    nbytes = roofline.branch_bytes(1000, 600)
    assert nbytes == 17 * 1000 + 8 * 600
    sec = nbytes / roofline.HBM_BYTES_PER_S
    # two traced schedules: the kernel's two entries summed, halved
    run.trace = dict(reps=2, device_ops=[
        ["void (anonymous namespace)::branch_kernel<true>(BranchArgs)",
         sec * 4], ["Memcpy HtoD", 1.0],
        ["void (anonymous namespace)::branch_kernel<false>(BranchArgs)",
         sec * 4]])
    assert rd("branch_roofline.loop")(run) == pytest.approx(25.0)
    # the kernel out of the trace's heaviest operations: nothing, not 0
    run.trace["device_ops"] = [["Memcpy HtoD", 1.0]]
    assert rd("branch_roofline.loop")(run) is None
    # a program with no such counts (the parent): nothing
    run.stats = [dict(host_syncs=16)]
    run.trace["device_ops"] = [["branch_kernel<true>", 1.0]]
    assert rd("branch_roofline.loop")(run) is None
    assert rd("branch_wide_groups.loop")(run) is None
