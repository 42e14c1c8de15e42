"""The corpus generator: deterministic by seed, the stated shape."""
import gzip
import re

import numpy as np

from gpubench.inputs import synth


def test_same_seed_same_records():
    sh = synth.Shape(4, 300)
    a = synth.draw_genome(sh, 2**31 + 11, 2)
    b = synth.draw_genome(sh, 2**31 + 11, 2)
    c = synth.draw_genome(sh, 2**31 + 12, 2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert len(a.gene) != len(c.gene) or not np.array_equal(a.cs, c.cs)
    # every genome a file of its own, in the seed's order


def test_seeds_order_one_set_of_genomes():
    sh = synth.Shape(6, 200)
    a = [synth.draw_genome(sh, 5, gi) for gi in range(6)]
    b = [synth.draw_genome(sh, 2**31 + 5, gi) for gi in range(6)]
    key = lambda g: (len(g.gene), int(g.cs.sum()))
    assert sorted(map(key, a)) == sorted(map(key, b))
    assert list(map(key, a)) != list(map(key, b))
    order = synth.genome_order(sh, 5)
    assert sorted(order) == list(range(6))
    np.testing.assert_array_equal(
        synth.draw_genome(sh, 5, 3, synth.layout(sh), order).cs, a[3].cs)


def test_multi_exon_shape():
    sh = synth.Shape(30, 2000)
    g = [synth.draw_genome(sh, 3, gi) for gi in range(sh.n_genome)]
    present = np.mean([len(np.unique(x.gene)) / sh.n_gene for x in g])
    assert abs(present - 0.95) < 0.01
    ne = np.concatenate([x.n_exon for x in g])
    assert ne.min() == 2 and ne.max() == 8
    assert np.concatenate([x.iso for x in g]).max() == sh.n_iso - 1
    # a paralog copy 2 Mb downstream at 8%: a gene's records split in two
    x = g[0]
    first_iso = x.iso == 0
    copies = np.bincount(x.gene[first_iso], minlength=sh.n_gene)
    share = (copies == 2).sum() / (copies > 0).sum()
    assert 0.06 < share < 0.10
    assert (x.ce - x.cs > 0).all() and (x.qe <= x.qlen).all()


def test_single_exon_shape():
    sh = synth.Shape(5, 500, 1, 4, 0.08, True)
    x = synth.draw_genome(sh, 9, 0)
    assert (x.n_exon == 1).all() and (x.iso == 0).all()
    assert (x.ce - x.cs == 3 * x.exon_aa).all()


def test_written_records(tmp_path):
    sh = synth.Shape(3, 150)
    files = synth.write_corpus(sh, 21, str(tmp_path), workers=2)
    assert len(files) == 3
    x = synth.draw_genome(sh, 21, 1)
    with gzip.open(files[1], "rt") as fp:
        lines = fp.read().splitlines()
    assert len(lines) == len(x.gene)
    for ln, cs, ce, ne in zip(lines, x.cs, x.ce, x.n_exon):
        f = ln.split("\t")
        assert len(f) == 16 and f[4] in "+-"
        assert int(f[7]) == cs and int(f[8]) == ce
        ops = re.findall(r"(\d+)([MN])", f[15][5:])
        span = sum(int(n) * (3 if op == "M" else 1) for n, op in ops)
        assert span == ce - cs
        assert sum(op == "M" for _, op in ops) == ne


def test_pangenome_presence():
    # the core in every genome, the accessory genes at the rate that gives
    # per_genome genes a genome
    sh = synth.Shape(40, 2000, 1, 4, 0.08, True, n_core=600, per_genome=1000)
    held = [set(np.unique(synth.draw_genome(sh, 3, gi).gene).tolist())
            for gi in range(sh.n_genome)]
    assert set.intersection(*held) == set(range(600))
    assert abs(np.mean([len(h) for h in held]) - 1000) < 15
    assert len(set.union(*held)) == 2000
