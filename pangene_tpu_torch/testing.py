"""Synthetic inputs for the tests and chip_smoke.py: miniprot-PAF corpora
and random single genomes for the sweep; and the rank of a launch that
reports what it built (`python -m pangene_tpu_torch.testing <CLI args>`,
run_ranks).

Generates structurally realistic inputs: orthologous gene loci shared across
genomes, multiple isoforms per gene (driving the overlap sweeps), occasional
paralogs/pseudogene copies (driving shadowing and branch pruning), valid
CIGAR strings with introns, and PanSN contig names (driving W-line parsing).
"""
from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List

import numpy as np


def synth_paf_files(out_dir: str, n_genome: int = 8, n_gene: int = 200,
                    n_iso: int = 3, n_ctg: int = 4, seed: int = 0,
                    paralog_rate: float = 0.08,
                    single_exon: bool = False) -> List[str]:
    """Synthetic miniprot-shaped PAF corpus. single_exon=True emits
    unspliced single-exon hits (the bacterial / miniprot -S shape,
    BASELINE.json's bacterial config)."""
    rng = np.random.default_rng(seed)
    # gene layout shared across genomes: order along contigs with jitter
    gene_ctg = rng.integers(0, n_ctg, n_gene)
    gene_pos = rng.integers(0, 50_000_000, n_gene)
    # protein lengths (aa) and exon structure per isoform
    files = []
    os.makedirs(out_dir, exist_ok=True)
    for gi in range(n_genome):
        fn = os.path.join(out_dir, "synth%03d.paf.gz" % gi)
        files.append(fn)
        lines = []
        for gene in range(n_gene):
            if rng.random() < 0.05:  # gene missing in this genome
                continue
            n_copies = 1 + (rng.random() < paralog_rate)
            for copy in range(n_copies):
                for iso in range(1 + int(rng.integers(0, n_iso))):
                    n_exon = 1 if single_exon else int(rng.integers(2, 9))
                    exon_aa = rng.integers(20, 200, n_exon)
                    introns = rng.integers(80, 5000, n_exon - 1)
                    qlen = int(exon_aa.sum()) + int(rng.integers(0, 30))
                    qs = int(rng.integers(0, 10))
                    qe = qs + int(exon_aa.sum())
                    if qe > qlen:
                        qe = qlen
                    span = int(exon_aa.sum()) * 3 + int(introns.sum())
                    ctg = int(gene_ctg[gene])
                    base = int(gene_pos[gene]) + copy * 2_000_000 \
                        + int(rng.integers(0, 2000))
                    strand = "+-"[int(rng.integers(0, 2))]
                    mlen = int((qe - qs) * (0.85 + 0.14 * rng.random()))
                    blen = qe - qs + int(rng.integers(0, 10))
                    ms = int(mlen * 2 * (0.9 + 0.2 * rng.random()))
                    cig = []
                    for k in range(n_exon):
                        cig.append("%dM" % exon_aa[k])
                        if k < n_exon - 1:
                            cig.append("%dN" % introns[k])
                    name = "GENE%05d:ISO%d" % (gene, iso)
                    ctg_name = "S%03d#%d#ctg%d" % (gi // 2, gi % 2 + 1, ctg)
                    lines.append("\t".join(map(str, (
                        name, qlen, qs, qe, strand, ctg_name, 60_000_000,
                        base, base + span, mlen, blen, 60,
                        "ms:i:%d" % ms, "fs:i:0", "st:i:0",
                        "cg:Z:%s" % "".join(cig)))))
        with gzip.open(fn, "wt") as fp:
            fp.write("\n".join(lines) + "\n")
    return files


def wide_paf_files(out_dir: str, n_genome: int = 40, n_slot: int = 8,
                   n_wide: int = 80, seed: int = 0) -> List[str]:
    """A corpus whose pruning loop meets a branch group wider than the
    branch kernels' block path (ops/loop_kernels.WIDE_ROWS), with the
    default options: every genome holds, along one contig, n_slot runs of
    a core gene of its own slot, a gene X, a hub gene P and one of n_wide
    genes Y (each in n_genome * n_slot / n_wide genomes, enough to be a
    vertex), then a last core gene; all single exon. P has n_wide
    successors, so the first round deletes it as a high-degree segment,
    and its merge links X to every Y: a group of n_wide arcs in the branch
    rounds."""
    rng = np.random.default_rng(seed)
    X, P = n_slot + 1, n_slot + 2
    files = []
    os.makedirs(out_dir, exist_ok=True)
    for gi in range(n_genome):
        genes = []
        for j in range(n_slot):
            genes += [j, X, P, n_slot + 3 + (gi * n_slot + j) % n_wide]
        genes.append(n_slot)
        lines = []
        for k, gene in enumerate(genes):
            aa = int(rng.integers(100, 400))
            qlen = aa + int(rng.integers(0, 30))
            qs = int(rng.integers(0, 10))
            qe = min(qs + aa, qlen)
            base = 100_000 + 20_000 * k + int(rng.integers(0, 2000))
            mlen = int((qe - qs) * (0.85 + 0.14 * rng.random()))
            ms = int(mlen * 2 * (0.9 + 0.2 * rng.random()))
            lines.append("\t".join(map(str, (
                "GENE%05d:ISO0" % gene, qlen, qs, qe, "+",
                "S%03d#%d#ctg0" % (gi // 2, gi % 2 + 1), 60_000_000, base,
                base + 3 * aa, mlen, qe - qs + int(rng.integers(0, 10)), 60,
                "ms:i:%d" % ms, "fs:i:0", "st:i:0", "cg:Z:%dM" % aa))))
        fn = os.path.join(out_dir, "wide%03d.paf.gz" % gi)
        with gzip.open(fn, "wt") as fp:
            fp.write("\n".join(lines) + "\n")
        files.append(fn)
    return files


def random_genome(rng, n_hits=60, n_genes=8, n_prots_per_gene=3, n_ctg=3,
                  weak=False, max_exon=4, max_cs=3000):
    """One cs-sorted random genome with dense overlaps, for the sweep:
    multi-contig layouts, both strands, filtered hits, preferred genes and,
    with `weak`, weak_br values. Draws from `rng` (a numpy Generator) in
    the same order as the JAX package's test generator
    (tests/test_device_engine.py:random_genome) at the default sizes."""
    from .core.data import DataSet, Genome, HitTable
    from .ops.sort import hit_sort
    d = DataSet.new()
    for gi in range(n_genes):
        gid = d.add_gene("G%d" % gi)
        for pi in range(n_prots_per_gene):
            d.add_prot("G%d:P%d" % (gi, pi), gid)
        d.gene_preferred[gid] = int(rng.random() < 0.2)
    n_prot = d.n_prot
    h = HitTable.empty(n_hits)
    exon_os = []
    exon_oe = []
    off = 0
    cols = {k: [] for k in ("pid", "cid", "cs", "ce", "cm", "score_adj",
                            "score_ori", "rank", "rev", "flt", "weak_br",
                            "n_exon", "off_exon")}
    for _ in range(n_hits):
        pid = int(rng.integers(0, n_prot))
        cid = int(rng.integers(0, n_ctg))
        cs = int(rng.integers(0, max_cs))
        n_exon = int(rng.integers(1, max_exon + 1))
        pts = np.sort(rng.integers(0, 500, 2 * n_exon))
        # make strictly increasing to keep exons disjoint
        pts = pts + np.arange(2 * n_exon)
        os_ = pts[0::2]
        oe_ = pts[1::2]
        span = int(oe_[-1])
        exon_os.append(os_.astype(np.int32))
        exon_oe.append(oe_.astype(np.int32))
        cols["pid"].append(pid)
        cols["cid"].append(cid)
        cols["cs"].append(cs)
        cols["ce"].append(cs + span)
        cols["cm"].append(cs + span // 2)
        cols["score_adj"].append(int(rng.integers(0, 1000)))
        cols["score_ori"].append(int(rng.integers(0, 1200)))
        cols["rank"].append(int(rng.integers(0, 3)))
        cols["rev"].append(int(rng.integers(0, 2)))
        cols["flt"].append(int(rng.random() < 0.15))
        cols["weak_br"].append(int(rng.integers(0, 3)) if weak else 0)
        cols["n_exon"].append(n_exon)
        cols["off_exon"].append(off)
        off += n_exon
    for k, v in cols.items():
        h.set(k, np.asarray(v, h.cols[k].dtype))
    h.set("pid_dom", np.full(n_hits, -1, np.int32))
    g = Genome("test", ["c%d" % i for i in range(n_ctg)],
               np.full(n_ctg, 10000, np.int64), h,
               np.concatenate([np.zeros(0, np.int32)] + exon_os),
               np.concatenate([np.zeros(0, np.int32)] + exon_oe))
    d.genomes.append(g)
    hit_sort(g, by_cm=False)
    return d, g


def clone(d, g):
    """A one-genome copy of (d, g): the hit table and the exon pool are
    copied, the global tables are shared (the JAX package's
    tests/test_sweep_vec.py:clone)."""
    from .core.data import DataSet, Genome
    d2 = DataSet.new()
    d2.__dict__.update({k: v for k, v in d.__dict__.items() if k != "genomes"})
    g2 = Genome(g.label, g.ctg_names, g.ctg_len, g.hits.copy(),
                g.exon_os.copy(), g.exon_oe.copy())
    d2.genomes = [g2]
    return d2, g2


def band_genome(rng, n_hits, W, max_exon=4, long_exons=0, all_flt=False):
    """One-contig genome whose band width is exactly W: hit r spans
    [10 r, 10 (r + W) + 5), so it reaches the next W hits and no further.
    Exons are random windows inside the span (they may overlap each other;
    the sweep sums over exon pairs all the same). `long_exons` > 0 gives
    hit n_hits // 2 that many exons; `all_flt` filters every hit. Other
    columns come from random_genome."""
    d, g = random_genome(rng, n_hits=n_hits, n_ctg=1, max_exon=max_exon,
                         max_cs=10 * n_hits)
    h = g.hits
    span = 10 * W + 5
    cs = 10 * np.arange(n_hits, dtype=np.int64)
    h.set("cs", cs.astype(h.cs.dtype))
    h.set("ce", (cs + span).astype(h.ce.dtype))
    h.set("cm", (cs + span // 2).astype(h.cm.dtype))
    n_exon = h.n_exon.astype(np.int64)
    if long_exons:
        n_exon[n_hits // 2] = long_exons
    starts = rng.integers(0, span - 1, int(n_exon.sum()))
    ends = np.minimum(starts + rng.integers(1, 40, len(starts)), span)
    h.set("n_exon", n_exon.astype(h.n_exon.dtype))
    h.set("off_exon", (np.cumsum(n_exon) - n_exon).astype(h.off_exon.dtype))
    if all_flt:
        h.set("flt", np.ones(n_hits, h.flt.dtype))
    g.exon_os = starts.astype(np.int32)
    g.exon_oe = ends.astype(np.int32)
    return d, g


SWEEP_EDGE_CASES = ("n=B-1", "n=B", "n=B+1", "n=2B+W", "W>tile",
                    "2000 exons", "all filtered", "no exons",
                    "dense cluster", "cs>2^31")


def _far_hits(d, g, base=5 << 30):
    """Shift every hit of a one-contig band genome but the first by `base`
    (beyond 2^32), and make three kinds of far hit; the band width stays
    what it was.

    * Hits m = n - 10 and m + 1 reach 2^31 - 1000 past their cs. Hit m has
      an exon at offset 0, which overlaps its neighbours, and one near
      2^31; hit m + 1 has only one near 2^31, which overlaps m's by 590.
      Both are unfiltered, of one protein, and m + 1 scores lower: it loses
      to m with ov 590. Their tile's exon offsets pass 2^29.
    * Hit 0 lies 2^32 - 50 before hit 1 and reaches 50 past it. Its exon
      [0, 100) overlaps nothing, but cut to int32 the cs difference would
      be +50 and shift it onto hit 1's exon [40, 140)."""
    h = g.hits
    n = g.n_hit
    ne = h.n_exon.astype(np.int64)
    off = np.cumsum(ne) - ne
    exons = [[g.exon_os[o:o + k], g.exon_oe[o:o + k]]
             for o, k in zip(off, ne)]
    top = 1 << 31
    m = n - 10
    exons[m] = [np.array([0, top - 3000]), np.array([100, top - 2000])]
    exons[m + 1] = [np.array([top - 2600]), np.array([top - 1500])]
    exons[0] = [np.array([0]), np.array([100])]
    exons[1] = [np.array([40]), np.array([140])]
    for name, v in (("flt", 0), ("pid", h.pid[m]), ("score_adj", 0)):
        h.cols[name][m + 1] = v
    h.cols["flt"][[0, 1, m]] = 0
    h.cols["score_adj"][m] = 999
    cs = h.cs.astype(np.int64) + base
    ce = h.ce.astype(np.int64) + base
    ce[m:m + 2] = cs[m:m + 2] + top - 1000
    cs[0] = cs[1] - (2 * top - 50)
    ce[0] = cs[1] + 50
    for name, v in (("cs", cs), ("ce", ce), ("cm", (cs + ce) // 2)):
        h.set(name, v.astype(h.cols[name].dtype))
    ne = np.array([len(e[0]) for e in exons])
    h.set("n_exon", ne.astype(h.n_exon.dtype))
    h.set("off_exon", (np.cumsum(ne) - ne).astype(h.off_exon.dtype))
    g.exon_os = np.concatenate([e[0] for e in exons]).astype(np.int32)
    g.exon_oe = np.concatenate([e[1] for e in exons]).astype(np.int32)
    return d, g


def sweep_edge_case(name):
    """(DataSet, Genome) of one of the sweep kernel's edge cases
    (SWEEP_EDGE_CASES), for its tiles of `rows` owned rows whose halo is
    staged up to W = `band_tile` (sweep_kernel.tile_shape): n at the tile
    edges, a band wider than the staged halo, a hit with thousands of
    exons, every hit filtered, one dense overlap cluster, an empty exon
    pool, coordinates beyond 2^31 with spans and exon offsets beyond
    2^29 and a cs difference beyond 2^31 (_far_hits)."""
    from .ops.sweep_kernel import tile_shape
    rows, band_tile = tile_shape()
    W = 15
    edges = {"n=B-1": rows - 1, "n=B": rows, "n=B+1": rows + 1,
             "n=2B+W": 2 * rows + W}
    if name in edges:
        return band_genome(np.random.default_rng(edges[name]), edges[name], W)
    if name == "W>tile":
        return band_genome(np.random.default_rng(1), 4 * rows,
                           3 * band_tile + 7)
    if name == "2000 exons":
        return band_genome(np.random.default_rng(2), 80, 8, long_exons=2000)
    if name == "all filtered":
        return band_genome(np.random.default_rng(3), 3 * rows, W,
                           all_flt=True)
    if name == "no exons":
        d, g = band_genome(np.random.default_rng(5), 2 * rows, W)
        g.hits.set("n_exon", np.zeros(g.n_hit, g.hits.n_exon.dtype))
        g.hits.set("off_exon", np.zeros(g.n_hit, g.hits.off_exon.dtype))
        g.exon_os = g.exon_os[:0]
        g.exon_oe = g.exon_oe[:0]
        return d, g
    if name == "dense cluster":
        return random_genome(np.random.default_rng(4), n_hits=600, n_ctg=1,
                             max_exon=6, max_cs=400)
    if name == "cs>2^31":
        return _far_hits(*band_genome(np.random.default_rng(6), 2 * rows, W))
    raise ValueError("unknown sweep edge case %r" % (name,))


def batch_cols(genomes, device, H=None):
    """The genomes [(DataSet, Genome), ...] (cs-sorted) stacked into the
    batched sweep's layout on `device`: (BatchCols, flt uint8 [G, H], weak
    uint8 [G, H], W), rows and exon pools zero-padded to the longest genome
    (or to H rows), contig ids padded with PAD_CID and ce with -1 as the
    device loop pads them, W the largest band of any genome."""
    import torch

    from .ops import device_engine as de
    from .ops import sweep_kernel as sk
    from .ops.device import PAD_CID
    cpu = torch.device("cpu")
    cols = [de.build_cols(d, g, cpu) for d, g in genomes]
    H = max([H or 1] + [c.cid.shape[0] for c in cols])
    E = max([1] + [c.exon_os.shape[0] for c in cols])
    pad = {"cid": int(PAD_CID), "ce": -1, "cds_len": 1}

    def stack(name):
        width = E if name in sk.EXON_FIELDS else H
        out = torch.full((len(cols), width), pad.get(name, 0),
                         dtype=sk.COL_DTYPES[name])
        for j, c in enumerate(cols):
            t = getattr(c, name)
            out[j, :t.shape[0]] = t
        return out.to(device)

    n_rows = torch.tensor([c.cid.shape[0] for c in cols], dtype=torch.int32)
    bc = sk.BatchCols(n_rows.to(device), *[
        stack(name) for name in sk.BatchCols._fields[1:]])
    W = max([1] + [sk.band_width(g.hits.cid, g.hits.cs, g.hits.ce)
                   for _, g in genomes])
    return bc, stack("flt"), stack("weak"), W


def stack_cols(genomes, device, seed=0, H=None):
    """batch_cols plus what parallel/stacked.round_step takes beside it:
    (StackCols, flt, shadow, weak, g2s, W). cm and score_ori are the
    genomes'; score_dom, dom_gid (-1 for a third of the hits), the stale
    shadow flags (a tenth of the hits) and g2s (a quarter of the genes are
    no vertices, so some kept hits are a non-vertex gene's) are drawn from
    `seed`. The genomes' gene ids share one id space. Rows padded to H as
    batch_cols pads them."""
    import torch

    from .parallel.stacked import StackCols
    bc, flt, weak, W = batch_cols(genomes, device, H)
    G, H = flt.shape
    rng = np.random.default_rng(seed)
    n_gene = max([1] + [d.n_gene for d, _ in genomes])
    cm = np.zeros((G, H), np.int64)
    score_ori = np.zeros((G, H), np.int32)
    for j, (_, g) in enumerate(genomes):
        cm[j, :g.n_hit] = g.hits.cm
        score_ori[j, :g.n_hit] = g.hits.score_ori
    score_dom = rng.integers(0, 1200, (G, H)).astype(np.int32)
    dom_gid = np.where(rng.random((G, H)) < 1 / 3, -1,
                       rng.integers(0, n_gene, (G, H))).astype(np.int32)
    shadow = (rng.random((G, H)) < 0.1).astype(np.uint8)
    g2s = np.where(rng.random(n_gene) < 0.25, -1,
                   np.arange(n_gene)).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(device)
    cols = StackCols(bc, t(cm), t(dom_gid), t(score_ori), t(score_dom))
    return cols, flt, t(shadow), weak, t(g2s), W


# The per-round step's states (step_state): random genome sets of the sizes
# STEP_SIZES (one past a step kernel's tile of TILE = 1,024 positions, its
# arc keys past two), and edges: most genes no vertex (kept hits of sid -1:
# keys past 2^63); cm gaps past 2^31 (int32-truncated distances); two empty
# genomes; one genome all filtered; every genome's hit 0 filtered; one
# genome of 2,500 kept hits on one contig and strand alternating between
# two genes (four groups of ~1,250 equal arcs, across warps and tiles);
# 300,000 genes (the counters' seen bits past 48 KB; with step_state's
# n_gene, any number); and the tiles' edges: "tile_gap", a genome of 6,000
# hits of one gene on one contig and strand (two runs of ~5,000 equal arc
# keys, each spanning at least three whole tiles besides the NO_ARC tail)
# whose positions [2 TILE, 3 TILE) are all filtered (a whole tile without
# a kept row, its carry looked back past it); "tiles_4T-1", "tiles_4T",
# "tiles_4T+1", H of 4 TILE - 1, 4 TILE and 4 TILE + 1 with genome 0 of H
# hits (the walk's last tile one short, whole or of one position; the
# dedupe's 2H keys likewise by two).
STEP_SIZES = (700, 0, 120, 64, 1, 1300)
STEP_STATES = ("random", "non_vertex", "cm_gap", "empty", "all_filtered",
               "hit0_filtered", "repeats", "many_genes", "tile_gap",
               "tiles_4T-1", "tiles_4T", "tiles_4T+1")
# The most genes whose seen bits a block's shared memory held when
# step_walk ran one block a genome: the card tests and chip_smoke.py draw
# "many_genes" at it and one past it.
SEEN_SMEM_GENES = 1661952
# step_state's gap genome: its hits, and the tile of positions it filters
GAP_HITS = 6000
GAP_TILE = 2


def step_state(which, seed, device, H=None, n_gene=300000):
    """The step state STEP_STATES[which] drawn from `seed` on `device`, as
    stack_cols returns it: (StackCols, flt, shadow, weak, g2s, W); n_gene
    is the gene count of "many_genes"."""
    import torch
    from .ops.step_kernels import TILE
    cpu = torch.device("cpu")
    sizes = list(STEP_SIZES)
    if which == "empty":
        sizes[0] = sizes[3] = 0
    if which.startswith("tiles_4T"):
        H = 4 * TILE + int(which[len("tiles_4T"):] or 0)
        sizes[0] = H
    genomes = [random_genome(np.random.default_rng(100 * seed + k),
                             n_hits=n, weak=True, max_cs=30 * n + 100)
               for k, n in enumerate(sizes)]
    if which == "repeats":
        genomes[2] = random_genome(np.random.default_rng(seed), n_hits=2500,
                                   n_ctg=1, max_cs=10 ** 8)
        genomes[2][1].hits.flt[:] = 0
    if which == "tile_gap":
        genomes[0] = random_genome(np.random.default_rng(seed),
                                   n_hits=GAP_HITS, n_ctg=1, max_cs=10 ** 8)
        genomes[0][1].hits.flt[:] = 0
    for d, g in genomes:
        if which == "hit0_filtered" and g.n_hit:
            g.hits.flt[0] = 1
    if which == "all_filtered":
        genomes[0][1].hits.flt[:] = 1
    cols, flt, shadow, weak, g2s, W = stack_cols(genomes, cpu, seed, H)
    rng = np.random.default_rng(seed + 7)
    n_rows = cols.batch.n_rows.numpy()
    valid = np.arange(flt.shape[1])[None, :] < n_rows[:, None]
    if which == "non_vertex":
        g2s[torch.from_numpy(rng.random(g2s.shape[0]) < 0.8)] = -1
    if which == "cm_gap":
        cols.cm[:, ::3] += 3 << 30
    if which == "repeats":
        # genes 0 and 1 in turn along the cm order, none stale-shadowed
        n = int(n_rows[2])
        order = np.argsort(cols.cm[2, :n].numpy(), kind="stable")
        gid = np.empty(n, np.int32)
        gid[order] = np.arange(n) % 2
        cols.batch.gid[2, :n] = torch.from_numpy(gid)
        cols.batch.rev[2] = 0
        shadow[2] = 0
        g2s[:2] = torch.tensor([0, 1], dtype=g2s.dtype)
    if which == "tile_gap":
        # one gene on one strand; the rows at positions [GAP_TILE TILE,
        # (GAP_TILE + 1) TILE) of the (cid, cm) order filtered
        n = int(n_rows[0])
        order = np.argsort(cols.cm[0, :n].numpy(), kind="stable")
        cols.batch.gid[0, :n] = 0
        cols.batch.rev[0] = 0
        shadow[0] = 0
        flt[0, torch.from_numpy(
            order[GAP_TILE * TILE:(GAP_TILE + 1) * TILE])] = 1
        g2s[0] = 0
    if which == "many_genes":
        g2s = torch.from_numpy(np.where(
            rng.random(n_gene) < 0.25, -1,
            rng.integers(0, n_gene, n_gene)).astype(np.int32))
        gid = rng.integers(0, n_gene, flt.shape)
        cols.batch.gid.copy_(torch.from_numpy(np.where(valid, gid, 0)))
        cols.dom_gid.copy_(torch.from_numpy(np.where(
            rng.random(flt.shape) < 1 / 3, -1,
            rng.integers(0, n_gene, flt.shape))))
    to = lambda t: t.to(device)
    cols = type(cols)(type(cols.batch)(*map(to, cols.batch)),
                      *map(to, cols[1:]))
    return (cols, to(flt), to(shadow), to(weak), to(g2s), W)


def step_calls(state, device, use_ori=False):
    """{kernel name: (args, kw)} for ops/step_kernels.step_walk and
    step_dedupe on the step state `state` (step_state's tuple), on
    `device`: the inputs the step hands each, made by the plain versions on
    the CPU (the fused sweep, the sorts, the walk)."""
    import torch

    from .ops import step_kernels as stk
    from .ops import sweep_kernel as sk
    cpu = torch.device("cpu")
    cols, flt, shadow, weak, g2s, W = [
        x.to(cpu) if isinstance(x, torch.Tensor) else x for x in state]
    cols = type(cols)(type(cols.batch)(*[t.cpu() for t in cols.batch]),
                      *[t.cpu() for t in cols[1:]])
    shadow = shadow.clone()
    marks, score, other = sk.shadow_sweep_batched_plain(
        cols.batch, flt, weak, W, False, 0.3)
    key = sk.sweep_epilogue_plain(marks, score, other, flt, shadow,
                                  cols.batch.n_rows, cid=cols.batch.cid,
                                  cm=cols.cm)
    perm = torch.sort(key, dim=1, stable=True).indices
    walk = stk.step_walk_plain(cols, perm, flt, shadow, g2s,
                               use_ori=use_ori)
    xs, aperm = torch.sort(walk[0], dim=1, stable=True)
    to = lambda t: t.to(device)
    dcols = type(cols)(type(cols.batch)(*map(to, cols.batch)),
                       *map(to, cols[1:]))
    return {"step_walk": ([dcols, to(perm), to(flt), to(shadow), to(g2s)],
                          dict(use_ori=use_ori)),
            "step_dedupe": ([to(xs), to(aperm)] + [to(t) for t in walk[1:5]],
                            {})}


def loop_sweep_args(genomes, device, seed=0, H=None):
    """batch_cols plus the device loop's epilogue planes, drawn from
    `seed`: (BatchCols, flt, weak, W, shadow, pid_dom, ev1, pid). A tenth
    of the rows filtered anew (padding rows stay unfiltered), shadow in
    {0, 1, 2}, pid_dom -1 or a row's pid, ev1 0 at each genome's row 0 and
    a twentieth of the others, pid distinct per row."""
    import torch
    bc, flt, weak, W = batch_cols(genomes, torch.device("cpu"), H)
    G, H = flt.shape
    rng = np.random.default_rng(seed)
    valid = np.arange(H)[None, :] < bc.n_rows.numpy()[:, None]
    more = torch.from_numpy((rng.random((G, H)) < 0.1) & valid)
    flt = flt | more.to(torch.uint8)
    shadow = rng.choice(3, (G, H), p=(0.8, 0.15, 0.05)).astype(np.uint8)
    pid = rng.permutation(G * H).reshape(G, H).astype(np.int32)
    pid_dom = np.where(rng.random((G, H)) < 0.5, -1, pid)
    ev1 = (rng.random((G, H)) >= 0.05) & (np.arange(H)[None, :] >= 1)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (type(bc)(*[t.to(device) for t in bc]), flt.to(device),
            weak.to(device), W, to(shadow), to(pid_dom.astype(np.int32)),
            to(ev1.astype(np.uint8)), to(pid))


def stacked_edge_cases():
    """The sweep kernel's edge cases as genomes of one batch, with an empty
    genome and a genome whose row 0 is filtered: {"tile": the cases whose
    band fits the staged halo, "wide": all of them (one band for the batch,
    so every genome takes the large-W path)}."""
    from .ops.sweep_kernel import band_width, tile_shape
    band_tile = tile_shape()[1]
    row0 = random_genome(np.random.default_rng(8), n_hits=200, weak=True)
    row0[1].hits.flt[0] = 1
    extra = [random_genome(np.random.default_rng(7), n_hits=0), row0]
    cases = [sweep_edge_case(name) for name in SWEEP_EDGE_CASES]
    tile = [c for c in cases if band_width(
        c[1].hits.cid, c[1].hits.cs, c[1].hits.ce) <= band_tile]
    return {"tile": tile + extra, "wide": cases + extra}


def locality_table(rng, G, sizes, n_invalid=5, n_gene=40, p_absent=0.3,
                   local_dist=1000, local_count=3):
    """Inputs of ops/loop_kernels.branch_locality as numpy arrays, a v-sorted
    arc table as the device loop holds it: groups of `sizes` arcs in order
    (gs_of the group's first arc; the members of a group of >= 2 branch,
    is_max where s1 is the group's largest), then `n_invalid` empty slots
    (their group id stays the last group's, as the loop's cumsum leaves it),
    and random gene-major representative planes [n_gene, G] (a gene absent
    from a genome with probability p_absent). Returns (dict in argument
    order, the groups as lists of arc indices)."""
    A = int(sum(sizes)) + n_invalid
    gs_of = np.zeros(A, np.int64)
    branching = np.zeros(A, bool)
    s1 = rng.integers(0, 5, A)
    is_max = np.zeros(A, bool)
    groups, start = [], 0
    for n in sizes:
        idx = list(range(start, start + n))
        gs_of[idx] = start
        if n >= 2:
            branching[idx] = True
            is_max[idx] = s1[idx] == s1[idx].max()
        groups.append(idx)
        start += n
    gs_of[start:] = groups[-1][0] if groups else A
    t = dict(r_pres=rng.random((n_gene, G)) >= p_absent,
             r_cid=rng.integers(0, 2, (n_gene, G)).astype(np.int32),
             r_cm=rng.integers(0, 8 * local_dist, (n_gene, G)),
             r_rank=rng.integers(0, 6 * local_count,
                                 (n_gene, G)).astype(np.int32),
             tgt_gid=rng.integers(0, n_gene, A).astype(np.int64),
             gs_of=gs_of, branching=branching, is_max=is_max)
    return t, groups


BRANCH_B = 20          # bits of the target below v in branch_table's arc_vw


# Branch constants that are deficits of ratios: 1 - 49/50, 1 - 19/20 and
# 1 - 1/2 in double, near the defaults 0.02, 0.05 and 0.5.
EXACT_BRANCH_DIFFS = (1.0 - 49 / 50, 1.0 - 19 / 20, 1.0 - 1 / 2)


def deficit_ratios(consts=(0.02, 0.05, 0.5)):
    """(s1, mx) pairs, 0 <= s1 <= mx, whose double deficit 1 - s1 / mx lies
    on or next to each constant c (s1 = round((1 - c) mx) and one either
    side, at several mx), the ratios of EXACT_BRANCH_DIFFS at several mx,
    then s1 == mx, s1 == 0 and 1 of 1."""
    out = []
    for c in consts:
        for mx in (50, 100, 1000, 4999, 99991):
            s1 = round((1.0 - c) * mx)
            out += [(x, mx) for x in (s1 - 1, s1, s1 + 1) if 0 <= x <= mx]
    for num, den in ((49, 50), (19, 20), (1, 2)):
        out += [(num * k, den * k) for k in (1, 2, 20, 1000)]
    return out + [(900, 900), (0, 900), (1, 1)]


def branch_table(rng, G, sizes, ratios=(), **kw):
    """Inputs of ops/loop_kernels.branch_block as numpy arrays: the planes
    and targets of locality_table(rng, G, sizes, **kw), the v-sorted arc
    table arc_vw (group k's source vertex v = 3k + 1 above BRANCH_B bits of
    target; SENT_I in the empty slots) and arc_s1. The (s1, mx) pairs of
    `ratios` go in order to the groups of >= 2 members (first member mx,
    second s1); other members draw s1 in [0, mx]. Returns (dict in argument
    order, the groups as lists of arc indices)."""
    from .ops.loop_kernels import SENT_I
    t, groups = locality_table(rng, G, sizes, **kw)
    A = len(t["tgt_gid"])
    vw = np.full(A, SENT_I, np.int64)
    s1 = np.zeros(A, np.int32)
    todo = list(ratios)
    for k, idx in enumerate(groups):
        vw[idx] = ((3 * k + 1) << BRANCH_B) | rng.integers(
            0, 1 << BRANCH_B, len(idx))
        mx = int(rng.integers(1, 3000))
        s1[idx] = rng.integers(0, mx + 1, len(idx))
        s1[idx[0]] = mx
        if len(idx) >= 2 and todo:
            r, mx = todo.pop(0)
            s1[idx] = np.minimum(s1[idx], mx)
            s1[idx[0]], s1[idx[1]] = mx, r
    out = {k: t[k] for k in ("r_pres", "r_cid", "r_cm", "r_rank", "tgt_gid")}
    out.update(arc_vw=vw, arc_s1=s1)
    return out, groups


def fold_inputs(rng, form, N, n_vw, n_g=8, p_valid=0.7, smax=1000,
                full=False, dist=(0, 1 << 20)):
    """Inputs of ops/loop_kernels.merge_fold as numpy arrays (keys, s1, jb,
    gb, perm) in the device loop's three call shapes: "jb" (each row's index
    in the low key bits, keys sorted alone), "cosorted" (keys sorted with a
    stable permutation), "exchange" (a received range: keys with origin
    bits, sorted with a permutation; s1 by received position). A row is
    valid with probability p_valid; s1 in [0, smax). With `full`, a sixth
    item (s2, dist) for the full mode, by origin as s1: s2 in [0, smax),
    dist int32 in [dist[0], dist[1])."""
    from .ops.loop_kernels import KSENT_I
    gb = max(int(n_g - 1).bit_length(), 1)
    vw = rng.integers(0, n_vw, N)
    g = rng.integers(0, n_g, N)
    valid = rng.random(N) < p_valid
    key = (vw << gb) | g
    s1 = rng.integers(0, smax, N).astype(np.int32)
    jb = max(int(N - 1).bit_length(), 1)
    if form == "jb":
        keys = np.sort(np.where(valid, (key << jb) | np.arange(N), KSENT_I))
        perm = None
    elif form == "cosorted":
        jb = 0
        k = np.where(valid, key, KSENT_I)
        perm = np.argsort(k, kind="stable")
        keys = k[perm]
    else:
        k = np.where(valid, (key << jb) | rng.permutation(N), KSENT_I)
        perm = np.argsort(k, kind="stable")
        keys = k[perm]
    out = (keys.astype(np.int64), s1, jb, gb, perm)
    if full:
        out += ((rng.integers(0, smax, N).astype(np.int32),
                 rng.integers(dist[0], dist[1], N).astype(np.int32)),)
    return out


# The fuzz cases of mesh_kernels.protein_reduce (reduction_inputs): random
# rows; pids outside [0, n_prot) (clamped); scores <= 0; every row
# filtered; one protein; an empty genome; 300 genomes; score_ori rising
# along the rows, so that every valid row is a new maximum of its protein
# (10 proteins, so many rows a protein, each raising its maximum); every
# row to one pid of 5,000; 60,000 proteins
# over 1.6 million rows (more row blocks than the card holds at once);
# every rank-0 unfiltered row multi-exon (cnt0 and sum0 zero, rep_cnt =
# cnt1).
REDUCE_CASES = ("random", "pid_out_of_range", "scores_le_zero",
                "all_filtered", "n_prot_1", "empty_genome", "many_genomes",
                "ascending_scores", "one_protein_all_rows", "wide",
                "r0_none_multi")


def reduction_inputs(which: str, flat: bool = False):
    """protein_reduce's arguments in case `which` (REDUCE_CASES) as numpy
    arrays: (cols: pid, score_ori, score_adj, n_exon, rank int32, flt
    uint8, n_rows int32, n_prot). The padded [G, H] stack, its rows past
    n_rows noise; with `flat`, the valid rows of every genome end to end
    (G = 1, one spare row), as post_reductions_sharded stacks them."""
    rng = np.random.default_rng(REDUCE_CASES.index(which))
    G, H, P = {"many_genomes": (300, 700, 5000),
               "ascending_scores": (4, 300, 10),
               "one_protein_all_rows": (4, 300, 5000),
               "wide": (4, 400_000, 60_000)}.get(which, (4, 300, 40))
    lo_pid, hi_pid, lo_sc = 0, P, 0
    if which == "pid_out_of_range":
        lo_pid, hi_pid = -5, P + 5
    elif which == "scores_le_zero":
        lo_sc = -1000
    elif which == "n_prot_1":
        P, hi_pid = 1, 3
    n_rows = rng.integers(1, H + 1, G).astype(np.int32)
    if which == "empty_genome":
        n_rows[1] = 0
    elif which == "wide":
        n_rows = (H - rng.integers(1, 100, G)).astype(np.int32)
    cols = [rng.integers(lo_pid, hi_pid, (G, H)),
            rng.integers(lo_sc, 900, (G, H)),
            rng.integers(lo_sc, 900, (G, H)),
            rng.integers(1, 4, (G, H)), rng.integers(0, 2, (G, H))]
    if which == "scores_le_zero":
        cols[1] = np.minimum(cols[1], 0)
    elif which == "ascending_scores":
        # 1, 2, ... along the valid rows, genome after genome
        valid = np.arange(H)[None, :] < n_rows[:, None]
        cols[1][valid] = np.arange(1, int(valid.sum()) + 1)
    elif which == "one_protein_all_rows":
        cols[0][:] = 1234
    elif which == "r0_none_multi":
        cols[3] = rng.integers(2, 4, (G, H))
    cols = [c.astype(np.int32) for c in cols]
    flt = (rng.random((G, H)) < 0.3).astype(np.uint8)
    if which == "all_filtered":
        flt[:] = 1
    if flat:
        take = lambda a: np.concatenate(
            [a[j, :n] for j, n in enumerate(n_rows)]
            + [np.zeros(1, a.dtype)])[None, :]
        cols, flt = [take(c) for c in cols], take(flt)
        n_rows = np.array([n_rows.sum()], np.int32)
    return cols, flt, n_rows, P


# The states of exchange_calls: random keys; one destination's run longer
# than the bucket (the overflow flag); every key a sentinel; every key to
# one destination (a bucket of NL); a table of A = NL // 64 rows, so that
# the later ranks' windows start past it; no key to destination 1, between
# destinations 0 and 2 that get keys (an empty run in the middle).
EXCHANGE_STATES = ("ordinary", "overflow", "all_sentinel", "one_dest",
                   "window_past_A", "empty_middle")


def exchange_calls(which: str, seed: int, device, nd: int = 4,
                   G_loc: int = 3, H: int = 400, S: int = 12,
                   A: int = None):
    """The bucket exchange of device_loop.exchange_merge over `nd` ranks of
    G_loc genomes of H rows (NL = 2 G_loc H lean keys a rank, 70% valid:
    v uniform in [0, 2S), w one of v's three neighbours), in state `which`
    (EXCHANGE_STATES), every rank's step made here with the plain versions
    on `device`; the bucket is the loop's (1.5 NL / nd keys, padded to 128,
    at most NL), A the given one or nd * NL. Returns (meta, calls):
    meta the shape (nd, NL, C, A, JB, GB, B, S); calls[r] maps
    "pack", "window" and "finish" to rank r's (args, kw) of
    ops/mesh_kernels' entry of that name (its plain version on other
    devices; the pair plane of "finish", its fifth argument, is a fresh
    copy of the pack's, its sixth the pack's bounds)."""
    import torch
    from .ops import loop_kernels as lk
    from .ops import mesh_kernels as mk
    rng = np.random.default_rng(seed)
    NL = G_loc * 2 * H
    B = max((2 * S - 1).bit_length(), 1)
    GB = max((nd * G_loc - 1).bit_length(), 1)
    JB = max((nd * NL - 1).bit_length(), 1)
    C = min(((int(NL * 1.5) // nd + 127) // 128) * 128, NL)
    if 2 * B + GB + JB > 62:
        raise ValueError("exchange_calls: a lean key of %d bits is not "
                         "below KSENT" % (2 * B + GB + JB))
    if A is None:
        A = nd * NL
    p_valid, skew, dest = 0.7, 0.0, None
    if which == "overflow":
        skew = 0.6              # of the keys forced to destination 0
    elif which == "all_sentinel":
        p_valid = 0.0
    elif which == "one_dest":
        dest, C = int(rng.integers(0, nd)), NL
    elif which == "window_past_A":
        A = max(1, NL // 64)
    elif which not in ("ordinary", "empty_middle"):
        raise ValueError(which)
    # the v's whose destination is not 1 (empty_middle draws from them)
    v_not1 = np.flatnonzero((np.arange(2 * S) * nd) // (2 * S) != 1)
    span = -(-2 * S // nd)                  # v's of one destination
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    kw_pack = dict(nd=nd, cap=C, jb=JB, shift=JB + GB + B, two_s=2 * S)
    keys, s1 = [], []
    for r in range(nd):
        v = rng.integers(0, 2 * S, NL)
        if dest is not None:
            v = rng.integers(dest * span, min((dest + 1) * span, 2 * S), NL)
        elif which == "empty_middle":
            v = rng.choice(v_not1, NL)
        elif skew:
            v = np.where(rng.random(NL) < skew, rng.integers(0, span, NL), v)
        w = (v + rng.integers(1, 4, NL)) % (2 * S)
        g = r * G_loc + np.arange(NL) // (2 * H)
        k = ((((v << B) | w) << GB | g) << JB) | (r * NL + np.arange(NL))
        keys.append(np.sort(np.where(rng.random(NL) < p_valid, k,
                                     lk.KSENT_I)))
        s1.append(rng.integers(0, 1000, NL).astype(np.int32))
    packs = [mk.exchange_pack_plain(t(keys[r]), t(s1[r]), rank=r, **kw_pack)
             for r in range(nd)]
    calls, folds = [], []
    for r in range(nd):
        got = torch.cat([packs[q][0][r:r + 1] for q in range(nd)])
        got_k = got[:, 0].reshape(-1)
        rk, rpos = torch.sort(got_k, stable=True)
        vw, fs1, n_out_l, reply_loc = lk.merge_fold_plain(
            rk, got[:, 1].to(torch.int32).reshape(-1), jb=JB, gb=GB,
            cap=nd * C, perm=rpos)
        folds.append((vw, fs1, n_out_l, reply_loc, got_k))
    per_rank = torch.stack([torch.stack([f[2], p[1]])
                            for f, p in zip(folds, packs)]).reshape(-1)
    windows = [mk.exchange_window_plain(per_rank, *folds[r][:2],
                                        *folds[r][3:], rank=r, A=A)
               for r in range(nd)]
    table = sum(w[0] for w in windows)
    for r in range(nd):
        back = torch.cat([windows[q][1][r * C:(r + 1) * C]
                          for q in range(nd)])
        calls.append({
            "pack": ((t(keys[r]), t(s1[r])), dict(kw_pack, rank=r)),
            "window": ((per_rank, *folds[r][:2], *folds[r][3:]),
                       dict(rank=r, A=A)),
            "finish": ((table, windows[r][2], packs[r][0], back,
                        packs[r][2].clone(), packs[r][3]),
                       dict(jb=JB, rank=r))})
    meta = dict(nd=nd, NL=NL, C=C, A=A, JB=JB, GB=GB, B=B, S=S)
    return meta, calls


def round_state(rng, G, H, S=40, n_gene=50, sizes=(3, 1, 5, 2, 1, 4),
                n_invalid=7, p_flt=0.2, p_shadow=0.1, p_dead=0.2,
                empty=(), far=False, edges=0, min_valid=0):
    """A random state of the device loop's rounds as numpy arrays, the
    inputs of ops/loop_kernels.walk_pairs, branch_prep, prop_round and
    occ_round: G genomes of H rows in cs order (a genome's valid rows
    first, sorted by contig, at least `min_valid`; the genomes in `empty`
    have none): cid, cm (beyond 2^31 on every third row with `far`, so cm
    gaps pass 2^31; with `edges`, every row valid, cm ascending, so the cm
    order is the cs order, and only the rows at either end of each `edges`
    rows kept), gid, dom_gid (-1 on some rows), score_ori, score_dom, rev,
    valid, flt (p_flt; padding rows 0), shadow, weak (0, 1, 2), ordcm (the
    cm order of the valid rows, then the padding rows in place: a
    permutation); sid_of
    [n_gene] (some -1), alive [S] (dead with p_dead), seg_tot [S], loci
    [S, 2], seg_gid [S]; the v-sorted arc table arc_vw [A] (groups of
    `sizes` arcs of ascending source vertices above B bits of target, then
    n_invalid empty slots; B, an int, the bits of a vertex: those of
    2S - 1) with arc_weak (0, 1, 2) and n_grp (a small count at each group
    of two or more's first arc, 0 elsewhere)."""
    from .ops.loop_kernels import SENT_I
    nk = np.full(G, H) if edges else rng.integers(min_valid, H + 1, G)
    nk[list(empty)] = 0
    valid = np.arange(H)[None, :] < nk[:, None]
    cid = np.sort(rng.integers(0, 3, (G, H)), axis=1).astype(np.int32)
    cm = rng.integers(0, 5000, (G, H)).astype(np.int64)
    if edges:
        cm.sort(axis=1)
    if far:
        cm[:, ::3] += 3 << 30
    ordcm = np.tile(np.arange(H, dtype=np.int32), (G, 1))
    for g in range(G):
        k = int(nk[g])
        ordcm[g, :k] = np.lexsort((cm[g, :k], cid[g, :k]))
    rows = lambda p: (rng.random((G, H)) < p) & valid
    gid = np.where(valid, rng.integers(0, n_gene, (G, H)), 0) \
        .astype(np.int32)
    dom_gid = np.where(rng.random((G, H)) < 0.3, -1,
                       rng.integers(0, n_gene, (G, H))).astype(np.int32)
    sid_of = np.where(rng.random(n_gene) < 0.1, -1,
                      rng.integers(0, S, n_gene)).astype(np.int32)
    B = max((2 * S - 1).bit_length(), 2)
    vs = np.sort(rng.choice(2 * S, len(sizes), replace=False))
    vw = [(int(v) << B) | int(w) for v, n in zip(vs, sizes)
          for w in np.sort(rng.integers(0, 2 * S, n))]
    A = len(vw) + n_invalid
    heads = np.cumsum([0] + list(sizes))[:-1]
    n_grp = np.zeros(A, np.int32)
    n_grp[heads] = np.where(np.asarray(sizes) >= 2,
                            rng.integers(1, 4, len(sizes)), 0)
    flt, shadow = rows(p_flt), rows(p_shadow)
    if edges:
        end = np.isin(np.arange(H) % edges, (0, edges - 1))[None, :]
        flt, shadow = valid & ~end, shadow & ~end
    return dict(
        cid=cid, cm=cm, gid=gid, dom_gid=dom_gid,
        score_ori=rng.integers(0, 1000, (G, H)).astype(np.int32),
        score_dom=rng.integers(0, 1000, (G, H)).astype(np.int32),
        rev=rng.integers(0, 2, (G, H)).astype(np.uint8), valid=valid,
        flt=flt.astype(np.uint8), shadow=shadow.astype(np.uint8),
        weak=np.where(valid, rng.choice(3, (G, H), p=(0.7, 0.2, 0.1)), 0)
        .astype(np.uint8),
        ordcm=ordcm, sid_of=sid_of, alive=rng.random(S) >= p_dead,
        seg_tot=rng.integers(0, 3 * G + 1, S).astype(np.int32),
        loci=rng.integers(0, 4, (S, 2)).astype(np.int32),
        seg_gid=rng.integers(0, n_gene, S).astype(np.int64),
        arc_vw=np.array(vw + [SENT_I] * n_invalid, np.int64),
        arc_weak=rng.choice(3, A).astype(np.uint8), n_grp=n_grp,
        pair_arc=rng.integers(0, A + 3, (G, 2 * H)).astype(np.int32), B=B)


# The round kernels' states: round_state keywords at G genomes of H rows,
# and `hit0` to filter each genome's hit 0 at entry (the ev1 stale-flag
# trap): the edge cases (`far`: cm gaps past 2^31), states over several of
# the scans' 1,024-row tiles (csrc/loop_round.cu kScanTile): 70 genomes;
# one genome; a north-star-wide genome's kept rows so sparse that several
# tiles in a row hold none; kept rows only at the tiles' first and last
# rows (tiles start at a genome's row 0), and groups of exactly 64 and 65
# arcs (the JAX package's branch window D = 64 and one past it; the branch
# kernels' block path and their wide path) across a branch_prep arc
# block's end (1,024 arcs a block).
ROUND_STATES = {
    "random": dict(G=5, H=40),
    "far": dict(G=5, H=40, far=True),
    "empty_genomes": dict(G=5, H=40, empty=(0, 2, 4)),
    "all_filtered": dict(G=5, H=40, p_flt=1.0),
    "hit0_filtered": dict(G=5, H=40, hit0=True),
    "all_dead": dict(G=5, H=40, p_dead=1.0),
    "window_D": dict(G=5, H=40, sizes=(3, 64, 2)),
    "window_D+1": dict(G=5, H=40, sizes=(3, 65, 2)),
    "tiles": dict(G=70, H=3077, S=3000, n_gene=4000,
                  sizes=tuple(range(1, 300))),
    "one_genome": dict(G=1, H=1025, S=500, n_gene=600, p_flt=0.02,
                       hit0=True),
    "sparse_tiles": dict(G=3, H=19000, S=500, n_gene=600, p_flt=0.999),
    "tile_edges": dict(G=3, H=5000, S=500, n_gene=600, edges=1024),
    "window_D_edge": dict(G=5, H=40, sizes=(50,) * 20 + (64, 3, 2)),
    "window_D+1_edge": dict(G=5, H=40, sizes=(50,) * 20 + (65, 3, 2)),
}
# the states only the card tests and chip_smoke take (the CPU oracles'
# row-by-row loops are slow there); the CPU oracle tests take the others
ROUND_CARD_ONLY = ("tiles", "one_genome")
ROUND_EDGE_CASES = tuple(n for n in ROUND_STATES if n not in ROUND_CARD_ONLY)


def make_state(which, seed):
    """The round_state ROUND_STATES[which] drawn from `seed`."""
    kw = dict(ROUND_STATES[which])
    hit0 = kw.pop("hit0", False)
    st = round_state(np.random.default_rng(seed), kw.pop("G"), kw.pop("H"),
                     **kw)
    if hit0:
        st["flt"][:, 0] = st["valid"][:, 0]
    return st


# The walk's key forms: (rank, world, jb on, full): the lean in-loop key
# with the global slot in its low bits, the co-sorted key, the full=True
# tail's, and the bucket exchange's lean key at rank 2 of three.
WALK_FORMS = {"lean": (0, 1, True, False), "cosorted": (0, 1, False, False),
              "full": (0, 1, False, True), "exchange": (2, 3, True, False)}
# positions of the arguments each round kernel updates in place
ROUND_INPLACE = {"walk_pairs": (), "branch_prep": (), "prop_round": (0, 1, 8),
                 "occ_round": (0, 1, 7, 8, 9, 10, 11, 12, 13)}


def round_calls(st, device, form="lean", use_ori=False, r=1,
                cuts=(60, 3, 2), propagate=True, loci=True):
    """{kernel name: make} for the four round kernels of
    ops/loop_kernels.py on the round_state `st` on `device`: make() returns
    (args, kw) on fresh copies of the state. walk_pairs in WALK_FORMS[form];
    prop_round's pair state is walk_pairs_plain's (nxt, pair_ok) with
    st["pair_arc"]; occ_round in round r of 4 with `cuts` (None: no occ)
    and, when `loci`, st["n_grp"]."""
    import torch
    from .ops import loop_kernels as lk
    t = lambda k: torch.from_numpy(np.array(st[k])).to(device)   # a copy
    G, H = st["cid"].shape
    S, ng = len(st["alive"]), len(st["sid_of"])
    rank, world, lean, full = WALK_FORMS[form]
    GB = max((world * G - 1).bit_length(), 1)
    jb = max((world * G * 2 * H - 1).bit_length(), 1) if lean else 0
    cols = {k: t(k) for k in ("cid", "cm", "gid", "dom_gid", "score_ori",
                              "score_dom", "rev", "valid")}
    planes = lk.walk_planes(cols, t("ordcm"), t("sid_of"), S)
    B = st["B"]
    walk_kw = dict(B=B, GB=GB, jb=jb, rank=rank, use_ori=use_ori,
                   full=full)
    _, _, pair_ok, nxt = lk.walk_pairs_plain(
        planes, t("flt"), t("shadow"), t("alive"), **walk_kw)[:4]
    new = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    R = 4
    return {
        "walk_pairs": lambda: (
            [planes, t("flt"), t("shadow"), t("alive")], dict(walk_kw)),
        "branch_prep": lambda: (
            [t(k) for k in ("flt", "shadow", "valid", "gid", "cid", "cm",
                            "arc_vw", "seg_gid")], dict(n_gene=ng, B=B)),
        "prop_round": lambda: (
            [t("weak"), t("flt"), t("valid"), planes.ordcm, t("pair_arc"),
             nxt, pair_ok, t("arc_weak"), new(2, torch.int64)],
            dict(propagate=propagate)),
        "occ_round": lambda: (
            [t(k) for k in ("alive", "flt", "valid", "gid", "sid_of",
                            "arc_vw", "seg_tot", "loci")]
            + [new((R, 10), torch.int64), new((R, S), torch.uint8),
               new((R, S, 2), torch.int32), new((R, S, 2), torch.int32),
               new((R, S), torch.int32), new(2, torch.int64)],
            dict(r=r, B=B, n_grp=t("n_grp") if loci else None,
                 cuts=cuts))}


def round_outputs(name, args, kw, plain=False):
    """Calls the round kernel `name` of ops/loop_kernels.py (or its plain
    version) and returns its outputs: what it returns, then the arguments
    it updates in place (ROUND_INPLACE)."""
    from .ops import loop_kernels as lk
    out = getattr(lk, name + ("_plain" if plain else ""))(*args, **kw)
    return tuple(out or ()) + tuple(args[i] for i in ROUND_INPLACE[name])


def sector_shares(idx) -> tuple:
    """The shares of the 32-wide words of a [G, W] index plane (each row's
    words from its column 0; a short last word repeats its last index)
    whose indices into a byte array that starts on a sector fall within
    one, and at most two, of its 32-byte sectors: how many sectors a
    warp's byte gather through them touches."""
    import torch
    G, W = idx.shape
    n = -(-W // 32)
    sec = idx.long() // 32
    sec = torch.cat([sec, sec[:, -1:].expand(G, n * 32 - W)], dim=1)
    steps = sec.reshape(G, n, 32).sort(dim=-1).values.diff(dim=-1)
    n_sec = 1 + (steps != 0).sum(dim=-1)
    words = max(G * n, 1)
    return (float((n_sec <= 1).sum()) / words,
            float((n_sec <= 2).sum()) / words)


def ordcm_locality(ordcm, tile: int = 1024) -> dict:
    """How near the cm order of a [G, H] ordcm (each genome's cs row of
    each cm position) is to the cs order, as prop_round reads it: "warps"
    counts the 32-position words of the genomes (from each genome's row 0,
    the last one of a genome short when H is not a multiple of 32);
    "one_sector" and "two_sectors" are sector_shares of the cs rows in a
    byte plane [G, H]; "identity" is the share of positions whose cs row
    is their own, "in_tile" the share whose cs row lies in their own tile
    of `tile` rows of the genome (the kernel's staged window), "max_shift"
    the largest |cs row - cm position|."""
    import torch
    G, H = ordcm.shape
    o = ordcm.long()
    pos = torch.arange(H, device=o.device)[None, :]
    one, two = sector_shares(torch.arange(G, device=o.device)[:, None] * H
                             + o)
    return {"warps": G * -(-H // 32), "one_sector": one, "two_sectors": two,
            "identity": float((o == pos).sum()) / max(G * H, 1),
            "in_tile": float((o // tile == pos // tile).sum())
            / max(G * H, 1),
            "max_shift": int((o - pos).abs().max()) if G * H else 0}


REPORT_TAG = "RANK_REPORT="


def rank_report_main(argv: List[str]) -> int:
    """One rank of a launch (parallel/mesh.launch, torchrun): the CLI on
    `argv`, with the output this rank would write hashed instead of written
    (every rank builds the graph; the CLI writes only rank 0's). Then one
    line on stderr, REPORT_TAG and a JSON object: rank, world, the md5 of
    the output, the CLI's exit code, the wall of the CLI call, the device
    loop's and the per-round path's LAST, the mesh's collective counts, the
    kernels' launches (the fused sweep's by epilogue and the step kernels'
    under step_launches, the mesh kernels' under mesh_launches) and plain
    calls (mesh_calls: the mesh kernels' both), the peak device bytes on
    cuda, the
    stage walls, and the modules of other packages the rank loaded."""
    import hashlib
    import torch
    from . import cli, pipeline, util
    from .ops import loop_kernels as lk
    from .ops import mesh_kernels as mk
    from .ops import step_kernels as stk
    from .ops import sweep_kernel as sk
    from .parallel import device_loop, mesh, stacked
    md5 = hashlib.md5()

    class Sink:
        def write(self, text: str) -> int:
            md5.update(text.encode())
            return len(text)

    run = pipeline.run
    pipeline.run = lambda opt, files, out=None, **kw: run(opt, files,
                                                         out=Sink(), **kw)
    sk.reset_counts()
    lk.reset_counts()
    stk.reset_counts()
    mk.reset_counts()
    mesh.reset_counts()
    t0 = time.monotonic()
    rc = cli.main(argv)
    wall = time.monotonic() - t0
    rep = {
        "rank": util.launch_rank(), "world": int(os.environ.get(
            "WORLD_SIZE", "1")), "rc": rc, "md5": md5.hexdigest(),
        "wall_s": round(wall, 3), "LAST": device_loop.LAST,
        "rounds_LAST": stacked.LAST, "mesh": mesh.LAST,
        "kernel_launches": sum(sk.n_kernel_launches.values()),
        "batched_launches": sk.n_batched()["kernel"],
        "loop_launches": {k: c["kernel"] for k, c in lk.n_calls.items()},
        "step_launches": {
            "sweep_round_loop": sk.n_fused["loop"]["kernel"],
            "sweep_round_step": sk.n_fused["step"]["kernel"],
            **{k: c["kernel"] for k, c in stk.n_calls.items()}},
        "mesh_launches": {k: c["kernel"] for k, c in mk.n_calls.items()},
        "mesh_calls": mk.n_calls,
        "plain_calls": (sum(sk.n_plain_calls.values()) + sk.n_batched()["plain"]
                        + sum(c["plain"] for c in lk.n_calls.values())
                        + sum(c["plain"] for c in stk.n_calls.values())
                        + sum(c["plain"] for c in mk.n_calls.values())),
        "peak_device_bytes": (torch.cuda.max_memory_allocated()
                              if torch.cuda.is_initialized() else None),
        "stages": util.stage_stats,
        "foreign_modules": sorted(m for m in sys.modules if m.split(".")[0]
                                  in ("jax", "jaxlib", "pangene_tpu"))}
    sys.stderr.write(REPORT_TAG + json.dumps(rep, default=str) + "\n")
    return rc


def run_ranks(world: int, argv: List[str], env=None, timeout=120.0,
              cwd=None) -> List[dict]:
    """`world` ranks of rank_report_main on `argv`, started as torchrun
    would start them (parallel/mesh.launch), each killed after `timeout`
    seconds. Returns each rank's report, in rank order, with its exit code
    ("exit") and its stderr ("stderr"); raises AssertionError when a rank
    failed, hung or did not report."""
    from .parallel.mesh import launch
    cmd = [sys.executable, "-m", "pangene_tpu_torch.testing"] + list(argv)
    with tempfile.TemporaryDirectory() as tmp:
        errs = [open(os.path.join(tmp, "rank%d.err" % r), "w+")
                for r in range(world)]
        try:
            rcs = launch(cmd, world, env=env, stdouts=[subprocess.DEVNULL] * world,
                          stderrs=errs, timeout=timeout, cwd=cwd)
            texts = []
            for f in errs:
                f.seek(0)
                texts.append(f.read())
        finally:
            for f in errs:
                f.close()
    reports = []
    for r, (rc, text) in enumerate(zip(rcs, texts)):
        lines = [x for x in text.splitlines() if x.startswith(REPORT_TAG)]
        if rc or not lines:
            raise AssertionError("rank %d of %d exited %s (timeout %s s): %s"
                                 % (r, world, rc, timeout, text[-3000:]))
        rep = json.loads(lines[-1][len(REPORT_TAG):])
        rep.update(exit=rc, stderr=text)
        reports.append(rep)
    return reports


if __name__ == "__main__":
    sys.exit(rank_report_main(sys.argv[1:]))
