"""Synthetic miniprot-PAF corpora, drawn in bulk from a seed.

The shape is that of a protein-to-genome alignment corpus: orthologous gene
loci shared across genomes in one layout along a few contigs, a paralog copy
2 Mb downstream at a rate of 8%, up to `n_iso` isoforms a copy with 2-8
exons (or one exon where the configuration says so), valid CIGAR strings
with introns, and PanSN contig names. Which genes a genome holds follows one
of two presence models: every gene missing in 5% of the genomes (a
population of one species' haplotypes), or, where the configuration gives
`n_core` and `per_genome`, a pangenome's counts: the core genes in every
genome and each accessory gene in a genome at the rate that gives
`per_genome` genes a genome on average. Only the scale (genomes, genes,
isoforms, the core and a genome's gene count) comes from a configuration.

The records themselves come from one fixed draw (BASE_SEED), and `--seed`
orders it: it picks which of the drawn genomes each file holds. So every
seed gives the same set of genomes and records, and the same work, in
another order, which gives the genes and proteins other ids (they are
numbered in first-encounter order over the files) and the sorts other ties.
Every genome is drawn from its own stream (numpy SeedSequence spawn keys),
so genomes can be drawn, and written, in any order and in any process, and
`draw_genome` gives the same records to the benchmark's writer and to its
reference. This module imports nothing of the program.
"""
from __future__ import annotations

import gzip
import os
from typing import List, NamedTuple

import numpy as np

BASE_SEED = 20_240_101
CTG_LEN = 60_000_000
PARALOG_GAP = 2_000_000
MISSING_RATE = 0.05


class Shape(NamedTuple):
    """The draw's parameters (a configuration's "draw" object)."""
    n_genome: int
    n_gene: int
    n_iso: int = 3
    n_ctg: int = 4
    paralog_rate: float = 0.08
    single_exon: bool = False
    n_core: int = -1       # genes in every genome; -1: each misses 5%
    per_genome: int = 0    # genes a genome holds on average (with n_core)


class GenomeDraw(NamedTuple):
    """One genome's records in file order (gene, then copy, then isoform)."""
    gene: np.ndarray      # int32 [n]
    iso: np.ndarray       # int32 [n]
    qlen: np.ndarray      # int64 [n]
    qs: np.ndarray        # int64 [n]
    qe: np.ndarray        # int64 [n]
    rev: np.ndarray       # uint8 [n]
    ctg: np.ndarray       # int32 [n]
    cs: np.ndarray        # int64 [n]
    ce: np.ndarray        # int64 [n]
    mlen: np.ndarray      # int64 [n]
    blen: np.ndarray      # int64 [n]
    ms: np.ndarray        # int64 [n]
    n_exon: np.ndarray    # int64 [n]
    exon_aa: np.ndarray   # int64 [sum(n_exon)], exons of record r in order
    intron: np.ndarray    # int64 [sum(n_exon)], -1 after a record's last exon


def shape_of(cfg: dict) -> Shape:
    return Shape(**cfg["draw"])


def _stream(seed: int, key: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(int(seed) % (1 << 64), spawn_key=(key,)))


def layout(shape: Shape):
    """The loci shared by every genome: contig and position of each gene."""
    rng = _stream(BASE_SEED, 0)
    return (rng.integers(0, shape.n_ctg, shape.n_gene),
            rng.integers(0, 50_000_000, shape.n_gene))


def genome_order(shape: Shape, seed: int) -> np.ndarray:
    """Which drawn genome file i holds, for this seed."""
    rng = np.random.default_rng(
        np.random.SeedSequence(int(seed) % (1 << 64)))
    return rng.permutation(shape.n_genome)


def present(shape: Shape, u: np.ndarray) -> np.ndarray:
    """The genes a genome holds, from one uniform draw a gene (`u`)."""
    if shape.n_core < 0:
        return np.flatnonzero(u >= MISSING_RATE)
    rate = (shape.per_genome - shape.n_core) / (shape.n_gene - shape.n_core)
    return np.flatnonzero((np.arange(shape.n_gene) < shape.n_core)
                          | (u < rate))


def _segments(counts: np.ndarray) -> np.ndarray:
    """Index within its segment of each element of segments of `counts`."""
    starts = np.cumsum(counts) - counts
    return np.arange(int(counts.sum())) - np.repeat(starts, counts)


def draw_genome(shape: Shape, seed: int, gi: int, lay=None,
                order=None) -> GenomeDraw:
    """The records of file `gi` under `seed` (`lay` and `order`, when
    given, are layout(shape) and genome_order(shape, seed))."""
    gene_ctg, gene_pos = layout(shape) if lay is None else lay
    src = (genome_order(shape, seed) if order is None else order)[gi]
    rng = _stream(BASE_SEED, int(src) + 1)
    genes = present(shape, rng.random(shape.n_gene))
    n_copy = 1 + (rng.random(len(genes)) < shape.paralog_rate)
    c_gene = np.repeat(genes, n_copy)
    c_copy = _segments(n_copy)
    n_iso = 1 + rng.integers(0, shape.n_iso, len(c_gene))
    gene = np.repeat(c_gene, n_iso).astype(np.int32)
    copy = np.repeat(c_copy, n_iso)
    iso = _segments(n_iso).astype(np.int32)
    n = len(gene)
    n_exon = (np.ones(n, np.int64) if shape.single_exon
              else rng.integers(2, 9, n))
    E = int(n_exon.sum())
    exon_aa = rng.integers(20, 200, E)
    last = np.cumsum(n_exon) - 1
    intron = rng.integers(80, 5000, E)
    intron[last] = -1
    rec = np.repeat(np.arange(n), n_exon)
    aa = np.bincount(rec, exon_aa, minlength=n).astype(np.int64)
    intr = np.bincount(rec, np.where(intron < 0, 0, intron),
                       minlength=n).astype(np.int64)
    qlen = aa + rng.integers(0, 30, n)
    qs = rng.integers(0, 10, n)
    qe = np.minimum(qs + aa, qlen)
    span = aa * 3 + intr
    cs = gene_pos[gene] + copy * PARALOG_GAP + rng.integers(0, 2000, n)
    rev = rng.integers(0, 2, n).astype(np.uint8)
    mlen = ((qe - qs) * (0.85 + 0.14 * rng.random(n))).astype(np.int64)
    blen = qe - qs + rng.integers(0, 10, n)
    ms = (mlen * 2 * (0.9 + 0.2 * rng.random(n))).astype(np.int64)
    return GenomeDraw(gene, iso, qlen, qs, qe, rev,
                      gene_ctg[gene].astype(np.int32), cs, cs + span, mlen,
                      blen, ms, n_exon, exon_aa, intron)


def paf_lines(g: GenomeDraw, gi: int) -> List[str]:
    """The records as PAF lines (query, target, CIGAR and the ms/fs/st
    tags that a miniprot record carries)."""
    tok = [("%dM%dN" % (a, b)) if b >= 0 else ("%dM" % a)
           for a, b in zip(g.exon_aa.tolist(), g.intron.tolist())]
    ends = np.cumsum(g.n_exon).tolist()
    cig, s = [], 0
    for e in ends:
        cig.append("".join(tok[s:e]))
        s = e
    sample, hap = gi // 2, gi % 2 + 1
    ctg = ["S%03d#%d#ctg%d" % (sample, hap, c) for c in range(
        int(g.ctg.max(initial=0)) + 1)]
    return ["GENE%05d:ISO%d\t%d\t%d\t%d\t%s\t%s\t%d\t%d\t%d\t%d\t%d\t60\t"
            "ms:i:%d\tfs:i:0\tst:i:0\tcg:Z:%s" % r for r in zip(
                g.gene.tolist(), g.iso.tolist(), g.qlen.tolist(),
                g.qs.tolist(), g.qe.tolist(),
                ["+-"[v] for v in g.rev.tolist()],
                [ctg[c] for c in g.ctg.tolist()], [CTG_LEN] * len(g.gene),
                g.cs.tolist(), g.ce.tolist(), g.mlen.tolist(),
                g.blen.tolist(), g.ms.tolist(), cig)]


def file_name(out_dir: str, gi: int) -> str:
    return os.path.join(out_dir, "synth%03d.paf.gz" % gi)


def write_genome(args) -> int:
    """Draw genome `gi` and write it; returns its record count."""
    shape, seed, gi, out_dir = args
    g = draw_genome(shape, seed, gi)
    with gzip.open(file_name(out_dir, gi), "wt", compresslevel=1) as fp:
        fp.write("\n".join(paf_lines(g, gi)) + "\n")
    return len(g.gene)


def write_corpus(shape: Shape, seed: int, out_dir: str,
                 workers: int = 1) -> List[str]:
    """Write one .paf.gz a genome under out_dir, the genomes split over
    `workers` forked processes (call it before anything starts threads)."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = [(shape, seed, gi, out_dir) for gi in range(shape.n_genome)]
    if workers > 1:
        import multiprocessing as mp
        with mp.get_context("fork").Pool(workers) as pool:
            list(pool.imap_unordered(write_genome, jobs))
    else:
        for j in jobs:
            write_genome(j)
    return [file_name(out_dir, gi) for gi in range(shape.n_genome)]
