"""The reference's ingest: the drawn records (inputs/synth.py) straight into
the data model, in NumPy, with the reference parser's semantics
(read.c:107-262): gene and protein ids in first-encounter order over the
files in order; a record dropped by the coverage (read.c:182) or identity
(read.c:209) gate still registers its names and still bumps its protein's
per-file rank; a protein's length is its last record's; the adjusted score
is score_ori * expl(-m * (div + uncov)) + .499 in long double (read.c:216);
exons are reversed on the minus strand, and cm is the CDS midpoint
(hit.c:14-27). The text of the files is not read: the records are those
the writer formatted."""
from __future__ import annotations

import numpy as np

from ..inputs import synth
from .data import DataSet, Genome, HitTable, IntVec
from .options import PgOpt


def _first_order(keys: np.ndarray):
    """Ids in first-encounter order: (id of each element, the distinct
    keys in id order)."""
    uniq, first, inv = np.unique(keys, return_index=True,
                                 return_inverse=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    return rank[inv], uniq[np.argsort(first, kind="stable")]


def _occurrence(keys: np.ndarray) -> np.ndarray:
    """How many earlier elements have the same key."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    start = np.concatenate(([True], ks[1:] != ks[:-1]))
    first = np.maximum.accumulate(np.where(start, np.arange(len(ks)), 0))
    out = np.empty(len(keys), np.int64)
    out[order] = np.arange(len(ks)) - first
    return out


def score_adj(score_ori, coef, qs, qe, qlen, mlen, blen) -> np.ndarray:
    div = 1.0 - mlen.astype(np.float64) / blen
    uncov = 1.0 - (qe - qs).astype(np.float64) / qlen
    x = (-coef * (div + uncov)).astype(np.longdouble)
    v = score_ori.astype(np.longdouble) * np.exp(x) + np.longdouble(0.499)
    return v.astype(np.int64)


def exons(g: synth.GenomeDraw):
    """Per exon (os, oe) relative to cs, in ascending contig order, and the
    CDS midpoint offset of each record (the C scan of hit.c:14-27)."""
    rec = np.repeat(np.arange(len(g.gene)), g.n_exon)
    length = 3 * g.exon_aa
    step = length + np.where(g.intron < 0, 0, g.intron)
    start = np.cumsum(step) - step
    rstart = np.cumsum(g.n_exon) - g.n_exon
    os_f = start - start[rstart][rec]
    oe_f = os_f + length
    x = (g.ce - g.cs)[rec]
    rv = g.rev[rec].astype(bool)
    # on the minus strand exon k of n is n-1-k of the forward list
    k = np.arange(len(rec)) - rstart[rec]
    src = rstart[rec] + (g.n_exon[rec] - 1 - k)
    os_ = np.where(rv, x - oe_f[src], os_f)
    oe_ = np.where(rv, x - os_f[src], oe_f)
    # midpoint: half of the CDS length, in the exon holding it
    lens = oe_ - os_
    cum = np.cumsum(lens) - np.repeat(np.cumsum(lens)[rstart] - lens[rstart],
                                      g.n_exon)
    tot = np.bincount(rec, lens, minlength=len(g.gene)).astype(np.int64)
    half = tot >> 1
    holds = (cum - lens <= half[rec]) & (half[rec] < cum)
    idx = np.flatnonzero(holds)
    first = np.unique(rec[idx], return_index=True)[1]
    e = idx[first]
    cm_off = os_[e] + half - (cum[e] - lens[e])
    return os_.astype(np.int32), oe_.astype(np.int32), cm_off


def read_all(opt: PgOpt, shape: synth.Shape, seed: int) -> DataSet:
    lay = synth.layout(shape)
    order = synth.genome_order(shape, seed)
    draws = [synth.draw_genome(shape, seed, gi, lay, order)
             for gi in range(shape.n_genome)]
    n_iso = shape.n_iso
    pkey = np.concatenate([dr.gene.astype(np.int64) * n_iso + dr.iso
                           for dr in draws])
    gkey = pkey // n_iso
    pid_all, prots = _first_order(pkey)
    gid_all, genes = _first_order(gkey)
    d = DataSet.new()
    d.gene_name = ["GENE%05d" % gk for gk in genes.tolist()]
    d.gene_id = {n: i for i, n in enumerate(d.gene_name)}
    ng, npr = len(genes), len(prots)
    prot_gid = np.empty(npr, np.int32)
    prot_gid[pid_all] = gid_all
    qlen_all = np.concatenate([dr.qlen for dr in draws])
    prot_len = np.zeros(npr, np.int64)
    order = np.argsort(pid_all, kind="stable")   # the last record wins
    ps = pid_all[order]
    last = order[np.flatnonzero(np.concatenate((ps[1:] != ps[:-1], [True])))]
    prot_len[pid_all[last]] = qlen_all[last]
    gene_len = np.zeros(ng, np.int64)
    np.maximum.at(gene_len, gid_all, qlen_all)
    d.prot_name = ["GENE%05d:ISO%d" % (p // n_iso, p % n_iso)
                   for p in prots.tolist()]
    d.prot_id = {n: i for i, n in enumerate(d.prot_name)}
    d.gene_len = IntVec.from_array(gene_len)
    d.gene_preferred = IntVec.from_array(np.zeros(ng, np.uint8))
    d.gene_included = IntVec.from_array(np.zeros(ng, np.uint8))
    d.gene_rep_pid = IntVec.from_array(np.full(ng, -1, np.int64))
    d.prot_len = IntVec.from_array(prot_len)
    d.prot_gid = IntVec.from_array(prot_gid)
    for name in ("prot_rep", "prot_n", "prot_avg_score_adj",
                 "prot_max_score_ori"):
        dt = np.uint8 if name == "prot_rep" else np.int64
        setattr(d, name, IntVec.from_array(np.zeros(npr, dt)))
    off = 0
    for gi, dr in enumerate(draws):
        n = len(dr.gene)
        pid = pid_all[off:off + n]
        off += n
        rank = _occurrence(pid)
        cover = (dr.qe - dr.qs) >= dr.qlen * opt.min_prot_ratio
        keep = cover & (dr.mlen >= dr.blen * opt.min_prot_iden)
        os_, oe_, cm_off = exons(dr)
        ekeep = np.repeat(keep, dr.n_exon)
        kk = np.flatnonzero(keep)
        ne = dr.n_exon[kk]
        # contig ids in first-encounter order of the records that pass the
        # coverage gate: the identity gate comes after the registration
        cid_c, ctgs = _first_order(dr.ctg[cover].astype(np.int64))
        cid = np.empty(n, np.int64)
        cid[cover] = cid_c
        cid = cid[kk]
        h = HitTable.empty(len(kk))
        h.set("pid", pid[kk])
        for name, col in (("qs", dr.qs), ("qe", dr.qe), ("mlen", dr.mlen),
                          ("blen", dr.blen), ("cs", dr.cs), ("ce", dr.ce)):
            h.set(name, col[kk])
        h.set("rank", rank[kk])
        h.set("cid", cid)
        h.set("score_ori", dr.ms[kk])
        h.set("score_adj", score_adj(dr.ms[kk], opt.score_adj_coef,
                                     dr.qs[kk], dr.qe[kk], dr.qlen[kk],
                                     dr.mlen[kk], dr.blen[kk]))
        h.set("n_exon", ne)
        h.set("off_exon", np.cumsum(ne) - ne)
        h.set("rev", dr.rev[kk])
        h.set("cm", dr.cs[kk] + cm_off[kk])
        h.set("pid_dom", np.full(len(kk), -1, np.int32))
        h.set("pid_dom0", np.full(len(kk), -1, np.int32))
        sample, hap = gi // 2, gi % 2 + 1
        names = ["S%03d#%d#ctg%d" % (sample, hap, c) for c in ctgs.tolist()]
        for nm in names:
            d.ctg_id.setdefault(nm, len(d.ctg_id))
        g = Genome("synth%03d" % gi, names,
                   np.full(len(names), synth.CTG_LEN, np.int64), h,
                   os_[ekeep], oe_[ekeep])
        d.genomes.append(g)
    return d

