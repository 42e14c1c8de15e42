"""Structure-of-arrays data model (a frozen copy of the port's).

The reference keeps per-hit records in an array-of-structs (pg_hit_t,
pangene.h:61-72) with a per-genome flat exon pool (pg_exon_t, pangene.h:44-46).
Here every column is a NumPy array so that per-genome tables can be padded,
uploaded to the device column by column.

Hit columns (reference field in parens):
    pid        int32  protein id            (pg_hit_t::pid)
    qs, qe     int32  query (protein) span  (::qs, ::qe)
    cid        int32  contig id in genome   (::cid)
    mlen,blen  int32  match/block length    (::mlen, ::blen)
    lof        int32  frameshift/stop count (::lof)
    rank       int32  per-file input order of the protein (::rank)
    score_ori  int32  ms:i score            (::score_ori)
    score_adj  int32  adjusted score        (::score_adj, read.c:213-216)
    score_dom  int32  blended dominator score (::score_dom, overlap.c:166-171)
    n_exon     int32  number of exons       (::n_exon)
    off_exon   int32  offset into exon pool (::off_exon)
    pid_dom    int32  current dominator pid, -1 if none (::pid_dom)
    pid_dom0   int32  read-time dominator pid (::pid_dom0, read.c:249-252)
    rev        uint8  strand                (bitfield ::rev)
    flt        uint8  filtered              (::flt)
    flt_iso_sub_self  uint8                 (::flt_iso_sub_self)
    flt_iso_ov uint8                        (::flt_iso_ov)
    flt_chain  uint8                        (::flt_chain)
    pseudo     uint8                        (::pseudo)
    vtx        uint8                        (::vtx)
    shadow     uint8                        (::shadow)
    rep        uint8                        (::rep)
    weak_br    uint8  0/1/2                 (2-bit field ::weak_br)
    cs, cm, ce int64  contig coordinates    (::cs, ::cm, ::ce)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

HIT_I32_COLS = (
    "pid", "qs", "qe", "cid", "mlen", "blen", "lof", "rank",
    "score_ori", "score_adj", "score_dom", "n_exon", "off_exon",
    "pid_dom", "pid_dom0",
)
HIT_U8_COLS = (
    "rev", "flt", "flt_iso_sub_self", "flt_iso_ov", "flt_chain",
    "pseudo", "vtx", "shadow", "rep", "weak_br",
)
HIT_I64_COLS = ("cs", "cm", "ce")
HIT_COLS = HIT_I32_COLS + HIT_U8_COLS + HIT_I64_COLS


@dataclasses.dataclass
class HitTable:
    """Column store of one genome's hits; always kept cs-sorted between stages
    (matching the reference invariant after read.c:247)."""

    cols: Dict[str, np.ndarray]

    @classmethod
    def empty(cls, n: int = 0) -> "HitTable":
        cols: Dict[str, np.ndarray] = {}
        for c in HIT_I32_COLS:
            cols[c] = np.zeros(n, np.int32)
        for c in HIT_U8_COLS:
            cols[c] = np.zeros(n, np.uint8)
        for c in HIT_I64_COLS:
            cols[c] = np.zeros(n, np.int64)
        return cls(cols)

    def __len__(self) -> int:
        return int(self.cols["pid"].shape[0])

    def __getattr__(self, name: str):
        try:
            return self.cols[name]
        except KeyError:
            raise AttributeError(name)

    def set(self, name: str, value: np.ndarray) -> None:
        assert name in self.cols and value.shape == self.cols[name].shape
        self.cols[name] = value.astype(self.cols[name].dtype, copy=False)

    def permute(self, perm: np.ndarray) -> None:
        for k in self.cols:
            self.cols[k] = self.cols[k][perm]

    def copy(self) -> "HitTable":
        return HitTable({k: v.copy() for k, v in self.cols.items()})


@dataclasses.dataclass
class Genome:
    """One input PAF file = one genome (reference pg_genome_t, pangene.h:79-87)."""

    label: Optional[str]
    ctg_names: List[str]
    ctg_len: np.ndarray          # int64 [n_ctg]
    hits: HitTable
    exon_os: np.ndarray          # int32 [n_exon_pool]
    exon_oe: np.ndarray          # int32 [n_exon_pool]

    @property
    def n_ctg(self) -> int:
        return len(self.ctg_names)

    @property
    def n_hit(self) -> int:
        return len(self.hits)


class IntVec:
    """Growable int vector backed by a numpy array (amortized doubling).

    Drop-in for the list-of-int global tables: list-style append / len /
    scalar get-set, plus zero-copy `np.asarray(vec)` via __array__ when
    dtypes match."""

    __slots__ = ("_a", "_n")

    def __init__(self, dtype=np.int64):
        self._a = np.zeros(16, dtype)
        self._n = 0

    @classmethod
    def from_array(cls, a) -> "IntVec":
        v = cls(np.asarray(a).dtype)
        v._a = np.array(a)
        v._n = len(v._a)
        return v

    def append(self, x) -> None:
        if self._n == len(self._a):
            self._a = np.concatenate(
                [self._a, np.zeros(len(self._a), self._a.dtype)])
        self._a[self._n] = x
        self._n += 1

    def extend(self, xs) -> None:
        """Bulk append (vector write instead of per-item)."""
        xs = np.asarray(xs, self._a.dtype)
        need = self._n + len(xs)
        if need > len(self._a):
            grow = max(need, 2 * len(self._a))
            a = np.zeros(grow, self._a.dtype)
            a[:self._n] = self._a[:self._n]
            self._a = a
        self._a[self._n:need] = xs
        self._n = need

    def extend_zeros(self, k: int, fill=0) -> None:
        if k <= 0:
            return
        self.extend(np.full(k, fill, self._a.dtype))

    def view(self) -> np.ndarray:
        """Writable zero-copy window of the live prefix."""
        return self._a[:self._n]

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        return self._a[:self._n][i]

    def __setitem__(self, i, v) -> None:
        self._a[:self._n][i] = v

    def __iter__(self):
        return iter(self._a[:self._n])

    def __array__(self, dtype=None, copy=None):
        v = self._a[:self._n]
        if dtype is not None and np.dtype(dtype) != v.dtype:
            return v.astype(dtype)
        if copy:
            return v.copy()
        return v

    def tolist(self):
        return self._a[:self._n].tolist()


@dataclasses.dataclass
class DataSet:
    """Global tables shared across genomes (reference pg_data_t, pangene.h:89-97).

    Gene/protein dictionaries assign ids in first-encounter order across all
    input files (read.c:151-170); the tables are small and replicated per
    host. Int tables are IntVec (growable numpy) during ingest; stages that
    rebuild one wholesale (ops/pseudo.py, io/checkpoint.py) may leave a
    plain ndarray — all consumers go through np.asarray / scalar indexing,
    which both types serve. After ingest no table grows.
    """

    gene_id: Dict[str, int]
    prot_id: Dict[str, int]
    ctg_id: Dict[str, int]      # global contig-name intern (d_ctg)
    gene_name: List[str]
    gene_len: IntVec            # max protein length of the gene
    gene_preferred: IntVec
    gene_included: IntVec
    gene_rep_pid: IntVec
    prot_name: List[str]
    prot_len: IntVec            # NB: last-parsed record wins (read.c:168,175)
    prot_gid: IntVec
    prot_rep: IntVec
    prot_n: IntVec
    prot_avg_score_adj: IntVec
    prot_max_score_ori: IntVec
    genomes: List[Genome]

    @classmethod
    def new(cls) -> "DataSet":
        return cls({}, {}, {}, [],
                   IntVec(np.int64), IntVec(np.uint8), IntVec(np.uint8),
                   IntVec(np.int64),
                   [], IntVec(np.int64), IntVec(np.int32), IntVec(np.uint8),
                   IntVec(np.int64), IntVec(np.int64), IntVec(np.int64),
                   [])

    @property
    def n_gene(self) -> int:
        return len(self.gene_name)

    @property
    def n_prot(self) -> int:
        return len(self.prot_name)

    @property
    def n_genome(self) -> int:
        return len(self.genomes)

    def add_gene(self, name: str) -> int:
        gid = self.gene_id.get(name, -1)
        if gid < 0:
            gid = len(self.gene_name)
            self.gene_id[name] = gid
            self.gene_name.append(name)
            self.gene_len.append(0)
            self.gene_preferred.append(0)
            self.gene_included.append(0)
            self.gene_rep_pid.append(-1)
        return gid

    def add_prot(self, name: str, gid: int) -> int:
        pid = self.prot_id.get(name, -1)
        if pid < 0:
            pid = len(self.prot_name)
            self.prot_id[name] = pid
            self.prot_name.append(name)
            self.prot_len.append(0)
            self.prot_gid.append(gid)
            self.prot_rep.append(0)
            self.prot_n.append(0)
            self.prot_avg_score_adj.append(0)
            self.prot_max_score_ori.append(0)
        return pid
