"""Pangene graph state: selected gene segments + oriented adjacency arcs.

SoA mirror of the reference graph structs (pg_seg_t / pg_arc_t / pg_graph_t,
pangene.h:99-124). Vertices are oriented segments v = sid*2 | strand; every
arc v->w is stored together with its complement w^1 -> v^1.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .data import DataSet

ARC_COLS = ("x", "n_genome", "tot_cnt", "avg_dist", "s1", "s2", "weak_br")


@dataclasses.dataclass
class ArcTable:
    x: np.ndarray          # uint64 v<<32|w
    n_genome: np.ndarray   # int32
    tot_cnt: np.ndarray    # int32
    avg_dist: np.ndarray   # int32
    s1: np.ndarray         # int32
    s2: np.ndarray         # int32
    weak_br: np.ndarray    # uint8

    @classmethod
    def empty(cls, n: int = 0) -> "ArcTable":
        return cls(np.zeros(n, np.uint64), np.zeros(n, np.int32),
                   np.zeros(n, np.int32), np.zeros(n, np.int32),
                   np.zeros(n, np.int32), np.zeros(n, np.int32),
                   np.zeros(n, np.uint8))

    def __len__(self) -> int:
        return int(self.x.shape[0])

    def take(self, idx: np.ndarray) -> "ArcTable":
        return ArcTable(self.x[idx], self.n_genome[idx], self.tot_cnt[idx],
                        self.avg_dist[idx], self.s1[idx], self.s2[idx],
                        self.weak_br[idx])


@dataclasses.dataclass
class Graph:
    d: DataSet
    seg_gid: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    seg_n_dom: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    seg_n_sub: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    seg_n_genome: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    seg_tot_cnt: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    seg_del: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.uint8))
    # n_dist_loci[:, 0] / [:, 1] per orientation (pg_seg_t::n_dist_loci)
    seg_n_dist_loci: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 2), np.int32))
    g2s: Optional[np.ndarray] = None  # int32 [n_gene], -1 if not a vertex
    arcs: ArcTable = dataclasses.field(default_factory=ArcTable.empty)
    # CSR arc index: idx_start[v], idx_cnt[v] over x-sorted arcs (graph.c:202-217)
    idx_start: Optional[np.ndarray] = None
    idx_cnt: Optional[np.ndarray] = None

    @property
    def n_seg(self) -> int:
        return int(self.seg_gid.shape[0])

    @property
    def n_arc(self) -> int:
        return len(self.arcs)

    def gen_g2s(self) -> None:
        """gene id -> segment id map (reference pg_gen_g2s, graph.c:49-59)."""
        g2s = np.full(self.d.n_gene, -1, np.int32)
        g2s[self.seg_gid] = np.arange(self.n_seg, dtype=np.int32)
        self.g2s = g2s

    def flag_vtx(self) -> None:
        """Set hit.vtx = gene is currently a vertex (pg_graph_flag_vtx, graph.c:61-69)."""
        prot_gid = np.asarray(self.d.prot_gid, np.int32)
        for g in self.d.genomes:
            h = g.hits
            # in place, as the port does
            np.greater_equal(self.g2s[prot_gid[h.pid]], 0, out=h.vtx.view(bool))

    def arc_index(self) -> None:
        """CSR index over x-sorted arcs (pg_arc_index_core, graph.c:202-211)."""
        nv = self.n_seg * 2
        start = np.zeros(nv, np.int64)
        cnt = np.zeros(nv, np.int64)
        if self.n_arc:
            src = (self.arcs.x >> np.uint64(32)).astype(np.int64)
            uniq, first, c = np.unique(src, return_index=True, return_counts=True)
            start[uniq] = first
            cnt[uniq] = c
        self.idx_start, self.idx_cnt = start, cnt
