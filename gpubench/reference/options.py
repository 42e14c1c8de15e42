"""Option registry of the frozen reference (reference option.c:6-26).

Mirrors the reference option struct and defaults 1:1 so that CLI-compatible
parity runs are possible (reference: pangene.h:23-42, option.c:6-26).
Behavior flags mirror pangene.h:8-17.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Set

import numpy as np

# Behavior flags (reference: pangene.h:8-17)
PG_F_WRITE_BED_RAW = 0x1
PG_F_WRITE_BED_WALK = 0x2
PG_F_WRITE_BED_FLAG = 0x4
PG_F_WRITE_NO_WALK = 0x8
PG_F_WRITE_VTX_SEL = 0x10
PG_F_FRAG_MODE = 0x20
PG_F_NO_JOINT_PSEUDO = 0x40
PG_F_ORI_FOR_BRANCH = 0x80
PG_F_CHECK_STRAND = 0x100
PG_F_DROP_SGL_EXON = 0x200

@dataclasses.dataclass
class PgOpt:
    """All tunables of graph construction (defaults: reference option.c:6-26)."""

    flag: int = 0
    gene_delim: str = ":"
    min_prot_iden: float = 0.5      # -e: drop alignment if identity below
    min_prot_ratio: float = 0.5     # -l: drop if aligned fraction below
    score_adj_coef: float = 2.0     # -m
    min_ov_ratio: float = 0.5       # -f
    min_vertex_ratio: float = 0.05  # -p
    max_avg_occ: int = 10           # -c
    max_degree: int = 15            # -g
    max_dist_loci: int = 3          # -r
    n_branch_flt: int = 15          # -T
    min_arc_cnt: int = 1            # -a
    local_dist: int = 2_000_000     # -D
    local_count: int = 10           # -C
    branch_diff: float = 0.02       # -b
    branch_diff_dist: float = 0.05  # -y
    branch_diff_cut: float = 0.5    # -B
    # -X / -I / -P name lists (sets of strings; None = unset)
    excl: Optional[Set[str]] = None
    incl: Optional[Set[str]] = None
    preferred: Optional[Set[str]] = None

    # the floating type of every rounded ratio and average (the branch
    # deficit, the arc averages); float32 only in the control, which must
    # fail the comparison
    ftype: type = np.float64

    @property
    def check_strand(self) -> bool:
        return bool(self.flag & PG_F_CHECK_STRAND)

    @property
    def frag_mode(self) -> bool:
        return bool(self.flag & PG_F_FRAG_MODE)

    @property
    def use_ori_for_branch(self) -> bool:
        return bool(self.flag & PG_F_ORI_FOR_BRANCH)
