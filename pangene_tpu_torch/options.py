"""Option registry for the PyTorch pangene engine.

Mirrors the reference option struct and defaults 1:1 so that CLI-compatible
parity runs are possible (reference: pangene.h:23-42, option.c:6-26).
Behavior flags mirror pangene.h:8-17.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Set

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

PG_VERSION = "0.1.0-torch"
PG_REF_VERSION = "1.1-r231"  # reference version this engine is parity-checked against

# engines that run every stage on the host and touch no torch device:
# "host" = the native C runtime (ops/sweep_native.py; the NumPy branches when
# no compiler is found), "host-vec" = NumPy, "host-ref" = the scalar oracle
HOST_ENGINES = ("host", "host-vec", "host-ref")
# engines that run the sweeps (and with "sharded" the rounds) on opt.device
DEVICE_ENGINES = ("sharded", "device")


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

    # --- port-specific knobs (no reference equivalent) ---
    # torch device of the sweeps and the device loop: "cuda" (the default;
    # raises when no CUDA device exists) or "cpu" (the kernels' plain
    # versions)
    device: str = "cuda"
    # "sharded" (the default; the JAX package's name, here on one device):
    # phases 2+3 as the device-resident loop (parallel/device_loop.py), and
    # where the loop is off or cannot take the graph, each round as one
    # device step over all genomes (parallel/stacked.py); "device": phase
    # 1-3 rounds on the host with one sweep launch per genome (the JAX
    # package's --engine jax); HOST_ENGINES: everything on the host, as the
    # JAX package's engines of the same names, and opt.device is not read
    engine: str = "sharded"
    # devices that shard the genome axis under "sharded": 0 = every rank of
    # the launch (one device without one); N > 1 without a launch: the CLI
    # starts N ranks (parallel/mesh.py). The other engines do not read it
    n_devices: int = 0

    @property
    def check_strand(self) -> bool:
        return bool(self.flag & PG_F_CHECK_STRAND)

    @property
    def frag_mode(self) -> bool:
        return bool(self.flag & PG_F_FRAG_MODE)

    @property
    def use_ori_for_branch(self) -> bool:
        return bool(self.flag & PG_F_ORI_FOR_BRANCH)
