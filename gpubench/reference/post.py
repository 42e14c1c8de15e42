"""Post-ingest cross-genome processing (pg_post_process, graph.c:7-32): a
frozen NumPy copy of the port's host path, the single-device loops."""
from __future__ import annotations

from .data import DataSet
from .options import PG_F_NO_JOINT_PSEUDO, PgOpt
from . import pseudo as pseudo_ops
from . import sweep_vec


def post_process(opt: PgOpt, d: DataSet) -> None:
    pseudo_ops.cap_score_dom(d, None)
    pseudo_ops.flag_representative(d, None)
    if not (opt.flag & PG_F_NO_JOINT_PSEUDO):
        pseudo_ops.flag_pseudo_joint(opt, d, None)
    for g in d.genomes:
        sweep_vec.shadow(opt, d, g, cal_dom_sc=False)
