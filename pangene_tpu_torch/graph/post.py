"""Post-ingest cross-genome processing (reference pg_post_process, graph.c:7-32)."""
from __future__ import annotations

import sys

import numpy as np

from ..core.data import DataSet
from ..options import PG_F_NO_JOINT_PSEUDO, PgOpt
from ..ops import pseudo as pseudo_ops
from ..ops import dispatch as sweep
from ..util import log_msg, timestamp


def n_genome_shards(opt: PgOpt) -> int:
    """The number of devices that shard the genomes: the world of the
    genome mesh (parallel/mesh.py)."""
    from ..parallel.mesh import make_mesh
    return make_mesh(opt.n_devices, opt.device).world


def post_process(opt: PgOpt, d: DataSet) -> None:
    log_msg("pg_post_process", "%d genes and %d proteins", d.n_gene, d.n_prot)
    mx = z = acc = None
    if opt.engine == "sharded" and d.n_genome and n_genome_shards(opt) > 1:
        # the protein-keyed reductions run on the devices only when more
        # than one shards the genomes (sums across devices); on one device
        # the host loops below win, as in the JAX package
        from ..parallel.stacked import post_reductions_sharded
        mx, z, acc = post_reductions_sharded(opt, d)
    pseudo_ops.cap_score_dom(d, mx)
    pseudo_ops.flag_representative(d, z)
    if not (opt.flag & PG_F_NO_JOINT_PSEUDO):
        n = pseudo_ops.flag_pseudo_joint(opt, d, acc)
        log_msg("pg_post_process", "%d pseudogene hits identified jointly", n)
    for j, g in enumerate(d.genomes):
        tot = int((g.hits.flt == 0).sum())
        n_shadow = sweep.shadow(opt, d, g, cal_dom_sc=False)
        # this log line is unconditional in the reference (graph.c:26-27)
        sys.stderr.write(
            "[M::pg_post_process::%s] genome[%d]: %s; %d hits remain, of "
            "which %d are shadowed\n" % (timestamp(), j,
                                         g.label or "?", tot, n_shadow))
    n_pref = int(np.asarray(d.gene_preferred).sum())
    sys.stderr.write("[M::pg_post_process] there are %d preferred genes\n"
                     % n_pref)
