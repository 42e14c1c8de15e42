"""Exon-level CDS length (pg_cds_len, overlap.c:45-51), for every hit."""
from __future__ import annotations

import numpy as np

from .data import Genome


def cds_len_all(g: Genome) -> np.ndarray:
    """Vectorized CDS length for every hit."""
    lens = (g.exon_oe - g.exon_os).astype(np.int64)
    cum = np.concatenate(([0], np.cumsum(lens)))
    off = g.hits.off_exon.astype(np.int64)
    return (cum[off + g.hits.n_exon] - cum[off]).astype(np.int32)
