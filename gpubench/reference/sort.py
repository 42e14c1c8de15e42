"""Hit sorting.

The reference buckets hits by contig id then LSD-radix-sorts each bucket by
cs or cm with stable tie order (hit.c:29-64). A stable lexicographic sort on
(cid, key) is the same permutation; NumPy lexsort provides it directly.
Every call sorts: nothing is kept from one call to the next.
"""
from __future__ import annotations

import numpy as np

from .data import Genome


def hit_sort_perm(cid: np.ndarray, key: np.ndarray) -> np.ndarray:
    """Stable (cid, key) sort permutation."""
    return np.lexsort((key, cid))


def hit_sort(g: Genome, by_cm: bool) -> None:
    """In-place sort of a genome's hits (reference pg_hit_sort, hit.c:29-64)."""
    h = g.hits
    if len(h):
        h.permute(hit_sort_perm(h.cid, h.cm if by_cm else h.cs))
