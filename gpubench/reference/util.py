"""Helpers of the frozen reference: the reference's uint32 hash, and a
log call that records nothing (the reference's messages are not compared)."""
from __future__ import annotations

import numpy as np


def log_msg(*args, **kw) -> None:
    return None


def hash_u32_np(keys: np.ndarray) -> np.ndarray:
    """Vectorized pg_hash_uint32 (pgpriv.h:88-97), uint32 wraparound."""
    k = keys.astype(np.uint32)
    with np.errstate(over="ignore"):
        k = (k + np.invert(k << np.uint32(15))).astype(np.uint32)
        k ^= k >> np.uint32(10)
        k = (k + (k << np.uint32(3))).astype(np.uint32)
        k ^= k >> np.uint32(6)
        k = (k + np.invert(k << np.uint32(11))).astype(np.uint32)
        k ^= k >> np.uint32(16)
    return k
