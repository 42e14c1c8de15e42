"""The reference's answers for a configuration and a seed."""
from __future__ import annotations

import numpy as np

from ..inputs import synth
from . import build, compare, ingest
from .options import PgOpt


def options(cfg: dict, ftype=np.float64) -> PgOpt:
    return PgOpt(ftype=ftype, **cfg.get("options", {}))


def loop(cfg: dict, seed: int, ftype=np.float64) -> dict:
    """The state the pruning schedule must hand back (compare.loop_answer)
    for the configuration's corpus drawn from `seed`."""
    opt = options(cfg, ftype)
    d = ingest.read_all(opt, synth.shape_of(cfg), seed)
    q, entry = build.phase1(opt, d)
    build.rounds(opt, q)
    return compare.loop_answer(q, entry)

