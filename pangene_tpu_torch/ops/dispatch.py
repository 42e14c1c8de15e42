"""Engine dispatch for the per-genome sweep kernels.

opt.engine == "host":     native C sweeps (ops/sweep_native.py) when a
                          compiler is available, else the vectorized NumPy
                          path (ops/sweep_vec.py). Identical results.
opt.engine == "host-vec": force the vectorized NumPy path.
opt.engine == "host-ref": scalar oracle (ops/sweep.py, tests).
opt.engine == "sharded":  as "host": the single-genome sweeps run in C. The
                          card holds the batched [G, H] sweeps of the
                          device loop and of the per-round step
                          (parallel/device_loop.py, parallel/stacked.py).
opt.engine == "device":   the device engine (ops/device_engine.py) on the
                          torch device in opt.device: the CUDA kernel on
                          "cuda", its plain version on "cpu" (the JAX
                          package's "jax" engine).

This is the JAX package's routing (pangene_tpu/ops/dispatch.py).
"""
from __future__ import annotations

from ..core.data import DataSet, Genome
from ..options import PgOpt
from . import sweep as host_sweep


def _host_native_ok() -> bool:
    from . import sweep_native
    return sweep_native.available()


def shadow(opt: PgOpt, d: DataSet, g: Genome, cal_dom_sc: bool) -> int:
    if opt.engine == "device":
        from . import device_engine
        return device_engine.shadow(opt, d, g, cal_dom_sc)
    if opt.engine == "host-ref":  # scalar oracle (tests)
        return host_sweep.shadow(opt, d, g, cal_dom_sc)
    # "sharded" runs single-genome (latency-bound) sweeps on the host; the
    # card holds the batched [G, H] sweep, one launch per round
    if opt.engine in ("host", "sharded") and _host_native_ok():
        from . import sweep_native
        return sweep_native.shadow(opt, d, g, cal_dom_sc)
    from . import sweep_vec
    return sweep_vec.shadow(opt, d, g, cal_dom_sc)


def flt_ov_isoform(opt: PgOpt, d: DataSet, g: Genome) -> int:
    if opt.engine == "device":
        from . import device_engine
        return device_engine.flt_ov_isoform(opt, d, g)
    if opt.engine == "host-ref":
        return host_sweep.flt_ov_isoform(opt, d, g)
    if opt.engine in ("host", "sharded") and _host_native_ok():
        from . import sweep_native
        return sweep_native.flt_ov_isoform(opt, d, g)
    from . import sweep_vec
    return sweep_vec.flt_ov_isoform(opt, d, g)
