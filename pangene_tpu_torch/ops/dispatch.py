"""Engine dispatch for the per-genome sweep kernels.

opt.engine == "host":     native C sweeps (ops/sweep_native.py) when a
                          compiler is available, else the vectorized NumPy
                          path (ops/sweep_vec.py). Identical results.
opt.engine == "host-vec": force the vectorized NumPy path.
opt.engine == "host-ref": scalar oracle (ops/sweep.py, tests).
opt.engine == "sharded" / "device": the device engine (ops/device_engine.py)
                          on the torch device in opt.device: the CUDA
                          kernel on "cuda", its plain version on "cpu".

This differs from the JAX package on purpose: its "sharded" engine sends the
single-genome sweeps to the native C library, while here every sweep of a
card engine stays on the card's kernel. The host engines touch no torch
device.
"""
from __future__ import annotations

from ..core.data import DataSet, Genome
from ..options import HOST_ENGINES, PgOpt
from . import sweep as host_sweep


def _host_native_ok() -> bool:
    from . import sweep_native
    return sweep_native.available()


def shadow(opt: PgOpt, d: DataSet, g: Genome, cal_dom_sc: bool) -> int:
    if opt.engine not in HOST_ENGINES:
        from . import device_engine
        return device_engine.shadow(opt, d, g, cal_dom_sc)
    if opt.engine == "host-ref":  # scalar oracle (tests)
        return host_sweep.shadow(opt, d, g, cal_dom_sc)
    if opt.engine == "host" and _host_native_ok():
        from . import sweep_native
        return sweep_native.shadow(opt, d, g, cal_dom_sc)
    from . import sweep_vec
    return sweep_vec.shadow(opt, d, g, cal_dom_sc)


def flt_ov_isoform(opt: PgOpt, d: DataSet, g: Genome) -> int:
    if opt.engine not in HOST_ENGINES:
        from . import device_engine
        return device_engine.flt_ov_isoform(opt, d, g)
    if opt.engine == "host-ref":
        return host_sweep.flt_ov_isoform(opt, d, g)
    if opt.engine == "host" and _host_native_ok():
        from . import sweep_native
        return sweep_native.flt_ov_isoform(opt, d, g)
    from . import sweep_vec
    return sweep_vec.flt_ov_isoform(opt, d, g)
