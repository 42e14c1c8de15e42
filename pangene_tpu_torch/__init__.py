"""pangene_tpu_torch: the PyTorch / CUDA port of pangene_tpu.

Builds the same byte-identical pangene graph from miniprot PAFs. Under the
card engines ("sharded", the default, and "device") the overlap sweeps, and
with "sharded" the pruning rounds, run on an NVIDIA GPU through a
hand-written CUDA kernel (csrc/shadow_sweep.cu) and torch ops, or through
their plain PyTorch versions when the caller asks for the CPU. Parsing,
filters, branch marking and GFA emission run on the host, in the native C
runtime (native/pgsweep.c, ops/sweep_native.py) where the JAX package uses
it, else in NumPy. The host engines ("host", "host-vec", "host-ref") run
everything on the host.
"""
from .options import PG_VERSION, PgOpt  # noqa: F401
