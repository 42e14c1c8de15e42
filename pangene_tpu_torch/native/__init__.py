"""Native (C) host code, compiled on first use into build/pangene_tpu_torch/:
the zlib PAF parser with the bit-exact long-double score adjustment
(pgparse.c, native/loader.py) and the host runtime of sweeps, walks, merges
and branch marking (pgsweep.c, ops/sweep_native.py)."""
