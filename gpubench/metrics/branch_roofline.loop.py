"""branch_roofline.loop: percent of its roofline the branch block reaches:
the least bytes of a schedule's branch launches (gpubench/roofline.py
branch_bytes, from the program's counts stats["branch_valid_arcs"] and
stats["branch_branching_arcs"], the window's mean) at the device's peak
bandwidth, over the branch kernels' device time a traced schedule (the
device_ops of the trace of the device alone whose names hold
branch_kernel, over trace["reps"]). Nothing to read where the program
reports no such counts, or where the kernel is not among the trace's
heaviest operations."""
from gpubench import roofline


def read(run):
    t = run.trace
    v = [(s["branch_valid_arcs"], s["branch_branching_arcs"])
         for s in run.stats if "branch_valid_arcs" in s]
    if not t or not t.get("reps") or not v:
        return None
    sec = sum(s for name, s in t.get("device_ops", ())
              if "branch_kernel" in name)
    if sec <= 0:
        return None
    nbytes = sum(roofline.branch_bytes(a, b) for a, b in v) / len(v)
    return 100.0 * nbytes / roofline.HBM_BYTES_PER_S / (sec / t["reps"])
