"""kernel_ms.loop: device milliseconds a schedule in which a kernel ran
(the union of the kernel intervals of the traced schedules, from the trace
of the device alone, over their count); copies and memsets are not in it."""


def read(run):
    t = run.trace
    if not t or not t.get("kernel_s"):
        return None
    return 1e3 * t["kernel_s"] / t["reps"]
