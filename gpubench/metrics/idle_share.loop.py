"""idle_share.loop: percent of a schedule's wall in which no kernel, copy or
memset ran on the device: 1 - the device's busy time a traced schedule (the
trace of the device alone) over the mean wall of the window's schedules,
which ran with no profiler, so the profiler's host cost is in neither."""


def read(run):
    t = run.trace
    if not t or not t.get("reps") or not run.walls:
        return None
    wall = run.window_s / len(run.walls)
    return 100.0 * (1.0 - t["busy_s"] / t["reps"] / wall)
