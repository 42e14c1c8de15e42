"""schedule_ms: the window's seconds x 1000 over the schedules it
completed (closed loop, each upload to synchronised pull)."""


def read(run):
    return 1e3 * run.window_s / len(run.walls) if run.walls else None
