"""driver_ms.loop: milliseconds a schedule of the host driver's own work
(schedule_device's stats["driver_ms"]: the span of the whole schedule less
the host's waits on the device, so Python, dispatch, launches and event
records), the window's mean. Nothing to read where the program has no such
span."""


def read(run):
    v = [s["driver_ms"] for s in run.stats if "driver_ms" in s]
    return sum(v) / len(v) if v else None
