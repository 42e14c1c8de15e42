"""sync_wait_ms.loop: milliseconds a schedule the host driver sat blocked
on the device (schedule_device's stats["sync_wait_ms"]: its spans around
the host reads and the closing synchronise), the window's mean. Nothing to
read where the program has no such span."""


def read(run):
    v = [s["sync_wait_ms"] for s in run.stats if "sync_wait_ms" in s]
    return sum(v) / len(v) if v else None
