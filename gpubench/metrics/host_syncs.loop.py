"""host_syncs.loop: values the schedule's host driver reads back a
schedule (schedule_device's stats["host_syncs"]), the window's mean."""


def read(run):
    v = [s["host_syncs"] for s in run.stats if "host_syncs" in s]
    return sum(v) / len(v) if v else None
