"""branch_wide_groups.loop: branch groups a schedule of more than the
branch kernels' block path holds (their wide path: every pair of a group of
any size), summed over its branch launches (schedule_device's
stats["branch_wide_groups"], counted on the device, read once after the
schedule), the window's mean. Nothing to read where the program has no
such count."""


def read(run):
    v = [s["branch_wide_groups"] for s in run.stats
         if "branch_wide_groups" in s]
    return sum(v) / len(v) if v else None
