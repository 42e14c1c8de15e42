"""block_ms.loop: milliseconds a schedule in the loop's blocks (branch,
prop, occ, sweep, walk_merge), the sum of schedule_device's
stats["block_ms"]: CUDA events around each block, so the host's launches
and reads inside a block count as well as its kernels; the window's mean."""


def read(run):
    v = [sum(s["block_ms"].values()) for s in run.stats if "block_ms" in s]
    return sum(v) / len(v) if v else None
