"""pack_s: seconds of parallel.device_loop.pack_host in set-up (the kept
rows of phase 1 packed into pinned blocks), by the benchmark's span."""


def read(run):
    return run.total("pack")
