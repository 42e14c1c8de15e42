"""parse_s: seconds of pipeline.read_all in set-up (the PAF parse in the
port's pool, the per-genome read postpass), by the benchmark's span."""


def read(run):
    return run.total("parse")
