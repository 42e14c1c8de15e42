"""transfer_ms.loop: milliseconds a schedule of the upload of the packed
blocks and of the pull of its outputs, each ended by a synchronise, by the
benchmark's spans; the window's mean."""


def read(run):
    return run.per_rep_ms("upload", "pull")
