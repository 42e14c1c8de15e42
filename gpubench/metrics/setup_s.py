"""setup_s: seconds from the process's start to the first repetition of
the window: imports, the draw of the corpus, the port's parse, post,
phase 1 and the entry's own set-up, the cold call (kernel libraries
loaded, or built on a checkout's first run) and the warm-up."""


def read(run):
    return getattr(run, "setup_s", None)
