"""``setup_s``: from the start of ``bench/run.py`` to the start of the
window: imports, the cell's files, the kernel library (built on a
checkout's first run) and one warm-up pipeline at the cell's shapes, in
a runtime of its own.  Host clock."""


def read(run):
    return run.setup_s
