"""``queue_wait_ms``: how long a task waited for a worker, in ms: the
mean over the window's task events of ``t0 - t_ready``, from the
runtime's own stamps (``t_ready``: the task became ready, its last input
published; ``t0``: a worker claimed it).  Host clock."""
from bench.harness.spans import stamps


def read(run):
    waits = [t0 - ready for _, ready, t0 in stamps(run, "t_ready", "t0")]
    return 1000.0 * sum(waits) / len(waits) if waits else None
