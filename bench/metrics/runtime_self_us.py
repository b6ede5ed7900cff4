"""``runtime_self_us``: the runtime's own time in a task attempt, in us:
the mean over the window's task events of ``(t_run - t0) + (t1 -
t_body)``, input resolution after dispatch plus publication after the
body returned (the runtime's stamps).  Host clock."""
from bench.harness.spans import stamps


def read(run):
    selfs = [(run_ - t0) + (t1 - body)
             for _, t0, run_, body, t1 in stamps(run, "t0", "t_run", "t_body", "t1")]
    return 1e6 * sum(selfs) / len(selfs) if selfs else None
