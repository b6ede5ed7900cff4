"""``worker_busy_pct``: the workers' host busy share over the window, in
percent: for each worker the union of its tasks' spans from dispatch to
completion (the runtime's tracer events), clipped to the window, summed
and divided by the window times the workers.  Host time: a kernel that a
task launches and does not wait for is not in it."""


def read(run):
    lo, hi = run.window
    spans = {}
    for e in run.task_events:
        a, b = max(e.t0, lo), min(e.t1, hi)
        if b > a:
            spans.setdefault(e.worker, []).append((a, b))
    busy = 0.0
    for ivs in spans.values():
        ivs.sort()
        end = lo
        for a, b in ivs:
            a = max(a, end)
            if b > a:
                busy += b - a
                end = b
    return 100.0 * busy / ((hi - lo) * run.n_workers) if hi > lo else None
