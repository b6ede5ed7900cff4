"""``iteration_ms``: the K-means user program's time per iteration.  For
each pipeline of the window, the span from its first ``partial_sum``
dispatch to its last ``update_centroids`` completion (the runtime's
tracer events); the sum of the spans over the sum of the iterations run.
Host clock; milliseconds."""


def read(run):
    total, iters = 0.0, 0
    for p in run.pipelines:
        evs = [e for e in run.task_events if p["t0"] <= e.t0 and e.t1 <= p["t1"]]
        starts = [e.t0 for e in evs if e.name == "partial_sum"]
        ends = [e.t1 for e in evs if e.name == "update_centroids"]
        if not starts or not ends:
            return None
        total += max(ends) - min(starts)
        iters += int(p["result"].iterations)
    return 1000.0 * total / iters if iters else None
