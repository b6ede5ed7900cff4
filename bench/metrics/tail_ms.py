"""``tail_ms``: what the linear regression DAG's depth costs once all its
data is on the card, in ms.  For each pipeline of the window, from the
latest completion (``t1``) of its fill tasks (the kind's ``fill_tasks``:
fragments and prediction blocks) to the latest completion of its
``compute_prediction`` tasks: the last partials, the upper merge levels,
the fit and the predictions behind it.  The mean over the pipelines
(the runtime's tracer events; host clock)."""


def read(run):
    fills = set(run.pipeline.fill_tasks)
    tails = []
    for p in run.pipelines:
        evs = [e for e in run.task_events if p["t0"] <= e.t0 and e.t1 <= p["t1"]]
        filled = [e.t1 for e in evs if e.name in fills]
        predicted = [e.t1 for e in evs if e.name == "compute_prediction"]
        if not filled or not predicted:
            return None
        tails.append(max(predicted) - max(filled))
    return 1000.0 * sum(tails) / len(tails) if tails else None
