"""``solve_ms``: the fit's ``solve`` spans (``compute_model_parameters``:
``torch.linalg.solve`` of the normal equations, which synchronises the
card, so the span holds the device work queued before it), summed and
taken per pipeline, in ms.  ``None`` where the body records no span."""


def read(run):
    spans = [b - a for e in run.task_events if e.name == "compute_model_parameters"
             for n, a, b in getattr(e, "spans", ()) if n == "solve"]
    if not spans or not run.pipelines:
        return None
    return 1000.0 * sum(spans) / len(run.pipelines)
