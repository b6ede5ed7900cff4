"""``fill_s``: host seconds of the fill tasks per pipeline (the kind's
``fill_tasks``: NumPy generation and the upload to the card), summed
over the workers from the runtime's tracer events.  The bodies end in a
synchronous copy, so their host time is their time."""


def read(run):
    names = set(run.pipeline.fill_tasks)
    total = sum(e.t1 - e.t0 for e in run.task_events if e.name in names)
    return total / len(run.pipelines) if total > 0 else None
