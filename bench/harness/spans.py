"""What the runtime's own stamps and spans say, for the metric readers.

The port's tracer gives each task event its lifecycle stamps (``t_ready``
ready, ``t0`` dispatched, ``t_run`` inputs resolved, ``t_body`` body
returned, ``t1`` published) and the body's child spans (``spans``:
``(name, start, end)``), all on ``time.perf_counter()``.  A program
that records none of them reads nothing here: every reader returns
``None`` then."""
from __future__ import annotations

from typing import List, Optional


def stamps(run, *names: str) -> List[tuple]:
    """For each of the window's task events that carries every stamp in
    ``names``: ``(event, stamp, ...)``."""
    out = []
    for e in run.task_events:
        values = tuple(getattr(e, n, None) for n in names)
        if all(v is not None for v in values):
            out.append((e,) + values)
    return out


def fill_span_s(run, name: str) -> Optional[float]:
    """Seconds of the fill events' child spans called ``name``, summed
    over the workers, per pipeline."""
    fills = set(run.pipeline.fill_tasks)
    spans = [(a, b) for e in run.task_events if e.name in fills
             for n, a, b in getattr(e, "spans", ()) if n == name]
    if not spans or not run.pipelines:
        return None
    return sum(b - a for a, b in spans) / len(run.pipelines)

