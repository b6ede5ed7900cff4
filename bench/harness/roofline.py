"""A kernel's share of its roofline over a traced window."""
from __future__ import annotations

from . import spec
from .peaks import least_seconds


def share(run, kernel: str):
    """Percent, or ``None`` where the window launched the kernel never or
    the trace holds none of its device time.  The calls' count is the
    program's own launch counter; each call's shape is the one the
    pipeline kind gives for the cell, and a count that is not a whole
    number of pipelines' calls reads nothing."""
    dt = run.device_trace
    launches = run.launches.get(kernel, 0)
    shapes = run.pipeline.kernel_calls().get(kernel, [])
    if dt is None or not launches or not shapes or launches % len(shapes):
        return None
    counts = spec.module("counts", kernel)
    per_pipeline = sum(least_seconds(*counts.work(**s), counts.PEAK) for s in shapes)
    device_s = dt.seconds_matching(counts.KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * per_pipeline * (launches // len(shapes)) / device_s
