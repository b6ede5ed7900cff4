"""``idle_kernel_queued_pct``: of the card's idle seconds in the traced
window (``DeviceTrace.idle_gaps()``), the share in percent during which
at least one task that is not a fill was ready and not yet dispatched:
the union of ``[t_ready, t0)`` over the window's non-fill task events,
intersected with the gaps.  That part of the idle time a scheduling
change could reach; the rest only faster fills or submission can."""
from bench.harness.spans import stamps
from bench.harness.trace import DeviceTrace


def read(run):
    dt = run.device_trace
    if dt is None or not dt.ops:
        return None
    stamped = stamps(run, "t_ready", "t0")
    idle = dt.window_s - dt.busy_s()
    if not stamped or idle <= 0:
        return None
    fills = set(run.pipeline.fill_tasks)
    waiting = [("waiting", ready, t0) for e, ready, t0 in stamped if e.name not in fills]
    # the waits inside the gaps are what they add to the card's busy union
    covered = DeviceTrace(window=dt.window, ops=dt.ops + waiting).busy_s() - dt.busy_s()
    return 100.0 * covered / idle
