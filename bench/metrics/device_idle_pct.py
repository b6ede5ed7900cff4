"""``device_idle_pct``: the share of the traced window in which no
kernel, copy or set ran on the card, in percent (torch.profiler's
device activity of the harness process)."""


def read(run):
    dt = run.device_trace
    if dt is None or dt.window_s <= 0 or not dt.ops:
        return None
    return 100.0 * (1.0 - dt.busy_s() / dt.window_s)
