"""The device trace of a ``--trace 1`` window, from ``torch.profiler``.

The profiler records the card's activity (kernels, copies, sets) over
the whole measured window, and nothing of the host's torch operations:
at hundreds of thousands of host events a window, their processing
alone would outlast a run.  A marker kernel (``torch.cuda._sleep``)
launched on the idle card at a known ``time.perf_counter()`` aligns the
profiler's clock with the host clock of the runtime's tracer, so idle
stretches of the card can be named by the tasks the host was running
meanwhile (to within the marker's launch latency, some microseconds).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

MARK = "spin_kernel"      # torch.cuda._sleep's kernel


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


@dataclass
class DeviceTrace:
    """Device intervals in host-clock seconds (``perf_counter``)."""
    window: Tuple[float, float]
    ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's activity, clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(a, lo), min(b, hi)) for _, a, b in self.ops if b > lo and a < hi)
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        gaps, t = [], lo
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        return gaps

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, a, b in self.ops:
            out[name] = out.get(name, 0.0) + (b - a)
        return out

    def seconds_matching(self, kernels) -> float:
        """Device seconds of the kernels whose base name is one of
        ``kernels``."""
        names = set(kernels)
        return sum(b - a for name, a, b in self.ops if base_name(name) in names)


def base_name(name: str) -> str:
    """A kernel's own name without its return type, namespaces, template
    arguments and parameters: ``void (anonymous namespace)::knn_chunk_topk<8>(float
    const*, ...)`` is ``knn_chunk_topk``."""
    head = name[5:] if name.startswith("void ") else name
    head = head.replace("(anonymous namespace)::", "").split("(", 1)[0].split("<", 1)[0]
    return head.rsplit("::", 1)[-1].strip()


class Profiler:
    """``torch.profiler`` over the card's activity."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._mark: Optional[float] = None

    def start(self) -> None:
        import torch
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._mark = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self, window: Tuple[float, float]) -> DeviceTrace:
        import torch
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        marks = [_ns(ev, "start") for ev in events
                 if ev.device_type() == cuda and base_name(ev.name()) == MARK]
        if not marks:
            raise RuntimeError("the profiler lost the clock mark")
        offset = self._mark - min(marks) / 1e9
        trace = DeviceTrace(window=window)
        for ev in events:
            if ev.device_type() != cuda or base_name(ev.name()) == MARK:
                continue
            a = _ns(ev, "start") / 1e9 + offset
            trace.ops.append((ev.name(), a, a + _ns(ev, "duration") / 1e9))
        return trace
