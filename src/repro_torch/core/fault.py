"""Fault-tolerance policies (paper §3.1/§6: task resubmission, exception
management) plus beyond-paper straggler speculation (DESIGN.md §19).

*Resubmission*: a task raising an exception is re-queued up to
``max_retries`` times; only after exhausting retries does the failure become
permanent, at which point the error is published on the task's outputs and
propagates to all transitive dependents (which fail fast without retrying —
their inputs are poisoned, re-running them cannot help).  Re-queueing waits
:meth:`RetryPolicy.delay_for` first: exponential backoff with bounded
jitter, folded with the §15 lost-input recovery pacing so a task whose
inputs died with a node never storms the rebuilding store.

*Speculation* (straggler mitigation, DESIGN.md §3): a monitor re-launches a
duplicate of any *pure* task whose running time exceeds
``factor ×`` the median duration of completed tasks of the same name, when
idle capacity exists.  First completion wins; the loser is discarded.  This
is the classic LATE/Dryad mitigation adapted to the COMPSs task model.

Liveness failure detection (the cluster backend's ``FailureDetector``)
comes with the cluster slice of the port.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class RetryPolicy:
    max_retries: int = 0          # default per-task; task() can override
    retry_on: tuple = (Exception,)
    backoff_seconds: float = 0.0  # base delay before re-queueing attempt 2
    backoff_factor: float = 2.0   # exponential growth per further attempt
    backoff_max: float = 30.0     # cap on the exponential term
    jitter: float = 0.25          # uniform extra, as a fraction of the delay

    def should_retry(self, attempts: int, max_retries: int, err: BaseException) -> bool:
        if attempts > max_retries:
            return False
        return isinstance(err, self.retry_on)

    def delay_for(self, attempts: int, *, lost_input: bool = False,
                  lost_input_pace: float = 0.25,
                  rng: Callable[[], float] = random.random) -> float:
        """Seconds to wait before re-queueing after failed attempt
        ``attempts`` (1-based).  The exponential term is
        ``backoff_seconds * backoff_factor**(attempts-1)`` capped at
        ``backoff_max``; lost-input failures are additionally paced by at
        least ``min(1.0, lost_input_pace * attempts)`` so retries don't
        race §15 lineage rebuilds even with ``backoff_seconds=0``.  Jitter
        adds up to ``jitter`` fraction on top (never subtracts), so the
        result is always >= the deterministic floor — the property the
        backoff regression test pins.
        """
        base = 0.0
        if self.backoff_seconds > 0.0 and attempts >= 1:
            base = min(self.backoff_max,
                       self.backoff_seconds *
                       self.backoff_factor ** (attempts - 1))
        if lost_input:
            base = max(base, min(1.0, lost_input_pace * max(1, attempts)))
        if base > 0.0 and self.jitter > 0.0:
            base += base * self.jitter * rng()
        return base


@dataclass(frozen=True)
class SpeculationConfig:
    enabled: bool = False
    factor: float = 3.0          # running > factor * median(same-name) => straggler
    min_samples: int = 3         # need this many completions to trust the median
    min_seconds: float = 0.05    # never speculate below this absolute runtime
    poll_interval: float = 0.02  # monitor period


class PoisonedInputError(RuntimeError):
    """A dependency failed permanently; this task cannot run."""

    def __init__(self, dep_task: int, cause: BaseException):
        super().__init__(f"input produced by failed task#{dep_task}: {cause!r}")
        self.dep_task = dep_task
        self.cause = cause
