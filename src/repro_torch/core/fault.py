"""Fault-tolerance policies (paper §3.1/§6: task resubmission, exception
management) plus beyond-paper straggler speculation and liveness failure
detection (DESIGN.md §19).

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

*Liveness* (DESIGN.md §19): every crash-recovery path in the cluster
backend is triggered by a TCP disconnect (``AgentChannel.on_close``).  An
agent that wedges without dying — SIGSTOP, pathological swap/GC stall, a
half-open connection after a partition — never disconnects, so before this
layer the job hung forever.  :class:`FailureDetector` is the scheduler-side
timeout detector over the §17 heartbeat plane: per node it tracks the last
beat (install time counts as a synthetic first beat so a node stopped at
birth is still caught) and classifies ``alive → suspect → dead`` by beat
age against :class:`LivenessConfig`.  The detector never repairs anything
itself: the executor closes a dead node's channel, which fires the
*existing* ``on_close`` → respawn → §15 lineage path, so recovery semantics
stay single-sourced no matter how the failure was noticed.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"


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


@dataclass(frozen=True)
class LivenessConfig:
    """Scheduler-side failure-detector knobs (``runtime_start(liveness=,
    suspicion_s=)`` / ``RJAX_LIVENESS`` / ``RJAX_SUSPICION_S``)."""

    enabled: bool = True
    suspicion_s: float = 5.0     # beat age after which a node is suspect
    dead_factor: float = 2.0     # dead at suspicion_s * dead_factor
    min_grace_beats: float = 3.0 # never suspect before this many beat periods

    @property
    def dead_s(self) -> float:
        return self.suspicion_s * self.dead_factor


@dataclass
class _NodeView:
    last_beat: float             # monotonic time of last heartbeat (or install)
    beats: int = 0
    state: str = ALIVE
    deadline_at: Optional[float] = None   # oldest in-flight request's deadline


class FailureDetector:
    """Timeout-style liveness detector over heartbeat ages and in-flight
    request deadlines.  Pure bookkeeping + classification: thread-safe,
    no timers of its own — the executor's monitor loop calls
    :meth:`assess` and acts on ``dead`` verdicts.
    """

    def __init__(self, cfg: LivenessConfig, heartbeat_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.heartbeat_s = float(heartbeat_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._nodes: Dict[int, _NodeView] = {}
        # a node must miss at least suspicion_s AND min_grace_beats beat
        # periods before suspicion — guards against false kills when the
        # configured suspicion window is tighter than the beat cadence
        self._suspect_age = max(cfg.suspicion_s,
                                cfg.min_grace_beats * self.heartbeat_s)
        self._dead_age = max(cfg.dead_s,
                             cfg.min_grace_beats * self.heartbeat_s)

    @property
    def active(self) -> bool:
        """Heartbeats off means beat age carries no information."""
        return self.cfg.enabled and self.heartbeat_s > 0.0

    # ------------------------------------------------------------- feeding
    def note_install(self, node: int) -> None:
        """A (re)spawned node's channel went live: install time counts as
        a synthetic beat so a node wedged at birth still ages out."""
        with self._lock:
            self._nodes[node] = _NodeView(last_beat=self._clock())

    def note_beat(self, node: int) -> None:
        with self._lock:
            view = self._nodes.get(node)
            if view is None:
                view = self._nodes[node] = _NodeView(last_beat=0.0)
            view.last_beat = self._clock()
            view.beats += 1

    def note_deadline(self, node: int, deadline_at: Optional[float]) -> None:
        """Earliest in-flight request deadline on ``node`` (monotonic
        timestamp), or ``None`` when nothing in flight carries one."""
        with self._lock:
            view = self._nodes.get(node)
            if view is not None:
                view.deadline_at = deadline_at

    def note_removed(self, node: int) -> None:
        """Channel went down (crash or verdict acted upon): forget the
        node until its replacement is installed."""
        with self._lock:
            self._nodes.pop(node, None)

    # ----------------------------------------------------------- verdicts
    def assess(self, node: int) -> str:
        """Classify one node right now; updates its recorded state."""
        now = self._clock()
        with self._lock:
            view = self._nodes.get(node)
            if view is None:
                return DEAD
            state = ALIVE
            if self.active:
                age = now - view.last_beat
                if age > self._dead_age:
                    state = DEAD
                elif age > self._suspect_age:
                    state = SUSPECT
            if (state != DEAD and view.deadline_at is not None
                    and now > view.deadline_at):
                # an in-flight request sailed past its deadline (plus the
                # executor's slack): the node is wedged even if it beats
                state = DEAD
            view.state = state
            return state

    def snapshot(self) -> Dict[int, dict]:
        """Per-node liveness view for telemetry (`/api/status`)."""
        now = self._clock()
        with self._lock:
            return {
                node: {
                    "state": view.state,
                    "beat_age_s": round(now - view.last_beat, 3),
                    "beats": view.beats,
                }
                for node, view in self._nodes.items()
            }


class PoisonedInputError(RuntimeError):
    """A dependency failed permanently; this task cannot run."""

    def __init__(self, dep_task: int, cause: BaseException):
        super().__init__(f"input produced by failed task#{dep_task}: {cause!r}")
        self.dep_task = dep_task
        self.cause = cause
