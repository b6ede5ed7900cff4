"""Live telemetry plane (DESIGN.md §17), the port's copy.

* **Sampler** — the thread backend has no agents to heartbeat, so an
  in-process sampler thread (started when ``telemetry=True``) records
  ``executor.stats()`` + the store's memory ledger as a ``local``
  pseudo-node heartbeat (cadence ``RJAX_HEARTBEAT_S``; 0 disables).
* **Task stream** — a bounded ring of lifecycle events
  (:class:`~repro_torch.core.tracing.TaskStream`), fed from
  ``Runtime.submit`` / ``begin_task`` / the completion paths.

The dashboard that serves these snapshots comes with a later slice.
Everything here is counters and dict snapshots — no third-party
dependencies.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

from .tracing import TaskStream

# default heartbeat/sampler cadence, seconds; 0 disables
HEARTBEAT_DEFAULT_S = 1.0


def heartbeat_interval(welcome_value: Any = None) -> float:
    """Resolve the heartbeat cadence: the local ``RJAX_HEARTBEAT_S``
    wins (an operator pinning one node), then the scheduler's
    welcome-carried value, then the default.  ``0`` disables."""
    env = os.environ.get("RJAX_HEARTBEAT_S")
    for raw in (env, welcome_value):
        if raw is None or raw == "":
            continue
        try:
            return max(0.0, float(raw))
        except (TypeError, ValueError):
            continue
    return HEARTBEAT_DEFAULT_S


# canonical executor-stats schema: the union of every backend's numeric
# counters, so ``runtime_stats()["executor"]`` exposes the same keys on
# thread/process/cluster alike (absent concepts read 0, not KeyError)
EXECUTOR_STAT_KEYS = (
    # shared
    "pipeline_depth",
    # process backend
    "worker_restarts", "descriptor_sends", "batched_sends",
    "segments", "bytes_planed", "refs_shipped", "deadline_kills",
    # cluster backend
    "n_agents", "workers_per_node", "agent_restarts", "liveness_kills",
    "reconnects", "replica_bytes", "replica_hits",
    "broadcasts",
    "puts", "refs", "fetches", "fetch_bytes", "bytes_shipped",
    "relay_result_bytes", "remote_results", "deferred_result_bytes",
    "relay_bytes",
)


def normalize_executor_stats(stats: dict) -> dict:
    """Uniform executor-stats schema: every canonical key present (0 when
    the backend has no such concept), backend-specific extras preserved."""
    out = {k: 0 for k in EXECUTOR_STAT_KEYS}
    out["p2p"] = False
    out.update(stats)
    return out


class TelemetryHub:
    """Scheduler-side aggregation point for the live telemetry plane.

    Holds the bounded task-lifecycle ring, the latest heartbeat per node
    (real agent heartbeats or sampler snapshots), and a per-node in-flight
    counter maintained from the dispatch/completion hooks.  All methods
    are thread-safe; the hot-path hooks (``note_dispatch``/``note_task``)
    are a guard check plus one ring append and one dict bump."""

    def __init__(self, enabled: bool = True,
                 ring_capacity: Optional[int] = None):
        self.enabled = bool(enabled)
        self.stream = TaskStream(ring_capacity)
        self._lock = threading.Lock()
        self._nodes: Dict[Any, dict] = {}      # node -> latest heartbeat
        self._inflight: Dict[int, int] = {}    # node -> dispatched, not done
        self.t_started = time.time()
        self._sampler: Optional[threading.Thread] = None
        self._sampler_stop = threading.Event()

    # ------------------------------------------------------------ heartbeats
    def note_heartbeat(self, node: Any, payload: dict) -> None:
        """An agent heartbeat (or sampler snapshot) arrived for ``node``."""
        now = time.time()
        with self._lock:
            ent = self._nodes.get(node)
            if ent is None:
                ent = self._nodes[node] = {"count": 0}
            ent["count"] += 1
            ent["t"] = now
            ent["payload"] = payload

    def nodes(self) -> Dict[Any, dict]:
        """Latest heartbeat per node: ``{node: {count, t, payload}}``."""
        with self._lock:
            return {n: dict(e) for n, e in self._nodes.items()}

    # ------------------------------------------------- task lifecycle hooks
    def note_submit(self, rows: List[dict]) -> None:
        """Tasks entered the graph; each row carries ``task``/``name``."""
        t = time.perf_counter()
        for r in rows:
            r["t"] = t
        self.stream.extend("submit", rows)

    def note_dispatch(self, tid: int, name: str, worker: int, node: int,
                      t0: float) -> None:
        """A dispatcher claimed the task (begin_task): input resolution
        starts now; the matching completion event's ``t_run`` - ``t0``
        gap is the fetch/stall time."""
        self.stream.append("dispatch", task=tid, name=name, worker=worker,
                           node=node, t=t0)
        with self._lock:
            self._inflight[node] = self._inflight.get(node, 0) + 1

    def note_task(self, tid: int, name: str, worker: int, node: int,
                  t0: float, t_run: Optional[float], t1: float,
                  ok: bool, retried: bool) -> None:
        """The attempt reached a terminal state (done/fail/retry)."""
        kind = "done" if ok else ("retry" if retried else "fail")
        self.stream.append(kind, task=tid, name=name, worker=worker,
                           node=node, t0=t0, t_run=t_run, t1=t1)
        with self._lock:
            left = self._inflight.get(node, 0) - 1
            if left > 0:
                self._inflight[node] = left
            else:
                self._inflight.pop(node, None)

    def inflight(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._inflight)

    # --------------------------------------------------- in-process sampler
    def start_sampler(self, runtime, interval: Optional[float] = None) -> None:
        """Thread/process-backend equivalent of agent heartbeats: sample
        ``executor.stats()`` + the store's memory ledger every
        ``interval`` seconds into a single ``local`` pseudo-node entry
        (one address-space plane ⇒ one gauge)."""
        if self._sampler is not None:
            return
        interval = heartbeat_interval(None) if interval is None else interval
        if interval <= 0:
            return

        def loop():
            # sample immediately: a dashboard opened right after start
            # should show the node, not a blank first interval
            while True:
                try:
                    self.sample_local(runtime)
                except Exception:
                    pass   # a torn-down runtime mid-sample is not an error
                if self._sampler_stop.wait(interval):
                    return

        self._sampler = threading.Thread(
            target=loop, daemon=True, name=f"{runtime.name}-telemetry")
        self._sampler.start()

    def sample_local(self, runtime) -> None:
        payload = {"t": time.time(), "sampled": True}
        payload.update(runtime.executor.stats())
        for k, v in runtime.store.memory_stats().items():
            payload[f"store_{k}"] = v
        self.note_heartbeat("local", payload)

    def close(self) -> None:
        self._sampler_stop.set()
