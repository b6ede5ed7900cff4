"""Live telemetry plane (DESIGN.md §17), the port's copy.

* **Heartbeats** — every cluster node agent posts a periodic ``hb``
  message on its scheduler channel (cadence settled by the welcome
  handshake / ``RJAX_HEARTBEAT_S``; 0 disables) carrying its node-plane
  ledger, pool occupancy and counters, and p2p fetch counters.  The
  thread and process backends have no wire to ride, so an in-process
  sampler thread (started when ``telemetry=True`` or a dashboard is
  served) records ``executor.stats()`` + the store's memory ledger as a
  ``local`` pseudo-node heartbeat at the same cadence.
* **Task stream** — a bounded ring of lifecycle events
  (:class:`~repro_torch.core.tracing.TaskStream`), fed from
  ``Runtime.submit`` / ``begin_task`` / the completion paths.
* **Snapshots** — the JSON payloads behind the dashboard endpoints
  (:mod:`repro_torch.core.dashboard`): ``/api/status``, ``/api/tasks``,
  ``/api/transfers``.

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

    # ------------------------------------------------------------ snapshots
    def snapshot_status(self, runtime) -> dict:
        """The ``/api/status`` payload: runtime identity, task counters,
        and the per-node heartbeat view (memory/occupancy gauges)."""
        counters = runtime.graph.counters()
        now = time.time()
        inflight = self.inflight()
        nodes = {}
        for nid, ent in self.nodes().items():
            entry = {"heartbeats": ent["count"],
                     "age_s": round(now - ent["t"], 3),
                     "inflight": inflight.get(nid, 0)}
            entry.update(ent.get("payload") or {})
            nodes[str(nid)] = entry
        # failure-detector verdicts (DESIGN.md §19): merged per node so the
        # dashboard shows exactly what liveness decisions are based on —
        # including nodes that have never beaten (install is a synthetic
        # beat, so they still appear, aging towards suspect/dead)
        for nid, view in self._executor_liveness(runtime).items():
            entry = nodes.setdefault(
                str(nid), {"heartbeats": 0, "age_s": None,
                           "inflight": inflight.get(nid, 0)})
            entry["state"] = view.get("state")
            entry["beat_age_s"] = view.get("beat_age_s")
            # replicated intermediates resident on this node (§20)
            entry["replicas"] = view.get("replicas", 0)
        return {
            "name": runtime.name,
            "backend": runtime.backend,
            "n_workers": runtime.n_workers,
            "workers_per_node": runtime.workers_per_node,
            "uptime_s": round(now - self.t_started, 3),
            "telemetry_enabled": self.enabled,
            "queue_len": runtime.scheduler.queue_len(),
            "tasks": counters,
            "inflight": {str(k): v for k, v in inflight.items()},
            "ring": {"seq": self.stream.last_seq, "size": len(self.stream),
                     "capacity": self.stream.capacity,
                     "dropped": self.stream.dropped},
            "nodes": nodes,
        }

    @staticmethod
    def _executor_liveness(runtime) -> dict:
        """The cluster executor's failure-detector snapshot (``{}`` for
        backends without one)."""
        live = getattr(getattr(runtime, "executor", None), "liveness", None)
        if not callable(live):
            return {}
        try:
            return live() or {}
        except Exception:
            return {}

    def snapshot_tasks(self, runtime, since: int = 0,
                       limit: Optional[int] = None) -> dict:
        """The ``/api/tasks`` payload: lifecycle events newer than
        ``since`` plus the clock anchor the client needs to place them."""
        return {
            "now": time.perf_counter(),
            "t_start": runtime.tracer.t_start,
            "last_seq": self.stream.last_seq,
            "dropped": self.stream.dropped,
            "events": self.stream.since(since, limit=limit),
        }

    def snapshot_transfers(self, runtime) -> dict:
        """The ``/api/transfers`` payload: the node×node byte matrix from
        the §15 ledger (source ``-1`` = the scheduler's own link) plus
        the aggregate split it must stay consistent with."""
        detail = runtime.store.transfer_detail()
        return {
            "matrix": detail.get("matrix", []),
            "scheduler_relay_bytes": detail["scheduler_relay_bytes"],
            "p2p_bytes": detail["p2p_bytes"],
            "p2p_by_source": {str(k): v
                              for k, v in detail["p2p_by_source"].items()},
            "transfers": detail["transfers"],
            "transfer_bytes": detail["transfer_bytes"],
        }
