"""Extrae/Paraver-style execution tracing (paper §3.3.4, Fig. 10).

The tracer records one event per task attempt: worker, node, task name,
and the attempt's lifecycle stamps, all from ``time.perf_counter()``:

* ``t_ready`` — the task became ready (its last input was published, or
  it was submitted with none, or a retry requeued it);
* ``t0`` — a worker claimed it (dispatch);
* ``t_run`` — its inputs were resolved and the body is about to run;
* ``t_body`` — the body returned (on the pipelined backends: its reply
  arrived);
* ``t1`` — its outputs were published and its dependents released;

plus ``spans``, the ``(name, start, end)`` child spans the body itself
recorded with :func:`span` (thread backend only).  From a trace we derive
the quantities the paper reads off Paraver timelines: per-worker
utilization, parallel efficiency, and an ASCII Gantt rendering for quick
terminal inspection.  Two file exports: a minimal ``.prv``-like format
familiar to Paraver users, and the Chrome trace-event JSON
(``to_chrome_trace``) that opens directly in Perfetto / ``about:tracing``.

:class:`TaskStream` is the live-telemetry counterpart (DESIGN.md §17): a
*bounded* ring of task-lifecycle events (submit → dispatch → done/fail)
that the dashboard polls incrementally by sequence number, while the
tracer above keeps the unbounded post-mortem record.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class TraceEvent:
    kind: str            # "task"
    name: str
    worker: int
    node: int
    t0: float
    t1: float
    task_id: int = -1
    meta: dict = field(default_factory=dict)
    t_ready: Optional[float] = None
    t_run: Optional[float] = None
    t_body: Optional[float] = None
    spans: Tuple[Tuple[str, float, float], ...] = ()

    @property
    def dt(self) -> float:
        return self.t1 - self.t0


# the span sink of the task body running on this thread: a list the
# runtime installs around a thread-backend body while its tracer is on,
# None everywhere else
_local = threading.local()


def set_span_sink(sink: Optional[list]) -> None:
    """Install ``sink`` as this thread's span sink (``None``: spans are
    dropped)."""
    _local.sink = sink


class span:
    """``with span("upload"): ...`` — a child span of the running task
    body.  Appends ``(name, start, end)`` to the sink the runtime
    installed on this thread, which ``TraceEvent.spans`` then carries.
    With no sink (outside a runtime, in a process or cluster worker, or
    with tracing off) it costs one thread-local attribute read."""

    __slots__ = ("name", "_sink", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self._sink = getattr(_local, "sink", None)
        if self._sink is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._sink is not None:
            self._sink.append((self.name, self._t0, time.perf_counter()))
        return False


class Tracer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._events: List[TraceEvent] = []
        self._lock = threading.Lock()
        self.t_start = time.perf_counter()
        self.t_stop: Optional[float] = None

    def record(self, ev: TraceEvent) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._events.append(ev)

    def stop(self) -> None:
        self.t_stop = time.perf_counter()

    def events(self, kind: Optional[str] = None) -> List[TraceEvent]:
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        return evs

    # ------------------------------------------------------------- analysis
    def wallclock(self) -> float:
        end = self.t_stop if self.t_stop is not None else time.perf_counter()
        return end - self.t_start

    def busy_per_worker(self) -> Dict[int, float]:
        busy: Dict[int, float] = {}
        for e in self.events("task"):
            busy[e.worker] = busy.get(e.worker, 0.0) + e.dt
        return busy

    def utilization(self, n_workers: int) -> float:
        wall = self.wallclock()
        if wall <= 0 or n_workers <= 0:
            return 0.0
        return sum(self.busy_per_worker().values()) / (wall * n_workers)

    def task_duration_stats(self) -> Dict[str, dict]:
        per: Dict[str, List[float]] = {}
        for e in self.events("task"):
            per.setdefault(e.name, []).append(e.dt)
        out = {}
        for name, ds in per.items():
            ds.sort()
            out[name] = {
                "count": len(ds),
                "total": sum(ds),
                "mean": sum(ds) / len(ds),
                "p50": ds[len(ds) // 2],
                "max": ds[-1],
            }
        return out

    # -------------------------------------------------------------- exports
    def to_prv(self) -> str:
        """Tiny Paraver-like export: header + one state record per task.

        Events are clamped and ordered defensively: completion threads
        record concurrently, so events may arrive out of submission order
        and a no-op task can carry ``t1 == t0`` (or, on clock hiccups,
        ``t1 < t0``) — Paraver expects ordered records with non-negative
        spans."""
        evs = sorted(self.events("task"), key=lambda e: (e.t0, e.t1))
        dur_us = max(0, int(self.wallclock() * 1e6))
        workers = sorted({e.worker for e in evs}) or [0]
        lines = [f"#Paraver (rjax):{dur_us}_us:1(1):{len(workers)}"]
        for e in evs:
            t0 = max(0, int((e.t0 - self.t_start) * 1e6))
            t1 = max(t0, int((e.t1 - self.t_start) * 1e6))
            # state record: 1:cpu:appl:task:thread:begin:end:state
            lines.append(f"1:{e.worker + 1}:1:1:1:{t0}:{t1}:{e.name}")
        return "\n".join(lines)

    def to_chrome_trace(self) -> str:
        """Chrome trace-event JSON (the ``traceEvents`` format Perfetto
        and ``about:tracing`` open directly): ``pid`` = locality domain /
        node, ``tid`` = worker, timestamps in µs from the tracer's origin,
        which ``metadata.perf_counter_origin_s`` gives on the
        ``time.perf_counter()`` clock, so that a profiler trace aligned to
        that clock can be laid over it.

        Each task attempt is one complete ("X") event from dispatch to
        publication on its worker's row, with its phases nested inside
        it: ``resolve`` (``t0`` → ``t_run``), the body's child spans, and
        ``publish`` (``t_body`` → ``t1``).  The wait before dispatch,
        ``queued`` (``t_ready`` → ``t0``), overlaps the worker's earlier
        tasks, and complete events on one row must nest, so it is an
        async slice ("b"/"e") with the same ``pid`` and ``tid``.
        Metadata records name the node/worker rows."""
        evs = self.events()

        def us(t: float) -> float:
            return round(max(0.0, (t - self.t_start) * 1e6), 3)

        def complete(name: str, cat: str, a: float, b: float,
                     e: TraceEvent) -> dict:
            ts = us(a)
            return {"name": name, "cat": cat, "ph": "X", "ts": ts,
                    "dur": round(max(0.0, us(b) - ts), 3),
                    "pid": int(e.node), "tid": int(e.worker)}

        records: List[dict] = []
        for node in sorted({e.node for e in evs}):
            records.append({"name": "process_name", "ph": "M",
                            "pid": int(node), "tid": 0,
                            "args": {"name": f"node {node}"}})
        for node, worker in sorted({(e.node, e.worker) for e in evs}):
            records.append({"name": "thread_name", "ph": "M",
                            "pid": int(node), "tid": int(worker),
                            "args": {"name": f"worker {worker}"}})
        for e in sorted(evs, key=lambda e: (e.t0, e.t1)):
            args = {"task_id": e.task_id}
            for k, v in e.meta.items():
                if isinstance(v, (bool, int, float, str)) or v is None:
                    args[k] = v
            records.append(dict(complete(e.name, e.kind, e.t0, e.t1, e),
                                args=args))
            if e.t_run is not None:
                records.append(complete("resolve", "phase", e.t0, e.t_run, e))
            for name, a, b in e.spans:
                records.append(complete(name, "span", a, b, e))
            if e.t_body is not None:
                records.append(complete("publish", "phase", e.t_body, e.t1, e))
            if e.t_ready is not None:
                queued = {"name": "queued", "cat": "queued",
                          "id": f"{e.task_id}.{e.meta.get('attempt', 0)}",
                          "pid": int(e.node), "tid": int(e.worker)}
                records.append(dict(queued, ph="b", ts=us(e.t_ready)))
                records.append(dict(queued, ph="e", ts=us(e.t0)))
        return json.dumps({"traceEvents": records, "displayTimeUnit": "ms",
                           "metadata": {"clock": "time.perf_counter",
                                        "perf_counter_origin_s": self.t_start}},
                          indent=1)

    def ascii_gantt(self, width: int = 100) -> str:
        """Terminal Gantt chart — one row per worker (paper Fig. 10 analogue)."""
        evs = self.events("task")
        if not evs:
            return "(empty trace)"
        width = max(2, int(width))
        t0 = min(e.t0 for e in evs)
        t1 = max(max(e.t1, e.t0) for e in evs)
        span = max(t1 - t0, 1e-9)
        rows: Dict[int, List[str]] = {}
        names = sorted({e.name for e in evs})
        glyph = {n: chr(ord("A") + (i % 26)) for i, n in enumerate(names)}
        for e in evs:
            row = rows.setdefault(e.worker, [" "] * width)
            # clamp into [0, width): zero-duration events still paint one
            # cell, events with a skewed/negative span never index out
            a = min(width - 1, max(0, int((e.t0 - t0) / span * (width - 1))))
            b = min(width, max(a + 1, int((e.t1 - t0) / span * (width - 1)) + 1))
            for i in range(a, b):
                row[i] = glyph[e.name]
        legend = "  ".join(f"{g}={n}" for n, g in glyph.items())
        out = [f"trace span: {span*1e3:.2f} ms   [{legend}]"]
        for w in sorted(rows):
            out.append(f"w{w:03d} |{''.join(rows[w])}|")
        return "\n".join(out)


# ------------------------------------------------------- live task stream
# bounded lifecycle ring (DESIGN.md §17); 0/negative = default
RING_CAPACITY = int(os.environ.get("RJAX_TELEMETRY_RING", "0") or 0) or 4096


class TaskStream:
    """Bounded ring buffer of task-lifecycle events (DESIGN.md §17).

    Each event is a plain dict tagged with a monotonically increasing
    ``seq``; the oldest events are evicted once ``capacity`` is reached
    (``dropped`` counts them), so a long-running service holds a sliding
    window instead of growing without bound.  Consumers (the dashboard's
    ``/api/tasks``) poll incrementally with ``since(last_seen_seq)``.
    Appends run on the dispatch/completion hot paths: one short lock hold
    and a deque append, nothing else."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = int(capacity) if capacity else RING_CAPACITY
        self.capacity = max(1, self.capacity)
        self._buf: collections.deque = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._dropped = 0

    def append(self, kind: str, **fields) -> int:
        with self._lock:
            self._seq += 1
            if len(self._buf) == self.capacity:
                self._dropped += 1
            fields["seq"] = self._seq
            fields["kind"] = kind
            self._buf.append(fields)
            return self._seq

    def extend(self, kind: str, rows) -> None:
        """Batch append (fan-out submission): one lock hold for the lot.
        ``rows`` is an iterable of field dicts."""
        with self._lock:
            for fields in rows:
                self._seq += 1
                if len(self._buf) == self.capacity:
                    self._dropped += 1
                fields["seq"] = self._seq
                fields["kind"] = kind
                self._buf.append(fields)

    def since(self, seq: int = 0, limit: Optional[int] = None) -> List[dict]:
        """Events with ``seq`` strictly greater than the given watermark,
        oldest first (capped at ``limit`` newest when given)."""
        with self._lock:
            evs = [dict(e) for e in self._buf if e["seq"] > seq]
        if limit is not None and len(evs) > limit:
            evs = evs[-int(limit):]
        return evs

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)
