"""Dynamic task dependency graph.

The runtime builds this DAG *online* as the user's sequential program submits
tasks (paper §3.2).  Dependencies are discovered by scanning task arguments
for ``Future`` objects: an argument ``dXvY`` produced by task *T* makes the
new task a child of *T*.  INOUT parameters bump the datum's version, which is
exactly COMPSs' renaming scheme.

Hot-path bookkeeping (DESIGN.md §14): the graph maintains per-state
counters, a running-task index, and a bounded per-name duration history,
so ``Runtime.stats()`` and the speculation monitor are O(1)/O(running)
instead of scanning every node ever submitted.  ``RJAX_GRAPH_RETAIN``
(default 0 = keep everything) bounds how many *terminal* nodes are
retained: long-running services set it so the graph stops growing without
bound (the pruned tail disappears from ``to_dot``/``critical_path``
renderings but not from the cumulative counters).
"""
from __future__ import annotations

import collections
import enum
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

# terminal-node retention: 0 = unbounded (retain the full graph, the
# pre-§14 behaviour); N > 0 = keep at most N DONE/FAILED/CANCELLED nodes
GRAPH_RETAIN = int(os.environ.get("RJAX_GRAPH_RETAIN", "0") or 0)
# duration samples kept per task name for speculation's median estimate
_DURATIONS_KEPT = 64


class TaskState(enum.Enum):
    PENDING = "pending"      # submitted, waiting on dependencies
    READY = "ready"          # all deps satisfied, queued for execution
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"        # exhausted retries
    CANCELLED = "cancelled"  # speculative duplicate that lost the race


@dataclass
class TaskNode:
    task_id: int
    name: str
    fn: Callable
    args: tuple
    kwargs: dict
    # dependency bookkeeping
    dep_keys: Set[Tuple[int, int]] = field(default_factory=set)   # (data_id, version) inputs
    parents: Set[int] = field(default_factory=set)
    children: Set[int] = field(default_factory=set)
    unresolved: int = 0
    # outputs
    out_keys: List[Tuple[int, int]] = field(default_factory=list)
    # execution state
    state: TaskState = TaskState.PENDING
    attempts: int = 0
    max_retries: int = 0
    worker: Optional[int] = None
    node: Optional[int] = None  # which (virtual) node executed it
    submit_t: float = 0.0
    ready_t: float = 0.0     # when it last entered READY
    start_t: float = 0.0
    end_t: float = 0.0
    error: Optional[BaseException] = None
    # scheduling metadata
    priority: int = 0
    nbytes_in: int = 0
    speculatable: bool = True
    speculative_of: Optional[int] = None  # set on speculative duplicates
    # fault tolerance (DESIGN.md §19): body wall-time bound; an attempt
    # running longer is killed agent-side and fails retryable
    deadline_s: Optional[float] = None

    @property
    def duration(self) -> float:
        return max(0.0, self.end_t - self.start_t)


_TERMINAL = (TaskState.DONE, TaskState.FAILED, TaskState.CANCELLED)


class TaskGraph:
    """Thread-safe DAG with in-degree tracking.

    ``add_task`` wires parent/child edges from the dependency keys; when a
    task completes, ``mark_done`` returns the children that just became
    ready.  The graph also retains completed nodes so traces and ``to_dot``
    renderings (paper Figs. 2-5) can be produced after the run — bounded
    by ``RJAX_GRAPH_RETAIN`` when set.
    """

    def __init__(self, retain: int = GRAPH_RETAIN):
        self._lock = threading.Lock()
        self._nodes: Dict[int, TaskNode] = {}
        self._producers: Dict[Tuple[int, int], int] = {}  # data key -> producer task
        self._ids = itertools.count(1)
        self.retain = int(retain)
        # -- incremental bookkeeping (replaces full-graph scans) -------------
        self._counts: Dict[TaskState, int] = {s: 0 for s in TaskState}
        self._running: Set[int] = set()          # RUNNING task ids
        self._terminal: collections.deque = collections.deque()  # completion order
        self._durations: Dict[str, collections.deque] = {}
        # body seconds as measured by the executing worker itself (the
        # cluster agent times around its pool invoke and ships ``dur``
        # in the done reply) — unlike ``_durations`` these carry no
        # dispatch/queue latency, so the replication cost bar (§20)
        # compares producer cost with producer cost
        self._run_s: Dict[str, collections.deque] = {}
        self._submitted = 0      # non-speculative adds (cumulative)
        self._speculative = 0    # speculative adds (cumulative)
        self._retries = 0        # re-executions observed (cumulative)
        self._total_work = 0.0   # sum of DONE durations (cumulative)

    def next_task_id(self) -> int:
        return next(self._ids)

    def next_task_ids(self, n: int) -> List[int]:
        return [next(self._ids) for _ in range(n)]

    # ------------------------------------------------------- state transitions
    def _set_state_locked(self, n: TaskNode, state: TaskState) -> None:
        self._counts[n.state] -= 1
        self._counts[state] += 1
        if n.state == TaskState.RUNNING:
            self._running.discard(n.task_id)
        if state == TaskState.RUNNING:
            self._running.add(n.task_id)
        n.state = state
        if state in _TERMINAL:
            self._terminal.append(n.task_id)
            self._prune_locked()

    def _prune_locked(self) -> None:
        """Drop the oldest terminal nodes past the retention bound.  Nodes
        flagged ``_speculated`` are kept (a late clone may still look its
        primary up); cumulative counters are unaffected."""
        if self.retain <= 0:
            return
        while len(self._terminal) > self.retain:
            tid = self._terminal.popleft()
            n = self._nodes.get(tid)
            if n is None or getattr(n, "_speculated", False):
                continue
            del self._nodes[tid]
            for key in n.out_keys:
                if self._producers.get(key) == tid:
                    del self._producers[key]

    # ------------------------------------------------------------------- adds
    def _add_task_locked(self, node: TaskNode) -> bool:
        """Insert one node; True if immediately ready."""
        unresolved = 0
        for key in node.dep_keys:
            producer = self._producers.get(key)
            if producer is not None:
                p = self._nodes.get(producer)
                # FAILED producers already published their error and
                # released children: counting them as unresolved would
                # block this task forever — let it run and fail fast on
                # the poisoned input instead
                # dedup by producer: a child reading two outputs of the
                # same task gets released once, so it must only count
                # one unresolved edge
                if p is not None and p.state not in (TaskState.DONE,
                                                     TaskState.FAILED) \
                        and producer not in node.parents:
                    node.parents.add(producer)
                    p.children.add(node.task_id)
                    unresolved += 1
        node.unresolved = unresolved
        node.submit_t = node.ready_t = time.perf_counter()
        for key in node.out_keys:
            self._producers[key] = node.task_id
        self._nodes[node.task_id] = node
        if node.speculative_of is None:
            self._submitted += 1
        else:
            self._speculative += 1
        if unresolved == 0:
            node.state = TaskState.READY
            self._counts[TaskState.READY] += 1
            return True
        self._counts[TaskState.PENDING] += 1
        return False

    def add_task(self, node: TaskNode) -> List[int]:
        """Insert ``node``; returns [node.task_id] if immediately ready."""
        with self._lock:
            return [node.task_id] if self._add_task_locked(node) else []

    def add_tasks(self, nodes: Sequence[TaskNode]) -> List[int]:
        """Batch insert under ONE lock acquisition (fan-out submission);
        returns the ids of all immediately-ready nodes in order."""
        ready: List[int] = []
        with self._lock:
            for node in nodes:
                if self._add_task_locked(node):
                    ready.append(node.task_id)
        return ready

    def claim_running(self, task_id: int, worker: int,
                      node_id: int) -> Optional[TaskNode]:
        """READY→RUNNING transition returning the node — one lock pass for
        the dispatch hot path (None = lost a cancellation race, or the
        node went terminal and was pruned while its id sat in the queue)."""
        with self._lock:
            n = self._nodes.get(task_id)
            if n is None or n.state not in (TaskState.READY,):
                return None
            self._set_state_locked(n, TaskState.RUNNING)
            n.worker = worker
            n.node = node_id
            n.start_t = time.perf_counter()
            n.attempts += 1
            if n.attempts > 1:
                self._retries += 1
            return n

    def _release_children_locked(self, n: TaskNode) -> List[int]:
        """Decrement the in-degree of ``n``'s PENDING children; those it
        releases become ready at ``n.end_t``."""
        newly_ready: List[int] = []
        for cid in n.children:
            c = self._nodes.get(cid)
            # only PENDING children hold unresolved edges; a resurrected
            # producer (lineage re-execution, DESIGN.md §15) completes a
            # second time with its children long released — decrementing
            # them again would corrupt the in-degree bookkeeping
            if c is None or c.state != TaskState.PENDING:
                continue
            c.unresolved -= 1
            if c.unresolved == 0:
                self._counts[TaskState.PENDING] -= 1
                self._counts[TaskState.READY] += 1
                c.state = TaskState.READY
                c.ready_t = n.end_t
                newly_ready.append(cid)
        return newly_ready

    def mark_done(self, task_id: int) -> List[int]:
        """Mark complete; return newly-ready children ids."""
        with self._lock:
            n = self._nodes[task_id]
            n.end_t = time.perf_counter()
            self._total_work += n.duration
            if n.speculative_of is None:
                ds = self._durations.get(n.name)
                if ds is None:
                    ds = self._durations[n.name] = collections.deque(
                        maxlen=_DURATIONS_KEPT)
                ds.append(n.duration)
            ready = self._release_children_locked(n)
            self._set_state_locked(n, TaskState.DONE)
            return ready

    def mark_failed(self, task_id: int, err: BaseException) -> List[int]:
        """Permanent failure: record error and release children (they will
        observe the stored error on their inputs and fail fast — COMPSs'
        exception propagation)."""
        with self._lock:
            n = self._nodes[task_id]
            n.end_t = time.perf_counter()
            n.error = err
            ready = self._release_children_locked(n)
            self._set_state_locked(n, TaskState.FAILED)
            return ready

    def requeue_for_retry(self, task_id: int) -> None:
        with self._lock:
            n = self._nodes[task_id]
            self._set_state_locked(n, TaskState.READY)
            n.ready_t = time.perf_counter()

    def producer_of(self, key: Tuple[int, int]) -> Optional[int]:
        """The task id that produces datum ``key`` (None once pruned)."""
        with self._lock:
            return self._producers.get(key)

    def resurrect(self, task_id: int) -> bool:
        """Lineage re-execution (DESIGN.md §15): a DONE task whose
        node-resident output was lost with its node goes back to READY so
        it can run again from its recorded inputs.  Returns False when
        the node is unknown, pruned, or not DONE (already resurrected /
        failed — nothing to do)."""
        with self._lock:
            n = self._nodes.get(task_id)
            if n is None or n.state != TaskState.DONE:
                return False
            try:
                self._terminal.remove(task_id)
            except ValueError:
                pass
            self._counts[TaskState.DONE] -= 1
            self._counts[TaskState.READY] += 1
            n.state = TaskState.READY
            n.ready_t = time.perf_counter()
            n.error = None
            # re-arm edges to children still PENDING: their edge to this
            # task was released by the first completion, so without the
            # +1 the SECOND completion would double-decrement and release
            # them while other parents are still running
            for cid in n.children:
                c = self._nodes.get(cid)
                if c is not None and c.state == TaskState.PENDING:
                    c.unresolved += 1
            return True

    def mark_cancelled(self, task_id: int) -> None:
        with self._lock:
            n = self._nodes.get(task_id)
            if n is None:   # already pruned (long-gone logical task)
                return
            if n.state not in (TaskState.DONE, TaskState.FAILED):
                n.end_t = time.perf_counter()
                self._set_state_locked(n, TaskState.CANCELLED)

    def get(self, task_id: int) -> TaskNode:
        with self._lock:
            return self._nodes[task_id]

    def nodes(self) -> List[TaskNode]:
        with self._lock:
            return list(self._nodes.values())

    def running_nodes(self) -> List[TaskNode]:
        """The RUNNING nodes, from the index — O(running), not O(all)."""
        with self._lock:
            return [self._nodes[tid] for tid in self._running
                    if tid in self._nodes]

    def done_durations(self, name: str) -> List[float]:
        """Recent completion durations of non-speculative tasks named
        ``name`` (bounded history; feeds speculation's median)."""
        with self._lock:
            ds = self._durations.get(name)
            return list(ds) if ds else []

    def note_run_s(self, name: str, dur: float) -> None:
        """Record a worker-measured body duration (no queue latency) for
        ``name`` — the cluster backend feeds these from the agent's done
        replies."""
        with self._lock:
            ds = self._run_s.get(name)
            if ds is None:
                ds = self._run_s[name] = collections.deque(
                    maxlen=_DURATIONS_KEPT)
            ds.append(float(dur))

    def duration_threshold(self) -> float:
        """Fleet-wide mean of the recorded task durations — the
        replication cost bar (DESIGN.md §20): a producer at or above the
        mean is worth pushing a replica for, one below it is cheaper to
        re-execute from lineage.  Prefers worker-measured body times
        (``note_run_s``) over scheduler-observed completion latencies;
        0.0 while no history exists, so early results replicate until
        the profile fills in."""
        with self._lock:
            total = 0.0
            n = 0
            for ds in (self._run_s or self._durations).values():
                total += sum(ds)
                n += len(ds)
        return (total / n) if n else 0.0

    def pending_count(self) -> int:
        with self._lock:
            return (self._counts[TaskState.PENDING]
                    + self._counts[TaskState.READY]
                    + self._counts[TaskState.RUNNING])

    def counters(self) -> dict:
        """Cumulative O(1) snapshot (unaffected by terminal pruning)."""
        with self._lock:
            return {
                "submitted": self._submitted,
                "speculative": self._speculative,
                "done": self._counts[TaskState.DONE],
                "failed": self._counts[TaskState.FAILED],
                "cancelled": self._counts[TaskState.CANCELLED],
                "retries": self._retries,
                "total_work_s": self._total_work,
                "retained_nodes": len(self._nodes),
            }

    # ------------------------------------------------------------------ export
    def to_dot(self) -> str:
        """Graphviz rendering in the paper's style (Fig. 2): nodes are task
        ids, edges labelled with the ``dXvY`` datum that carries the
        dependency."""
        lines = ["digraph G {", '  main [shape=box];', '  sync [shape=octagon];']
        with self._lock:
            key_producer = dict(self._producers)
            for n in self._nodes.values():
                lines.append(f'  t{n.task_id} [label="{n.name}\\n#{n.task_id}"];')
                if not n.parents:
                    lines.append(f"  main -> t{n.task_id};")
                if not n.children:
                    lines.append(f"  t{n.task_id} -> sync;")
            for n in self._nodes.values():
                for key in n.dep_keys:
                    p = key_producer.get(key)
                    if p is not None and p in self._nodes and p != n.task_id:
                        lines.append(
                            f'  t{p} -> t{n.task_id} [label="d{key[0]}v{key[1]}"];'
                        )
        lines.append("}")
        return "\n".join(lines)

    # -------------------------------------------------------- analysis helpers
    def critical_path_seconds(self) -> float:
        """Longest chain of measured task durations (T_inf) over the
        *retained* nodes."""
        with self._lock:
            memo: Dict[int, float] = {}
            order = sorted(self._nodes)  # task ids increase topologically
            for tid in order:
                n = self._nodes[tid]
                base = max((memo.get(p, 0.0) for p in n.parents), default=0.0)
                memo[tid] = base + n.duration
            return max(memo.values(), default=0.0)

    def total_work_seconds(self) -> float:
        """Sum of completed task durations (T_1) — cumulative, survives
        terminal pruning."""
        with self._lock:
            return self._total_work
