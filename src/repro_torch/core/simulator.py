"""Calibrated discrete-event simulator for scaling studies (the port's
copy of the JAX package's simulator, unchanged in behaviour).

The paper's evaluation (Figs. 6-9) is wall-clock weak/strong scaling on two
supercomputers.  One card cannot show a many-core node's speedup, so the
port, like the reference, *replays the very same task DAGs* under a
virtual machine model:

* N nodes × W workers, greedy list scheduling (same policies as the real
  scheduler);
* per-task durations from cost models **calibrated against real measured
  executions** of the task functions (``algorithms/*.calibrate``; on the
  card each timed call is bracketed by ``torch.cuda.synchronize``, so a
  duration is the task's device work, not its launch);
* a transport model — crossing nodes costs ``latency + bytes/bandwidth`` plus
  serialize/deserialize at the measured codec throughput (paper §3.3.3);
* a master dispatch overhead per task — the serial component that produces
  the paper's efficiency roll-off at high core counts.

A projection from card-calibrated costs is a projection, not a measurement
of a many-core node.  The simulator is property-tested against classic
scheduling bounds: for zero transport/dispatch overhead a greedy schedule
satisfies ``max(T1/P, T∞) ≤ T_P ≤ T1/P + T∞`` (Graham).
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class SimTask:
    tid: int
    name: str
    duration: float               # seconds of pure compute
    deps: Tuple[int, ...] = ()
    out_bytes: int = 0


@dataclass
class MachineModel:
    n_nodes: int = 1
    workers_per_node: int = 1
    # transport (paper §3.3.3: file-based parameter passing between spaces)
    bandwidth_Bps: float = 12.5e9        # ~100 Gb/s interconnect
    latency_s: float = 25e-6
    ser_Bps: Optional[float] = 2e9       # codec throughput (raw codec measured)
    intranode_free: bool = True          # same-node hand-off is by reference
    dispatch_overhead_s: float = 0.0     # serial master cost per task launch
    worker_init_s: float = 0.0           # per-worker startup (paper §5.4:
                                         # slow worker init hurt MareNostrum)

    @property
    def n_workers(self) -> int:
        return self.n_nodes * self.workers_per_node


@dataclass
class ScheduledTask:
    tid: int
    name: str
    worker: int
    node: int
    start: float
    transfer: float
    end: float


@dataclass
class SimResult:
    makespan: float
    total_work: float
    critical_path: float
    n_workers: int
    schedule: List[ScheduledTask] = field(default_factory=list)
    transfer_total: float = 0.0

    @property
    def speedup(self) -> float:
        return self.total_work / self.makespan if self.makespan > 0 else 0.0

    @property
    def efficiency(self) -> float:
        return self.speedup / self.n_workers if self.n_workers else 0.0


def critical_path(tasks: Sequence[SimTask]) -> float:
    by_id = {t.tid: t for t in tasks}
    memo: Dict[int, float] = {}

    def depth(tid: int) -> float:
        if tid in memo:
            return memo[tid]
        t = by_id[tid]
        memo[tid] = t.duration + max((depth(d) for d in t.deps), default=0.0)
        return memo[tid]

    # iterative topological accumulation to avoid recursion limits
    order = _topo_order(tasks)
    for tid in order:
        t = by_id[tid]
        memo[tid] = t.duration + max((memo[d] for d in t.deps), default=0.0)
    return max(memo.values(), default=0.0)


def _topo_order(tasks: Sequence[SimTask]) -> List[int]:
    indeg = {t.tid: len(t.deps) for t in tasks}
    children: Dict[int, List[int]] = {t.tid: [] for t in tasks}
    for t in tasks:
        for d in t.deps:
            children[d].append(t.tid)
    q = deque(sorted(tid for tid, k in indeg.items() if k == 0))
    order = []
    while q:
        tid = q.popleft()
        order.append(tid)
        for c in children[tid]:
            indeg[c] -= 1
            if indeg[c] == 0:
                q.append(c)
    if len(order) != len(tasks):
        raise ValueError("cycle in task graph")
    return order


def simulate(
    tasks: Sequence[SimTask],
    machine: MachineModel,
    policy: str = "fifo",
) -> SimResult:
    """Greedy event-driven list scheduling of ``tasks`` on ``machine``."""
    by_id = {t.tid: t for t in tasks}
    if len(by_id) != len(tasks):
        raise ValueError("duplicate task ids")
    indeg = {t.tid: len(t.deps) for t in tasks}
    children: Dict[int, List[int]] = {t.tid: [] for t in tasks}
    for t in tasks:
        for d in t.deps:
            if d not in by_id:
                raise ValueError(f"task {t.tid} depends on unknown {d}")
            children[d].append(t.tid)

    ready: deque = deque(sorted(tid for tid, k in indeg.items() if k == 0))
    data_loc: Dict[int, set] = {}
    idle: List[int] = list(range(machine.n_workers))
    events: List[Tuple[float, int, int, int]] = []   # (time, seq, tid, worker)
    seq = itertools.count()
    master_free = 0.0
    schedule: List[ScheduledTask] = []
    transfer_total = 0.0
    done_t: Dict[int, float] = {}

    def node_of(w: int) -> int:
        return w // machine.workers_per_node

    def transfer_cost(t: SimTask, node: int) -> float:
        cost = 0.0
        for d in t.deps:
            locs = data_loc.get(d, set())
            if machine.intranode_free and node in locs:
                continue
            nbytes = by_id[d].out_bytes
            if nbytes <= 0:
                continue
            cost += machine.latency_s + nbytes / machine.bandwidth_Bps
            if machine.ser_Bps:
                cost += 2.0 * nbytes / machine.ser_Bps  # serialize + deserialize
            locs = data_loc.setdefault(d, set())
            locs.add(node)
        return cost

    def pick(worker: int) -> Optional[int]:
        if not ready:
            return None
        if policy == "lifo":
            return ready.pop()
        if policy == "locality":
            node = node_of(worker)
            best_i, best = 0, -1.0
            for i, tid in enumerate(ready):
                t = by_id[tid]
                if not t.deps:
                    score = 0.0
                else:
                    score = sum(1.0 for d in t.deps if node in data_loc.get(d, ()))
                    score /= len(t.deps)
                if score > best:
                    best_i, best = i, score
            ready.rotate(-best_i)
            tid = ready.popleft()
            ready.rotate(best_i)
            return tid
        return ready.popleft()  # fifo

    now = 0.0

    def try_assign(now: float) -> float:
        nonlocal master_free, transfer_total
        while idle and ready:
            w = idle.pop(0)
            tid = pick(w)
            t = by_id[tid]
            start = now
            if machine.dispatch_overhead_s > 0:
                start = max(start, master_free)
                master_free = start + machine.dispatch_overhead_s
                start = master_free
            tr = transfer_cost(t, node_of(w))
            if machine.worker_init_s > 0:
                start = max(start, machine.worker_init_s)
            end = start + tr + t.duration
            transfer_total += tr
            schedule.append(ScheduledTask(tid, t.name, w, node_of(w), start, tr, end))
            heapq.heappush(events, (end, next(seq), tid, w))
        return master_free

    try_assign(0.0)
    while events:
        now, _, tid, w = heapq.heappop(events)
        done_t[tid] = now
        data_loc.setdefault(tid, set()).add(node_of(w))
        for c in children[tid]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
        idle.append(w)
        idle.sort()
        try_assign(now)

    if len(done_t) != len(tasks):
        raise RuntimeError("simulation dead-locked (graph not fully executed)")

    total_work = sum(t.duration for t in tasks)
    return SimResult(
        makespan=now,
        total_work=total_work,
        critical_path=critical_path(tasks),
        n_workers=machine.n_workers,
        schedule=schedule,
        transfer_total=transfer_total,
    )


# --------------------------------------------------------------- calibration
class CostModel:
    """Affine cost model ``seconds = a + b * units`` fitted from measured
    (units, seconds) samples of real task executions (least squares)."""

    def __init__(self, a: float, b: float, name: str = ""):
        self.a = max(0.0, a)
        self.b = max(0.0, b)
        self.name = name

    def __call__(self, units: float) -> float:
        return self.a + self.b * units

    @classmethod
    def fit(cls, samples: Sequence[Tuple[float, float]], name: str = "") -> "CostModel":
        if len(samples) == 1:
            u, s = samples[0]
            return cls(0.0, s / max(u, 1e-12), name)
        import numpy as np

        us = np.array([u for u, _ in samples], dtype=np.float64)
        ts = np.array([t for _, t in samples], dtype=np.float64)
        A = np.stack([np.ones_like(us), us], axis=1)
        coef, *_ = np.linalg.lstsq(A, ts, rcond=None)
        return cls(float(coef[0]), float(coef[1]), name)


def replay_graph(graph, default_bytes: int = 0) -> List[SimTask]:
    """Convert a *measured* runtime TaskGraph into SimTasks (durations =
    observed durations), so a real small-scale run can be re-scheduled on a
    virtual large machine.

    On the card a task's observed duration is host time around a body
    that launches work asynchronously: device time is charged to
    whichever task synchronises (reads a value back), not to the task
    that queued it."""
    from .dag import TaskState

    nodes = [n for n in graph.nodes() if n.speculative_of is None]
    keep = {n.task_id for n in nodes if n.state == TaskState.DONE}
    producer: Dict[Tuple[int, int], int] = {}
    for n in nodes:
        for key in n.out_keys:
            producer[key] = n.task_id
    out = []
    for n in nodes:
        if n.task_id not in keep:
            continue
        deps = tuple(sorted({producer[k] for k in n.dep_keys
                             if k in producer and producer[k] in keep}))
        out.append(SimTask(n.task_id, n.name, n.duration, deps,
                           out_bytes=default_bytes or n.nbytes_in))
    return out
