"""Pluggable scheduling policies (paper §3.1: FIFO, LIFO, locality-aware).

The scheduler owns the ready set.  Worker threads call ``take(worker)``,
which blocks until a task is available (or the runtime drains).  Policies
differ only in *which* ready task a worker receives:

* ``fifo``      — submission order (COMPSs default).
* ``lifo``      — most recently readied first (depth-first; smaller memory
                  footprint for wide fan-outs).
* ``locality``  — prefer the ready task with the most input bytes already
                  resident on the worker's node (COMPSs data-locality-aware
                  policy).  Domains follow the executor backend: one per
                  node under ``thread``, per worker process under
                  ``process``, per TCP node agent under ``cluster`` —
                  where a miss costs a real wire transfer (DESIGN.md §12).
                  Under the peer data plane (DESIGN.md §15) the store's
                  location sets reflect TRUE node residency of unfetched
                  results (``RemoteValue`` placeholders carry their home
                  node and every peer pull adds the puller's domain), so
                  the same score now steers consumers at the node that
                  physically holds the bytes — a hit costs zero wire
                  crossings, a miss one peer hop instead of a scheduler
                  relay.
                  With a per-node memory budget configured (DESIGN.md §13)
                  the policy is additionally *memory-aware*: the placement
                  score subtracts the projected input+output bytes that
                  would exceed the node's remaining budget, so tasks flow
                  to nodes with both the data and the headroom.
* ``worksteal`` — per-worker deques; owner pops LIFO, thieves steal FIFO.
                  Beyond-paper addition used for straggler mitigation.

Hot-path accounting (DESIGN.md §14): ``queue_len`` reads an incrementally
maintained counter (no per-poll deque sweep), ``push_many`` wakes exactly
as many waiters as it enqueued tasks, and the ``locality`` policy keeps a
per-node cache of placement scores that is invalidated by the store's
residency epoch (``note_location``/spill/evict) instead of rescoring the
whole window on every pop — O(1) amortized per take while residency is
stable.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, List, Optional, Tuple

from .dag import TaskGraph
from .futures import ObjectStore

# weight of the memory-overflow penalty relative to the locality score
# (which lives in [0, 1]).  > 1 so a fully-local task on a node with NO
# headroom scores below a fully-remote task on a node with room: paying
# the transfer beats spilling the node's working set.
MEMORY_PENALTY = 1.5

# locality scan window over the head of the ready queue
LOCALITY_WINDOW = 64

# score bonus for a task's hinted node (collectives pin merges where the
# larger child is resident, DESIGN.md §16).  The hint augments the
# locality fraction rather than overriding it: a hinted node that also
# holds the inputs is unbeatable, a hinted node with nothing resident
# still loses to a fully-local unhinted one only when the bonus is < 1.
HINT_BONUS = 0.75

# a per-node score cache larger than this is reset wholesale (entries for
# tasks popped by *other* nodes linger until the next residency epoch)
_SCORE_CACHE_MAX = 4096


class Scheduler:
    def __init__(
        self,
        graph: TaskGraph,
        store: ObjectStore,
        policy: str = "fifo",
        workers_per_node: int = 1,
        node_budget: Optional[int] = None,
    ):
        if policy not in ("fifo", "lifo", "locality", "worksteal"):
            raise ValueError(f"unknown scheduling policy: {policy}")
        self.policy = policy
        self.graph = graph
        self.store = store
        self.workers_per_node = max(1, workers_per_node)
        # per-node memory capacity for memory-aware placement (None =
        # unbounded: pure locality, the pre-§13 behaviour)
        self.node_budget = node_budget
        self._out_bytes: Dict[str, int] = {}   # task name -> output-size EMA
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._local_queues: Dict[int, collections.deque] = collections.defaultdict(
            collections.deque
        )
        self._qsize = 0          # incrementally-maintained total (all queues)
        # per-node locality caches: node -> (store epoch, {tid: score entry})
        self._loc_cache: Dict[int, Tuple[int, Dict[int, tuple]]] = {}
        # placement hints: task id -> preferred node (DESIGN.md §16); set
        # before the task is pushed, consumed when it is taken
        self._hints: Dict[int, int] = {}
        self._closed = False
        # ready hook (DESIGN.md §18): the async control plane sets this
        # to re-enter its dispatch pump when tasks become ready — there
        # are no dispatcher threads parked in take() to notify.  Fired
        # OUTSIDE the scheduler lock (the hook schedules loop work).
        self.on_ready: Optional[Callable[[], None]] = None

    # ------------------------------------------------------------------ admin
    def node_of(self, worker: int) -> int:
        return worker // self.workers_per_node

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def queue_len(self) -> int:
        # incrementally maintained; a bare int read is atomic under the GIL,
        # so the speculation poll never touches the scheduler lock
        return self._qsize

    def set_hint(self, task_id: int, node: int) -> None:
        """Pin a placement preference for ``task_id`` (collectives tree
        placement).  Must be called before the task is pushed; only the
        ``locality`` policy honors it — elsewhere it is inert."""
        with self._lock:
            self._hints[task_id] = node

    # ---------------------------------------------------------------- enqueue
    def push(self, task_id: int, preferred_worker: Optional[int] = None) -> None:
        with self._cond:
            if self.policy == "worksteal" and preferred_worker is not None:
                self._local_queues[preferred_worker].append(task_id)
            else:
                self._queue.append(task_id)
            self._qsize += 1
            self._cond.notify()
        cb = self.on_ready
        if cb is not None:
            cb()

    def push_many(self, task_ids: List[int]) -> None:
        if not task_ids:
            return
        with self._cond:
            self._queue.extend(task_ids)
            self._qsize += len(task_ids)
            # wake exactly as many waiters as there are new tasks: a
            # notify_all here stampedes every idle dispatcher through the
            # lock only for most to go back to sleep
            self._cond.notify(len(task_ids))
        cb = self.on_ready
        if cb is not None:
            cb()

    # ------------------------------------------------------------------- take
    def take(self, worker: int, timeout: Optional[float] = None) -> Optional[int]:
        """Blocking pop according to the policy. None => scheduler closed or
        timeout expired with nothing to run."""
        with self._cond:
            while True:
                tid = self._select(worker)
                if tid is not None:
                    self._qsize -= 1
                    self._hints.pop(tid, None)
                    return tid
                if self._closed:
                    return None
                if not self._cond.wait(timeout=timeout):
                    return None

    def _select(self, worker: int) -> Optional[int]:
        if self.policy == "fifo":
            if self._queue:
                return self._queue.popleft()
            return None
        if self.policy == "lifo":
            if self._queue:
                return self._queue.pop()
            return None
        if self.policy == "worksteal":
            own = self._local_queues[worker]
            if own:
                return own.pop()  # owner: LIFO (hot cache)
            if self._queue:
                return self._queue.popleft()
            # steal: oldest task from the longest victim queue
            victim = max(
                (q for w, q in self._local_queues.items() if w != worker and q),
                key=len,
                default=None,
            )
            if victim:
                return victim.popleft()
            return None
        return self._select_locality(worker)

    def _select_locality(self, worker: int) -> Optional[int]:
        """Pick the best-placed task in the window using the per-node score
        cache: a (task, node) pair is scored at most once per residency
        epoch, so steady-state pops only rescore what actually changed."""
        if not self._queue:
            return None
        node = self.node_of(worker)
        epoch = self.store.residency_epoch
        cached = self._loc_cache.get(node)
        if cached is None or cached[0] != epoch:
            cached = (epoch, {})
            self._loc_cache[node] = cached
        scores = cached[1]
        if len(scores) > _SCORE_CACHE_MAX:
            scores.clear()
        window = min(len(self._queue), LOCALITY_WINDOW)
        best_i, best_score = 0, float("-inf")
        for i in range(window):
            tid = self._queue[i]
            score = scores.get(tid)
            if score is None:
                score = self._placement_score(tid, node)
                scores[tid] = score
            if score > best_score:
                best_i, best_score = i, score
                if best_score >= 1.0 and not self._hints:
                    break   # fully local, no overflow — can't be beaten
                    # (an outstanding hint could still outscore this)
        self._queue.rotate(-best_i)
        tid = self._queue.popleft()
        self._queue.rotate(best_i)
        scores.pop(tid, None)
        return tid

    # ------------------------------------------------- placement scoring
    def note_output_bytes(self, name: str, nbytes: int) -> None:
        """Feed back an observed output size so projections for future
        tasks of the same name track reality (simple half-life EMA)."""
        with self._lock:
            prev = self._out_bytes.get(name)
            self._out_bytes[name] = int(nbytes) if prev is None \
                else (prev + int(nbytes)) // 2

    def _placement_score(self, task_id: int, node: int) -> float:
        """Locality score minus a memory-overflow penalty (DESIGN.md §13).

        Projected footprint of running the task on ``node`` = bytes of
        inputs *not yet resident* there (they would have to be pulled in)
        plus the projected output (EMA of past outputs of the same task
        name).  The fraction of that projection exceeding the node's
        remaining budget, weighted by :data:`MEMORY_PENALTY`, comes off
        the locality score — so tasks drift to nodes with headroom, but
        a worker with nothing better to do still makes progress (the
        budget is a gradient, not an admission check)."""
        t = self.graph.get(task_id)
        score, nonlocal_b = self._locality_score(t, node)
        if self._hints.get(task_id) == node:
            score += HINT_BONUS
        if self.node_budget:
            projected = nonlocal_b + self._out_bytes.get(t.name, 0)
            if projected > 0:
                remaining = max(0, self.node_budget - self.store.node_bytes(node))
                overflow = max(0, projected - remaining)
                score -= MEMORY_PENALTY * overflow / projected
        return score

    def _locality_score(self, t, node: int):
        """(fraction of input *bytes* already resident in this worker's
        address-space domain, non-resident input bytes).  Falls back to
        input count when sizes are unknown, e.g. scalars."""
        if not t.dep_keys:
            return 0.0, 0
        total_b = local_b = 0
        local_n = 0
        for key in t.dep_keys:
            b = self.store.nbytes(key)
            total_b += b
            if node in self.store.locations(key):
                local_n += 1
                local_b += b
        if total_b > 0:
            return local_b / total_b, total_b - local_b
        return local_n / len(t.dep_keys), 0
