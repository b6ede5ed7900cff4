"""The RJAX runtime engine — RCOMPSs' COMPSs core, reproduced (the port's
copy, trimmed to the thread backend).

One ``Runtime`` owns: the versioned object store, the dynamic task graph,
a scheduling policy, an *executor backend* holding the pool of persistent
workers (the paper's persistent-executor model: workers live for the whole
application and are reused across tasks, §3.3.2), the tracer, fault
handling, and the optional straggler-speculation monitor.

The task lifecycle is three runtime-owned phases, run synchronously by
each worker's dispatcher thread:

* :meth:`begin_task`    — claim the task (mark RUNNING) and resolve its
                          inputs from the store;
* the backend invokes the body on the dispatcher thread;
* :meth:`complete_task` / :meth:`fail_task` — publish outputs or apply
  the retry policy, release dependents, trace.

Only ``backend="thread"`` exists in this slice of the port: task bodies
share one address space, so the store can hold CUDA tensors and hand them
from task to task without a copy.  The process and cluster backends (and
with them lineage recovery of node-resident data) and the live dashboard
come with later slices.

Users normally go through :mod:`repro_torch.core.api` (``task`` /
``barrier`` / ``wait_on``), which mirrors the five-function RCOMPSs API.
"""
from __future__ import annotations

import os
import statistics
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .config import resolve as resolve_knob
from .dag import TaskGraph, TaskNode
from .executors import make_executor
from .fault import PoisonedInputError, RetryPolicy, SpeculationConfig
from .futures import Future, ObjectStore, TaskFailedError
from .memory import budget_from_env
from .scheduler import Scheduler
from .telemetry import TelemetryHub, normalize_executor_stats
from .tracing import TraceEvent, Tracer

def _walk(obj: Any, fn: Callable[[Any], Any]) -> Any:
    """Structure-preserving map over (lists, tuples, dicts); applies ``fn``
    to leaves.  Used both to collect Future deps and to substitute values."""
    if isinstance(obj, Future):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        mapped = [_walk(o, fn) for o in obj]
        if isinstance(obj, tuple):
            # namedtuples (e.g. optimizer states) take positional fields
            return type(obj)(*mapped) if hasattr(obj, "_fields") else tuple(mapped)
        return mapped
    if isinstance(obj, dict):
        return {k: _walk(v, fn) for k, v in obj.items()}
    return obj


def _nbytes(v: Any) -> int:
    if isinstance(v, np.ndarray):
        return v.nbytes
    if hasattr(v, "nbytes"):
        try:
            return int(v.nbytes)
        except Exception:
            return 0
    return 0


class TaskExecution:
    """One claimed task with resolved inputs, between ``begin_task`` and
    its completion."""

    __slots__ = ("t", "args", "kwargs", "input_keys", "t0", "t_run",
                 "worker", "node_id")

    def __init__(self, t: TaskNode, args: tuple, kwargs: dict,
                 input_keys: Dict[int, Tuple[int, int]], t0: float,
                 worker: int, node_id: int, t_run: Optional[float] = None):
        self.t = t
        self.args = args
        self.kwargs = kwargs
        self.input_keys = input_keys
        self.t0 = t0
        # inputs resolved, body about to run: t_run - t0 is the
        # fetch/stall gap the telemetry plane surfaces (DESIGN.md §17)
        self.t_run = t_run
        self.worker = worker
        self.node_id = node_id


class Runtime:
    def __init__(
        self,
        n_workers: int = 4,
        workers_per_node: Optional[int] = None,
        policy: str = "fifo",
        tracing: bool = True,
        retry: RetryPolicy = RetryPolicy(),
        speculation: SpeculationConfig = SpeculationConfig(),
        name: str = "rjax",
        backend: str = "thread",
        memory_budget: Any = None,
        spill_dir: Optional[str] = None,
        telemetry: Optional[bool] = None,
        dashboard_port: Optional[int] = None,
        deadline_s: Optional[float] = None,
        resolve_timeout_s: Optional[float] = None,
        **later_backend_opts: Any,
    ):
        # ``later_backend_opts`` are the RuntimeConfig knobs only the
        # process/cluster backends read (cluster, n_agents, pipeline_depth,
        # control_plane, inline_max, heartbeat_s, p2p, liveness,
        # suspicion_s, reconnect_grace_s, replication); those backends are
        # not ported yet, so setting one is an error, not a silent no-op
        pinned = sorted(k for k, v in later_backend_opts.items() if v is not None)
        if pinned:
            raise ValueError(
                f"knob(s) {', '.join(pinned)} configure the process/cluster "
                f"backends, which the port does not have yet")
        # memory governance (DESIGN.md §13): explicit knob beats
        # RJAX_MEMORY_BUDGET; None/0 = unbounded.  Only host ndarrays are
        # governed: device tensors in the store are never spilled.
        self.memory_budget = budget_from_env(memory_budget)
        self.spill_dir = spill_dir
        # fault-tolerance knobs (DESIGN.md §19): how long a dispatch may
        # wait for an input datum, and the default per-task deadline
        # (per-call submit(deadline_s=) overrides)
        self.resolve_timeout_s = resolve_knob(
            resolve_timeout_s, "RJAX_RESOLVE_TIMEOUT_S", None, 30.0, float)
        self.default_deadline_s = resolve_knob(
            deadline_s, "RJAX_DEADLINE_S", None, None, float)
        self.n_workers = int(n_workers)
        self.backend = backend
        if dashboard_port is None:
            env_dash = os.environ.get("RJAX_DASHBOARD", "")
            dashboard_port = int(env_dash) if env_dash != "" else None
        if dashboard_port is not None:
            raise NotImplementedError(
                "the live dashboard is not ported yet (it comes with a later "
                "slice of the port); leave dashboard_port / RJAX_DASHBOARD unset")
        # live telemetry plane (DESIGN.md §17): ring hooks follow the
        # tracing flag unless asked for explicitly
        telemetry_on = bool(tracing) if telemetry is None else bool(telemetry)
        # sampler thread only when telemetry was requested explicitly —
        # plain traced runs keep their thread count unchanged
        want_sampler = bool(telemetry)
        if workers_per_node is None:
            # threads all share one address space => one locality domain
            workers_per_node = self.n_workers
        self.workers_per_node = workers_per_node
        self.store = ObjectStore()
        self.store.configure_memory(self.memory_budget, spill_dir=self.spill_dir)
        self.graph = TaskGraph()
        self.scheduler = Scheduler(
            self.graph, self.store, policy=policy,
            workers_per_node=self.workers_per_node,
            node_budget=self.memory_budget,
        )
        self.tracer = Tracer(enabled=tracing)
        self.telemetry = TelemetryHub(enabled=telemetry_on)
        self.retry = retry
        self.speculation = speculation
        self.name = name

        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._inflight_cond = threading.Condition(self._inflight_lock)
        self._logical_done: Dict[int, bool] = {}   # speculation once-flags
        self._logical_lock = threading.Lock()
        self._idle_workers = self.n_workers
        self._stopped = False

        self.executor = make_executor(backend, self.n_workers, label=name)
        self.executor.start(self)

        if self.telemetry.enabled and want_sampler:
            # no agents to heartbeat: an in-process sampler synthesizes
            # the per-node view instead
            self.telemetry.start_sampler(self)

        self._monitor: Optional[threading.Thread] = None
        if self.speculation.enabled:
            self._monitor = threading.Thread(target=self._speculation_loop, daemon=True,
                                             name=f"{name}-spec")
            self._monitor.start()

    # ----------------------------------------------------------- worker hooks
    def locality_domain(self, worker: int) -> int:
        """The address-space/NUMA domain of ``worker`` for locality scoring."""
        return worker // self.workers_per_node

    def _note_worker_busy(self) -> None:
        with self._inflight_lock:
            self._idle_workers -= 1

    def _note_worker_idle(self) -> None:
        with self._inflight_lock:
            self._idle_workers += 1

    # ------------------------------------------------------------- submission
    def submit(
        self,
        fn: Callable,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        *,
        name: Optional[str] = None,
        returns: int = 1,
        max_retries: Optional[int] = None,
        priority: int = 0,
        speculatable: bool = True,
        inout: Sequence[Future] = (),
        placement_hint: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ):
        """Submit one asynchronous task; returns ``returns`` Future(s).

        ``deadline_s`` bounds the task body's running time (DESIGN.md
        §19): an attempt running longer has its worker killed and fails
        retryable.  Defaults to ``runtime_start(deadline_s=)`` /
        ``RJAX_DEADLINE_S``; ``None`` = unbounded.

        ``inout`` lists argument Futures the task semantically *updates*: the
        runtime bumps their datum version (COMPSs renaming) so later readers
        depend on this task's output — the Future objects are re-pointed at
        the new version and the task's extra return values (beyond
        ``returns``) provide the new contents, in ``inout`` order.

        ``placement_hint`` names the node the task would prefer to run on
        (collectives pin merges where the larger child lives, DESIGN.md
        §16); only the ``locality`` policy acts on it.
        """
        if self._stopped:
            raise RuntimeError("runtime is stopped")
        kwargs = kwargs or {}
        tid = self.graph.next_task_id()
        tname = name or getattr(fn, "__name__", "task")

        dep_keys = set()

        def _collect(f: Future):
            dep_keys.add(f.key)
            # snapshot: INOUT renaming mutates the caller's handle later;
            # the task must keep reading the version it was submitted with
            return Future(f.data_id, f.version, f.producer_task, self.store)

        args = _walk(args, _collect)
        kwargs = _walk(kwargs, _collect)

        out_futures: List[Future] = []
        out_keys: List[Tuple[int, int]] = []
        for _ in range(returns):
            did = self.store.new_data_id()
            f = Future(did, 1, tid, self.store)
            out_futures.append(f)
            out_keys.append(f.key)
        # INOUT renaming: new version of an existing datum
        for f in inout:
            if f.key not in dep_keys:
                raise ValueError("inout future must also be passed as an argument")
            new_v = f.version + 1
            out_keys.append((f.data_id, new_v))
            # re-point the caller's handle at the new version; tasks already
            # submitted captured the old (data_id, version) key.
            f.version = new_v
            f.producer_task = tid

        node = TaskNode(
            task_id=tid, name=tname, fn=fn, args=args, kwargs=kwargs,
            dep_keys=dep_keys, out_keys=out_keys,
            max_retries=self.retry.max_retries if max_retries is None else max_retries,
            priority=priority, speculatable=speculatable,
            deadline_s=(self.default_deadline_s if deadline_s is None
                        else float(deadline_s)),
        )
        with self._inflight_cond:
            self._inflight += 1
        # hint before add_task: the task may be immediately ready and taken
        # by a dispatcher the instant push_many releases it
        if placement_hint is not None:
            self.scheduler.set_hint(tid, placement_hint)
        if self.telemetry.enabled:
            self.telemetry.note_submit([{"task": tid, "name": tname}])
        ready = self.graph.add_task(node)
        self.scheduler.push_many(ready)
        if returns == 1 and not inout:
            return out_futures[0]
        return tuple(out_futures) if returns > 1 else out_futures[0] if out_futures else None

    def submit_many(
        self,
        fn: Callable,
        args_list: Sequence[tuple],
        *,
        name: Optional[str] = None,
        returns: int = 1,
        max_retries: Optional[int] = None,
        priority: int = 0,
        speculatable: bool = True,
        deadline_s: Optional[float] = None,
    ) -> List[Any]:
        """Fan-out submission: one task per entry of ``args_list`` (each a
        tuple of positional arguments), amortizing the per-task graph,
        store and in-flight locking over the whole batch (DESIGN.md §14).
        Returns one Future (or tuple of Futures when ``returns > 1``) per
        entry, in order.  Semantically identical to calling :meth:`submit`
        in a loop; INOUT parameters are not supported here."""
        if self._stopped:
            raise RuntimeError("runtime is stopped")
        args_list = list(args_list)
        if not args_list:
            return []
        tname = name or getattr(fn, "__name__", "task")
        n = len(args_list)
        tids = self.graph.next_task_ids(n)
        dids = iter(self.store.new_data_ids(n * returns))
        max_r = self.retry.max_retries if max_retries is None else max_retries
        dl = self.default_deadline_s if deadline_s is None else float(deadline_s)

        nodes: List[TaskNode] = []
        futures_out: List[Any] = []
        for tid, raw_args in zip(tids, args_list):
            dep_keys: set = set()

            def _collect(f: Future, _deps=dep_keys):
                _deps.add(f.key)
                return Future(f.data_id, f.version, f.producer_task, self.store)

            args = _walk(tuple(raw_args), _collect)
            out_futures = [Future(next(dids), 1, tid, self.store)
                           for _ in range(returns)]
            nodes.append(TaskNode(
                task_id=tid, name=tname, fn=fn, args=args, kwargs={},
                dep_keys=dep_keys,
                out_keys=[f.key for f in out_futures],
                max_retries=max_r, priority=priority,
                speculatable=speculatable, deadline_s=dl,
            ))
            futures_out.append(out_futures[0] if returns == 1
                               else tuple(out_futures))
        with self._inflight_cond:
            self._inflight += n
        if self.telemetry.enabled:
            self.telemetry.note_submit(
                [{"task": nd.task_id, "name": tname} for nd in nodes])
        ready = self.graph.add_tasks(nodes)
        self.scheduler.push_many(ready)
        return futures_out

    # ------------------------------------------------------- input resolution
    def _resolve_inputs(self, t: TaskNode, node_id: int
                        ) -> Tuple[tuple, dict, Dict[int, Tuple[int, int]]]:
        nbytes_in = 0
        input_keys: Dict[int, Tuple[int, int]] = {}

        def _fetch(f: Future):
            nonlocal nbytes_in
            try:
                v = self.store.get_nowait(f.key)
            except KeyError:
                # value arrived concurrently: block briefly
                v = self.store.get(f.key, timeout=self.resolve_timeout_s)
            except BaseException as err:
                raise PoisonedInputError(f.producer_task, err) from err
            nbytes_in += _nbytes(v)
            self.store.note_location(f.key, node_id)
            input_keys[id(v)] = f.key
            return v

        args = _walk(t.args, _fetch)
        kwargs = _walk(t.kwargs, _fetch)
        t.nbytes_in = nbytes_in
        return args, kwargs, input_keys

    # --------------------------------------------------------- task lifecycle
    def begin_task(self, tid: int, worker: int, node_id: int
                   ) -> Optional[TaskExecution]:
        """Claim ``tid`` and resolve its inputs.  Returns ``None`` when the
        task was cancelled before start (lost speculation race) or input
        resolution already completed it (poisoned input / resolve error) —
        in both cases no completion call must follow."""
        t = self.graph.claim_running(tid, worker, node_id)
        if t is None:
            return None  # cancelled before start (lost speculation race)
        t0 = time.perf_counter()
        if self.telemetry.enabled:
            self.telemetry.note_dispatch(t.task_id, t.name, worker,
                                         node_id, t0)
        try:
            args, kwargs, input_keys = self._resolve_inputs(t, node_id)
        except PoisonedInputError as err:
            self._finish_failure(t, err, retryable=False)
            self._trace_task(t, worker, node_id, t0, ok=False)
            return None
        except BaseException as err:
            self._handle_task_error(t, err, worker, node_id, t0)
            return None
        return TaskExecution(t, args, kwargs, input_keys, t0, worker, node_id,
                             t_run=time.perf_counter())

    def complete_task(self, ex: TaskExecution, result: Any) -> None:
        """Successful body execution: publish outputs, release children."""
        self._finish_success(ex.t, result, ex.node_id)
        self._trace_task(ex.t, ex.worker, ex.node_id, ex.t0, ok=True,
                         t_run=ex.t_run)

    def fail_task(self, ex: TaskExecution, err: BaseException) -> None:
        """Body execution raised: apply the retry policy or fail."""
        if isinstance(err, PoisonedInputError):
            self._finish_failure(ex.t, err, retryable=False)
            self._trace_task(ex.t, ex.worker, ex.node_id, ex.t0, ok=False,
                             t_run=ex.t_run)
            return
        self._handle_task_error(ex.t, err, ex.worker, ex.node_id, ex.t0,
                                t_run=ex.t_run)

    def _handle_task_error(self, t: TaskNode, err: BaseException,
                           worker: int, node_id: int, t0: float,
                           t_run: Optional[float] = None) -> None:
        if self.retry.should_retry(t.attempts, t.max_retries, err):
            # one unified backoff policy (DESIGN.md §19): exponential in
            # the attempt number with bounded jitter
            backoff = self.retry.delay_for(t.attempts)
            if backoff:
                # a timer, not a sleep: the dispatcher thread goes straight
                # back to other ready tasks
                timer = threading.Timer(backoff,
                                        self._requeue_retry, args=(t.task_id,))
                timer.daemon = True
                timer.start()
            else:
                self._requeue_retry(t.task_id)
            self._trace_task(t, worker, node_id, t0, ok=False, retried=True,
                             t_run=t_run)
            return
        self._finish_failure(t, err, retryable=True)
        self._trace_task(t, worker, node_id, t0, ok=False, t_run=t_run)

    def _requeue_retry(self, task_id: int) -> None:
        self.graph.requeue_for_retry(task_id)
        self.scheduler.push(task_id)

    def _execute(self, tid: int, worker: int, node_id: int) -> None:
        """Synchronous task lifecycle, run on the dispatcher thread."""
        ex = self.begin_task(tid, worker, node_id)
        if ex is None:
            return
        try:
            result = self.executor.invoke(worker, ex.t.fn, ex.args, ex.kwargs,
                                          input_keys=ex.input_keys)
        except BaseException as err:
            self.fail_task(ex, err)
            return
        self.complete_task(ex, result)

    def _trace_task(self, t: TaskNode, worker: int, node_id: int, t0: float,
                    ok: bool, retried: bool = False,
                    t_run: Optional[float] = None) -> None:
        t1 = time.perf_counter()
        self.tracer.record(TraceEvent(
            kind="task", name=t.name, worker=worker, node=node_id,
            t0=t0, t1=t1, task_id=t.task_id,
            meta={"ok": ok, "retried": retried, "attempt": t.attempts,
                  "speculative_of": t.speculative_of},
        ))
        if self.telemetry.enabled:
            self.telemetry.note_task(t.task_id, t.name, worker, node_id,
                                     t0, t_run, t1, ok, retried)

    # ------------------------------------------------------- completion paths
    def _logical_id(self, t: TaskNode) -> int:
        return t.speculative_of if t.speculative_of is not None else t.task_id

    def _claim_completion(self, t: TaskNode) -> bool:
        lid = self._logical_id(t)
        with self._logical_lock:
            if self._logical_done.get(lid):
                return False
            self._logical_done[lid] = True
            return True

    def _put_output(self, key: Tuple[int, int], value: Any, node_id: int) -> None:
        self.store.put(key, value, node=node_id)
        self.executor.publish(key, value)

    def _finish_success(self, t: TaskNode, result: Any, node_id: int) -> None:
        try:
            primary = self.graph.get(self._logical_id(t))
        except KeyError:
            # the logical task was pruned long after completion (graph
            # retention) — this can only be a very late clone: discard
            self.graph.mark_cancelled(t.task_id)
            self._dec_inflight(t)
            return
        if not self._claim_completion(t):
            # lost the speculation race — discard
            self.graph.mark_cancelled(t.task_id)
            self._dec_inflight(t)
            return
        out_keys = primary.out_keys
        if len(out_keys) == 0:
            pass
        elif len(out_keys) == 1:
            self._put_output(out_keys[0], result, node_id)
        else:
            if not isinstance(result, (tuple, list)) or len(result) != len(out_keys):
                err = TypeError(
                    f"task {primary.name} declared {len(out_keys)} outputs but "
                    f"returned {type(result).__name__}"
                )
                self._publish_failure(primary, err)
                if t.task_id != primary.task_id:
                    self.graph.mark_cancelled(t.task_id)
                self._dec_inflight(t)
                return
            for key, val in zip(out_keys, result):
                self._put_output(key, val, node_id)
        if out_keys:
            # observed output footprint feeds memory-aware placement
            self.scheduler.note_output_bytes(
                primary.name, sum(self.store.nbytes(k) for k in out_keys))
        ready = self.graph.mark_done(primary.task_id)
        if t.task_id != primary.task_id:
            # speculative clone won: record clone done too
            self.graph.mark_done(t.task_id)
        self.scheduler.push_many(ready)
        self._dec_inflight(t)

    def _publish_failure(self, primary: TaskNode, err: BaseException) -> None:
        wrapped = TaskFailedError(primary.name, primary.task_id, err)
        for key in primary.out_keys:
            self.store.put_error(key, wrapped)
        ready = self.graph.mark_failed(primary.task_id, err)
        self.scheduler.push_many(ready)

    def _finish_failure(self, t: TaskNode, err: BaseException, retryable: bool) -> None:
        try:
            primary = self.graph.get(self._logical_id(t))
        except KeyError:
            self.graph.mark_cancelled(t.task_id)
            self._dec_inflight(t)
            return
        if not self._claim_completion(t):
            self.graph.mark_cancelled(t.task_id)
            self._dec_inflight(t)
            return
        self._publish_failure(primary, err)
        if t.task_id != primary.task_id:
            self.graph.mark_cancelled(t.task_id)
        self._dec_inflight(t)

    def _dec_inflight(self, t: TaskNode) -> None:
        with self._inflight_cond:
            self._inflight -= 1
            if self._inflight <= 0:
                self._inflight_cond.notify_all()

    # ------------------------------------------------------------ speculation
    def _speculation_loop(self) -> None:
        cfg = self.speculation
        while not self._stopped:
            time.sleep(cfg.poll_interval)
            if self.scheduler.queue_len() > 0:
                continue
            # indexed scans (DESIGN.md §14): the running set and the
            # bounded per-name duration history replace the full-graph walk
            running = self.graph.running_nodes()
            if not running:
                continue
            # idle capacity = workers with NOTHING in flight.  (The
            # _idle_workers counter decrements once per in-flight task, so
            # under pipeline_depth > 1 it goes negative while half the
            # pool sits idle — it cannot gate speculation.)
            busy_workers = {n.worker for n in running}
            if len(busy_workers) >= self.n_workers:
                continue
            now = time.perf_counter()
            for n in running:
                if not n.speculatable or n.speculative_of is not None:
                    continue
                ds = self.graph.done_durations(n.name)
                if len(ds) < cfg.min_samples:
                    continue
                med = statistics.median(ds)
                run_t = now - n.start_t
                if run_t < cfg.min_seconds or run_t < cfg.factor * med:
                    continue
                with self._logical_lock:
                    if self._logical_done.get(n.task_id):
                        continue
                    already = getattr(n, "_speculated", False)
                if already:
                    continue
                n._speculated = True  # type: ignore[attr-defined]
                clone_id = self.graph.next_task_id()
                clone = TaskNode(
                    task_id=clone_id, name=n.name + "(spec)", fn=n.fn,
                    args=n.args, kwargs=n.kwargs, dep_keys=set(n.dep_keys),
                    out_keys=[], speculative_of=n.task_id, speculatable=False,
                )
                with self._inflight_cond:
                    self._inflight += 1
                ready = self.graph.add_task(clone)
                self.scheduler.push_many(ready)

    # --------------------------------------------------------- sync primitives
    def barrier(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted task reached a terminal state
        (paper's ``compss_barrier``)."""
        with self._inflight_cond:
            if not self._inflight_cond.wait_for(lambda: self._inflight <= 0,
                                                timeout=timeout):
                raise TimeoutError(f"barrier timed out with {self._inflight} tasks inflight")

    def wait_on(self, obj: Any, timeout: Optional[float] = None) -> Any:
        """Synchronize: resolve Future(s) (paper's ``compss_wait_on``).
        Accepts a Future or any nesting of lists/tuples/dicts of Futures."""
        return _walk(obj, lambda f: f.result(timeout=timeout))

    def stop(self, wait: bool = True) -> None:
        """``compss_stop``: optionally drain, then shut the pool down.
        Idempotent — a second call (e.g. explicit ``runtime_stop``
        followed by the context manager's exit) is a no-op."""
        if self._stopped:
            return
        if wait:
            self.barrier()
        self._stopped = True
        self.telemetry.close()
        self.scheduler.close()
        self.executor.shutdown(wait=wait)
        self.tracer.stop()
        self.store.dispose_spills()

    # ---------------------------------------------------------- with-statement
    def __enter__(self) -> "Runtime":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """Guaranteed teardown for ``with runtime_start(...) as rt:`` —
        drain on the clean path, tear down immediately (no barrier) when
        the body raised.  Also clears the module-level current runtime
        if this instance is still it."""
        from . import api
        api._release_runtime(self, wait=exc_type is None)

    # --------------------------------------------------------------- metrics
    def stats(self) -> dict:
        c = self.graph.counters()   # O(1): incrementally maintained
        # uniform schema across backends (DESIGN.md §17): every canonical
        # executor counter present, 0 where the backend has no such concept
        ex_stats = normalize_executor_stats(self.executor.stats())
        data_plane = self.store.transfer_detail()
        return {
            "tasks_submitted": c["submitted"],
            "tasks_done": c["done"],
            "tasks_failed": c["failed"],
            "tasks_cancelled": c["cancelled"],
            "retries": c["retries"],
            "speculative": c["speculative"],
            "total_work_s": c["total_work_s"],
            "critical_path_s": self.graph.critical_path_seconds(),
            "wallclock_s": self.tracer.wallclock(),
            "utilization": self.tracer.utilization(self.n_workers),
            "scheduler_relay_bytes": data_plane["scheduler_relay_bytes"],
            "p2p_bytes": data_plane["p2p_bytes"],
            "data_plane": data_plane,
            "executor": ex_stats,
            "memory": self.store.memory_stats(),
        }
