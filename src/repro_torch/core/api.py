"""The RCOMPSs user-facing API, reproduced (paper §3.2).

The paper exposes five functions; we keep the names (aliased) plus the
pythonic spellings used throughout this repo:

==========================  =============================
paper (R)                   here (Python)
==========================  =============================
``compss_start()``          ``runtime_start()``
``task(f, ...)``            ``task(f, ...)`` (also usable as decorator)
``compss_barrier()``        ``barrier()``
``compss_wait_on(x)``       ``wait_on(x)``
``compss_stop()``           ``runtime_stop()``
==========================  =============================

Example (the paper's Fig. 2 program, see examples/quickstart.py)::

    from repro_torch.core import api

    def add(x, y):
        return x + y

    api.runtime_start(n_workers=4)
    add_t = api.task(add)
    res1 = add_t(4, 5)
    res2 = add_t(6, 7)
    res3 = add_t(res1, res2)          # dependency discovered automatically
    print(api.wait_on(res3))          # -> 22
    api.runtime_stop()
"""
from __future__ import annotations

import functools
import threading
from typing import Any, Callable, Iterable, List, Optional

from .config import RuntimeConfig
from .fault import RetryPolicy, SpeculationConfig
from .runtime import Runtime

_lock = threading.Lock()
_runtime: Optional[Runtime] = None


def runtime_start(n_workers: Optional[int] = None, *,
                  config: Optional[RuntimeConfig] = None,
                  **kwargs: Any) -> Runtime:
    """Initialize the global runtime (``compss_start``).

    Configuration is one :class:`repro_torch.core.config.RuntimeConfig`
    (DESIGN.md §18): pass ``config=RuntimeConfig(...)``, plain keyword
    arguments, or both — explicit kwargs override the config object, and
    unset knobs fall through env vars to the built-in defaults under the
    one documented precedence rule (explicit > env > default).  The
    returned runtime is a context manager::

        with api.runtime_start(backend="cluster", n_agents=2) as rt:
            ...                       # runtime_stop guaranteed on exit

    ``backend`` selects the executor model (see
    :mod:`repro_torch.core.executors`): ``"thread"`` runs task bodies on
    the dispatcher threads in this address space, so task results may be
    CUDA tensors that stay on the device from task to task; ``"process"``
    runs them in persistent worker processes behind a shared-memory
    object plane (the paper's per-node worker architecture, §3.3.2),
    each worker its own CUDA context.  The port's pools *spawn* by
    default (``mp_context`` / ``RJAX_MP_CONTEXT``; ``"fork"`` raises once
    this process has initialised CUDA).  ``"cluster"`` runs them on real
    TCP node agents (``n_agents`` x ``workers_per_node``; a
    ``LocalCluster`` on localhost unless ``cluster=`` is given), each
    with its own spawned pool: tensors cross the wire as host bytes, the
    agents never touch the card, node-resident results move agent to
    agent, and a lost node's results are re-executed from lineage.

    ``memory_budget`` bounds every object plane (DESIGN.md §13): e.g.
    ``"256M"`` or ``2**30``; cold host arrays past the high watermark
    spill to mmap-codec files and fault back transparently on the next
    read.  Defaults to ``RJAX_MEMORY_BUDGET``; ``None``/``0`` =
    unbounded.

    ``pipeline_depth`` bounds the in-flight task messages per worker on
    the process backend (DESIGN.md §14): depth 1 is stop-and-wait,
    higher depths overlap dispatch with remote execution.  Defaults to
    ``RJAX_PIPELINE_DEPTH`` (4).

    ``tracing`` (on by default) keeps the task tracer
    (``runtime.tracer``): one event per task attempt with its lifecycle
    stamps and the body's child spans, for the Paraver / Chrome exports.
    ``telemetry`` toggles the live telemetry plane (DESIGN.md §17): the
    bounded task-lifecycle ring behind ``/api/tasks`` and the sampler.
    It is off unless ``telemetry=True`` or a dashboard asks for it; the
    tracer does not turn it on.  ``dashboard_port`` serves the
    zero-dependency live dashboard on ``127.0.0.1:<port>`` (``0`` = pick
    an ephemeral port, read it back from ``runtime.dashboard.url``;
    implies ``telemetry=True``); ``RJAX_DASHBOARD=<port>`` does the same
    from the environment."""
    global _runtime
    cfg = config if config is not None else RuntimeConfig()
    if n_workers is not None:
        kwargs = dict(kwargs, n_workers=n_workers)
    cfg = cfg.merged(**kwargs)   # kwargs > config; unknown kwarg raises
    with _lock:
        if _runtime is not None and not _runtime._stopped:
            raise RuntimeError("runtime already started; call runtime_stop() first")
        _runtime = Runtime(
            retry=RetryPolicy(max_retries=cfg.resolved("max_retries"),
                              backoff_seconds=cfg.resolved("retry_backoff_s")),
            speculation=SpeculationConfig(
                enabled=cfg.resolved("speculation"),
                factor=cfg.resolved("speculation_factor")),
            **cfg.runtime_kwargs(),
        )
        return _runtime


def current_runtime() -> Runtime:
    if _runtime is None or _runtime._stopped:
        raise RuntimeError("runtime not started; call runtime_start() first")
    return _runtime


def runtime_stats() -> dict:
    """Live statistics of the running runtime: task counters, wallclock/
    utilization, the memory ledger, and the data-plane split —
    ``scheduler_relay_bytes`` (bytes that crossed the scheduler's own
    link) vs ``p2p_bytes`` (bytes moved directly between node agents,
    attributed per source node under ``data_plane.p2p_by_source``;
    DESIGN.md §15)."""
    return current_runtime().stats()


def runtime_stop(wait: bool = True) -> dict:
    """Drain and shut down (``compss_stop``); returns run statistics."""
    global _runtime
    with _lock:
        rt = _runtime
        if rt is None:
            return {}
        rt.stop(wait=wait)
        stats = rt.stats()
        _runtime = None
        return stats


def _release_runtime(rt: Runtime, wait: bool = True) -> None:
    """``Runtime.__exit__``'s half of ``runtime_stop``: stop ``rt``
    (idempotent — an explicit ``runtime_stop()`` inside the ``with``
    body already did it) and clear the module-level current runtime if
    this instance is still it."""
    global _runtime
    with _lock:
        try:
            rt.stop(wait=wait)
        finally:
            if _runtime is rt:
                _runtime = None


class TaskFunction:
    """A function registered as an RCOMPSs task.  Calling it submits an
    asynchronous task and returns Future(s) instead of running inline."""

    def __init__(self, fn: Callable, *, returns: int = 1, name: Optional[str] = None,
                 max_retries: Optional[int] = None, priority: int = 0,
                 speculatable: bool = True, deadline_s: Optional[float] = None):
        functools.update_wrapper(self, fn)
        self.fn = fn
        self.returns = returns
        self.name = name or fn.__name__
        self.max_retries = max_retries
        self.priority = priority
        self.speculatable = speculatable
        self.deadline_s = deadline_s

    def __call__(self, *args, **kwargs):
        rt = current_runtime()
        return rt.submit(
            self.fn, args, kwargs,
            name=self.name, returns=self.returns, max_retries=self.max_retries,
            priority=self.priority, speculatable=self.speculatable,
            deadline_s=self.deadline_s,
        )

    def map(self, args_list: Iterable[tuple]) -> List[Any]:
        """Fan-out: submit one task per positional-args tuple in a single
        batch (see :func:`map_tasks`)."""
        return map_tasks(self, args_list)

    def inline(self, *args, **kwargs):
        """Run synchronously, bypassing the runtime (debugging aid)."""
        return self.fn(*args, **kwargs)


def task(fn: Optional[Callable] = None, *, returns: int = 1, name: Optional[str] = None,
         max_retries: Optional[int] = None, priority: int = 0,
         speculatable: bool = True, deadline_s: Optional[float] = None) -> Any:
    """Register ``fn`` as a task (paper's ``task()``); decorator or wrapper.

    ``deadline_s`` bounds each attempt's execution time (DESIGN.md §19):
    a body running longer has its worker killed and the attempt fails as
    a retryable :class:`~repro_torch.core.executors.DeadlineExceededError` —
    pair it with ``max_retries`` when overruns are transient.  Defaults
    to the runtime's ``deadline_s`` knob (``RJAX_DEADLINE_S``).  The
    process and cluster backends enforce it (they kill the worker); under
    ``"thread"`` it has no effect."""
    def wrap(f: Callable) -> TaskFunction:
        return TaskFunction(f, returns=returns, name=name, max_retries=max_retries,
                            priority=priority, speculatable=speculatable,
                            deadline_s=deadline_s)
    return wrap(fn) if fn is not None else wrap


def map_tasks(task_fn: Any, args_list: Iterable[tuple]) -> List[Any]:
    """Submit one task per entry of ``args_list`` (each a tuple of
    positional arguments) in a single batched call, amortizing the
    per-task graph/store/in-flight locking over the whole fan-out
    (DESIGN.md §14).  ``task_fn`` may be a :class:`TaskFunction` or a
    plain callable.  Returns the Futures in order — semantically identical
    to ``[task_fn(*a) for a in args_list]``, just cheaper to submit::

        frags = api.map_tasks(fill_t, [(seed + i, n, d) for i in range(k)])
    """
    rt = current_runtime()
    if isinstance(task_fn, TaskFunction):
        return rt.submit_many(
            task_fn.fn, [tuple(a) for a in args_list],
            name=task_fn.name, returns=task_fn.returns,
            max_retries=task_fn.max_retries, priority=task_fn.priority,
            speculatable=task_fn.speculatable, deadline_s=task_fn.deadline_s,
        )
    return rt.submit_many(task_fn, [tuple(a) for a in args_list])


def barrier(timeout: Optional[float] = None) -> None:
    """Wait for all submitted tasks (``compss_barrier``)."""
    current_runtime().barrier(timeout=timeout)


def wait_on(obj: Any, timeout: Optional[float] = None) -> Any:
    """Synchronize on Future(s) (``compss_wait_on``)."""
    return current_runtime().wait_on(obj, timeout=timeout)


# -- paper-spelled aliases ----------------------------------------------------
compss_start = runtime_start
compss_stop = runtime_stop
compss_barrier = barrier
compss_wait_on = wait_on

# -- collectives (DESIGN.md §16) ----------------------------------------------
# imported last: collectives resolves this module lazily at call time
from .collectives import broadcast, shuffle, tree_reduce  # noqa: E402,F401
