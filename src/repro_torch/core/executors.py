"""Executor backends (paper §3.3.2: persistent per-node workers) —
trimmed to the ``"thread"`` backend.

The runtime's dispatch loop is backend-agnostic: one dispatcher thread per
worker pulls ready tasks from the :class:`~repro_torch.core.scheduler.Scheduler`
and asks the executor backend to *invoke* the task function.  Under
``"thread"`` the body runs in the dispatcher thread itself: one shared
address space, values passed by reference — which is what lets task
bodies hand CUDA tensors to each other without a copy.

The ``"process"`` and ``"cluster"`` backends fork worker processes and
move host bytes across address spaces; a forked child cannot re-initialise
CUDA and device tensors do not cross that boundary, so both wait for a
later slice of the port and :func:`make_executor` refuses them.
"""
from __future__ import annotations

import pickle
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

try:  # optional, but present in the baked image; required for lambda tasks
    import cloudpickle as _cloudpickle
except Exception:  # pragma: no cover - cloudpickle is available in CI
    _cloudpickle = None


class WorkerCrashedError(RuntimeError):
    """A worker process died mid-task (segfault/OOM-kill).  Retryable."""


class DeadlineExceededError(WorkerCrashedError):
    """A task body overran its ``deadline_s`` and its worker was killed
    (DESIGN.md §19).  Retryable like any crash: pair ``deadline_s`` with
    ``max_retries`` when the overrun is expected to be transient."""


class RemoteTaskError(RuntimeError):
    """A worker-side exception that could not be unpickled; carries the
    original type name and traceback text."""

    def __init__(self, type_name: str, message: str, traceback_text: str = ""):
        super().__init__(f"{type_name}: {message}")
        self.type_name = type_name
        self.traceback_text = traceback_text


def _dumps_fn(fn: Callable) -> bytes:
    """Serialize a task function for another address space.

    Functions living in ``__main__`` don't resolve by *reference* in a
    process with a different ``__main__`` (a TCP node agent, a
    spawn-context worker), so those ship by *value* via cloudpickle;
    everything else tries stdlib pickle first, falling back to
    cloudpickle for lambdas/closures."""
    by_value = getattr(fn, "__module__", None) in (None, "__main__")
    if not by_value:
        try:
            return b"P" + pickle.dumps(fn, protocol=5)
        except Exception:
            pass
    if _cloudpickle is not None:
        return b"C" + _cloudpickle.dumps(fn)
    # forked workers share our __main__, so by-reference still works there
    return b"P" + pickle.dumps(fn, protocol=5)


def _loads_fn(blob: bytes) -> Callable:
    tag, body = blob[:1], blob[1:]
    if tag == b"P":
        return pickle.loads(body)
    if tag == b"C":
        if _cloudpickle is None:
            raise RuntimeError("cloudpickle unavailable in worker")
        return _cloudpickle.loads(body)
    raise RuntimeError("function body missing from worker cache")


# ------------------------------------------------------------------ backends
class ExecutorBackend:
    """Owns the persistent workers and the dispatch loop threads: one
    dispatcher thread per worker runs the synchronous task lifecycle
    (claim, resolve inputs, invoke, publish) for each task it takes."""

    name = "base"

    def __init__(self, n_workers: int, label: str = "rjax"):
        self.n_workers = int(n_workers)
        self.label = label
        self.runtime = None
        self._threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self, runtime) -> None:
        self.runtime = runtime
        for w in range(self.n_workers):
            t = threading.Thread(target=self._dispatch_loop, args=(w,),
                                 daemon=True, name=f"{self.label}-w{w}")
            t.start()
            self._threads.append(t)

    def _dispatch_loop(self, worker: int) -> None:
        rt = self.runtime
        node_id = rt.locality_domain(worker)
        while True:
            tid = rt.scheduler.take(worker)
            if tid is None:
                return
            rt._note_worker_busy()
            try:
                rt._execute(tid, worker, node_id)
            finally:
                rt._note_worker_idle()
                self.task_done()

    def shutdown(self, wait: bool = True, timeout: float = 10.0) -> None:
        for t in self._threads:
            t.join(timeout=timeout if wait else 0.2)

    # -- invocation ----------------------------------------------------------
    def invoke(self, worker: int, fn: Callable, args: tuple, kwargs: dict,
               input_keys: Optional[Dict[int, Tuple[int, int]]] = None) -> Any:
        """Run ``fn(*args, **kwargs)`` on ``worker`` and return the result.
        ``input_keys`` maps ``id(value) -> (data_id, version)`` for inputs
        resolved from the object store (lets the plane dedup by datum)."""
        raise NotImplementedError

    def publish(self, key: Tuple[int, int], value: Any) -> None:
        """Hook: ``value`` was published to the store under ``key``."""

    def task_done(self) -> None:
        """Hook: the current completion thread finished a task's
        completion path (success or failure)."""

    def stats(self) -> dict:
        # every backend reports how its dispatch side is driven, for
        # stats-key parity across backends: the in-process and pool
        # executors use per-worker dispatcher threads; the cluster
        # executor overrides this with its control-plane knob
        # (DESIGN.md §18)
        return {"backend": self.name, "control_plane": "threads"}


class ThreadExecutor(ExecutorBackend):
    """The original in-process model: invoke == plain call."""

    name = "thread"

    def invoke(self, worker, fn, args, kwargs, input_keys=None):
        return fn(*args, **kwargs)


BACKENDS = {"thread": ThreadExecutor}

# the slice of the port that will bring each backend that is not here yet
_LATER = {"process": "the process/cluster-backend slice",
          "cluster": "the process/cluster-backend slice"}


def make_executor(backend: str, n_workers: int, label: str = "rjax",
                  **kw) -> ExecutorBackend:
    if backend in _LATER:
        raise ValueError(
            f"executor backend {backend!r} is not ported yet (it comes with "
            f"{_LATER[backend]}); the port runs backend='thread'")
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown executor backend {backend!r}; choose from {sorted(BACKENDS)}")
    return BACKENDS[backend](n_workers, label, **kw)
