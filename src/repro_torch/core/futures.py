"""Futures and versioned data registry.

RCOMPSs tracks every task parameter/result as a *datum* with an id and a
version (rendered ``dXvY`` in the paper's DAG figures).  A ``Future`` is a
lightweight handle to one ``(data_id, version)`` pair plus the task that
produces it.  The object store keeps the concrete values; versions exist so
that INOUT parameters get COMPSs-style renaming semantics (a task that
mutates datum ``d3`` produces ``d3v2`` while previously-submitted readers
still see ``d3v1``).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from .memory import (
    MemoryBudget,
    MemoryGovernor,
    SpilledValue,
    spill_to_file,
    spillable,
)


class TaskFailedError(RuntimeError):
    """Raised by ``wait_on`` when the producing task exhausted its retries."""

    def __init__(self, task_name: str, task_id: int, cause: BaseException):
        super().__init__(f"task {task_name}#{task_id} failed: {cause!r}")
        self.task_name = task_name
        self.task_id = task_id
        self.cause = cause


class Future:
    """Handle to the (eventual) value of ``data_id`` at ``version``."""

    __slots__ = ("data_id", "version", "producer_task", "_store")

    def __init__(self, data_id: int, version: int, producer_task: int, store: "ObjectStore"):
        self.data_id = data_id
        self.version = version
        self.producer_task = producer_task
        self._store = store

    @property
    def key(self) -> Tuple[int, int]:
        return (self.data_id, self.version)

    def done(self) -> bool:
        return self._store.is_ready(self.key)

    def result(self, timeout: Optional[float] = None) -> Any:
        return self._store.get(self.key, timeout=timeout)

    def __repr__(self) -> str:  # matches the paper's DAG edge labels
        return f"<Future d{self.data_id}v{self.version} by task#{self.producer_task}>"


class ObjectStore:
    """Thread-safe versioned value store.

    Values are indexed by ``(data_id, version)``.  ``put`` publishes a value
    (or an exception) and wakes waiters.  Location metadata (which *node* the
    bytes live on) feeds the locality-aware scheduler and the discrete-event
    simulator's transport model.
    """

    def __init__(self):
        # reentrant: a put/get may trigger governed spill/fault paths that
        # re-enter store accounting from the same thread
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._values: Dict[Tuple[int, int], Any] = {}
        self._errors: Dict[Tuple[int, int], BaseException] = {}
        self._locations: Dict[Tuple[int, int], set] = {}
        self._nbytes: Dict[Tuple[int, int], int] = {}
        self._node_bytes: Dict[int, int] = {}   # resident bytes per domain
        self._transfers = 0          # cross-domain reads observed
        self._transfer_bytes = 0
        # source-attributed movement (DESIGN.md §15): bytes relayed
        # through the scheduler's own link vs moved peer-to-peer between
        # node data planes (booked against the actual source node)
        self._relay_bytes = 0
        self._p2p_bytes = 0
        self._p2p_by_source: Dict[int, int] = {}
        # node×node movement for the dashboard's transfer matrix
        # (DESIGN.md §17): (src, dst) -> bytes, src == -1 meaning the
        # scheduler's own link (relay).  Invariant: summing src >= 0
        # entries gives _p2p_bytes; summing src == -1 gives _relay_bytes.
        self._transfer_matrix: Dict[Tuple[int, int], int] = {}
        self._next_data_id = 1
        self.governor: Optional[MemoryGovernor] = None
        self._spill_dir: Optional[str] = None
        self._spill_min: Optional[int] = None
        # bumped on every residency/budget-relevant change (a key gaining a
        # domain, a spill, an evict, a node reset); the locality scheduler
        # keys its per-node placement caches off this (DESIGN.md §14)
        self.residency_epoch = 0

    # -- memory governance (DESIGN.md §13) ------------------------------------
    def configure_memory(self, budget, spill_dir: Optional[str] = None,
                         high_frac: float = 0.9, low_frac: float = 0.7,
                         min_bytes: Optional[int] = None) -> None:
        """Bound this store: values past the high watermark spill to
        mmap-codec files (coldest first) and fault back as zero-copy
        ``np.memmap`` views on the next read.  ``budget`` of ``None``/0
        disables governance (the pre-§13 behaviour)."""
        from .memory import parse_bytes
        cap = parse_bytes(budget)
        if cap is None:
            self.governor = None
            return
        self._spill_dir = spill_dir
        self._spill_min = min_bytes
        self.governor = MemoryGovernor(
            MemoryBudget(cap, high_frac, low_frac), self._spill_key,
            name="store")

    def _spill_key(self, key: Tuple[int, int]) -> int:
        """Governor callback: replace a resident array with its on-disk
        form.  Returns bytes freed (0 = not spillable right now)."""
        value = self._values.get(key)
        if not spillable(value, self._spill_min):
            return 0
        try:
            spilled = spill_to_file(value, prefix=f"rjax_store_d{key[0]}v{key[1]}_",
                                    dir=self._spill_dir)
        except Exception:
            return 0
        self._values[key] = spilled
        self.residency_epoch += 1
        return value.nbytes

    def _maybe_fault(self, key: Tuple[int, int], value: Any) -> Any:
        """Transparent fault path: a spilled entry is read back as a
        read-only memmap view and stays resident in that (file-backed,
        kernel-reclaimable) form."""
        if isinstance(value, SpilledValue):
            view = value.load()
            self._values[key] = view
            if self.governor is not None:
                self.governor.fault(key, value.nbytes)
            return view
        if self.governor is not None:
            self.governor.touch(key)
        return value

    # -- identity allocation -------------------------------------------------
    def new_data_id(self) -> int:
        with self._lock:
            did = self._next_data_id
            self._next_data_id += 1
            return did

    def new_data_ids(self, n: int) -> range:
        """Allocate ``n`` consecutive data ids under one lock acquisition
        (fan-out submission)."""
        with self._lock:
            first = self._next_data_id
            self._next_data_id += n
            return range(first, first + n)

    # -- publication ----------------------------------------------------------
    def put(self, key: Tuple[int, int], value: Any, node: Optional[int] = None) -> None:
        nbytes = getattr(value, "nbytes", 0)
        try:
            nbytes = int(nbytes)
        except Exception:
            nbytes = 0
        with self._cond:
            self._values[key] = value
            self._nbytes[key] = nbytes
            if node is not None:
                held = self._locations.setdefault(key, set())
                if node not in held:
                    held.add(node)
                    self._node_bytes[node] = self._node_bytes.get(node, 0) + nbytes
                    self.residency_epoch += 1
            if self.governor is not None and spillable(value, self._spill_min):
                self.governor.admit(key, nbytes)
            self._cond.notify_all()

    def put_error(self, key: Tuple[int, int], err: BaseException) -> None:
        with self._cond:
            self._errors[key] = err
            self._cond.notify_all()

    # -- retrieval -------------------------------------------------------------
    def is_ready(self, key: Tuple[int, int]) -> bool:
        with self._lock:
            return key in self._values or key in self._errors

    def get(self, key: Tuple[int, int], timeout: Optional[float] = None) -> Any:
        """Blocking read: waits until ``key`` is published (or failed)."""
        with self._cond:
            if not self._cond.wait_for(
                lambda: key in self._values or key in self._errors,
                timeout=timeout,
            ):
                raise TimeoutError(f"timed out waiting for d{key[0]}v{key[1]}")
            if key in self._errors:
                raise self._errors[key]
            return self._maybe_fault(key, self._values[key])

    def get_nowait(self, key: Tuple[int, int]) -> Any:
        """Non-blocking read; ``KeyError`` when the datum is absent."""
        with self._lock:
            if key in self._errors:
                raise self._errors[key]
            return self._maybe_fault(key, self._values[key])

    # -- locality / transfer metadata ------------------------------------------
    # Every datum records which address-space *domains* hold a copy (node ids
    # for the thread backend, worker-process ids for the process backend) and
    # its byte size, so scheduling policies can score ready tasks by resident
    # input *bytes* — across threads and across processes alike.
    def note_location(self, key: Tuple[int, int], node: int,
                      source: Optional[int] = None) -> None:
        """Record that ``node`` now holds a copy of ``key``.  ``source``
        names the node the copy actually came from when the caller knows
        the transport (a broadcast/peer leg, DESIGN.md §16) — otherwise
        attribution falls back to inspecting the stored value."""
        with self._lock:
            held = self._locations.setdefault(key, set())
            if node not in held:
                nb = self._nbytes.get(key, 0)
                if held:  # a new domain pulled a copy: that's a transfer
                    self._transfers += 1
                    self._transfer_bytes += nb
                    # attribute the movement to its actual source: the
                    # scheduler's own link unless the caller told us
                    # which peer served the bytes
                    if source is not None and source != node:
                        self._p2p_bytes += nb
                        self._p2p_by_source[source] = (
                            self._p2p_by_source.get(source, 0) + nb)
                        self._matrix_add(source, node, nb)
                    else:
                        self._relay_bytes += nb
                        self._matrix_add(-1, node, nb)
                held.add(node)
                self._node_bytes[node] = (
                    self._node_bytes.get(node, 0) + nb)
                self.residency_epoch += 1

    def _matrix_add(self, src: int, dst: int, nb: int) -> None:
        if nb:
            self._transfer_matrix[(src, dst)] = (
                self._transfer_matrix.get((src, dst), 0) + nb)

    def node_bytes(self, node: int) -> int:
        """Resident governed bytes attributed to one locality domain —
        the scheduler's memory-aware placement reads this."""
        with self._lock:
            return self._node_bytes.get(node, 0)

    def locations(self, key: Tuple[int, int]) -> set:
        with self._lock:
            return set(self._locations.get(key, ()))

    def nbytes(self, key: Tuple[int, int]) -> int:
        with self._lock:
            return self._nbytes.get(key, 0)

    def transfer_detail(self) -> dict:
        """Source-attributed movement ledger (DESIGN.md §15):
        ``scheduler_relay_bytes`` crossed the scheduler's link,
        ``p2p_bytes`` moved directly between node data planes (broken
        down per source node)."""
        with self._lock:
            return {
                "transfers": self._transfers,
                "transfer_bytes": self._transfer_bytes,
                "scheduler_relay_bytes": self._relay_bytes,
                "p2p_bytes": self._p2p_bytes,
                "p2p_by_source": dict(self._p2p_by_source),
                "matrix": [{"src": s, "dst": d, "bytes": b}
                           for (s, d), b in
                           sorted(self._transfer_matrix.items())],
            }

    def memory_stats(self) -> dict:
        """The spill/fault side of the ledger (zeros when ungoverned)."""
        if self.governor is not None:
            return self.governor.stats()
        return {"budget_bytes": None, "bytes_used": 0, "peak_bytes": 0,
                "spills": 0, "faults": 0, "spill_bytes": 0,
                "fault_bytes": 0, "governed_entries": 0}

    def dispose_spills(self) -> None:
        """Unlink every still-spilled entry's file (runtime shutdown).
        Faulted views clean up after themselves — their files unlink at
        view GC — but a value that was spilled and never read again
        would otherwise leave its temp file behind."""
        with self._lock:
            for key, value in list(self._values.items()):
                if isinstance(value, SpilledValue):
                    value.dispose()
                    del self._values[key]

    # -- housekeeping ------------------------------------------------------------
    def evict(self, key: Tuple[int, int]) -> None:
        """Drop a value (garbage collection once all consumers ran)."""
        with self._lock:
            value = self._values.pop(key, None)
            if isinstance(value, SpilledValue):
                value.dispose()
            if self.governor is not None:
                self.governor.release(key)
            nbytes = self._nbytes.pop(key, 0)
            for node in self._locations.pop(key, ()):
                self._node_bytes[node] = max(
                    0, self._node_bytes.get(node, 0) - nbytes)
            self.residency_epoch += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._values)
