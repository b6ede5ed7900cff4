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
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

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


class Deferred:
    """A stored value its reader must finish first: ``Future.result``
    returns ``materialize()`` in its place (the process backend keeps a
    worker's card tensor as host bytes until the parent reads it)."""

    __slots__ = ()

    def materialize(self) -> Any:
        raise NotImplementedError


def materialize(value: Any) -> Any:
    """``value`` with every :class:`Deferred` leaf of its lists, tuples
    and dicts materialized; ``value`` itself when it holds none."""
    if isinstance(value, Deferred):
        return value.materialize()
    if isinstance(value, (list, tuple)):
        out = [materialize(v) for v in value]
        if all(a is b for a, b in zip(out, value)):
            return value
        if isinstance(value, tuple):
            return type(value)(*out) if hasattr(value, "_fields") else tuple(out)
        return out
    if isinstance(value, dict):
        out = {k: materialize(v) for k, v in value.items()}
        if all(out[k] is v for k, v in value.items()):
            return value
        return out
    return value


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
        return materialize(self._store.get(self.key, timeout=timeout))

    def __repr__(self) -> str:  # matches the paper's DAG edge labels
        return f"<Future d{self.data_id}v{self.version} by task#{self.producer_task}>"


class RemoteValue:
    """Placeholder for a datum whose bytes are resident on a cluster
    node, not on the scheduler (DESIGN.md §15).

    The producing agent kept the result in its node plane and the
    ``done`` reply carried only this descriptor: result ``token``, home
    ``node``, the node's data-plane ``addr`` (``host:port``) and the
    datum's array and tensor byte count.  ``key`` is bound when the
    runtime publishes the output.  The scheduler only materializes the
    bytes on ``wait_on``/gather (through the store's installed fetcher);
    tasks consuming the datum on another node pull it peer-to-peer via a
    ``Fetch`` directive instead.

    The bytes that come back are host bytes: a tensor that lived on a
    card arrives as a :class:`~repro_torch.core.executors.CardResult`
    (a :class:`Deferred`), so the store holds host bytes and
    ``Future.result`` uploads them to this process's card at the first
    read, exactly as for a process-backend result.
    """

    __slots__ = ("key", "token", "node", "addr", "nbytes")

    def __init__(self, token: int, node: int, addr: Optional[str],
                 nbytes: int, key: Optional[Tuple[int, int]] = None):
        self.key = key
        self.token = token
        self.node = node
        self.addr = addr
        self.nbytes = int(nbytes)

    def __repr__(self) -> str:
        k = f"d{self.key[0]}v{self.key[1]}" if self.key else "unbound"
        return (f"<RemoteValue {k} {self.nbytes}B on node {self.node} "
                f"({self.addr})>")


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
        self._gathers = 0            # RemoteValues materialized scheduler-side
        self._gather_bytes = 0
        # installed by the cluster executor: fetcher(key, rv) -> value
        self._fetcher: Optional[Callable[[Tuple[int, int], RemoteValue], Any]] = None
        self._fetching: set = set()   # keys with a gather pull in flight
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

    def set_fetcher(self, fetcher: Optional[Callable]) -> None:
        """Install the scheduler-side materializer for
        :class:`RemoteValue` placeholders:
        ``fetcher(key, rv, timeout) -> value`` pulls the bytes from the
        producing node's data plane (``timeout`` of None = the fetcher's
        own default)."""
        self._fetcher = fetcher

    def _materialize(self, key: Tuple[int, int], rv: RemoteValue,
                     timeout: Optional[float] = None) -> Any:
        """Pull a node-resident datum to the scheduler (gather path).
        Runs OUTSIDE the store lock — a peer fetch must never stall
        completions publishing other keys.  Always clears the key's
        single-flight mark and wakes waiters on the way out."""
        try:
            if self._fetcher is None:
                raise RuntimeError(
                    f"cannot materialize {rv!r}: no remote fetcher installed")
            value = self._fetcher(key, rv, timeout)
            with self._cond:
                if self._values.get(key) is rv:
                    self._values[key] = value
                    self._gathers += 1
                    self._gather_bytes += rv.nbytes
                    if self.governor is not None \
                            and spillable(value, self._spill_min):
                        self.governor.admit(key, getattr(value, "nbytes", 0))
            return value
        finally:
            with self._cond:
                self._fetching.discard(key)
                self._cond.notify_all()

    def get(self, key: Tuple[int, int], timeout: Optional[float] = None,
            materialize: bool = True) -> Any:
        """Blocking read.  ``materialize=False`` returns node-resident
        datums as their :class:`RemoteValue` placeholder (the cluster
        dispatch path, which moves metadata only); the default pulls the
        bytes to the scheduler.  A placeholder whose home node died is
        invalidated by the recovery path — waiters simply keep waiting
        until the resurrected producer re-publishes."""
        deadline = None if timeout is None else time.monotonic() + timeout
        attempts = 0
        while True:
            with self._cond:
                remaining = None if deadline is None else \
                    max(0.0, deadline - time.monotonic())
                if not self._cond.wait_for(
                    lambda: key in self._values or key in self._errors,
                    timeout=remaining,
                ):
                    raise TimeoutError(
                        f"timed out waiting for d{key[0]}v{key[1]}")
                if key in self._errors:
                    raise self._errors[key]
                value = self._values[key]
                if not (materialize and isinstance(value, RemoteValue)):
                    return self._maybe_fault(key, value)
                if key in self._fetching:
                    # single-flight: another thread is already pulling
                    # this datum — wait for its swap instead of paying a
                    # duplicate network transfer (still honoring OUR
                    # deadline: the in-flight fetch may be slower)
                    if deadline is not None:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            raise TimeoutError(
                                f"timed out waiting for d{key[0]}v{key[1]}")
                        self._cond.wait(timeout=min(0.5, left))
                    else:
                        self._cond.wait(timeout=0.5)
                    continue
                self._fetching.add(key)
                rv = value
            remaining = None if deadline is None else \
                max(0.1, deadline - time.monotonic())
            try:
                return self._materialize(key, rv, remaining)
            except Exception:
                # the home node may have died mid-fetch: if recovery
                # already invalidated the placeholder, loop back into the
                # wait for the re-executed producer; otherwise retry a
                # couple of times before surfacing — but never past the
                # caller's deadline
                if deadline is not None and time.monotonic() >= deadline:
                    raise
                with self._lock:
                    still_same = self._values.get(key) is rv
                if still_same:
                    attempts += 1
                    if attempts >= 3:
                        raise
                    time.sleep(0.05 * attempts)

    def get_nowait(self, key: Tuple[int, int], materialize: bool = True) -> Any:
        """Non-blocking read — except that a present-but-node-resident
        datum with ``materialize=True`` inherently needs a network pull;
        that pull routes through :meth:`get` so concurrent callers share
        one single-flight transfer."""
        with self._lock:
            if key in self._errors:
                raise self._errors[key]
            value = self._values[key]   # KeyError when absent: the contract
            if not (materialize and isinstance(value, RemoteValue)):
                return self._maybe_fault(key, value)
        return self.get(key, materialize=True)

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
                    # attribute the movement to its actual source: a
                    # node-resident datum moves peer-to-peer from its home
                    # node; anything else is relayed over the scheduler's
                    # own link (DESIGN.md §15) — unless the caller told us
                    # which peer served the bytes
                    v = self._values.get(key)
                    if source is not None and source != node:
                        self._p2p_bytes += nb
                        self._p2p_by_source[source] = (
                            self._p2p_by_source.get(source, 0) + nb)
                        self._matrix_add(source, node, nb)
                    elif isinstance(v, RemoteValue) and v.node != node:
                        self._p2p_bytes += nb
                        self._p2p_by_source[v.node] = (
                            self._p2p_by_source.get(v.node, 0) + nb)
                        self._matrix_add(v.node, node, nb)
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

    def reattribute_to_p2p(self, key: Tuple[int, int], source: int,
                           dest: Optional[int] = None) -> None:
        """Move one copy of ``key`` from the relay ledger to the p2p
        ledger.  Input residency is booked during task resolution, before
        the dispatcher knows the transport; when packing later turns the
        input into a by-key peer ``Fetch`` (DESIGN.md §16) the bytes never
        cross the scheduler link after all.  ``dest`` (the consuming
        node, when the caller knows it) keeps the node×node matrix in
        step with the aggregate split."""
        with self._lock:
            nb = self._nbytes.get(key, 0)
            moved = min(nb, self._relay_bytes)
            self._relay_bytes -= moved
            self._p2p_bytes += nb
            self._p2p_by_source[source] = (
                self._p2p_by_source.get(source, 0) + nb)
            if dest is not None:
                cell = self._transfer_matrix.get((-1, dest), 0)
                take = min(moved, cell)
                if take:
                    if cell - take:
                        self._transfer_matrix[(-1, dest)] = cell - take
                    else:
                        self._transfer_matrix.pop((-1, dest), None)
                self._matrix_add(source, dest, nb)

    def transfer_matrix(self) -> List[dict]:
        """JSON-friendly node×node movement matrix: one
        ``{"src", "dst", "bytes"}`` row per nonzero cell, ``src == -1``
        meaning the scheduler relayed the bytes (DESIGN.md §17)."""
        with self._lock:
            return [{"src": s, "dst": d, "bytes": b}
                    for (s, d), b in sorted(self._transfer_matrix.items())]

    def forget_node(self, node: int) -> None:
        """Drop a domain from every datum's residency set — the address
        space died (e.g. a node agent crashed).  Locality scoring stops
        steering reads there, re-ships to its replacement count as fresh
        transfers in the ledger, and the per-node *budget* ledger resets
        too (a replacement agent starts with empty memory: leaving the old
        byte count in place would starve the node of placements)."""
        with self._lock:
            for held in self._locations.values():
                held.discard(node)
            self._node_bytes[node] = 0
            self.residency_epoch += 1

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

    def transfer_stats(self) -> Tuple[int, int]:
        """(cross-domain reads, bytes moved) — the transfer ledger."""
        with self._lock:
            return self._transfers, self._transfer_bytes

    def transfer_detail(self) -> dict:
        """Source-attributed movement ledger (DESIGN.md §15):
        ``scheduler_relay_bytes`` crossed the scheduler's link,
        ``p2p_bytes`` moved directly between node data planes (broken
        down per source node), ``gather_bytes`` were materialized
        scheduler-side for ``wait_on``/gather."""
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
                "gathers": self._gathers,
                "gather_bytes": self._gather_bytes,
            }

    # -- loss recovery (DESIGN.md §15) ----------------------------------------
    def homed_keys(self, node: int) -> List[Tuple[int, int]]:
        """Keys whose unmaterialized :class:`RemoteValue` is homed on
        ``node`` — what :meth:`invalidate_lost` would delete."""
        with self._lock:
            return [key for key, v in self._values.items()
                    if isinstance(v, RemoteValue) and v.node == node]

    def redirect_node(self, node: int,
                      replacements: Dict[Tuple[int, int], Tuple[int, str]]
                      ) -> List[Tuple[int, int]]:
        """Replica-hit recovery (DESIGN.md §20): node ``node`` is dead,
        but some of its placeholders have surviving copies — rehome each
        key in ``replacements`` (``key -> (replica_node, replica_addr)``)
        onto its replica, with a by-key token (``None``) so fetches
        resolve through the replica plane's key table.  Keys NOT in
        ``replacements`` are left for ``invalidate_lost`` + lineage.
        Returns the rehomed keys.  Pure dict work under the store lock —
        callers must pre-snapshot replica locations (no executor locks
        are taken here)."""
        out: List[Tuple[int, int]] = []
        with self._lock:
            for key, v in list(self._values.items()):
                if not (isinstance(v, RemoteValue) and v.node == node):
                    continue
                rep = replacements.get(key)
                if rep is None:
                    continue
                b, addr = rep
                self._values[key] = RemoteValue(None, b, addr, v.nbytes,
                                                key=key)
                out.append(key)
            if out:
                self.residency_epoch += 1
        return out

    def invalidate_lost(self, node: int) -> List[Tuple[int, int]]:
        """A node died: every unmaterialized :class:`RemoteValue` homed
        there is gone.  Drop those entries (readers block until the
        resurrected producers re-publish) and wipe their residency
        everywhere — consumers that already pulled a copy keep serving
        their own tasks from their planes, but placement and the
        transfer ledger must stop trusting stale locations.  Returns the
        lost keys for lineage re-execution."""
        with self._cond:
            keys = [key for key, v in self._values.items()
                    if isinstance(v, RemoteValue) and v.node == node]
            return self._invalidate_keys_locked(keys)

    def invalidate_keys(self, keys) -> List[Tuple[int, int]]:
        """Targeted form of :meth:`invalidate_lost` for placeholders that
        slipped into the store after their home node's sweep (a ``done``
        reply racing the crash)."""
        with self._cond:
            return self._invalidate_keys_locked(keys)

    def _invalidate_keys_locked(self, keys) -> List[Tuple[int, int]]:
        lost: List[Tuple[int, int]] = []
        for key in keys:
            if isinstance(self._values.get(key), RemoteValue):
                del self._values[key]
                lost.append(key)
                nb = self._nbytes.get(key, 0)
                for holder in self._locations.pop(key, ()):
                    self._node_bytes[holder] = max(
                        0, self._node_bytes.get(holder, 0) - nb)
        if lost:
            self.residency_epoch += 1
        return lost

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
