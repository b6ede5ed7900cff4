"""Memory governance for the object planes (DESIGN.md §13).

The paper's weak-scaling results hold only while every node's working set
fits in RAM; COMPSs itself bounds that with per-node memory accounting.
This module supplies the shared machinery that turns each of the port's
object planes — the scheduler-side
:class:`~repro_torch.core.futures.ObjectStore`, the process backend's
:class:`~repro_torch.core.executors.SegmentPlane`, and the cluster
agent's node-local plane — into a *bounded* cache.  Only host ndarrays
are governed; tensors are never spilled:

* :class:`MemoryBudget` — byte accounting for one address-space domain
  with high/low watermarks (evict when ``used`` crosses the high mark,
  stop once back under the low mark) plus the spill/fault ledger.
* :class:`LRULedger` — recency order over keyed entries, with pin counts
  so in-flight data can never be evicted under a running task.
* :class:`MemoryGovernor` — budget + LRU + a plane-supplied spill
  callback.  ``admit`` charges a new entry and evicts cold ones past the
  watermark; the plane decides what "spill" means (write an mmap-codec
  file, drop a shared-memory segment whose authoritative copy lives
  elsewhere, ...).
* :class:`SpilledValue` — the on-disk form: an mmap-codec file plus
  enough metadata to fault the array back as a zero-copy ``np.memmap``
  view (the RMVL deserialize-side property, §3.3.3).

The budget knob is ``RJAX_MEMORY_BUDGET`` (e.g. ``256M``, ``2G``); unset
or ``0`` means unbounded — the pre-governance behaviour.  Faulted-back
views are read-only (file-backed); tasks that want to mutate inputs must
go through INOUT parameters, same as under the process backend.

Locking contract: every plane already serializes access with its own
lock; the governor is reentrant (``RLock``) and is only ever entered
*from* its owning plane, so the lock order is always plane → governor
and cross-component deadlock is impossible by construction.
"""
from __future__ import annotations

import os
import tempfile
import threading
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from .serialization import MmapCodec, _unlink_quiet

Key = Tuple[int, int]

ENV_BUDGET = "RJAX_MEMORY_BUDGET"

# arrays below this size are not worth a spill file (the file-system
# metadata would cost more than the bytes saved)
SPILL_MIN_BYTES = int(os.environ.get("RJAX_SPILL_MIN_BYTES", 4096))

_UNITS = {
    "": 1, "b": 1,
    "k": 1 << 10, "kb": 1 << 10,
    "m": 1 << 20, "mb": 1 << 20,
    "g": 1 << 30, "gb": 1 << 30,
    "t": 1 << 40, "tb": 1 << 40,
}


def parse_bytes(value) -> Optional[int]:
    """``"256M"`` / ``"1.5g"`` / ``1048576`` → bytes; ``None``/``0``/empty
    → ``None`` (unbounded)."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        n = int(value)
        if n < 0:
            raise ValueError(f"negative memory budget: {value!r}")
        return n or None
    s = str(value).strip().lower().replace("_", "")
    if not s:
        return None
    i = len(s)
    while i > 0 and s[i - 1].isalpha():
        i -= 1
    num, unit = s[:i], s[i:]
    if unit not in _UNITS or not num:
        raise ValueError(f"cannot parse memory budget {value!r}")
    try:
        n = int(float(num) * _UNITS[unit])
    except ValueError as err:
        raise ValueError(f"cannot parse memory budget {value!r}") from err
    if n < 0:
        raise ValueError(f"negative memory budget: {value!r}")
    return n or None


def budget_from_env(explicit=None) -> Optional[int]:
    """Resolve the effective budget: an explicit value wins, otherwise
    ``RJAX_MEMORY_BUDGET``, otherwise unbounded."""
    if explicit is not None:
        return parse_bytes(explicit)
    return parse_bytes(os.environ.get(ENV_BUDGET))


class MemoryBudget:
    """Byte accounting for one address-space domain.

    ``used`` tracks resident governed bytes; crossing ``high_frac ×
    capacity`` triggers eviction down to ``low_frac × capacity`` (the
    classic two-watermark scheme, so one hot entry doesn't cause an
    evict-readmit storm at the boundary).  Spill/fault counters live here
    so every plane reports the same ledger shape.
    """

    def __init__(self, capacity, high_frac: float = 0.9, low_frac: float = 0.7):
        self.capacity = parse_bytes(capacity)
        if not 0.0 < low_frac <= high_frac <= 1.0:
            raise ValueError(
                f"watermarks must satisfy 0 < low <= high <= 1, "
                f"got low={low_frac} high={high_frac}")
        self.high_frac = high_frac
        self.low_frac = low_frac
        self._lock = threading.Lock()
        self.used = 0
        self.peak_used = 0   # high-water mark (peer fetches land here too)
        self.spills = 0
        self.faults = 0
        self.spill_bytes = 0
        self.fault_bytes = 0

    @property
    def bounded(self) -> bool:
        return self.capacity is not None

    @property
    def high_bytes(self) -> Optional[int]:
        return None if self.capacity is None else int(self.capacity * self.high_frac)

    @property
    def low_bytes(self) -> Optional[int]:
        return None if self.capacity is None else int(self.capacity * self.low_frac)

    def charge(self, nbytes: int) -> None:
        with self._lock:
            self.used += int(nbytes)
            if self.used > self.peak_used:
                self.peak_used = self.used

    def discharge(self, nbytes: int) -> None:
        with self._lock:
            self.used = max(0, self.used - int(nbytes))

    def over_high(self) -> bool:
        return self.capacity is not None and self.used > self.high_bytes

    def release_target(self) -> int:
        """Bytes to free to get back under the low watermark."""
        if self.capacity is None:
            return 0
        return max(0, self.used - self.low_bytes)

    def note_spill(self, nbytes: int) -> None:
        with self._lock:
            self.spills += 1
            self.spill_bytes += int(nbytes)

    def note_fault(self, nbytes: int) -> None:
        with self._lock:
            self.faults += 1
            self.fault_bytes += int(nbytes)

    def stats(self) -> dict:
        with self._lock:
            return {
                "budget_bytes": self.capacity,
                "bytes_used": self.used,
                "peak_bytes": self.peak_used,
                "spills": self.spills,
                "faults": self.faults,
                "spill_bytes": self.spill_bytes,
                "fault_bytes": self.fault_bytes,
            }


class LRULedger:
    """Recency order over keyed entries, with pin counts.

    A pinned key is never offered as an eviction victim; pins are
    counted (the same key can be pinned by several in-flight tasks) and
    work even for keys not yet admitted, closing the race between a
    dispatcher deciding to ship a datum and the plane admitting it.
    """

    def __init__(self):
        self._entries: "OrderedDict[Key, int]" = OrderedDict()
        self._pins: Dict[Key, int] = {}

    def add(self, key: Key, nbytes: int) -> None:
        self._entries[key] = int(nbytes)
        self._entries.move_to_end(key)

    def touch(self, key: Key) -> None:
        if key in self._entries:
            self._entries.move_to_end(key)

    def discard(self, key: Key) -> int:
        return self._entries.pop(key, 0)

    def pin(self, key: Key) -> None:
        self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, key: Key) -> None:
        n = self._pins.get(key, 0) - 1
        if n <= 0:
            self._pins.pop(key, None)
        else:
            self._pins[key] = n

    def pinned(self, key: Key) -> bool:
        return key in self._pins

    def victims(self, want_bytes: int, exclude: Iterable[Key] = ()) -> List[Tuple[Key, int]]:
        """Coldest-first candidates summing to at least ``want_bytes``,
        skipping pinned and excluded keys."""
        excluded = set(exclude)
        out: List[Tuple[Key, int]] = []
        total = 0
        for key, nbytes in self._entries.items():
            if total >= want_bytes:
                break
            if key in excluded or key in self._pins:
                continue
            out.append((key, nbytes))
            total += nbytes
        return out

    def __contains__(self, key: Key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)


class MemoryGovernor:
    """Budget + LRU + spill driver for one object plane.

    ``spill(key) -> bytes_freed`` is supplied by the plane; returning 0
    means "cannot spill this entry right now" and the governor moves on
    (the budget is a *soft* bound: progress always beats the watermark).
    Reentrant: planes call it while holding their own lock, and the spill
    callback may re-enter plane methods.
    """

    def __init__(self, budget: MemoryBudget, spill: Callable[[Key], int],
                 name: str = "plane"):
        self.budget = budget
        self.name = name
        self._spill = spill
        self._lock = threading.RLock()
        self._ledger = LRULedger()

    # -- residency -----------------------------------------------------------
    def admit(self, key: Key, nbytes: int) -> None:
        """Record ``key`` as resident and enforce the watermark.  The key
        being admitted is never its own victim."""
        with self._lock:
            if key in self._ledger:
                self._ledger.touch(key)
                return
            self._ledger.add(key, nbytes)
            self.budget.charge(nbytes)
            self._enforce(exclude=(key,))

    def touch(self, key: Key) -> None:
        with self._lock:
            self._ledger.touch(key)

    def release(self, key: Key) -> None:
        """The plane dropped ``key`` itself (GC, explicit evict)."""
        with self._lock:
            freed = self._ledger.discard(key)
            if freed:
                self.budget.discharge(freed)

    def fault(self, key: Key, nbytes: int) -> None:
        """A spilled entry was read back.  Faulted views are file-backed
        (``np.memmap``), so they are *not* re-charged against the budget —
        the kernel can drop their pages under pressure."""
        self.budget.note_fault(nbytes)

    # -- pinning -------------------------------------------------------------
    def pin_many(self, keys: Iterable[Key]) -> None:
        with self._lock:
            for k in keys:
                self._ledger.pin(k)

    def unpin_many(self, keys: Iterable[Key]) -> None:
        with self._lock:
            for k in keys:
                self._ledger.unpin(k)

    def reclaim(self) -> None:
        """Re-run watermark enforcement outside an admit.  Needed by deep
        dispatch pipelines (DESIGN.md §14): a working set admitted while
        every entry was pinned by in-flight tasks sails past the high
        watermark untouched, so completions re-enforce after unpinning."""
        with self._lock:
            self._enforce()

    # -- enforcement ---------------------------------------------------------
    def _enforce(self, exclude: Iterable[Key] = ()) -> None:
        if not self.budget.over_high():
            return
        target = self.budget.release_target()
        tried: set = set(exclude)
        while target > 0:
            victims = self._ledger.victims(target, exclude=tried)
            if not victims:
                return  # everything cold is pinned/unspillable: soft bound
            progress = False
            for key, nbytes in victims:
                tried.add(key)
                freed = self._spill(key)
                if freed > 0:
                    self._ledger.discard(key)
                    self.budget.discharge(freed)
                    self.budget.note_spill(freed)
                    progress = True
            if not progress:
                return
            target = self.budget.release_target()

    def stats(self) -> dict:
        with self._lock:
            s = self.budget.stats()
            s["governed_entries"] = len(self._ledger)
            return s


class SpilledValue:
    """An array that was spilled to an mmap-codec file.

    ``load()`` faults it back as a zero-copy read-only ``np.memmap`` view
    *owning* the file (unlinked when the view is collected), so a reader
    holding the view stays valid even after the plane later evicts the
    entry entirely.  ``dispose()`` is for entries dropped while still on
    disk."""

    __slots__ = ("path", "nbytes")

    def __init__(self, path: str, nbytes: int):
        self.path = path
        self.nbytes = int(nbytes)

    def load(self) -> np.ndarray:
        return MmapCodec().de_from_file(self.path, owned=True)

    def dispose(self) -> None:
        _unlink_quiet(self.path)

    def __repr__(self) -> str:
        return f"<SpilledValue {self.nbytes}B at {self.path}>"


def spillable(value, min_bytes: Optional[int] = None) -> bool:
    """Only raw-codec-eligible ndarrays are governed: they round-trip
    through the mmap codec losslessly and zero-copy.  Memmaps are already
    file-backed (spilling them would copy disk to disk)."""
    if not isinstance(value, np.ndarray) or isinstance(value, np.memmap):
        return False
    floor = SPILL_MIN_BYTES if min_bytes is None else min_bytes
    if value.nbytes < floor or value.dtype.hasobject:
        return False
    from .serialization import _pack_header
    try:
        _pack_header(np.asarray(value))
        return True
    except TypeError:
        return False


def spill_to_file(value: np.ndarray, prefix: str = "rjax_spill_",
                  dir: Optional[str] = None) -> SpilledValue:
    """Write ``value`` to a fresh mmap-codec temp file and return its
    :class:`SpilledValue` handle."""
    fd, path = tempfile.mkstemp(prefix=prefix, suffix=".rjx", dir=dir)
    os.close(fd)
    try:
        MmapCodec().ser_to_file(value, path)
    except BaseException:
        _unlink_quiet(path)
        raise
    return SpilledValue(path, value.nbytes)
