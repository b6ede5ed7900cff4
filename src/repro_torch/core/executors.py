"""Executor backends (paper §3.3.2: persistent per-node workers), the
port's copy: the ``"thread"``, ``"process"`` and ``"cluster"`` backends.

The runtime's dispatch loop is backend-agnostic: one dispatcher thread per
worker pulls ready tasks from the :class:`~repro_torch.core.scheduler.Scheduler`
and asks the executor backend to run the task function.  Backends differ
only in **where** the body runs:

* ``"thread"``  — in the dispatcher thread itself: one shared address
                  space, values passed by reference, so task bodies hand
                  CUDA tensors to each other without a copy.
* ``"process"`` — in one of N *persistent* worker processes started with
                  the runtime (the paper's worker model: task bodies run
                  truly in parallel, unconstrained by the GIL).  Task
                  parameters and results cross the address-space boundary
                  through a shared-memory object plane built on the
                  ``raw`` codec of :mod:`repro_torch.core.serialization`:
                  an array or tensor is written once into a
                  ``multiprocessing.shared_memory`` segment laid out like a
                  ``raw``-codec blob (header in the ref, buffer in the
                  segment), and every worker that later reads the same
                  datum rebuilds it from its per-process segment cache —
                  the RMVL memory-mapped-deserialization property of the
                  paper's §3.3.3 / Table 1.  Other values are pickled, and
                  task functions that stdlib pickle cannot ship (lambdas,
                  closures) go through cloudpickle with a per-worker code
                  cache, so each function body crosses the pipe at most
                  once.
* ``"cluster"`` — in one of N persistent worker processes *on a node
                  agent* reached over TCP (DESIGN.md §12,
                  :class:`ClusterExecutor`): the scheduler ships task
                  bodies and only the inputs the target node does not
                  already hold, node-resident results move agent to agent
                  (DESIGN.md §15), and every node runs its own spawned
                  ``"process"`` pool in its synchronous mode, so the
                  shared-memory plane below serves as the intra-node tier.
                  Tensors cross the wire as host bytes; the agent never
                  touches the card.

What the process backend does with the card, and why:

* **Start method.**  A forked child cannot re-initialise CUDA, so the
  port's pools *spawn* by default (the ``mp_context`` knob's default in
  the port's ``RuntimeConfig``; the JAX package forks by default).
  ``mp_context`` / ``RJAX_MP_CONTEXT`` may still ask for ``"fork"``; in a
  parent that has initialised CUDA that request raises — it does not fall
  back.  Spawned workers re-import each task's module, so a body defined
  in ``__main__`` of a script file ships by value (cloudpickle), and one
  typed at ``<stdin>`` cannot be found.  A spawned worker takes the
  parent's torch numerics settings (deterministic algorithms, TF32
  switches, fp32 matmul precision), as a forked one would inherit them.
* **Device values at the boundary.**  A ``torch.Tensor`` is a leaf like an
  ndarray.  One that crosses an address space travels as host bytes in a
  segment (bf16 as an int16 bit view: NumPy has no bf16); its ref carries
  the torch dtype and the device type, and it is rebuilt where it is read
  with the dtype and device it had — on the card in a worker, and on the
  card in the parent when the parent first reads it (until then the
  store holds a :class:`CardResult` over the host bytes), so ``wait_on``
  returns what it returns under ``"thread"``.  There is no CUDA IPC.  Every array or tensor *leaf* of a
  keyed datum (a fragment ``(X, y)`` too) gets its own plane key, the
  datum key extended by the leaf's path.
* **The RMVL property on the card.**  A worker's segment cache also keeps
  the device tensor it uploaded for a segment, and drops it with the
  mapping when the parent evicts the segment: a fragment is uploaded once
  per worker, not once per task.
* **Each worker is a CUDA context** with its own caching allocator.  The
  parent builds the kernel library before the pool starts, so no worker
  compiles; workers load the published library.  The pool starts when
  every worker has reported ready: torch imported and, where the parent
  has a CUDA context, its own created.
* **Launch counters are per process.**  Each reply carries the worker's
  counter deltas since its last reply (kernel launches, segment-cache
  hits, device uploads, and the card memory its caching allocator
  reserves); the executor sums them into ``stats()``
  (``kernel_launches``, ``worker_cache_hits``, ``device_uploads``,
  ``device_uploads_saved``, ``card_bytes_by_pid``).

Dispatch pipelining (DESIGN.md §14): the process backend is
*credit-based*.  Each worker pipe accepts up to ``pipeline_depth``
in-flight task messages; the dispatcher thread hands a task off and pulls
the next one, while one collector thread per pool drains every worker's
replies.  For the common all-keyed-array task the executor replaces the
per-task pickle frame with a compact binary descriptor.  A worker that
dies with tasks in flight fails *all* of them as retryable
:class:`WorkerCrashedError` and is respawned; a task that overruns its
``deadline_s`` has its worker killed (:class:`DeadlineExceededError`).

Semantics that differ under ``"process"`` (DESIGN.md §11): task bodies
observe *read-only* views of plane-resident ndarray inputs (CPU tensors
rebuilt from a segment are writable views of the shared copy: do not
mutate them), and closure state mutated inside a body stays in the
worker.
"""
from __future__ import annotations

import collections
import os
import pickle
import struct
import sys
import threading
import time
import traceback
from multiprocessing import get_context
from multiprocessing import shared_memory as _shm_mod
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .config import RuntimeConfig
from .futures import Deferred
from .memory import MemoryBudget, MemoryGovernor
from .serialization import _pack_header, _unpack_header, as_c_contiguous

try:  # optional, but present in the baked image; required for lambda tasks
    import cloudpickle as _cloudpickle
except Exception:  # pragma: no cover - cloudpickle is available in CI
    _cloudpickle = None

# arrays and tensors at or above this size ride the shared-memory plane;
# smaller ones are cheaper to pickle straight through the pipe
SHM_MIN_BYTES = int(os.environ.get("RJAX_SHM_MIN_BYTES", 16384))
# serialized-function cache entries kept per side (parent and each worker)
_FN_CACHE_MAX = int(os.environ.get("RJAX_FN_CACHE_MAX", 512))
# how long the pool waits for a spawned worker's first message
_READY_TIMEOUT_S = 300.0

_LEAVES = (np.ndarray, torch.Tensor)   # widened by CardResult below
# dtypes NumPy lacks travel as a bit view of the same width
_BIT_VIEWS = {torch.bfloat16: torch.int16}
_TORCH_DTYPES = {str(dt).split(".")[1]: dt for dt in (
    torch.float16, torch.float32, torch.float64, torch.bfloat16, torch.int8,
    torch.int16, torch.int32, torch.int64, torch.uint8, torch.bool)}


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


def _walk(obj: Any, fn: Callable[[Any], Any], leaf_types: tuple) -> Any:
    """Structure-preserving map over lists/tuples/dicts applying ``fn`` to
    leaves of ``leaf_types`` (mirrors runtime._walk, typed)."""
    if isinstance(obj, leaf_types):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        mapped = [_walk(o, fn, leaf_types) for o in obj]
        if isinstance(obj, tuple):
            return type(obj)(*mapped) if hasattr(obj, "_fields") else tuple(mapped)
        return mapped
    if isinstance(obj, dict):
        return {k: _walk(v, fn, leaf_types) for k, v in obj.items()}
    return obj


def _leaf_paths(obj: Any, path: tuple = ()):
    """Yield ``(path, leaf)`` for every array/tensor leaf of ``obj``."""
    if isinstance(obj, _LEAVES):
        yield path, obj
    elif isinstance(obj, (list, tuple)):
        for i, o in enumerate(obj):
            yield from _leaf_paths(o, path + (i,))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaf_paths(v, path + (k,))


def _dispose_segment(seg: _shm_mod.SharedMemory, unlink: bool) -> None:
    """Release a segment, tolerating live views.

    Store values handed to user code may be zero-copy views into the
    mapping; if any are still referenced, ``close`` raises BufferError.
    The mapping then lives until those views are collected — we unlink the
    name (freeing it immediately) and disarm the object so interpreter
    exit does not spray "cannot close exported pointers exist" tracebacks."""
    if unlink:
        try:
            seg.unlink()
        except Exception:
            pass
    try:
        seg.close()
    except BufferError:
        seg._buf = None       # type: ignore[attr-defined]
        seg._mmap = None      # type: ignore[attr-defined]
        try:
            fd = getattr(seg, "_fd", -1)
            if fd >= 0:
                os.close(fd)
                seg._fd = -1  # type: ignore[attr-defined]
        except Exception:
            pass
    except Exception:
        pass


# Resource-tracker accounting: spawned (and forked) workers inherit the
# parent's tracker over an fd, so there is exactly ONE tracker per
# runtime; the explicit ``unlink`` in SegmentPlane.close/evict unregisters
# each name.  Nobody must call resource_tracker.unregister by hand.


class ShmRef:
    """Picklable handle to one array or tensor in the shared-memory plane.

    The segment holds exactly a ``raw``-codec blob body: the packed header
    travels in the ref, the buffer lives in the segment.  ``torch_dtype``
    is ``""`` for an ndarray, else the tensor's dtype name (the header
    then describes its host bytes: an int16 bit view for bf16), and
    ``device`` the device type it is rebuilt on (``"cpu"`` / ``"cuda"``)."""

    __slots__ = ("name", "header", "nbytes", "key", "torch_dtype", "device")

    def __init__(self, name: str, header: bytes, nbytes: int,
                 key: Optional[tuple] = None, torch_dtype: str = "",
                 device: str = ""):
        self.name = name
        self.header = header
        self.nbytes = nbytes
        self.key = key
        self.torch_dtype = torch_dtype
        self.device = device

    def __getstate__(self):
        return (self.name, self.header, self.nbytes, self.key,
                self.torch_dtype, self.device)

    def __setstate__(self, state):
        (self.name, self.header, self.nbytes, self.key,
         self.torch_dtype, self.device) = state


def _host_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t`` detached, contiguous, and bit-viewed where NumPy lacks its
    dtype (still on its own device)."""
    t = t.detach()
    if not t.is_contiguous():
        t = t.contiguous()
    view = _BIT_VIEWS.get(t.dtype)
    return t.view(view) if view is not None else t


def _value_to_segment(value) -> Tuple[_shm_mod.SharedMemory, ShmRef]:
    """Copy one array or tensor into a fresh segment (a tensor on the card
    is copied device-to-host straight into the mapping; a re-planed
    :class:`CardResult` keeps its device)."""
    if isinstance(value, CardResult):
        seg, ref = _value_to_segment(value.host)
        ref.device = value.device
        return seg, ref
    if isinstance(value, torch.Tensor):
        src = _host_tensor(value)
        header = _pack_header(_header_proxy(src))
        nbytes = src.numel() * src.element_size()
        seg = _shm_mod.SharedMemory(create=True, size=max(1, nbytes))
        if nbytes:
            dst = torch.frombuffer(seg.buf, dtype=src.dtype, count=src.numel())
            dst.view(src.shape).copy_(src)
            del dst
        return seg, ShmRef(seg.name, header, nbytes,
                           torch_dtype=str(value.dtype).split(".")[1],
                           device=value.device.type)
    arr = as_c_contiguous(value)
    header = _pack_header(arr)
    seg = _shm_mod.SharedMemory(create=True, size=max(1, arr.nbytes))
    if arr.nbytes:
        np.frombuffer(seg.buf, dtype=arr.dtype, count=arr.size)[...] = arr.reshape(-1)
    return seg, ShmRef(seg.name, header, arr.nbytes)


def _header_proxy(src: torch.Tensor) -> np.ndarray:
    """A zero-byte ndarray with ``src``'s NumPy dtype and shape, for
    ``_pack_header`` (which reads only dtype and shape)."""
    dtype = torch.empty(0, dtype=src.dtype).numpy().dtype
    return np.lib.stride_tricks.as_strided(np.empty(1, dtype=dtype), shape=tuple(src.shape),
                                           strides=(0,) * src.dim())


def _segment_host_view(seg: _shm_mod.SharedMemory, ref: ShmRef):
    """Zero-copy view of a segment: a read-only ndarray, or for a tensor
    ref a CPU tensor with the tensor's own dtype."""
    dtype, shape, _ = _unpack_header(memoryview(ref.header))
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if not ref.torch_dtype:
        arr = np.frombuffer(seg.buf, dtype=dtype, count=count).reshape(shape)
        arr.flags.writeable = False
        return arr
    want = _TORCH_DTYPES[ref.torch_dtype]
    if count == 0:
        return torch.empty(shape, dtype=want)
    # through NumPy, not torch.frombuffer: the array holds the buffer
    # export, so closing the segment under a live tensor raises (and
    # _dispose_segment defers it) instead of unmapping the tensor's bytes
    host = torch.from_numpy(np.frombuffer(seg.buf, dtype=dtype, count=count).reshape(shape))
    return host.view(want) if host.dtype is not want else host


def _rebuild(host, device: str):
    """The value a reader gets for host bytes that lived on ``device``: the
    host view itself, or for a tensor that lived on the card, a copy
    uploaded to this process's card."""
    if device and device != "cpu":
        return host.to(device)
    return host


class CardResult(Deferred):
    """The host bytes of a tensor that lived on the card: a worker's
    result in the parent's store (a zero-copy view of its segment), or a
    card tensor that crossed a cluster wire (a view of its frame).  Held
    as host bytes until it is read: the first ``Future.result`` uploads it
    to this process's card, once.  Shipping it on to another worker or
    node sends the host bytes and uploads nothing here, so a process that
    never reads it (a node agent) never touches the card."""

    __slots__ = ("host", "device", "_value", "_lock")

    def __init__(self, host: torch.Tensor, device: str):
        self.host = host
        self.device = device
        self._value = None
        self._lock = threading.Lock()

    @property
    def nbytes(self) -> int:
        return self.host.numel() * self.host.element_size()

    def materialize(self) -> torch.Tensor:
        with self._lock:
            if self._value is None:
                self._value = _rebuild(self.host, self.device)
            return self._value

    def __reduce__(self):   # pickled straight through: rebuilt where read
        return _rebuild, (self.host, self.device)


_LEAVES = _LEAVES + (CardResult,)


class _CardBytes(CardResult):
    """A worker's small card result (below the segment threshold), sent
    through the pipe as its host bytes: it unpickles as a plain
    :class:`CardResult`, never as a CUDA tensor, so the receiving process
    (the parent, or a node agent that has no CUDA context) uploads
    nothing until the value is read."""

    __slots__ = ()

    def __reduce__(self):
        return CardResult, (self.host, self.device)


def _attached(host, ref: ShmRef):
    """What the parent stores for a result segment: a card tensor stays
    a :class:`CardResult` until it is read; anything else is its view."""
    if ref.device and ref.device != "cpu":
        return CardResult(host, ref.device)
    return host


def _shm_eligible(value) -> bool:
    if isinstance(value, CardResult):
        return value.nbytes >= SHM_MIN_BYTES
    if isinstance(value, torch.Tensor):
        return str(value.dtype).split(".")[1] in _TORCH_DTYPES \
            and value.numel() * value.element_size() >= SHM_MIN_BYTES
    if value.nbytes < SHM_MIN_BYTES or value.dtype.hasobject:
        return False
    try:
        _pack_header(value)
        return True
    except TypeError:  # dtype outside the raw-codec table
        return False


class SegmentPlane:
    """Parent-side registry of shared-memory segments keyed by plane key
    (a datum key ``(data_id, version)``, extended by the leaf's path for a
    leaf inside a container datum), plus anonymous result segments.  One
    leaf is copied into the plane at most once no matter how many workers
    read it; the per-worker segment caches then make repeated reads
    zero-copy (and, on the card, upload-free).

    With a memory budget configured (DESIGN.md §13), the plane is a
    *bounded* cache tier: keyed segments past the high watermark are
    evicted coldest-first (the authoritative copy lives in the scheduler's
    ObjectStore, so dropping the shm copy loses nothing).  A later
    ``ensure`` of an evicted key re-planes it — counted as a fault.  Keys
    of in-flight task inputs are pinned by the executor so a ref already
    on a pipe can never point at an unlinked segment, and every worker is
    told (piggybacked on its next task message) to drop its cached mapping
    — and device copy — of evicted names."""

    def __init__(self, memory_budget=None):
        # reentrant: governed ensure() may evict (and re-enter plane
        # bookkeeping) while holding the lock
        self._lock = threading.RLock()
        self._by_key: Dict[tuple, Tuple[_shm_mod.SharedMemory, ShmRef]] = {}
        self._anon: Dict[str, _shm_mod.SharedMemory] = {}
        self._by_name: Dict[str, _shm_mod.SharedMemory] = {}  # every live segment
        self.bytes_planed = 0      # bytes copied into the plane (once per leaf)
        self.refs_shipped = 0      # ShmRefs sent over pipes (dedup wins show here)
        self.governor: Optional[MemoryGovernor] = None
        self.on_evict: Optional[Callable[[str], None]] = None
        self._evicted_keys: Set[tuple] = set()
        self.configure_memory(memory_budget)

    def configure_memory(self, budget, high_frac: float = 0.9,
                         low_frac: float = 0.7) -> None:
        from .memory import parse_bytes
        cap = parse_bytes(budget)
        self.governor = None if cap is None else MemoryGovernor(
            MemoryBudget(cap, high_frac, low_frac), self._spill_key,
            name="shm-plane")

    def reclaim(self) -> None:
        """Re-run watermark enforcement under the PLANE lock (plane →
        governor is the global lock order)."""
        if self.governor is None:
            return
        with self._lock:
            self.governor.reclaim()

    def _spill_key(self, key: tuple) -> int:
        """Governor callback: drop one keyed segment.  Only ever invoked
        with the plane lock held (admit via ensure, or :meth:`reclaim`)."""
        item = self._by_key.pop(key, None)
        if item is None:
            return 0
        seg, ref = item
        self._by_name.pop(seg.name, None)
        self._evicted_keys.add(key)
        if self.on_evict is not None:
            self.on_evict(seg.name)
        _dispose_segment(seg, unlink=True)
        return ref.nbytes

    def ensure(self, key: tuple, value) -> ShmRef:
        with self._lock:
            if key in self._by_key:
                self.refs_shipped += 1
                if self.governor is not None:
                    self.governor.touch(key)
                return self._by_key[key][1]
        seg, ref = _value_to_segment(value)
        ref.key = key
        with self._lock:
            dup = self._by_key.get(key)
            if dup is not None:  # lost a publish race: keep the first
                _dispose_segment(seg, unlink=True)
                self.refs_shipped += 1
                return dup[1]
            self._by_key[key] = (seg, ref)
            self._by_name[ref.name] = seg
            self.bytes_planed += ref.nbytes
            self.refs_shipped += 1
            if self.governor is not None:
                if key in self._evicted_keys:   # re-plane of an evicted key
                    self._evicted_keys.discard(key)
                    self.governor.fault(key, ref.nbytes)
                self.governor.admit(key, ref.nbytes)
        return ref

    def attach(self, ref: ShmRef) -> Tuple[Any, bool]:
        """The parent's value for a worker-shipped segment: its host view,
        or a :class:`CardResult` for a card tensor.  Returns ``(value,
        fresh)`` — ``fresh`` is False when the segment is already
        plane-resident (a pass-through result reshipping a ref the parent
        owns)."""
        with self._lock:
            seg = self._by_name.get(ref.name)
            if seg is not None:
                return _attached(_segment_host_view(seg, ref), ref), False
        seg = _shm_mod.SharedMemory(name=ref.name)
        with self._lock:
            raced = self._by_name.get(ref.name)
            if raced is not None:
                _dispose_segment(seg, unlink=False)
                return _attached(_segment_host_view(raced, ref), ref), False
            self._anon[ref.name] = seg
            self._by_name[ref.name] = seg
            self.bytes_planed += ref.nbytes
        return _attached(_segment_host_view(seg, ref), ref), True

    def alias(self, key: tuple, ref: ShmRef) -> None:
        """Promote an adopted (anonymous) result segment to a plane key so
        later ships of the same leaf reuse it instead of re-copying."""
        with self._lock:
            seg = self._anon.pop(ref.name, None)
            if seg is None:
                return
            if key in self._by_key:
                self._anon[ref.name] = seg  # keep ownership; key already bound
                return
            self._by_key[key] = (seg, ShmRef(ref.name, ref.header, ref.nbytes, key,
                                             ref.torch_dtype, ref.device))
            if self.governor is not None:
                self.governor.admit(key, ref.nbytes)

    def evict(self, key: tuple) -> None:
        with self._lock:
            item = self._by_key.pop(key, None)
            self._evicted_keys.discard(key)   # datum GC'd: no fault ahead
            if item is not None:
                self._by_name.pop(item[0].name, None)
                if self.governor is not None:
                    self.governor.release(key)
                if self.on_evict is not None:
                    self.on_evict(item[0].name)
        if item is not None:
            _dispose_segment(item[0], unlink=True)

    def drop_anonymous(self, name: str) -> None:
        """Reclaim an adopted-but-never-published result segment."""
        with self._lock:
            seg = self._anon.pop(name, None)
            if seg is not None:
                self._by_name.pop(name, None)
        if seg is not None:
            _dispose_segment(seg, unlink=True)

    def names(self) -> List[str]:
        """The names of every segment the plane holds now."""
        with self._lock:
            return sorted(self._by_name)

    def stats(self) -> dict:
        with self._lock:
            s = {
                "segments": len(self._by_key) + len(self._anon),
                "bytes_planed": self.bytes_planed,
                "refs_shipped": self.refs_shipped,
            }
            if self.governor is not None:
                s.update({f"plane_{k}": v
                          for k, v in self.governor.stats().items()})
            return s

    def close(self) -> None:
        with self._lock:
            segs = [s for s, _ in self._by_key.values()] + list(self._anon.values())
            self._by_key.clear()
            self._anon.clear()
            self._by_name.clear()
        for seg in segs:
            _dispose_segment(seg, unlink=True)


# --------------------------------------------------------------- worker side
class _WorkerSegmentCache:
    """Per-process cache: segment name -> (shm, the value readers get).
    For a tensor that lives on the card the value is the device copy
    uploaded at the first read, so later reads upload nothing."""

    def __init__(self):
        self._cache: Dict[str, Tuple[_shm_mod.SharedMemory, Any]] = {}
        self._refs: Dict[int, ShmRef] = {}   # id(value) -> its ref
        self.counters: Dict[str, int] = collections.Counter()

    def get(self, ref: ShmRef):
        hit = self._cache.get(ref.name)
        on_card = bool(ref.device) and ref.device != "cpu"
        if hit is not None:
            self.counters["worker_cache_hits"] += 1
            if on_card:
                self.counters["device_uploads_saved"] += 1
            return hit[1]
        seg = _shm_mod.SharedMemory(name=ref.name)
        value = _rebuild(_segment_host_view(seg, ref), ref.device)
        if on_card:
            self.counters["device_uploads"] += 1
            self.counters["device_upload_bytes"] += ref.nbytes
        self._cache[ref.name] = (seg, value)
        self._refs[id(value)] = ref
        return value

    def ref_for(self, value) -> Optional[ShmRef]:
        """The ref of ``value`` if it IS a cached plane value (identity,
        not a slice) — lets pass-through results reship instead of
        re-copy."""
        ref = self._refs.get(id(value))
        if ref is not None:
            cached = self._cache.get(ref.name)
            if cached is not None and cached[1] is value:
                return ref
        return None

    def drop(self, name: str) -> None:
        """The parent evicted this segment: close our mapping (and free the
        device copy) so the memory actually returns.  Safe mid-stream —
        the parent only sends drops for segments no in-flight task uses."""
        hit = self._cache.pop(name, None)
        if hit is None:
            return
        seg, value = hit
        self._refs.pop(id(value), None)
        del value, hit
        _dispose_segment(seg, unlink=False)

    def close(self) -> None:
        for seg, _ in self._cache.values():
            _dispose_segment(seg, unlink=False)
        self._cache.clear()


def _dumps_fn(fn: Callable) -> bytes:
    """Serialize a task function for another address space.

    Functions living in ``__main__`` don't resolve by *reference* in a
    process with a different ``__main__`` (a spawned worker), so those
    ship by *value* via cloudpickle; everything else tries stdlib pickle
    first, falling back to cloudpickle for lambdas/closures."""
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


def _rebuild_remote_error(enc, tb) -> BaseException:
    """Reconstruct an exception shipped from a worker without raising:
    unpickle the original and chain the remote traceback text, or fall
    back to the ``type|message|tb`` encoding when it didn't pickle."""
    if enc is not None:
        try:
            exc = pickle.loads(enc)
        except Exception:
            exc = None
        if isinstance(exc, BaseException):
            exc.__cause__ = RemoteTaskError(type(exc).__name__,
                                            str(exc), tb or "")
            return exc
    type_name, _, rest = (tb or "RemoteTaskError||").partition("|")
    message, _, tb_text = rest.partition("|")
    return RemoteTaskError(type_name, message, tb_text)


class _FnRegistry:
    """Token registry for serialized task functions: one monotonically
    increasing token per distinct function object, so each worker pipe
    sees a function body at most once.  Bounded by ``RJAX_FN_CACHE_MAX``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cache: Dict[int, Tuple[int, Any, bytes]] = {}
        self._next_token = 1

    def entry(self, fn: Callable) -> Tuple[int, bytes]:
        with self._lock:
            entry = self._cache.get(id(fn))
            if entry is not None and entry[1] is fn:
                return entry[0], entry[2]
            blob = _dumps_fn(fn)
            token = self._next_token
            self._next_token += 1
            self._cache[id(fn)] = (token, fn, blob)
            while len(self._cache) > _FN_CACHE_MAX:
                self._cache.pop(next(iter(self._cache)))
            return token, blob


def _encode_result(result: Any, cache: "_WorkerSegmentCache"
                   ) -> Tuple[bytes, List[_shm_mod.SharedMemory]]:
    created: List[_shm_mod.SharedMemory] = []

    def enc(value):
        passthrough = cache.ref_for(value)
        if passthrough is not None:   # identity result: reship, don't re-copy
            return passthrough
        if not _shm_eligible(value):
            if isinstance(value, torch.Tensor) and value.device.type != "cpu":
                # a small card tensor: host bytes, never a pickled CUDA
                # tensor (unpickling one would initialise CUDA where read)
                return _CardBytes(value.detach().cpu(),
                                  value.device.type)
            return value
        seg, ref = _value_to_segment(value)   # parent takes ownership on adopt()
        created.append(seg)
        return ref

    structure = _walk(result, enc, _LEAVES)
    try:
        return pickle.dumps(structure, protocol=5), created
    except Exception:
        if _cloudpickle is None:
            raise
        return _cloudpickle.dumps(structure), created


# --------------------------------------------- pipe wire format (DESIGN.md §14)
# Parent -> worker messages are raw byte strings (send_bytes/recv_bytes), the
# first byte selecting the kind:
#
#   b"X"  exit
#   b"P"  pickle.dumps((token, fn_blob, structure, evicted)) — the general
#         task message, ONE pickle pass with the args/kwargs structure
#         inline (ShmRefs and small values pickle fine)
#   b"Q"  like "P" but the structure needed cloudpickle: the tuple carries
#         cloudpickle.dumps(structure) as bytes instead
#   b"D"  compact binary descriptor for the common all-keyed-leaf case:
#         fn token + evict piggyback + flat ShmRef args — no pickle frame
#   b"M"  batch: u32 count, then per task u32 length + sub-message (each a
#         P/Q/D message) — answered one reply per sub-message, in order.
#
# Worker -> parent replies, one per task message in FIFO order (which is
# what lets the parent run a single completion collector per pool): the
# kind byte, u32 length + pickle of the worker's counter deltas since its
# last reply (empty when none), then the payload:
#
#   b"K" ... result-structure pickle          task succeeded
#   b"E" ... pickle.dumps((exc_blob, tb))     task raised
#
# plus one b"R" (ready), a worker's first message, before any reply.
_DESC_HEAD = struct.Struct("<QHH")   # fn token, n_evicted, n_refs
_DESC_U8 = struct.Struct("<B")
_DESC_U16 = struct.Struct("<H")
_DESC_U64 = struct.Struct("<Q")
_BATCH_U32 = struct.Struct("<I")
_READY = b"R"   # a worker's first message: set up, taking tasks


def _pack_descriptor(token: int, evicted: Tuple[str, ...],
                     refs: Tuple[ShmRef, ...]) -> bytes:
    out = [b"D", _DESC_HEAD.pack(token, len(evicted), len(refs))]
    for name in evicted:
        nb = name.encode("ascii")
        out.append(_DESC_U16.pack(len(nb)))
        out.append(nb)
    for ref in refs:
        nb = ref.name.encode("ascii")
        out.append(_DESC_U16.pack(len(nb)))
        out.append(nb)
        out.append(_DESC_U16.pack(len(ref.header)))
        out.append(ref.header)
        out.append(_DESC_U64.pack(ref.nbytes))
        tag = f"{ref.torch_dtype}|{ref.device}".encode("ascii")
        out.append(_DESC_U8.pack(len(tag)))
        out.append(tag)
    return b"".join(out)


def _unpack_descriptor(buf: bytes):
    token, n_ev, n_refs = _DESC_HEAD.unpack_from(buf, 1)
    off = 1 + _DESC_HEAD.size
    evicted = []
    for _ in range(n_ev):
        (ln,) = _DESC_U16.unpack_from(buf, off)
        off += 2
        evicted.append(buf[off:off + ln].decode("ascii"))
        off += ln
    refs = []
    for _ in range(n_refs):
        (ln,) = _DESC_U16.unpack_from(buf, off)
        off += 2
        name = buf[off:off + ln].decode("ascii")
        off += ln
        (hl,) = _DESC_U16.unpack_from(buf, off)
        off += 2
        header = bytes(buf[off:off + hl])
        off += hl
        (nb,) = _DESC_U64.unpack_from(buf, off)
        off += 8
        (tl,) = _DESC_U8.unpack_from(buf, off)
        off += 1
        torch_dtype, _, device = buf[off:off + tl].decode("ascii").partition("|")
        off += tl
        refs.append(ShmRef(name, header, nb, torch_dtype=torch_dtype, device=device))
    return token, evicted, refs


def _pack_reply(kind: bytes, counters: Dict[str, int], payload: bytes) -> bytes:
    cnt = pickle.dumps(counters, protocol=5) if counters else b""
    return kind + _BATCH_U32.pack(len(cnt)) + cnt + payload


def _unpack_reply(resp: bytes):
    (ln,) = _BATCH_U32.unpack_from(resp, 1)
    counters = pickle.loads(resp[5:5 + ln]) if ln else {}
    return resp[:1], counters, memoryview(resp)[5 + ln:]


def _torch_settings() -> dict:
    """The parent's torch state a spawned worker takes over (a forked one
    would inherit it): the numerics switches, and whether the parent has a
    CUDA context — then the worker creates its own before it reports
    ready, so no task pays for it."""
    return {
        "cuda": torch.cuda.is_initialized(),
        "deterministic": torch.are_deterministic_algorithms_enabled(),
        "deterministic_warn_only": torch.is_deterministic_algorithms_warn_only_enabled(),
        "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_tf32": torch.backends.cudnn.allow_tf32,
        "fp32_precision": torch.get_float32_matmul_precision(),
    }


def _apply_torch_settings(s: dict) -> None:
    torch.use_deterministic_algorithms(s["deterministic"],
                                       warn_only=s["deterministic_warn_only"])
    torch.backends.cuda.matmul.allow_tf32 = s["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = s["cudnn_tf32"]
    torch.set_float32_matmul_precision(s["fp32_precision"])
    if s["cuda"]:
        try:
            torch.zeros(1, device="cuda")
        except Exception:   # noqa: BLE001 - a task that needs the card fails then
            pass


class _CounterDeltas:
    """The worker's counters to ship with its next reply: the segment
    cache's, plus the port's kernel launch counters once a task body has
    imported the kernels."""

    def __init__(self, cache: _WorkerSegmentCache):
        self.cache = cache
        self.sent: Dict[str, int] = {}

    def take(self) -> Dict[str, int]:
        now = dict(self.cache.counters)
        ops = sys.modules.get("repro_torch.kernels.ops")
        if ops is not None:
            now.update({f"launches:{k}": v for k, v in ops.launch_counts().items()})
        if torch.cuda.is_initialized():
            # a gauge under this process's own key: its deltas sum to the
            # card memory its caching allocator holds now
            now[f"card_bytes:{os.getpid()}"] = torch.cuda.memory_reserved()
        delta = {k: v - self.sent.get(k, 0) for k, v in now.items()
                 if v != self.sent.get(k, 0)}
        self.sent = now
        return delta


def _worker_main(conn, worker_index: int, close_fds: tuple = (),
                 settings: Optional[dict] = None) -> None:
    """Persistent worker loop: one process, many tasks (§3.3.2).  Tasks
    arrive pipelined (up to the parent's credit depth queued in the pipe,
    possibly several per batch message) and are answered strictly in
    arrival order."""
    for fd in close_fds:   # inherited sibling/parent fds (fork only)
        try:
            os.close(fd)
        except OSError:
            pass
    if settings is not None:
        _apply_torch_settings(settings)
    try:
        conn.send_bytes(_READY)
    except OSError:
        return
    cache = _WorkerSegmentCache()
    deltas = _CounterDeltas(cache)
    fns: Dict[int, Callable] = {}

    def run_task(raw) -> bool:
        """Execute one P/Q/D task message; False = parent is gone.  The
        parse runs INSIDE the try: an argument whose unpickling raises
        must cost one error reply, not the worker."""
        try:
            kind = raw[:1]
            desc_refs = None
            structure = None
            if kind == b"D":
                fn_token, evicted, desc_refs = _unpack_descriptor(raw)
                fn_blob = b""
            else:  # b"P"/b"Q": general pickled task tuple
                fn_token, fn_blob, structure, evicted = \
                    pickle.loads(memoryview(raw)[1:])
            if "*" in evicted:     # overflow sentinel: drop everything
                for name in list(cache._cache):
                    cache.drop(name)
            else:
                for name in evicted:   # parent-evicted: drop mappings
                    cache.drop(name)
            fn = fns.get(fn_token)
            if fn is None:
                fn = _loads_fn(fn_blob)
                fns[fn_token] = fn
                while len(fns) > _FN_CACHE_MAX:
                    fns.pop(min(fns))   # tokens are monotonic: min = oldest
            if desc_refs is not None:
                args = tuple(cache.get(r) for r in desc_refs)
                kwargs: dict = {}
            else:
                if kind == b"Q":   # cloudpickled structure
                    if _cloudpickle is None:
                        raise RuntimeError("cloudpickle unavailable in worker")
                    structure = _cloudpickle.loads(structure)
                args, kwargs = _walk(structure, cache.get, (ShmRef,))
            result = fn(*args, **kwargs)
            blob, created = _encode_result(result, cache)
            conn.send_bytes(_pack_reply(b"K", deltas.take(), blob))
            for seg in created:  # parent adopts; drop our handles
                _dispose_segment(seg, unlink=False)
        except BaseException as err:  # noqa: BLE001 - ships to parent
            import traceback
            tb = traceback.format_exc()
            try:
                conn.send_bytes(_pack_reply(b"E", deltas.take(), pickle.dumps(
                    (pickle.dumps(err, protocol=5), tb), protocol=5)))
            except (BrokenPipeError, ConnectionResetError):
                return False   # parent is gone — exit quietly
            except Exception:
                try:
                    conn.send_bytes(_pack_reply(b"E", {}, pickle.dumps(
                        (None, f"{type(err).__name__}|{err}|{tb}"), protocol=5)))
                except OSError:
                    return False
        return True

    try:
        while True:
            try:
                raw = conn.recv_bytes()
            except (EOFError, OSError):
                break
            kind = raw[:1]
            if kind == b"X":
                break
            if kind == b"M":   # batch: unpack, run each in order
                (count,) = _BATCH_U32.unpack_from(raw, 1)
                off = 1 + 4
                alive = True
                for _ in range(count):
                    (ln,) = _BATCH_U32.unpack_from(raw, off)
                    off += 4
                    alive = run_task(raw[off:off + ln])
                    off += ln
                    if not alive:
                        break
                if not alive:
                    break
                continue
            if not run_task(raw):
                break
    finally:
        cache.close()
        try:
            conn.close()
        except Exception:
            pass


# ------------------------------------------------------------------ backends
class ExecutorBackend:
    """Owns the persistent workers and the dispatch loop threads.

    ``pipelined`` backends run the credit-based dispatch loop: the
    dispatcher thread of worker ``w`` may have up to ``pipeline_depth``
    tasks in flight (begin_task → async submit), and the backend promises
    that every submitted task eventually reaches exactly one completion
    (success, failure, or crash-requeue) on some completion thread."""

    name = "base"
    pipelined = False

    def __init__(self, n_workers: int, label: str = "rjax",
                 pipeline_depth: int = 1):
        self.n_workers = int(n_workers)
        self.label = label
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.runtime = None
        self._threads: List[threading.Thread] = []
        self._credits: Optional[List[threading.Semaphore]] = None
        self._stop_dispatch = False

    # -- lifecycle -----------------------------------------------------------
    def start(self, runtime) -> None:
        self.runtime = runtime
        if self.pipelined:
            self._credits = [threading.Semaphore(self.pipeline_depth)
                             for _ in range(self.n_workers)]
        for w in range(self.n_workers):
            t = threading.Thread(target=self._dispatch_loop, args=(w,),
                                 daemon=True, name=f"{self.label}-w{w}")
            t.start()
            self._threads.append(t)

    def _dispatch_loop(self, worker: int) -> None:
        rt = self.runtime
        node_id = rt.locality_domain(worker)
        if not self.pipelined:
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
            return
        # credit-based pipelined dispatch (DESIGN.md §14)
        credits = self._credits[worker]
        depth = self.pipeline_depth
        while True:
            credits.acquire()
            self._await_worker(worker)
            if self._stop_dispatch:
                credits.release()
                return
            tid = rt.scheduler.take(worker)
            if tid is None:
                credits.release()
                return
            tids = [tid]
            # opportunistic batching: while credits are free AND ready
            # tasks are queued, grab them too — they ship in one write
            while len(tids) < depth and credits.acquire(blocking=False):
                if self._stop_dispatch:
                    credits.release()
                    break
                nxt = rt.scheduler.take(worker, timeout=0)
                if nxt is None:
                    credits.release()
                    break
                tids.append(nxt)
            exs = []
            for t in tids:
                rt._note_worker_busy()
                ex = rt.begin_task(t, worker, node_id)
                if ex is None:   # cancelled / completed during resolution
                    rt._note_worker_idle()
                    credits.release()
                    continue
                exs.append(ex)
            if exs:
                # hand off; the backend guarantees exactly one completion
                # call per execution
                self._submit_batch(worker, exs)

    def _submit_pipelined(self, worker: int, ex) -> None:
        raise NotImplementedError

    def _submit_batch(self, worker: int, exs: List) -> None:
        for ex in exs:
            self._submit_pipelined(worker, ex)

    def _await_worker(self, worker: int) -> None:
        """Hook: block the dispatcher of ``worker`` until it can take a
        task (a respawning process backend worker cannot)."""

    def _halt_dispatch(self) -> None:
        """Wake dispatchers blocked on credits so they observe shutdown."""
        self._stop_dispatch = True
        if self._credits:
            for c in self._credits:
                for _ in range(self.pipeline_depth):
                    c.release()

    def shutdown(self, wait: bool = True, timeout: float = 10.0) -> None:
        self._halt_dispatch()
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
        # stats-key parity across backends (DESIGN.md §18)
        return {"backend": self.name, "control_plane": "threads"}


class ThreadExecutor(ExecutorBackend):
    """The original in-process model: invoke == plain call."""

    name = "thread"

    def invoke(self, worker, fn, args, kwargs, input_keys=None):
        return fn(*args, **kwargs)


class _Inflight:
    """One task on a worker's pipe, awaiting its FIFO-ordered reply."""

    __slots__ = ("ex", "pinned")

    def __init__(self, ex, pinned):
        self.ex = ex
        self.pinned = pinned


def start_method(mp_context: Optional[str] = None) -> str:
    """The pool's start method, resolved through the ``mp_context`` knob
    of :class:`~repro_torch.core.config.RuntimeConfig` (the argument, else
    ``RJAX_MP_CONTEXT``, else ``"spawn"``).  ``"fork"`` in a parent that
    has initialised CUDA raises: the forked children could not use the
    card."""
    method = RuntimeConfig(mp_context=mp_context).resolved("mp_context")
    if method == "fork" and torch.cuda.is_initialized():
        raise RuntimeError(
            "mp_context='fork' was asked for, but this process has initialised "
            "CUDA and a forked worker cannot re-initialise it; use 'spawn' (the "
            "default) or start the runtime before touching the card")
    return method


class ProcessExecutor(ExecutorBackend):
    """Persistent worker processes + shared-memory object plane.

    Runtime mode (``start()``) is pipelined: each worker pipe carries up
    to ``pipeline_depth`` in-flight task messages, dispatcher threads hand
    off without blocking, and one per-pool *collector* thread drains every
    worker's replies (replies are strictly FIFO per pipe, so completion
    matching is a deque pop).  Pool mode (``spawn_workers()`` +
    ``invoke()``, used by the cluster node agent) stays synchronous
    stop-and-wait per slot thread.

    ``settings`` are the torch settings the workers take at spawn (default:
    this process's, read at each spawn); a node agent passes the
    scheduler's, since it has no CUDA context of its own to read.
    ``build_kernels=False`` leaves the kernel library to the workers (a
    node agent loads no CUDA library: the scheduler built it)."""

    name = "process"
    pipelined = True

    def __init__(self, n_workers: int, label: str = "rjax",
                 mp_context: Optional[str] = None, memory_budget=None,
                 pipeline_depth: int = 1, settings: Optional[dict] = None,
                 build_kernels: bool = True):
        super().__init__(n_workers, label, pipeline_depth=pipeline_depth)
        self._ctx = get_context(start_method(mp_context))
        self.settings = settings
        self.build_kernels = build_kernels
        self.plane = SegmentPlane(memory_budget=memory_budget)
        self.plane.on_evict = self._note_evicted
        # evicted segment names each worker has not yet been told to drop;
        # drained into (and piggybacked on) that worker's next task message
        self._evict_lock = threading.Lock()
        self._pending_evicts: List[Set[str]] = [set() for _ in range(n_workers)]
        self._fns = _FnRegistry()
        self._procs: List[Any] = [None] * self.n_workers
        self._conns: List[Any] = [None] * self.n_workers
        self._conn_locks = [threading.Lock() for _ in range(self.n_workers)]
        self._shipped: List[Set[int]] = [set() for _ in range(self.n_workers)]
        self._inflight: List[collections.deque] = [collections.deque()
                                                   for _ in range(self.n_workers)]
        self._inflight_locks = [threading.Lock() for _ in range(self.n_workers)]
        self._collector: Optional[threading.Thread] = None
        self._collector_stop = threading.Event()
        self._conn_gen = 0   # bumped per (re)spawn; keys the selector registry
        # fds (beyond sibling pipe ends) that forked workers must close so
        # a dead parent actually EOFs its peers — e.g. the node agent's TCP
        # socket: a worker inheriting it would keep the scheduler's
        # connection half-open after the agent dies, masking the crash
        # (a spawned worker inherits no fd but its own pipe end)
        self.inherit_blockers: List[int] = []
        # set once a worker has reported ready: the dispatcher of a
        # respawning worker takes no task, so retried tasks go to the
        # workers that are up
        self._ready = [threading.Event() for _ in range(self.n_workers)]
        self._tl = threading.local()   # per-completion-thread decoded views
        self._closing = False
        self.worker_restarts = 0
        self.descriptor_sends = 0      # compact-descriptor fast-path hits
        self.batched_sends = 0         # multi-task M messages shipped
        # the workers' counters, summed from their replies
        self._counter_lock = threading.Lock()
        self.worker_counters: Dict[str, int] = collections.Counter()
        # deadline enforcement (DESIGN.md §19): lazily started monitor
        # killing workers whose head-of-pipe task overran its deadline_s
        self._deadline_monitor: Optional[threading.Thread] = None
        self._deadline_victims: Dict[int, Any] = {}
        self.deadline_kills = 0

    # -- process management --------------------------------------------------
    def spawn_workers(self) -> None:
        """Start the persistent worker pool.  Public because the cluster
        node agent drives this pool directly (no dispatcher threads)."""
        # the tracker must exist BEFORE the first worker starts, or each
        # worker lazily starts its own and the one-tracker accounting
        # (and its crash safety-net) silently fragments
        try:
            from multiprocessing import resource_tracker
            resource_tracker.ensure_running()
        except Exception:
            pass
        if self.build_kernels and torch.cuda.is_available():
            # build the kernel library here, once, so that no worker
            # compiles: workers load the published library
            from ..kernels import _build
            _build.library()
        for w in range(self.n_workers):
            self._spawn(w)
        # a spawned worker imports torch (and creates its CUDA context)
        # before it takes tasks: wait for every one, so the pool is up
        # when the runtime starts
        for w, conn in enumerate(self._conns):
            try:
                ready = conn.recv_bytes() if conn.poll(_READY_TIMEOUT_S) else b""
            except (EOFError, OSError):
                ready = b""
            if ready != _READY:
                raise WorkerCrashedError(f"worker process {w} did not start")
            self._ready[w].set()

    def start(self, runtime) -> None:
        # start the workers *before* the dispatcher threads exist: forking
        # a multithreaded process risks inheriting locks held mid-operation
        self.spawn_workers()
        super().start(runtime)
        self._collector = threading.Thread(target=self._collector_loop,
                                           daemon=True,
                                           name=f"{self.label}-collect")
        self._collector.start()

    def _spawn(self, worker: int) -> None:
        parent, child = self._ctx.Pipe(duplex=True)
        close_fds: List[int] = []
        if self._ctx.get_start_method() == "fork":
            # a forked worker inherits the parent-side pipe end of every
            # worker so far — INCLUDING ITS OWN.  Unless the child closes
            # them, a dead parent never EOFs the pipe
            try:
                close_fds.append(parent.fileno())
            except (OSError, ValueError):
                pass
            for c in self._conns:
                if c is not None and c is not parent:
                    try:
                        close_fds.append(c.fileno())
                    except (OSError, ValueError):
                        pass
            close_fds.extend(self.inherit_blockers)
        settings = self.settings if self.settings is not None else _torch_settings()
        p = self._ctx.Process(target=_worker_main,
                              args=(child, worker, tuple(close_fds), settings),
                              daemon=True, name=f"{self.label}-p{worker}")
        self._ready[worker].clear()
        p.start()
        child.close()
        self._procs[worker] = p
        self._conns[worker] = parent
        self._shipped[worker] = set()
        self._conn_gen += 1   # collector rebuilds its selector registry
        with self._evict_lock:   # fresh process, empty segment cache
            self._pending_evicts[worker] = set()

    @property
    def worker_pids(self) -> List[Optional[int]]:
        return [p.pid if p is not None else None for p in self._procs]

    # an idle worker's pending-evict set is drained only when it next runs
    # a task; past this size, collapse it to a drop-everything sentinel
    _EVICT_PENDING_MAX = 4096

    def _note_evicted(self, name: str) -> None:
        """Plane hook: queue an evicted segment name for every worker."""
        with self._evict_lock:
            for w, pending in enumerate(self._pending_evicts):
                if "*" in pending:
                    continue
                pending.add(name)
                if len(pending) > self._EVICT_PENDING_MAX:
                    self._pending_evicts[w] = {"*"}

    # -- the object plane ----------------------------------------------------
    @staticmethod
    def _plane_keys(structure, input_keys: Dict[int, Tuple[int, int]]) -> Dict[int, tuple]:
        """``id(leaf) -> plane key`` for every plane-eligible leaf of a
        keyed datum in ``structure``: the datum key, extended by the
        leaf's path inside the datum.  Only *keyed* data (store-resident,
        re-readable) enters the plane; a direct one-shot argument rides
        the pipe — a segment for it could never be deduped or evicted."""
        out: Dict[int, tuple] = {}

        def visit(obj, key):
            key = input_keys.get(id(obj), key)
            if isinstance(obj, _LEAVES):
                if key is not None and _shm_eligible(obj):
                    out[id(obj)] = key
            elif isinstance(obj, (list, tuple)):
                for i, o in enumerate(obj):
                    visit(o, None if key is None else key + (i,))
            elif isinstance(obj, dict):
                for k, v in obj.items():
                    visit(v, None if key is None else key + (k,))

        visit(structure, None)
        return out

    def _encode_structure(self, structure, keys: Dict[int, tuple]):
        def enc(value):
            key = keys.get(id(value))
            return value if key is None else self.plane.ensure(key, value)

        return _walk(structure, enc, _LEAVES)

    def _pack_task_bytes(self, token: int, blob: bytes, first: bool,
                         structure, evicted) -> bytes:
        """The general task message: one pickle pass with the structure
        inline; cloudpickle fallback rides a ``Q`` message."""
        fn_field = blob if first else b""
        try:
            return b"P" + pickle.dumps((token, fn_field, structure, evicted),
                                       protocol=5)
        except Exception:
            if _cloudpickle is None:
                raise
            return b"Q" + pickle.dumps(
                (token, fn_field, _cloudpickle.dumps(structure), evicted),
                protocol=5)

    def _decode_result(self, blob) -> Any:
        views: Dict[int, ShmRef] = {}

        def dec(ref: ShmRef):
            value, fresh = self.plane.attach(ref)
            if fresh:   # newly adopted: publish() aliases it or task_done() reclaims it
                views[id(value)] = ref
            return value

        result = _walk(pickle.loads(blob), dec, (ShmRef,))
        self._tl.views = views   # consumed by publish() in the same thread
        return result

    def publish(self, key, value):
        """Alias just-decoded result segments to plane keys (the datum key,
        extended by each leaf's path), so later reads of the datum ship a
        ref instead of bytes."""
        views = getattr(self._tl, "views", None)
        if not views:
            return
        for path, leaf in _leaf_paths(value):
            ref = views.pop(id(leaf), None)
            if ref is not None:
                self.plane.alias(key + path, ref)

    def task_done(self):
        """Dispose result segments that were adopted but never published —
        discarded outputs (``returns=0``), lost speculation races, arity
        failures — so anonymous segments cannot accumulate."""
        views = getattr(self._tl, "views", None)
        if views:
            for ref in views.values():
                self.plane.drop_anonymous(ref.name)
        self._tl.views = None

    # -- pipelined dispatch --------------------------------------------------
    def _await_worker(self, worker: int) -> None:
        self._ready[worker].wait()

    def _halt_dispatch(self) -> None:
        super()._halt_dispatch()
        for ev in self._ready:   # wake dispatchers of workers still starting
            ev.set()

    def _submit_batch(self, worker: int, exs: List) -> None:
        """Ship up to ``pipeline_depth`` claimed tasks in ONE pipe write
        (an ``M`` batch when more than one).  Every task ends up either in
        the in-flight FIFO (the collector completes it) or completed here
        (encode/send failure)."""
        items: List[Tuple[bytes, _Inflight]] = []
        with self._conn_locks[worker]:
            conn = self._conns[worker]
            for ex in exs:
                structure = (ex.args, ex.kwargs)
                keys = self._plane_keys(structure, ex.input_keys)
                # pin this task's plane keys BEFORE encoding plants them in
                # the plane: a concurrent reclaim could otherwise evict a
                # segment between its ensure() and the send.  Unpinned at
                # completion.
                pinned = frozenset(keys.values())
                if self.plane.governor is not None and pinned:
                    self.plane.governor.pin_many(pinned)
                try:
                    token, blob = self._fns.entry(ex.t.fn)
                    structure = self._encode_structure(structure, keys)
                    first = token not in self._shipped[worker]
                    with self._evict_lock:
                        evicted = tuple(self._pending_evicts[worker])
                        self._pending_evicts[worker] = set()
                    args_s, kwargs_s = structure
                    if not first and not kwargs_s \
                            and isinstance(args_s, tuple) \
                            and all(type(a) is ShmRef for a in args_s):
                        # the common all-keyed-leaf case: compact binary
                        # descriptor, no per-task pickle frame
                        msg = _pack_descriptor(token, evicted, args_s)
                        self.descriptor_sends += 1
                    else:
                        msg = self._pack_task_bytes(token, blob, first,
                                                    structure, evicted)
                        if first:
                            # committed optimistically: a failed send is a
                            # crash, and respawn resets the shipped set
                            self._shipped[worker].add(token)
                except BaseException as err:   # encode failure: task fails
                    self._finish_entry(worker, _Inflight(ex, pinned), error=err)
                    continue
                items.append((msg, _Inflight(ex, pinned)))
            if not items:
                return
            if len(items) == 1:
                out = items[0][0]
            else:
                parts = [b"M", _BATCH_U32.pack(len(items))]
                for msg, _ in items:
                    parts.append(_BATCH_U32.pack(len(msg)))
                    parts.append(msg)
                out = b"".join(parts)
                self.batched_sends += 1
            with self._inflight_locks[worker]:
                for _, entry in items:
                    self._inflight[worker].append(entry)
            if any(entry.ex.t.deadline_s is not None for _, entry in items):
                self._ensure_deadline_monitor()
            try:
                conn.send_bytes(out)
                return   # in flight; the collector completes them
            except BaseException as err:
                # send failed — usually a crashed worker.  If the collector
                # already drained our entries (it races us on EOF), it owns
                # those completions; we own whatever is still queued.
                owned = []
                with self._inflight_locks[worker]:
                    for _, entry in items:
                        try:
                            self._inflight[worker].remove(entry)
                            owned.append(entry)
                        except ValueError:
                            pass
                for entry in owned:
                    crash = WorkerCrashedError(
                        f"worker process {worker} died executing "
                        f"{getattr(entry.ex.t.fn, '__name__', entry.ex.t.fn)!r}")
                    crash.__cause__ = err
                    self._finish_entry(worker, entry, error=crash)

    def _finish_entry(self, worker: int, entry: _Inflight, *,
                      result: Any = None, error: Optional[BaseException] = None
                      ) -> None:
        """Exactly-once completion bookkeeping for one in-flight task."""
        rt = self.runtime
        try:
            if error is not None:
                rt.fail_task(entry.ex, error)
            else:
                rt.complete_task(entry.ex, result)
        finally:
            if self.plane.governor is not None and entry.pinned:
                self.plane.governor.unpin_many(entry.pinned)
                # admits under a fully-pinned working set skip eviction;
                # re-enforce the watermark now that this task's pins are off
                self.plane.reclaim()
            self.task_done()
            rt._note_worker_idle()
            self._credits[worker].release()

    def _collector_loop(self) -> None:
        import selectors
        sel = selectors.DefaultSelector()
        my_gen = -1
        try:
            while not self._collector_stop.is_set():
                if my_gen != self._conn_gen:
                    # a worker was (re)spawned: rebuild the registry
                    my_gen = self._conn_gen
                    sel.close()
                    sel = selectors.DefaultSelector()
                    for w, c in enumerate(self._conns):
                        if c is not None:
                            try:
                                sel.register(c, selectors.EVENT_READ, w)
                            except (ValueError, OSError):
                                pass
                try:
                    events = sel.select(timeout=0.1)
                except OSError:
                    time.sleep(0.005)
                    continue
                for key, _ in events:
                    w, conn = key.data, key.fileobj
                    if self._conns[w] is not conn:
                        continue
                    # one message per event: the selector is level-triggered
                    try:
                        self._collect_one(w, conn)
                    except BaseException:
                        # a completion that raises must not kill the ONLY
                        # collector — that would freeze every pipeline
                        import traceback
                        traceback.print_exc()
        finally:
            sel.close()

    def _collect_one(self, w: int, conn) -> None:
        try:
            resp = conn.recv_bytes()
        except (EOFError, OSError):
            self._on_worker_crash(w, conn)
            return
        if resp == _READY:   # a respawned worker is up
            self._ready[w].set()
            return
        kind, counters, payload = _unpack_reply(resp)
        self._note_counters(counters)
        with self._inflight_locks[w]:
            entry = (self._inflight[w].popleft()
                     if self._inflight[w] else None)
        if entry is None:
            return   # stray reply (e.g. raced a crash drain)
        if kind == b"K":
            self._tl.views = None
            try:
                result = self._decode_result(payload)
            except BaseException as err:
                self._finish_entry(w, entry, error=err)
            else:
                self._finish_entry(w, entry, result=result)
        else:
            enc, tb = pickle.loads(payload)
            self._finish_entry(w, entry, error=_rebuild_remote_error(enc, tb))

    def _on_worker_crash(self, worker: int, conn) -> None:
        """EOF on a worker pipe: fail EVERY in-flight task of that worker
        as a retryable crash and respawn it."""
        with self._conn_locks[worker]:
            if self._conns[worker] is not conn:
                return   # already handled
            with self._inflight_locks[worker]:
                entries = list(self._inflight[worker])
                self._inflight[worker].clear()
            if self._closing:
                try:
                    conn.close()
                except Exception:
                    pass
                self._conns[worker] = None
            else:
                self._restart(worker)
        victim = self._deadline_victims.pop(worker, None)
        n = len(entries)
        for entry in entries:
            if entry is victim:
                err: WorkerCrashedError = DeadlineExceededError(
                    f"task {entry.ex.t.name!r} exceeded its deadline of "
                    f"{entry.ex.t.deadline_s}s on worker {worker} (killed)")
            else:
                err = WorkerCrashedError(
                    f"worker process {worker} died with {n} task(s) in flight "
                    f"(executing up to {entry.ex.t.name!r})")
            self._finish_entry(worker, entry, error=err)

    # -- deadline enforcement (DESIGN.md §19) --------------------------------
    def kill_worker(self, worker: int) -> None:
        """SIGKILL a (wedged) worker *without* respawning it here: the
        pipe EOF surfaces in the collector's crash handler, and THAT path
        does the single restart.  A killed worker's CUDA context and
        card memory are freed with its process."""
        proc = self._procs[worker]
        try:
            if proc is not None and proc.is_alive():
                proc.kill()
        except Exception:
            pass

    def _ensure_deadline_monitor(self) -> None:
        if self._deadline_monitor is not None or self._closing:
            return
        t = threading.Thread(target=self._deadline_loop, daemon=True,
                             name=f"{self.label}-deadline")
        self._deadline_monitor = t
        t.start()

    def _deadline_loop(self) -> None:
        """Kill workers whose head-of-pipe task overran its deadline.
        Replies are FIFO per pipe, so head-of-queue residency is the
        closest observable proxy for "the body is running"."""
        heads: Dict[int, Tuple[Any, float]] = {}
        while not self._closing and not self._collector_stop.is_set():
            now = time.monotonic()
            for w in range(self.n_workers):
                with self._inflight_locks[w]:
                    entry = self._inflight[w][0] if self._inflight[w] else None
                if entry is None:
                    heads.pop(w, None)
                    continue
                prev = heads.get(w)
                if prev is None or prev[0] is not entry:
                    heads[w] = (entry, now)
                    continue
                dl = entry.ex.t.deadline_s
                if dl is not None and now - prev[1] > dl:
                    self._deadline_victims[w] = entry
                    self.deadline_kills += 1
                    self.kill_worker(w)
                    heads.pop(w, None)
            time.sleep(0.02)

    def running_task(self, worker: int) -> Optional[str]:
        """The name of the task at the head of ``worker``'s pipe (the one
        its body is running, or about to), or None."""
        with self._inflight_locks[worker]:
            q = self._inflight[worker]
            return q[0].ex.t.name if q else None

    def _note_counters(self, counters: Dict[str, int]) -> None:
        if counters:
            with self._counter_lock:
                self.worker_counters.update(counters)

    # -- synchronous invocation (pool mode: the cluster node agent) ----------
    def invoke(self, worker, fn, args, kwargs, input_keys=None):
        """Run one task on ``worker`` and wait for its reply.  Keyed
        inputs enter the plane leaf by leaf (the datum key extended by the
        leaf's path), as in the pipelined mode.  The reply's counter
        deltas (this task's launches, uploads, the worker's reserved card
        bytes) are summed into ``stats()`` and left for the calling thread
        in :meth:`last_counters`."""
        self._tl.deltas = {}
        token, blob = self._fns.entry(fn)
        structure = (args, kwargs)
        keys = self._plane_keys(structure, input_keys or {})
        # pin this task's plane keys for the whole round-trip: a ref on
        # the pipe must never point at a segment the governor unlinked
        pinned = frozenset(keys.values())
        if self.plane.governor is not None and pinned:
            self.plane.governor.pin_many(pinned)
        try:
            structure = self._encode_structure(structure, keys)
            with self._conn_locks[worker]:
                conn = self._conns[worker]
                first = token not in self._shipped[worker]
                with self._evict_lock:
                    evicted = tuple(self._pending_evicts[worker])
                    self._pending_evicts[worker] = set()
                try:
                    if not self._ready[worker].is_set():
                        # a respawned worker: its ready message comes first
                        ready = conn.recv_bytes() if conn.poll(_READY_TIMEOUT_S) else b""
                        if ready != _READY:
                            raise EOFError(f"worker process {worker} did not start")
                        self._ready[worker].set()
                    conn.send_bytes(self._pack_task_bytes(
                        token, blob, first, structure, evicted))
                    self._shipped[worker].add(token)
                    resp = conn.recv_bytes()
                except (EOFError, OSError) as err:
                    if not self._closing:
                        self._restart(worker)
                    raise WorkerCrashedError(
                        f"worker process {worker} died executing "
                        f"{getattr(fn, '__name__', fn)!r}") from err
            kind, counters, payload = _unpack_reply(resp)
            self._note_counters(counters)
            self._tl.deltas = counters
            if kind == b"K":
                # decode while the inputs stay pinned: a pass-through
                # result reships an input ref, which must still attach
                return self._decode_result(payload)
        finally:
            if self.plane.governor is not None and pinned:
                self.plane.governor.unpin_many(pinned)
        enc, tb = pickle.loads(payload)
        raise _rebuild_remote_error(enc, tb)

    def last_counters(self) -> Dict[str, int]:
        """Take the counter deltas of this thread's last :meth:`invoke`
        reply (empty once taken, and after an invoke that got none)."""
        deltas = getattr(self._tl, "deltas", None) or {}
        self._tl.deltas = {}
        return dict(deltas)

    def _restart(self, worker: int) -> None:
        self.worker_restarts += 1
        proc = self._procs[worker]
        try:
            if proc is not None and proc.is_alive():
                proc.terminate()
                proc.join(timeout=2.0)
        except Exception:
            pass
        old = self._conns[worker]
        if old is not None:
            try:
                old.close()
            except Exception:
                pass
        self._spawn(worker)

    # -- lifecycle -----------------------------------------------------------
    def shutdown(self, wait: bool = True, timeout: float = 10.0) -> None:
        self._closing = True
        self._halt_dispatch()
        for w, conn in enumerate(self._conns):
            if conn is None:
                continue
            # a slot thread blocked in recv holds the lock (pool mode):
            # skip the polite exit for that worker and terminate it below
            if self._conn_locks[w].acquire(timeout=0.5 if wait else 0.05):
                try:
                    conn.send_bytes(b"X")
                except Exception:
                    pass
                finally:
                    self._conn_locks[w].release()
        for p in self._procs:
            if p is None:
                continue
            p.join(timeout=5.0 if wait else 0.2)
            if p.is_alive():
                try:
                    p.terminate()
                    p.join(timeout=1.0)
                except Exception:
                    pass
        self._collector_stop.set()
        if self._collector is not None:
            self._collector.join(timeout=2.0)
        for conn in self._conns:
            try:
                if conn is not None:
                    conn.close()
            except Exception:
                pass
        super().shutdown(wait=wait, timeout=timeout)
        self.plane.close()

    def stats(self) -> dict:
        with self._counter_lock:
            counters = dict(self.worker_counters)
        s = {"backend": self.name, "control_plane": "threads",
             "start_method": self._ctx.get_start_method(),
             "worker_pids": self.worker_pids,
             "worker_restarts": self.worker_restarts,
             "pipeline_depth": self.pipeline_depth,
             "descriptor_sends": self.descriptor_sends,
             "batched_sends": self.batched_sends,
             "deadline_kills": self.deadline_kills,
             "kernel_launches": {k.split(":", 1)[1]: v for k, v in counters.items()
                                 if k.startswith("launches:")},
             "card_bytes_by_pid": {int(k.split(":", 1)[1]): v for k, v in counters.items()
                                   if k.startswith("card_bytes:")}}
        for k in ("worker_cache_hits", "device_uploads", "device_upload_bytes",
                  "device_uploads_saved"):
            s[k] = counters.get(k, 0)
        s.update(self.plane.stats())
        return s


class ClusterExecutor(ExecutorBackend):
    """Dispatch tasks to TCP node agents (DESIGN.md §12).

    Slot ``worker`` maps to agent ``worker // workers_per_node``, which
    is also the task's locality domain, so the ``locality`` policy
    scores real cross-node residency.  Each slot streams up to
    ``pipeline_depth`` task requests before any completion arrives
    (DESIGN.md §14).

    Two control planes (``RJAX_CONTROL_PLANE`` / the ``control_plane``
    knob, DESIGN.md §18): the default ``async`` plane runs every channel
    as a coroutine pair on one IOLoop thread and dispatches from a loop
    pump — scheduler-side thread count is O(1) in agent count; the
    legacy ``threads`` plane keeps one dispatcher thread per slot and
    one reader thread per channel, with replies routed on the reader.

    Data plane: the scheduler tracks, per agent, which keys that node
    already caches.  A keyed array or tensor input is shipped inside the
    task message (``Put``) the *first* time a node needs it and referenced
    (``Ref``) ever after — the wire-level send-once/reuse-many property.
    Results at or above the inline threshold stay node-resident and come
    back as :class:`~repro_torch.core.futures.RemoteValue` descriptors;
    smaller ones come back tagged with agent-side cache tokens, and when
    the runtime publishes them an ``alias`` control message pins them
    into the producing node's plane under their datum key, so a node
    never re-downloads its own outputs.

    Device values cross as host bytes (tensor frames of
    :mod:`repro_torch.cluster.protocol`): a node agent holds host bytes
    only and never touches the card; its spawned pool workers rebuild a
    tensor on the device it lived on, and this process uploads a card
    result only when ``Future.result`` reads it.  Each ``done`` reply
    carries the counter deltas of that task's pool reply (kernel
    launches, device uploads, the worker's reserved card bytes), summed
    into ``stats()`` as under the process backend.

    Per-agent consistency relies on connection FIFO ordering: residency
    marks and the messages that justify them are emitted under one
    per-agent ordering lock, so a ``Ref`` can never overtake its ``Put``
    or ``alias`` on the wire — pipelining does not change this, because
    the marks are made at *send* time under the same lock.

    Failure model: a dropped agent connection fails every in-flight task
    on that agent as a retryable :class:`WorkerCrashedError`; if the
    cluster harness can respawn the agent, the executor does so and clears
    that node's residency ledger, after which retries re-ship whatever the
    replacement needs.
    """

    name = "cluster"
    pipelined = True
    # dispatch resolves inputs WITHOUT materializing node-resident
    # results: RemoteValue placeholders flow through pack_payload as
    # Ref/Fetch directives instead (DESIGN.md §15)
    remote_values_ok = True

    def __init__(self, n_workers: int, label: str = "rjax", cluster=None,
                 pipeline_depth: int = 1, p2p=None, control_plane=None,
                 liveness=None, suspicion_s=None, reconnect_grace_s=None,
                 replication=None):
        super().__init__(n_workers, label, pipeline_depth=pipeline_depth)
        from .config import parse_bool, resolve as resolve_knob
        from .fault import LivenessConfig
        if cluster is None:
            raise ValueError(
                'backend="cluster" needs a cluster= harness '
                "(e.g. repro_torch.cluster.LocalCluster)")
        self.cluster = cluster
        self.n_agents = int(cluster.n_agents)
        self.wpn = int(cluster.workers_per_node)
        if self.n_workers != self.n_agents * self.wpn:
            raise ValueError(
                f"n_workers={self.n_workers} != n_agents({self.n_agents}) x "
                f"workers_per_node({self.wpn})")
        # peer data plane kill-switch: RJAX_P2P=0 restores the §12
        # star topology (every result framed back to the scheduler)
        self.p2p = resolve_knob(p2p, "RJAX_P2P", default=True,
                                cast=parse_bool)
        # scheduler comm layer (DESIGN.md §18): "async" = one IOLoop
        # thread owns every channel + the dispatch pump (O(1) threads in
        # agent count); "threads" = the legacy reader-thread-per-channel
        # + dispatcher-thread-per-slot structure
        self.control_plane = resolve_knob(
            control_plane, "RJAX_CONTROL_PLANE", default="async")
        if self.control_plane not in ("async", "threads"):
            raise ValueError(
                f"control_plane must be 'async' or 'threads', "
                f"got {self.control_plane!r}")
        self.async_plane = self.control_plane == "async"
        # liveness failure detector (DESIGN.md §19): suspicion over
        # heartbeat age + in-flight request deadlines; a dead verdict
        # closes the channel, driving the normal on_close recovery
        self.liveness_cfg = LivenessConfig(
            enabled=resolve_knob(liveness, "RJAX_LIVENESS",
                                 default=True, cast=parse_bool),
            suspicion_s=resolve_knob(suspicion_s, "RJAX_SUSPICION_S",
                                     default=5.0, cast=float))
        self._detector = None
        self._liveness_stop = threading.Event()
        self._liveness_thread: Optional[threading.Thread] = None
        # per-agent in-flight scheduler-side deadlines: id(ex) ->
        # monotonic kill time (deadline + slack), under _stats_lock.
        # The agent watchdog fires first at deadline_s; this is the
        # backstop for an agent too wedged to run its own watchdog
        self._deadline_inflight: List[Dict[int, float]] = []
        self._deadline_slack = 0.0
        self.liveness_kills = 0
        # session resumption (DESIGN.md §20): on a TCP disconnect the
        # agent is PARKED for a grace window and allowed to re-dial with
        # its session token instead of being killed and replayed.  Only
        # wired on the async plane (the legacy channel starts its
        # on_close thread before consulting the adoption hook, so parking
        # there would race the restart path).
        self.reconnect_grace_s = resolve_knob(
            reconnect_grace_s, "RJAX_RECONNECT_GRACE_S", default=5.0,
            cast=float)
        self.resumption = self.async_plane and self.reconnect_grace_s > 0
        # asynchronous k-way replication (DESIGN.md §20): node-resident
        # results whose producer cost clears the duration threshold are
        # pushed to k buddy planes over the existing p2p bcast leg
        self.replication = resolve_knob(
            replication, "RJAX_REPLICATION", default=0, cast=int)
        self._io = None            # IOLoop (async control plane only)
        self._recovery = None      # small pool for blocking recovery work
        self._agent_up = [True] * self.n_agents
        # agents being replaced right now: a late failure callback of the
        # dead channel must not park it for a resumption it cannot make
        self._restarting: Set[int] = set()
        self._channels: List[Any] = [None] * self.n_agents
        self._data_addrs: List[Optional[str]] = [None] * self.n_agents
        self._order_locks = [threading.Lock() for _ in range(self.n_agents)]
        self._restart_lock = threading.Lock()
        self._resident: List[Set[Tuple[int, int]]] = [set() for _ in range(self.n_agents)]
        self._shipped_fns: List[Set[int]] = [set() for _ in range(self.n_agents)]
        self._fns = _FnRegistry()
        self._peers = None         # scheduler-side PeerPool (gather path)
        self._tl = threading.local()
        self._closing = False
        # data-plane counters are bumped from per-agent channel reader
        # threads AND dispatcher threads — bare += across threads loses
        # updates, and relay_bytes is the CI-gated §15 acceptance metric
        self._stats_lock = threading.Lock()
        # first agent each scheduler-resident key was Put to (key ->
        # (agent, nbytes), under _stats_lock): later agents needing the
        # same key pull it agent→agent instead of costing a second copy
        # over our own link (the broadcast-residue fix, DESIGN.md §16)
        self._put_home: Dict[Tuple[int, int], Tuple[int, int]] = {}
        # residency generations (§20): per-(agent, key) counter bumped on
        # every residency MARK the scheduler sends (Put/Fetch/alias/bcast
        # leg); the agent bumps its mirror on receipt.  Equal counters at
        # resume time prove the mark landed — the manifest reconciliation
        # predicate.  Survives _drop_residency (a strike is not a
        # process death); reset only when the process is replaced.
        # Guarded by _order_locks[a], like _resident.
        self._res_gen: List[Dict[Tuple[int, int], int]] = [
            dict() for _ in range(self.n_agents)]
        # process generation per agent: bumped in _restart_agent only.
        # Result-token views carry the gen they were minted under so
        # publish/drop never talk to a replacement process, while tokens
        # minted before a RESUME (same process) stay valid.
        self._proc_gen = [0] * self.n_agents
        # parked agents: a -> {"ch", "token", "pending", "next_mid",
        # "deadline", "timer", "state"}; under _park_lock.  "state" moves
        # disconnected -> reconnecting while _on_resume reconciles.
        self._park_lock = threading.Lock()
        self._disconnected: Dict[int, dict] = {}
        # ops (alias/drop) that arrived while the agent was parked; each
        # list guarded by _order_locks[a], flushed on resume in order
        self._parked_ops: List[list] = [[] for _ in range(self.n_agents)]
        # in-flight task sends by mid: a -> {mid: (worker, ex)}.  A mid
        # the resumed agent never received maps back to its task here and
        # is re-submitted on the new channel instead of burning a retry
        # (GIL-atomic dict ops; entries die with the reply or restart)
        self._inflight_reqs: List[Dict[int, tuple]] = [
            dict() for _ in range(self.n_agents)]
        # replica locations: key -> set of agents holding a pushed copy
        # (beyond the producer); under _stats_lock
        self._replicas: Dict[Tuple[int, int], Set[int]] = {}
        self.reconnects = 0        # sessions resumed in place
        self.replica_bytes = 0     # bytes pushed to buddy planes
        self.replica_hits = 0      # lost keys served from a replica
        self.agent_restarts = 0
        self.broadcasts = 0        # collective broadcast waves completed
        self.puts = 0              # keyed datums shipped to some node
        self.refs = 0              # keyed datums referenced, not re-shipped
        self.fetches = 0           # peer-fetch directives issued
        self.fetch_bytes = 0       # bytes those directives moved node↔node
        self.bytes_shipped = 0     # scheduler→agent Put bytes
        self.relay_result_bytes = 0   # agent→scheduler result frame bytes
        self.remote_results = 0       # datums left node-resident
        self.deferred_result_bytes = 0  # bytes that never crossed our link
        # the agents' pool counters, summed from the done replies
        self._counter_lock = threading.Lock()
        self.worker_counters: Dict[str, int] = collections.Counter()

    # -- lifecycle -----------------------------------------------------------
    def start(self, runtime) -> None:
        from ..cluster.peer import PeerPool
        from ..cluster.protocol import inline_max_from_env
        from .telemetry import heartbeat_interval
        if torch.cuda.is_available():
            # build the kernel library here, once, before any task runs:
            # the agents' pool workers load the published library, and
            # the agents themselves load no CUDA library at all
            from ..kernels import _build
            _build.library()
        self.cluster.p2p = self.p2p
        # ship the scheduler-side inline threshold in the welcome, so
        # external agents on other hosts apply the same encoding policy
        if getattr(self.cluster, "inline_max", None) is None:
            self.cluster.inline_max = inline_max_from_env()
        # likewise the heartbeat cadence (DESIGN.md §17): resolved here
        # from the scheduler's environment so off-host agents beat in step
        if getattr(self.cluster, "heartbeat_s", None) is None:
            self.cluster.heartbeat_s = heartbeat_interval()
        # grace window rides the welcome so agents know to re-dial
        # (None disables the agent-side reconnect loop entirely)
        if hasattr(self.cluster, "reconnect_grace_s"):
            self.cluster.reconnect_grace_s = (
                self.reconnect_grace_s if self.resumption else None)
        if self.async_plane:
            from ..cluster.eventloop import AsyncAgentChannel, IOLoop
            self._io = IOLoop(name=f"{self.label}-io")
            # every accepted/respawned agent connection becomes a
            # coroutine pair on the one loop instead of a reader thread
            self.cluster.channel_factory = (
                lambda sock, nid, hello: AsyncAgentChannel(
                    sock, nid, hello, io=self._io))
        try:
            self._channels = self.cluster.accept_agents()
        except Exception:
            self.cluster.shutdown()
            if self._io is not None:
                self._io.stop()
            raise
        self._peers = PeerPool(label=f"{self.label}-sched")
        # arm the failure detector BEFORE channels are installed so
        # note_install (the synthetic first beat) has somewhere to land
        from .fault import FailureDetector
        self._detector = FailureDetector(
            self.liveness_cfg, float(self.cluster.heartbeat_s or 0.0))
        self._deadline_slack = max(
            1.0, 2.0 * float(self.cluster.heartbeat_s or 0.0))
        self._deadline_inflight = [dict() for _ in range(self.n_agents)]
        for a, ch in enumerate(self._channels):
            self._install_channel(a, ch)
        if self.resumption and hasattr(self.cluster, "start_acceptor"):
            # re-dials land on the harness's background acceptor and are
            # routed here with the session token for reconciliation
            self.cluster.start_acceptor(self._on_resume)
        runtime.store.set_fetcher(self._fetch_remote)
        if self.liveness_cfg.enabled:
            self._liveness_thread = threading.Thread(
                target=self._liveness_loop, daemon=True,
                name=f"{self.label}-liveness")
            self._liveness_thread.start()
        if not self.async_plane:
            super().start(runtime)
            return
        # async control plane (DESIGN.md §18): no dispatcher threads.
        # The scheduler's ready hook and every completion re-enter the
        # dispatch pump on the loop; blocking recovery work (agent
        # respawn, lost-input waits) is offloaded to a 2-thread pool so
        # the loop never stalls — total scheduler-side thread count is
        # O(1) in agent count.
        from concurrent.futures import ThreadPoolExecutor
        from .runtime import InputsPending
        self._inputs_pending = InputsPending
        self.runtime = runtime
        self._credits = [threading.Semaphore(self.pipeline_depth)
                         for _ in range(self.n_workers)]
        self._recovery = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix=f"{self.label}-recover")
        runtime.scheduler.on_ready = self._schedule_pump
        self._io.call_soon(self._pump)

    def _install_channel(self, a: int, ch) -> None:
        self._data_addrs[a] = ch.data_addr()
        ch.on_close = lambda _a=a, _ch=ch: self._on_channel_down(_a, _ch)
        ch.on_push = lambda meta, frames, _a=a: self._on_push(_a, meta)
        if self.resumption:
            # the channel consults this before erroring its in-flight
            # slots: True = the executor adopted them (parked, awaiting a
            # session resume); False = fail them retryably as before
            ch.on_lost_pending = (
                lambda pending, _a=a, _ch=ch:
                    self._maybe_park(_a, _ch, pending))
        if self._detector is not None:
            self._detector.note_install(a)

    def _on_push(self, a: int, meta: dict) -> None:
        """Agent-initiated push (channel reader thread): feed the failure
        detector and route heartbeats into the runtime's telemetry hub.
        Guarded — the first beats can arrive before ``super().start``
        binds the runtime."""
        if meta.get("op") != "hb" or self._closing:
            return
        if self._detector is not None:
            # liveness is independent of whether telemetry is enabled
            self._detector.note_beat(a)
        rt = self.runtime
        if rt is not None:
            rt.telemetry.note_heartbeat(meta.get("node", a),
                                        meta.get("stats") or {})

    def _on_channel_down(self, a: int, ch) -> None:
        """Connection-death hook: recover even when nothing was in
        flight — the dead node may hold the only copy of published
        results (DESIGN.md §15)."""
        if self._detector is not None:
            # this hook runs on the dead channel's drain thread and can
            # arrive AFTER a session resume already installed (and
            # note_install-ed) the successor — wiping the fresh view
            # would read as an instant DEAD verdict on the next liveness
            # poll.  The order lock serializes against _do_resume's swap.
            with self._order_locks[a]:
                if self._channels[a] is ch:
                    self._detector.note_removed(a)
        if self._closing:
            return
        # session resumption (§20): a parked channel's recovery belongs
        # to the grace timer / resume handler, not the restart path.
        # _maybe_park is idempotent — on_lost_pending (fires only when
        # requests were in flight) and this hook race freely, and an idle
        # disconnect (no pending) parks here.
        if ch is not None and self._maybe_park(a, ch, {}):
            self._agent_up[a] = False
            return
        if self.async_plane:
            self._kick_restart(a, ch)
        else:
            self._restart_agent(a, ch)

    # -- liveness monitor (DESIGN.md §19) ------------------------------------
    def _liveness_loop(self) -> None:
        """Poll the failure detector and act on ``dead`` verdicts by
        closing the node's channel — everything downstream (failing the
        in-flight tasks retryable, respawn, §15 lineage re-execution) is
        the one existing ``on_close`` recovery path."""
        from .fault import DEAD
        det = self._detector
        poll = max(0.02, min(0.25, self.liveness_cfg.suspicion_s / 8.0))
        while not self._liveness_stop.wait(poll):
            if self._closing:
                return
            for a in range(self.n_agents):
                ch = self._channels[a]
                if ch is None or ch.closed or not self._agent_up[a]:
                    continue   # down or respawning: recovery owns it
                dl = self._deadline_inflight[a]
                if dl:
                    with self._stats_lock:
                        oldest = min(dl.values()) if dl else None
                    det.note_deadline(a, oldest)
                else:
                    det.note_deadline(a, None)
                if det.assess(a) == DEAD:
                    with self._stats_lock:
                        self.liveness_kills += 1
                    # a liveness verdict means the PROCESS is gone or
                    # wedged — never park this channel for resumption
                    ch.liveness_killed = True
                    ch.close()

    # -- async dispatch pump (DESIGN.md §18) ---------------------------------
    def _schedule_pump(self) -> None:
        io = self._io
        if io is not None and not self._stop_dispatch:
            io.call_soon(self._pump)

    def _pump(self) -> None:
        """The dispatch loop, as a loop callback: drain ready tasks into
        free credits, no dispatcher threads.  Runs on the IOLoop, so it
        must never block — credit acquire and scheduler take are
        non-blocking polls, and input resolution that would wait (a
        lost-node recovery race) is offloaded to a thread of its own,
        which gives the worker's credit back while it waits."""
        rt = self.runtime
        if rt is None or self._stop_dispatch:
            return
        for worker in range(self.n_workers):
            if not self._agent_up[worker // self.wpn]:
                continue
            credits = self._credits[worker]
            node_id = rt.locality_domain(worker)
            while credits.acquire(blocking=False):
                if self._stop_dispatch:
                    credits.release()
                    return
                tid = rt.scheduler.take(worker, timeout=0)
                if tid is None:
                    credits.release()
                    break
                rt._note_worker_busy()
                try:
                    ex = rt.begin_task(tid, worker, node_id,
                                       block_inputs=False)
                except self._inputs_pending as pend:
                    # the claim waits for an input that lineage recovery
                    # is re-executing: its credit goes back meanwhile, or
                    # waiting consumers could hold every credit the
                    # re-executed producers need to be dispatched
                    credits.release()
                    threading.Thread(target=self._resume_begin, args=(worker, pend),
                                     daemon=True, name=f"{self.label}-pending").start()
                    continue
                if ex is None:   # cancelled / completed during resolution
                    rt._note_worker_idle()
                    credits.release()
                    continue
                self._submit_pipelined(worker, ex)

    def _resume_begin(self, worker: int, pend) -> None:
        """Tail of a non-blocking ``begin_task``, off the loop: wait for
        the straggling input (or its error), take a credit of the worker
        again, then submit."""
        rt = self.runtime
        ex = rt.resume_begin(pend)
        if ex is None:
            rt._note_worker_idle()
            self._schedule_pump()
            return
        self._credits[worker].acquire()
        self._submit_pipelined(worker, ex)

    def _kick_restart(self, a: int, ch, park: bool = True) -> None:
        """Route an agent death to a thread of its own: respawn blocks on
        process spawn + handshake, which must never run on the loop, and
        it must not queue behind the recovery pool either, whose threads
        may all be waiting for inputs that only this recovery brings back
        (lineage re-execution of the dead node's results).  The agent's
        workers are skipped by the pump until the replacement is up.
        ``park=False`` is the resumption machinery giving up on a session
        (grace expired / resume failed): the respawn must proceed, never
        re-park the same dead channel."""
        if self._closing:
            return
        # a caller that observed ``closed`` before the park registered
        # (the flag flips a beat earlier) must not respawn a channel the
        # resume path owns — park it here instead (idempotent)
        if park and ch is not None and self._maybe_park(a, ch, {}):
            self._agent_up[a] = False
            return
        self._agent_up[a] = False

        def work():
            try:
                self._restart_agent(a, ch)
            finally:
                new_ch = self._channels[a]
                self._agent_up[a] = new_ch is not None and not new_ch.closed
                self._schedule_pump()

        threading.Thread(target=work, daemon=True,
                         name=f"{self.label}-respawn{a}").start()

    def _fetch_remote(self, key, rv, timeout=None):
        """The store's gather-path materializer: pull a node-resident
        datum straight from its producer's data plane, within the
        caller's remaining deadline when one was given."""
        from ..cluster.peer import PEER_FETCH_TIMEOUT, PeerFetchError
        if rv.addr is None or self._peers is None:
            raise PeerFetchError(
                f"no data-plane address for node {rv.node} "
                f"(d{key[0]}v{key[1]})")
        t = PEER_FETCH_TIMEOUT if timeout is None \
            else max(0.1, min(timeout, PEER_FETCH_TIMEOUT))
        return self._peers.fetch(rv.addr, key, rv.token, timeout=t)

    def shutdown(self, wait: bool = True, timeout: float = 10.0) -> None:
        from ..cluster.protocol import ConnectionClosed
        self._closing = True
        self._liveness_stop.set()
        if self._liveness_thread is not None:
            self._liveness_thread.join(timeout=2.0)
        self._halt_dispatch()
        if self.runtime is not None:
            self.runtime.store.set_fetcher(None)
            sched = getattr(self.runtime, "scheduler", None)
            if sched is not None and getattr(sched, "on_ready", None) is not None:
                sched.on_ready = None
        for ch in self._channels:
            if ch is not None and not ch.closed:
                try:
                    ch.post({"op": "exit"})
                except ConnectionClosed:
                    pass
        super().shutdown(wait=wait, timeout=timeout)
        if self._recovery is not None:
            # pending respawns observe _closing and exit fast; an
            # in-flight one must not wedge shutdown
            self._recovery.shutdown(wait=False, cancel_futures=True)
        if self._peers is not None:
            self._peers.close()
        for ch in self._channels:
            if ch is not None:
                ch.close()
        try:
            self.cluster.shutdown()
        except Exception:
            pass
        if self._io is not None:
            self._io.stop()

    # -- pipelined dispatch --------------------------------------------------
    def _submit_pipelined(self, worker: int, ex) -> None:
        from ..cluster.protocol import ConnectionClosed, pack_payload
        a, slot = divmod(worker, self.wpn)
        ch = self._channels[a]
        if ch is None or ch.closed:
            if self.async_plane:
                # a parked channel (§20) is coming back: hold the task
                # for the resumed session rather than burning a retry
                if self._defer_if_parked(a, worker, ex):
                    return
                # never respawn inline (it blocks); fail retryably and
                # let the recovery pool bring the agent back — unless the
                # channel is parked for session resumption (§20), whose
                # grace timer owns recovery
                if not self._closing and not self._is_parked(a):
                    self._kick_restart(a, ch)
                self._finish_cluster(worker, ex, error=WorkerCrashedError(
                    f"node agent {a} is down"))
                return
            if not self._closing:
                self._restart_agent(a, ch)   # no-op if already replaced
            ch = self._channels[a]
            if ch is None or ch.closed:
                self._finish_cluster(worker, ex, error=WorkerCrashedError(
                    f"node agent {a} is down"))
                return
        t = ex.t
        try:
            token, blob = self._fns.entry(t.fn)
            # the agent needs the declared output arity to know which
            # result positions are whole datums (RemoteRef-eligible); a
            # speculative clone reports its primary's arity
            n_out = len(t.out_keys)
            if t.speculative_of is not None and self.runtime is not None:
                try:
                    n_out = len(self.runtime.graph.get(t.speculative_of).out_keys)
                except KeyError:
                    pass
            with self._order_locks[a]:
                srcs = self._peer_sources(a, ex.input_keys)
                structure, frames, info = pack_payload(
                    (ex.args, ex.kwargs), ex.input_keys, self._resident[a],
                    peer_sources=srcs)
                meta = {"op": "task", "slot": slot, "token": token,
                        "structure": structure, "n_out": n_out}
                if token not in self._shipped_fns[a]:
                    meta["fn"] = blob
                if t.deadline_s is not None:
                    # the agent watchdog enforces deadline_s at the body
                    # (kills the wedged pool worker); the detector's
                    # slacked copy is the backstop for an agent too
                    # wedged to run its own watchdog.  Registered BEFORE
                    # the send: the reply callback (which pops) can fire
                    # on the reader thread the instant the send lands
                    meta["deadline_s"] = t.deadline_s
                    with self._stats_lock:
                        self._deadline_inflight[a][id(ex)] = (
                            time.monotonic() + t.deadline_s
                            + self._deadline_slack)
                mid = ch.request_cb(
                    meta, frames,
                    lambda rmeta, rframes, err, _w=worker, _a=a, _ch=ch,
                    _ex=ex: self._on_reply(_w, _a, _ch, _ex, rmeta,
                                           rframes, err))
                self._inflight_reqs[a][mid] = (worker, ex)
                self._shipped_fns[a].add(token)
                # a Fetch directive makes the key node-resident exactly
                # like a Put — the consumer agent registers the pull on
                # its reader in stream order, so later Refs are safe
                self._resident[a].update(info["put_keys"])
                self._resident[a].update(info["fetch_keys"])
                # residency generations (§20): one bump per mark message
                # sent; the agent bumps its mirror on receipt, and equal
                # counters at resume time validate a manifest entry
                gens = self._res_gen[a]
                for k in info["put_keys"]:
                    gens[k] = gens.get(k, 0) + 1
                for k in info["fetch_keys"]:
                    gens[k] = gens.get(k, 0) + 1
                with self._stats_lock:
                    self.puts += len(info["put_keys"])
                    self.refs += info["refs"]
                    self.fetches += len(info["fetch_keys"])
                    self.fetch_bytes += info["fetch_bytes"]
                    self.bytes_shipped += info["put_bytes"]
                    for k, nb in info["put_sizes"].items():
                        self._put_home.setdefault(k, (a, nb))
                if srcs:
                    # input resolution booked these copies as relayed
                    # before the transport was known — they move peer-to-
                    # peer after all
                    st = getattr(self.runtime, "store", None)
                    if st is not None:
                        for k in info["fetch_keys"]:
                            src = srcs.get(k)
                            if src is not None:
                                st.reattribute_to_p2p(k, src[0], dest=a)
        except (ConnectionClosed, OSError) as err:
            if t.deadline_s is not None and self._deadline_inflight:
                with self._stats_lock:
                    self._deadline_inflight[a].pop(id(ex), None)
            # the send failed while this call still owned the mid (the
            # reply callback will never fire): a parked channel defers
            # the task to the resumed session instead of failing it
            if self._defer_if_parked(a, worker, ex):
                return
            if not self._closing and not self._is_parked(a):
                if self.async_plane:
                    self._kick_restart(a, ch)
                else:
                    self._restart_agent(a, ch)
            crash = WorkerCrashedError(
                f"node agent {a} died executing "
                f"{getattr(t.fn, '__name__', t.fn)!r}")
            crash.__cause__ = err
            self._finish_cluster(worker, ex, error=crash)
        except BaseException as err:   # pack/pickle failure: plain failure
            self._finish_cluster(worker, ex, error=err)

    def _peer_sources(self, a: int,
                      input_keys) -> Optional[Dict[Tuple[int, int],
                                                   Tuple[int, str, int]]]:
        """Scheduler-resident input keys some OTHER live agent already
        caches: ``pack_payload`` turns them into by-key ``Fetch``
        directives so the bytes move agent→agent instead of crossing the
        scheduler link once per consumer agent (DESIGN.md §16).  Must be
        called under ``_order_locks[a]``."""
        if not self.p2p or not input_keys:
            return None
        keys = set(input_keys.values()) - self._resident[a]
        if not keys:
            return None
        with self._stats_lock:
            homes = [(k, self._put_home[k]) for k in keys
                     if k in self._put_home]
        srcs: Optional[Dict[Tuple[int, int], Tuple[int, str, int]]] = None
        for key, (home, nb) in homes:
            if home == a:
                continue   # ledger says resident elsewhere; re-Put is fine
            addr = self._data_addrs[home]
            ch = self._channels[home]
            if addr is None or ch is None or ch.closed:
                continue
            if srcs is None:
                srcs = {}
            srcs[key] = (home, addr, nb)
        return srcs

    def _on_reply(self, worker: int, a: int, ch, ex, rmeta, rframes,
                  err) -> None:
        """Completion path, on the channel reader (or its failure
        drainer): exactly one call per streamed task."""
        if rmeta is not None and rmeta.get("mid") is not None:
            self._inflight_reqs[a].pop(rmeta["mid"], None)
        if ex.t.deadline_s is not None and self._deadline_inflight:
            with self._stats_lock:
                self._deadline_inflight[a].pop(id(ex), None)
        if err is not None:
            if not self._closing and not self._is_parked(a):
                if self.async_plane:
                    self._kick_restart(a, ch)
                else:
                    self._restart_agent(a, ch)
            crash = WorkerCrashedError(
                f"node agent {a} died with task {ex.t.name!r} in flight")
            crash.__cause__ = err
            self._finish_cluster(worker, ex, error=crash)
            return
        counters = rmeta.get("counters")
        if counters:
            with self._counter_lock:
                self.worker_counters.update(counters)
        if rmeta.get("op") == "done":
            self._tl.views = None
            # replication hint (§20): publish() consults this, in the same
            # thread, for every RemoteValue this reply produced — replicate
            # when the producer's run time clears the graph's fleet-wide
            # duration bar (re-running cheap tasks beats paying their copy)
            self._tl.replicate = False
            # the agent times the task body itself ("dur" in the done
            # reply) — scheduler-observed latency would fold pipeline
            # queue time into every producer's apparent cost.  The
            # profile is only consulted by the replication bar, so with
            # replication off the hot completion path skips the graph
            # lock entirely.
            if self.replication > 0 and self.runtime is not None:
                dur = rmeta.get("dur")
                if dur is not None:
                    dur = float(dur)
                    self.runtime.graph.note_run_s(ex.t.name, dur)
                    self._tl.replicate = (
                        dur >= self.runtime.graph.duration_threshold())
            try:
                result = self._decode_result(a, ch, rmeta, rframes)
            except BaseException as derr:
                self._finish_cluster(worker, ex, error=derr)
            else:
                self._finish_cluster(worker, ex, result=result)
        else:
            remote = self._remote_error(rmeta)
            from ..cluster.peer import PeerFetchError
            if isinstance(remote, PeerFetchError):
                # the agent failed to pull a datum we marked resident at
                # dispatch time (transient peer failure with the producer
                # channel still up — channel death has its own reset).
                # Strike this task's input keys from the agent's ledger
                # so the retry re-ships Put/Fetch instead of a Ref the
                # plane cannot resolve; over-striking a genuinely
                # resident Put key only costs a redundant re-Put (the
                # agent's pre-store skips keys it already holds)
                with self._order_locks[a]:
                    self._resident[a] -= set(ex.input_keys.values())
                # the failed pull may have chased a stale peer-source
                # home: forget it so the retry ships a fresh Put
                with self._stats_lock:
                    for k in ex.input_keys.values():
                        self._put_home.pop(k, None)
                self._expire_dead_parks()
            self._finish_cluster(worker, ex, error=remote)

    def _finish_cluster(self, worker: int, ex, *, result: Any = None,
                        error: Optional[BaseException] = None) -> None:
        rt = self.runtime
        try:
            if error is not None:
                rt.fail_task(ex, error)
            else:
                rt.complete_task(ex, result)
        finally:
            self.task_done()
            rt._note_worker_idle()
            self._credits[worker].release()
            if self.async_plane:
                # a freed credit is dispatch capacity: re-enter the pump
                # (inline when the completion already runs on the loop)
                self._schedule_pump()

    def _remote_error(self, rmeta: dict) -> BaseException:
        return _rebuild_remote_error(rmeta.get("exc"), rmeta.get("tb"))

    def _decode_result(self, a: int, ch, rmeta: dict, rframes) -> Any:
        from .futures import RemoteValue
        from ..cluster.protocol import (Frame, RemoteRef, frame_to_value,
                                        struct_nbytes)
        tokens = rmeta.get("tokens") or []
        gen = self._proc_gen[a]
        views: Dict[int, Tuple[int, int, Any, int]] = {}
        # inline (below-RJAX_INLINE_MAX) result arrays ride the reply
        # pickle — they crossed our link too, so the relay ledger counts
        # them (Frame/RemoteRef markers contribute 0 here; frames add
        # their own bytes below, tensors included: they always ride a
        # frame, untokened below the threshold)
        with self._stats_lock:
            self.relay_result_bytes += struct_nbytes(rmeta["structure"])

        def dec(marker):
            if isinstance(marker, RemoteRef):
                # the datum stayed on the producing node: book a
                # placeholder; only this descriptor crossed our link
                rv = RemoteValue(marker.token, a, self._data_addrs[a],
                                 marker.nbytes)
                views[id(rv)] = (a, marker.token, ch, gen)
                with self._stats_lock:
                    self.remote_results += 1
                    self.deferred_result_bytes += marker.nbytes
                return rv
            arr = frame_to_value(rframes[marker.i])
            with self._stats_lock:
                self.relay_result_bytes += struct_nbytes(arr)
            token = tokens[marker.i]
            if token is None:
                return arr   # an inline tensor: nothing held agent-side
            # the token is only meaningful in the PROCESS that minted it —
            # a respawned agent restarts its counter, so publish/drop
            # verify the process generation; a RESUMED session (§20) is
            # the same process, and its tokens stay valid across the
            # channel swap
            views[id(arr)] = (a, token, ch, gen)
            return arr

        result = _walk(rmeta["structure"], dec, (Frame, RemoteRef))
        self._tl.views = views   # consumed by publish() in the same thread
        return result

    # -- data-plane hooks ----------------------------------------------------
    def publish(self, key, value):
        """The runtime bound a just-returned result to ``(data_id,
        version)``: pin it into the producing node's plane via ``alias``
        so later tasks there reference it without a wire crossing.  For a
        :class:`~repro_torch.core.futures.RemoteValue` the alias is load-bearing
        — the node's token side-table holds the ONLY copy until it is
        bound to the datum key."""
        from .futures import RemoteValue
        from ..cluster.protocol import WIRE_LEAVES, ConnectionClosed
        views = getattr(self._tl, "views", None)
        if not views or not isinstance(value, WIRE_LEAVES + (RemoteValue,)):
            return
        entry = views.pop(id(value), None)
        if entry is None:
            return
        a, token, ch, gen = entry
        key = tuple(key)
        if isinstance(value, RemoteValue):
            value.key = key
        nb = int(getattr(value, "nbytes", 0) or 0)
        published = False
        try:
            with self._order_locks[a]:
                # the token survives as long as the agent PROCESS does:
                # valid on the original channel and on any resumed
                # successor (§20), dead after a respawn (gen mismatch)
                if self._proc_gen[a] == gen:
                    cur = self._channels[a]
                    if cur is not None and not cur.closed:
                        cur.post({"op": "alias", "token": token,
                                  "key": key})
                        self._resident[a].add(key)
                        self._res_gen[a][key] = (
                            self._res_gen[a].get(key, 0) + 1)
                        if not isinstance(value, RemoteValue):
                            # a framed result relayed through us now
                            # lives BOTH here and on its producer: other
                            # agents can pull it from that plane instead
                            # of costing a second Put
                            with self._stats_lock:
                                self._put_home.setdefault(key, (a, nb))
                        published = True
                    elif self._is_parked(a):
                        # parked for resumption: defer the alias; the
                        # resume flush posts it (FIFO before any later
                        # Ref) or the grace-expiry restart discards it
                        self._parked_ops[a].append(
                            ("alias", token, key, nb,
                             isinstance(value, RemoteValue)))
                        published = True
        except ConnectionClosed:
            return   # the restart path resets this node's residency ledger
        if not published:
            # agent died/respawned since.  A plain array is already safe
            # in the store; a RemoteValue just entered the store pointing
            # at a dead node AFTER the crash sweep.  Recovery cannot run
            # HERE: publish() is called mid-completion, before mark_done,
            # so graph.resurrect would refuse the still-RUNNING producer
            # — park the key and let task_done() (which runs after the
            # completion) invalidate + re-execute from lineage
            if isinstance(value, RemoteValue) and not self._closing:
                orphans = getattr(self._tl, "orphaned", None)
                if orphans is None:
                    orphans = self._tl.orphaned = []
                orphans.append(key)
            return
        # asynchronous replication (§20): push a costly node-resident
        # result to k buddy planes over the existing p2p bcast leg —
        # fire-and-forget, outside the producer's ordering lock
        if (isinstance(value, RemoteValue) and self.replication > 0
                and getattr(self._tl, "replicate", False)
                and not self._closing):
            self._replicate(key, value, a)

    def task_done(self):
        """Drop result tokens that were never published (discarded
        outputs, lost speculation races) so agent side-tables don't grow
        — and recover keys orphaned by a publish that raced the
        producer's death (the task is DONE by now, so lineage
        re-execution can actually resurrect it)."""
        from ..cluster.protocol import ConnectionClosed
        views = getattr(self._tl, "views", None)
        if views:
            for a, token, ch, gen in views.values():
                with self._order_locks[a]:
                    if self._proc_gen[a] != gen:
                        continue   # the minting process is gone
                    cur = self._channels[a]
                    if cur is not None and not cur.closed:
                        try:
                            cur.post({"op": "drop", "token": token})
                        except ConnectionClosed:
                            pass
                    elif self._is_parked(a):
                        self._parked_ops[a].append(("drop", token))
        self._tl.views = None
        orphans = getattr(self._tl, "orphaned", None)
        self._tl.orphaned = None
        if orphans and self.runtime is not None and not self._closing:
            self.runtime.store.invalidate_keys(orphans)
            self._drop_residency(orphans)
            # relaunch every orphan key that is not (re-)published by now
            # — NOT just the ones invalidate_keys caught: the restart
            # sweep may have deleted the placeholder already, back when
            # the producer was still RUNNING and resurrect had to refuse
            # (it is DONE now, completions run before task_done).
            # relaunch_lost is idempotent for producers the sweep did
            # resurrect (resurrect no-ops unless DONE)
            need = [k for k in orphans
                    if not self.runtime.store.is_ready(k)]
            self.runtime.relaunch_lost(need)

    # -- collectives (DESIGN.md §16) -----------------------------------------
    def broadcast(self, key, value, store=None) -> int:
        """Fan a scheduler-resident datum out to every live agent: ONE
        encoded copy crosses the scheduler link (to a root agent), then
        the bytes move agent→agent in a doubling frontier — every ack
        promotes the receiver to a source for the next wave, so the wave
        count is ⌈log2(agents)⌉ (a binomial tree).  With p2p disabled the
        copies go out over each agent link concurrently instead (star
        topology, but never serialized behind one ordering lock).

        Blocks until the wave settles; returns the number of agents that
        hold the key.  Dead agents are skipped — a respawned agent picks
        the key up as a normal Put/peer-Fetch when a task needs it."""
        from ..cluster.peer import PEER_FETCH_TIMEOUT
        from ..cluster.protocol import (ConnectionClosed, pack_payload,
                                        struct_nbytes)
        key = tuple(key)
        nbytes = struct_nbytes(value)
        cv = threading.Condition()
        pending = [0]
        failed = [0]
        holders: List[int] = []
        free: List[int] = []
        waiting: List[int] = []
        enc: List[Any] = []   # lazily packed [structure, frames]

        for a in range(self.n_agents):
            ch = self._channels[a]
            if ch is None or ch.closed:
                continue
            with self._order_locks[a]:
                resident = key in self._resident[a]
            (holders if resident else waiting).append(a)
        free.extend(holders)

        def send_root(a: int) -> bool:
            ch = self._channels[a]
            if ch is None or ch.closed:
                return False
            if not enc:
                structure, frames, _ = pack_payload(value)
                enc.extend((structure, frames))
            try:
                with self._order_locks[a]:
                    if self._channels[a] is not ch:
                        return False
                    ch.request_cb(
                        {"op": "bcast", "key": key, "root": True,
                         "structure": enc[0]},
                        enc[1],
                        lambda rm, rf, err, _a=a: on_leg(_a, None, rm, err))
                    with self._stats_lock:
                        self.puts += 1
                        self.bytes_shipped += nbytes
                return True
            except (ConnectionClosed, OSError):
                return False

        def send_pull(child: int, parent: int) -> bool:
            ch = self._channels[child]
            addr = self._data_addrs[parent]
            if ch is None or ch.closed or addr is None:
                return False
            try:
                with self._order_locks[child]:
                    if self._channels[child] is not ch:
                        return False
                    ch.request_cb(
                        {"op": "bcast", "key": key, "addr": addr,
                         "node": parent, "nbytes": nbytes},
                        (),
                        lambda rm, rf, err, _c=child, _p=parent:
                            on_leg(_c, _p, rm, err))
                    with self._stats_lock:
                        self.fetches += 1
                        self.fetch_bytes += nbytes
                return True
            except (ConnectionClosed, OSError):
                return False

        def pump() -> None:
            """Launch every leg the current sources can serve.  Runs with
            ``cv`` held (re-entrant from on_leg: Condition uses an RLock)."""
            while waiting:
                if not self.p2p or (not holders and pending[0] == 0):
                    a = waiting.pop(0)
                    if send_root(a):
                        pending[0] += 1
                    else:
                        failed[0] += 1
                    continue
                if not free:
                    return
                parent = free.pop(0)
                child = waiting.pop(0)
                if send_pull(child, parent):
                    pending[0] += 1
                else:
                    failed[0] += 1
                    free.append(parent)

        def on_leg(a: int, parent: Optional[int], rmeta, err) -> None:
            ok = err is None and rmeta is not None \
                and rmeta.get("op") == "bcast_ok"
            with cv:
                pending[0] -= 1
                if parent is not None:
                    free.append(parent)
                if ok:
                    with self._order_locks[a]:
                        if self._channels[a] is not None:
                            self._resident[a].add(key)
                            # the agent bumped its mirror when the bcast
                            # landed; bump ours on the ack (§20)
                            self._res_gen[a][key] = (
                                self._res_gen[a].get(key, 0) + 1)
                    with self._stats_lock:
                        self._put_home.setdefault(key, (a, nbytes))
                    holders.append(a)
                    free.append(a)
                    if store is not None:
                        store.note_location(key, a, source=parent)
                else:
                    failed[0] += 1
                pump()
                cv.notify_all()

        deadline = time.monotonic() + PEER_FETCH_TIMEOUT + 30.0
        with cv:
            pump()
            while pending[0] > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                cv.wait(timeout=left)
            with self._stats_lock:
                self.broadcasts += 1
            return len(holders)

    # -- failure handling ----------------------------------------------------
    def _drop_residency(self, keys) -> None:
        """Strike lost datum keys from EVERY agent's residency ledger: a
        retried consumer must get a fresh Put/Fetch for the recomputed
        value, never a Ref into a plane that predates the loss."""
        if not keys:
            return
        keyset = set(tuple(k) for k in keys)
        for a in range(self.n_agents):
            with self._order_locks[a]:
                self._resident[a] -= keyset
        with self._stats_lock:
            for k in keyset:
                self._put_home.pop(k, None)
                self._replicas.pop(k, None)

    # -- session resumption (DESIGN.md §20) ----------------------------------
    def _is_parked(self, a: int) -> bool:
        with self._park_lock:
            return a in self._disconnected

    def _maybe_park(self, a: int, ch, pending) -> bool:
        """Channel-death first refusal: adopt the in-flight slots and
        park the node for the grace window instead of killing it.
        Idempotent — the on_lost_pending hook and the on_close hook race
        freely, and later calls merge extra pending slots into the
        existing entry.  Returns False when resumption cannot apply
        (disabled, closing, liveness-killed, or already replaced) — the
        caller then runs the §19 fail/respawn path unchanged."""
        if (not self.resumption or self._closing
                or getattr(ch, "liveness_killed", False)):
            return False
        tok = getattr(self.cluster, "session_tokens", {}).get(a)
        if not tok:
            return False
        with self._park_lock:
            entry = self._disconnected.get(a)
            if entry is not None:
                if entry["ch"] is not ch:
                    return False   # a successor channel died, not ours
                entry["pending"].update(pending)
                return True
            if self._channels[a] is not ch or a in self._restarting:
                return False       # being replaced: restart owns it
            exited = getattr(self.cluster, "exited", None)
            if exited is not None and exited(a):
                return False       # the process is gone: it cannot re-dial
            entry = {"ch": ch, "token": tok, "pending": dict(pending),
                     "next_mid": ch.next_mid, "state": "disconnected",
                     "deferred": [],
                     "deadline": time.monotonic() + self.reconnect_grace_s}
            timer = threading.Timer(self.reconnect_grace_s,
                                    self._grace_expired, (a, entry))
            timer.daemon = True
            entry["timer"] = timer
            self._disconnected[a] = entry
            # stop the pump from offering this agent's workers new tasks
            # while parked (set HERE, synchronously on the failing loop
            # thread, so no dispatch can slip between close and park)
            self._agent_up[a] = False
            timer.start()
        return True

    def _expire_dead_parks(self) -> None:
        """End the grace window of every parked agent whose process has
        exited since it was parked (a pull from its data plane just
        failed): it can never resume, and its node's losses must be
        recovered before its consumers spend their retries."""
        exited = getattr(self.cluster, "exited", None)
        if exited is None:
            return
        with self._park_lock:
            parked = list(self._disconnected.items())
        for a, entry in parked:
            if entry["state"] == "disconnected" and exited(a, wait_s=0):
                timer = entry.get("timer")
                if timer is not None:
                    timer.cancel()
                self._grace_expired(a, entry)

    def _defer_if_parked(self, a: int, worker: int, ex) -> bool:
        """A dispatch raced the park: hold the task (credit and all)
        until the session resumes instead of burning one of its retries
        on a channel that is coming back."""
        with self._park_lock:
            entry = self._disconnected.get(a)
            if entry is None:
                return False
            entry["deferred"].append((worker, ex))
            return True

    def _grace_expired(self, a: int, entry: dict) -> None:
        """The agent did not re-dial in time: fall through to the
        normal kill-and-replay path (fail adopted slots retryably,
        respawn, §15 lineage re-execution)."""
        if self._closing:
            return
        with self._park_lock:
            if self._disconnected.get(a) is not entry \
                    or entry["state"] != "disconnected":
                return   # resumed (or resuming) in time
            del self._disconnected[a]
        self._fail_slots(a, entry["pending"].values())
        for worker, ex in entry["deferred"]:
            self._finish_cluster(worker, ex, error=WorkerCrashedError(
                f"node agent {a} session lost (grace expired)"))
        if self.async_plane:
            self._kick_restart(a, entry["ch"], park=False)
        else:
            self._restart_agent(a, entry["ch"])

    def _fail_slots(self, a: int, slots) -> None:
        """Error adopted slots retryably (grace expiry, or mids the
        resumed agent never received)."""
        from ..cluster.protocol import ConnectionClosed
        err = ConnectionClosed(
            f"agent {a} session lost", mid_message=True)
        for slot in slots:
            cb = getattr(slot, "callback", None)
            if cb is not None:
                try:
                    cb(None, None, err)
                except BaseException:
                    traceback.print_exc()
            else:
                slot.error = err
                slot.event.set()

    def _on_resume(self, conn, hello: dict) -> None:
        """A parked agent re-dialed with its session token (runs on the
        cluster's acceptor thread).  Reconcile and swap the channel in;
        any failure falls back to reject + the kill-and-replay path."""
        from ..cluster.protocol import send_msg
        a = hello.get("node_id")
        tokens = getattr(self.cluster, "session_tokens", {})
        ok = (isinstance(a, int) and 0 <= a < self.n_agents
              and not self._closing and self.resumption
              and tokens.get(a) == hello.get("resume"))
        entry = None
        if ok:
            # the park entry may lag the re-dial (the scheduler-side
            # read loop notices the break asynchronously): force the old
            # channel down and wait briefly for the park to land
            deadline = time.monotonic() + 2.0
            kicked = False
            while entry is None and time.monotonic() < deadline:
                with self._park_lock:
                    cur = self._disconnected.get(a)
                    if cur is not None and cur["state"] == "disconnected":
                        cur["state"] = "reconnecting"
                        entry = cur
                        break
                    if cur is not None:
                        break   # another resume is already in progress
                if not kicked:
                    kicked = True
                    old = self._channels[a]
                    if old is not None and not old.closed:
                        old.close()
                time.sleep(0.01)
        if entry is None:
            try:
                send_msg(conn, {"op": "welcome", "resumed": False})
            except Exception:
                pass
            conn.close()
            return
        timer = entry.get("timer")
        if timer is not None:
            timer.cancel()
        try:
            self._do_resume(a, conn, hello, entry)
        except BaseException:
            traceback.print_exc()
            with self._park_lock:
                self._disconnected.pop(a, None)
            try:
                conn.close()
            except OSError:
                pass
            self._fail_slots(a, entry["pending"].values())
            for worker, ex in entry["deferred"]:
                self._finish_cluster(worker, ex, error=WorkerCrashedError(
                    f"node agent {a} resume failed"))
            self._kick_restart(a, entry["ch"], park=False)

    def _do_resume(self, a: int, conn, hello: dict, entry: dict) -> None:
        """The resumption body: strike stale residency via the manifest,
        split in-flight mids at the agent's receive high-water, welcome,
        swap the channel, flush parked ops — the partition costs zero
        task re-executions (§20)."""
        from ..cluster.eventloop import AsyncAgentChannel
        from ..cluster.protocol import send_msg
        pending = entry["pending"]
        seen = int(hello.get("seen_mid") or 0)
        # the async writer drains its queue in mid order, so a mid the
        # agent has not seen implies nothing after it arrived either:
        # mids <= seen survive (the agent replays their recorded replies
        # or is still executing them); mids > seen never arrived — fail
        # them retryably once the channel is live again
        kept = {mid: slot for mid, slot in pending.items() if mid <= seen}
        lost = {mid: slot for mid, slot in pending.items() if mid > seen}
        # a lost mid that maps back to a task in the send ledger is not
        # dead work — the request never reached the agent, so it re-sends
        # on the resumed channel with a fresh mid, costing zero retries.
        # Only mids with no ledger entry (stats probes, bcast legs) fail.
        reqs = self._inflight_reqs[a]
        resend = []
        orphans = []
        for mid, slot in lost.items():
            req = reqs.pop(mid, None)
            if req is not None:
                resend.append(req)
            else:
                orphans.append(slot)
        # manifest reconciliation: an entry is valid iff the agent's
        # per-key mark generation matches ours — every mark message that
        # was in flight when the wire broke shows up as a mismatch and
        # is struck (conservative: a struck Put key only costs a re-ship)
        manifest = hello.get("manifest") or ()
        struck: Set[Tuple[int, int]] = set()
        with self._order_locks[a]:
            gens = self._res_gen[a]
            valid = set()
            for item in manifest:
                k = tuple(item[0])
                if gens.get(k, 0) == int(item[1]):
                    valid.add(k)
            struck = self._resident[a] - valid
            self._resident[a] = valid
            # an fn body that first shipped inside a lost message never
            # landed: strike the ship ledger so the re-send carries the
            # body again (the agent's blob table dedupes if it did land)
            for _w, _ex in resend:
                self._shipped_fns[a].discard(self._fns.entry(_ex.t.fn)[0])
            if struck:
                with self._stats_lock:
                    for k in struck:
                        home = self._put_home.get(k)
                        if home is not None and home[0] == a:
                            del self._put_home[k]
            # welcome + channel swap still under the ordering lock: a
            # dispatcher blocked on it must see the fully-resumed state
            send_msg(conn, {"op": "welcome", "node_id": a,
                            "resumed": True,
                            "epoch": int(hello.get("epoch") or 0),
                            "outstanding": sorted(kept)})
            new_ch = AsyncAgentChannel(conn, a, hello, io=self._io,
                                       start_mid=entry["next_mid"])
            new_ch.adopt_pending(kept)
            self._install_channel(a, new_ch)
            self._channels[a] = new_ch
            # flush ops that landed while parked, in arrival order (FIFO
            # before anything a dispatcher sends after the lock drops)
            for op in self._parked_ops[a]:
                if op[0] == "alias":
                    _, token, k, nb, _remote = op
                    new_ch.post({"op": "alias", "token": token, "key": k})
                    self._resident[a].add(k)
                    gens[k] = gens.get(k, 0) + 1
                elif op[0] == "drop":
                    new_ch.post({"op": "drop", "token": op[1]})
            self._parked_ops[a] = []
            with self._park_lock:
                self._disconnected.pop(a, None)
        # node-resident values homed here whose manifest entry was struck
        # are actually gone: invalidate + lineage, like a partial loss
        if struck and self.runtime is not None:
            gone = [k for k in self.runtime.store.homed_keys(a)
                    if k in struck]
            if gone:
                self.runtime.store.invalidate_keys(gone)
                self._drop_residency(gone)
                self.runtime.relaunch_lost(
                    [k for k in gone
                     if not self.runtime.store.is_ready(k)])
        self._agent_up[a] = True
        with self._stats_lock:
            self.reconnects += 1
        if orphans:
            self._fail_slots(a, orphans)
        # tasks whose send died on the wire, then tasks a dispatcher
        # deferred while the node was parked, go out on the resumed
        # channel — off this (acceptor) thread, in order
        for worker, ex in resend + entry["deferred"]:
            self._recovery.submit(self._submit_pipelined, worker, ex)
        self._schedule_pump()

    # -- replication (DESIGN.md §20) -----------------------------------------
    def _replicate(self, key, rv, a: int) -> None:
        """Fire-and-forget: ask up to k buddy agents to pull ``key``
        from its producer over the p2p data plane (the bcast leg, which
        is §13 memory-governed on the receiving plane).  Failures are
        ignored — a missing replica just means lineage recovery later."""
        from ..cluster.protocol import ConnectionClosed
        addr = self._data_addrs[a]
        if addr is None or not self.p2p:
            return
        want = min(self.replication, self.n_agents - 1)
        placed = 0
        for off in range(1, self.n_agents):
            if placed >= want:
                break
            b = (a + off) % self.n_agents
            ch = self._channels[b]
            if ch is None or ch.closed or not self._agent_up[b]:
                continue
            try:
                with self._order_locks[b]:
                    if self._channels[b] is not ch:
                        continue
                    ch.request_cb(
                        {"op": "bcast", "key": key, "addr": addr,
                         "node": a, "nbytes": rv.nbytes,
                         "token": rv.token},
                        (),
                        lambda rm, rf, err, _b=b, _k=key, _nb=rv.nbytes,
                        _a=a: self._on_replica(_b, _k, _nb, _a, rm, err))
            except (ConnectionClosed, OSError):
                continue
            placed += 1

    def _on_replica(self, b: int, key, nb: int, src: int, rmeta,
                    err) -> None:
        """A replica pull settled: book the copy (residency mark, store
        location, replica ledger) on success; on failure do nothing."""
        if err is not None or rmeta is None \
                or rmeta.get("op") != "bcast_ok" or self._closing:
            return
        with self._order_locks[b]:
            if self._channels[b] is None:
                return
            self._resident[b].add(key)
            self._res_gen[b][key] = self._res_gen[b].get(key, 0) + 1
        with self._stats_lock:
            self.replica_bytes += nb
            self._replicas.setdefault(key, set()).add(b)
        if self.runtime is not None:
            self.runtime.store.note_location(key, b, source=src)

    def _redirect_replicas(self, a: int) -> int:
        """Node ``a`` is really dead: point every store placeholder it
        homed at a surviving replica holder instead, so
        ``invalidate_lost`` skips them and zero producers re-execute for
        replicated keys.  Returns the number of keys redirected."""
        rt = self.runtime
        if rt is None:
            return 0
        # snapshot candidate homes OUTSIDE the store lock (redirect_node
        # runs under it and must not take executor locks)
        with self._stats_lock:
            cand: Dict[Tuple[int, int], Tuple[int, str]] = {}
            for key, holders in self._replicas.items():
                for b in sorted(holders):
                    if b == a or not self._agent_up[b]:
                        continue
                    ch = self._channels[b]
                    addr = self._data_addrs[b]
                    if ch is None or ch.closed or addr is None:
                        continue
                    cand[key] = (b, addr)
                    break
        if not cand:
            return 0
        swapped = rt.store.redirect_node(a, cand)
        if swapped:
            with self._stats_lock:
                self.replica_hits += len(swapped)
        return len(swapped)

    def _restart_agent(self, a: int, failed_ch) -> None:
        """Replace a dead agent.  The node's losses are recovered BEFORE
        the respawn: a replacement agent starts its spawned pool (each
        worker imports torch, and on a card makes its CUDA context) before
        it registers, which takes seconds, and consumers of the dead
        node's results must not spend their retries pulling from a corpse
        meanwhile.  So the residency ledgers are reset, surviving replicas
        take over (§20), and every other lost placeholder is invalidated
        and its producer re-executed from lineage (§15) on the live
        agents; then the replacement is spawned and installed."""
        with self._restart_lock:
            if self._channels[a] is not failed_ch:
                return   # another dispatcher already replaced it
            self._restarting.add(a)
            try:
                self._replace_agent(a, failed_ch)
            finally:
                self._restarting.discard(a)

    def _replace_agent(self, a: int, failed_ch) -> None:
        """The body of :meth:`_restart_agent`, under its lock."""
        # a stale park entry must not adopt a resume after the
        # process is replaced (respawn also mints a new session
        # token, so a late re-dial is rejected outright)
        with self._park_lock:
            stale = self._disconnected.pop(a, None)
        if stale is not None:
            timer = stale.get("timer")
            if timer is not None:
                timer.cancel()
            if stale["pending"]:
                self._fail_slots(a, stale["pending"].values())
            for worker, ex in stale["deferred"]:
                self._finish_cluster(worker, ex,
                                     error=WorkerCrashedError(
                                         f"node agent {a} replaced"))
        old_addr = self._data_addrs[a]
        if failed_ch is not None:
            failed_ch.close()
        if self._deadline_inflight:
            # in-flight deadline entries die with the channel (each
            # reply callback also pops its own — this is belt and
            # braces against the detector chasing ghosts)
            with self._stats_lock:
                self._deadline_inflight[a].clear()
        with self._order_locks[a]:
            self._resident[a] = set()
            self._shipped_fns[a] = set()
            self._res_gen[a] = {}
            self._parked_ops[a] = []
            self._inflight_reqs[a] = {}
            # tokens minted by the dead process are invalid forever;
            # publish/drop for its results become no-ops (§20)
            self._proc_gen[a] += 1
            self._data_addrs[a] = None
        if self._peers is not None:
            self._peers.drop(old_addr)   # the pooled conn died with it
        # every peer-source home pointing at the dead plane is stale
        with self._stats_lock:
            self._put_home = {k: v for k, v in self._put_home.items()
                              if v[0] != a}
            for k in list(self._replicas):
                self._replicas[k].discard(a)
                if not self._replicas[k]:
                    del self._replicas[k]
        # the store's residency metadata must die with the agent too,
        # or locality keeps steering reads at data the replacement
        # doesn't hold and the transfer ledger undercounts re-ships —
        # and every node-resident result homed there is GONE: first
        # rehome what a surviving replica can serve (§20), then the
        # runtime invalidates the remaining placeholders and
        # re-executes their producers from graph lineage (§15)
        if self.runtime is not None:
            self._redirect_replicas(a)
            self.runtime.store.forget_node(a)
            lost = self.runtime.recover_lost_node(a)
            self._drop_residency(lost)
        new_ch = None
        if getattr(self.cluster, "can_respawn", False) \
                and not self._closing:
            try:
                new_ch = self.cluster.respawn(a)
            except Exception:
                new_ch = None
        with self._order_locks[a]:
            if new_ch is not None:
                # data addr + on_close BEFORE the channel is exposed:
                # a dispatcher blocked on this order lock ships the
                # moment we release it, and its reply must not mint
                # RemoteValues with addr=None
                self._install_channel(a, new_ch)
            self._channels[a] = new_ch
        if new_ch is not None:
            self.agent_restarts += 1

    # -- metrics -------------------------------------------------------------
    def liveness(self) -> Dict[int, dict]:
        """Per-agent liveness view (state, beat age, beat count) for
        ``/api/status`` and the dashboard — the failure detector's own
        numbers, so what the UI shows is exactly what verdicts use.
        Agents between channel death and reinstall report ``respawning``;
        agents parked for session resumption (§20) report
        ``disconnected`` (grace window open) or ``reconnecting`` (a
        resume is being reconciled), and every row carries its replica
        count."""
        det = self._detector
        snap = det.snapshot() if det is not None else {}
        with self._park_lock:
            parked = {a: e["state"] for a, e in self._disconnected.items()}
        repl: Dict[int, int] = {}
        with self._stats_lock:
            for holders in self._replicas.values():
                for b in holders:
                    repl[b] = repl.get(b, 0) + 1
        out: Dict[int, dict] = {}
        for a in range(self.n_agents):
            ent = snap.get(a)
            if ent is None:
                ent = {"state": "respawning", "beat_age_s": None, "beats": 0}
            st = parked.get(a)
            if st is not None:
                ent = dict(ent, state=st)
            ent = dict(ent, replicas=repl.get(a, 0))
            out[a] = ent
        return out

    def agent_stats(self) -> List[Optional[dict]]:
        """Round-trip per-agent stats (pool + node plane); ``None`` for
        agents that are down."""
        out: List[Optional[dict]] = []
        for ch in self._channels:
            if ch is None or ch.closed:
                out.append(None)
                continue
            try:
                meta, _ = ch.request({"op": "stats"}, timeout=10.0)
                out.append(meta.get("stats"))
            except Exception:
                out.append(None)
        return out

    def stats(self) -> dict:
        with self._counter_lock:
            counters = dict(self.worker_counters)
        s = {
            "backend": self.name,
            "n_agents": self.n_agents,
            "workers_per_node": self.wpn,
            "pipeline_depth": self.pipeline_depth,
            "control_plane": self.control_plane,
            "agent_restarts": self.agent_restarts,
            "liveness_kills": self.liveness_kills,
            "reconnects": self.reconnects,
            "replica_bytes": self.replica_bytes,
            "replica_hits": self.replica_hits,
            "p2p": self.p2p,
            "broadcasts": self.broadcasts,
            "puts": self.puts,
            "refs": self.refs,
            "fetches": self.fetches,
            "fetch_bytes": self.fetch_bytes,
            "bytes_shipped": self.bytes_shipped,
            "relay_result_bytes": self.relay_result_bytes,
            "remote_results": self.remote_results,
            "deferred_result_bytes": self.deferred_result_bytes,
            # everything that crossed the scheduler's own link for task
            # data: Put payloads out + result frames back.  The §15
            # acceptance metric — peer traffic lives in fetch_bytes and
            # the store's transfer_detail() instead
            "relay_bytes": self.bytes_shipped + self.relay_result_bytes,
            # the agents' pool workers' counters, as the process backend
            # reports its own workers'
            "kernel_launches": {k.split(":", 1)[1]: v for k, v in counters.items()
                                if k.startswith("launches:")},
            "card_bytes_by_pid": {int(k.split(":", 1)[1]): v for k, v in counters.items()
                                  if k.startswith("card_bytes:")},
        }
        for k in ("worker_cache_hits", "device_uploads", "device_upload_bytes",
                  "device_uploads_saved"):
            s[k] = counters.get(k, 0)
        return s


BACKENDS = {"thread": ThreadExecutor, "process": ProcessExecutor,
            "cluster": ClusterExecutor}


def make_executor(backend: str, n_workers: int, label: str = "rjax",
                  **kw) -> ExecutorBackend:
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown executor backend {backend!r}; choose from {sorted(BACKENDS)}")
    return BACKENDS[backend](n_workers, label, **kw)
