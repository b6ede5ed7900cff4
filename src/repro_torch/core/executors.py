"""Executor backends (paper §3.3.2: persistent per-node workers), the
port's copy: the ``"thread"`` and ``"process"`` backends.

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
worker.  The cluster backend and the process pool's synchronous mode
(which serves a cluster node agent) come with the cluster slice of the
port.
"""
from __future__ import annotations

import collections
import os
import pickle
import struct
import sys
import threading
import time
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
        ref.device = value.ref.device
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
    host_dtype = _BIT_VIEWS.get(want, want)
    if count == 0:
        return torch.empty(shape, dtype=want)
    host = torch.frombuffer(seg.buf, dtype=host_dtype, count=count).view(shape)
    return host.view(want) if host_dtype is not want else host


def _rebuild(host, ref: ShmRef):
    """The value a reader gets for ``ref``: the host view itself, or for a
    tensor that lived on the card, a copy uploaded to this process's card."""
    if ref.device and ref.device != "cpu":
        return host.to(ref.device)
    return host


class CardResult(Deferred):
    """A worker's result tensor that lived on the card, held in the
    parent's store as its host view (zero-copy on the segment) until the
    parent reads it: the first ``Future.result`` uploads it to this
    process's card, once.  Shipping it on to another worker sends the
    segment's ref and uploads nothing here."""

    __slots__ = ("host", "ref", "_value", "_lock")

    def __init__(self, host: torch.Tensor, ref: ShmRef):
        self.host = host
        self.ref = ref
        self._value = None
        self._lock = threading.Lock()

    @property
    def nbytes(self) -> int:
        return self.ref.nbytes

    def materialize(self) -> torch.Tensor:
        with self._lock:
            if self._value is None:
                self._value = _rebuild(self.host, self.ref)
            return self._value

    def __reduce__(self):   # pickled straight through: rebuilt where read
        return _rebuild, (self.host, self.ref)


_LEAVES = _LEAVES + (CardResult,)


def _attached(host, ref: ShmRef):
    """What the parent stores for a result segment: a card tensor stays
    a :class:`CardResult` until it is read; anything else is its view."""
    if ref.device and ref.device != "cpu":
        return CardResult(host, ref)
    return host


def _shm_eligible(value) -> bool:
    if isinstance(value, CardResult):
        return True
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
        value = _rebuild(_segment_host_view(seg, ref), ref)
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

    def _submit_batch(self, worker: int, exs: List) -> None:
        raise NotImplementedError

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

    Each worker pipe carries up to ``pipeline_depth`` in-flight task
    messages, dispatcher threads hand off without blocking, and one
    per-pool *collector* thread drains every worker's replies (replies
    are strictly FIFO per pipe, so completion matching is a deque pop)."""

    name = "process"
    pipelined = True

    def __init__(self, n_workers: int, label: str = "rjax",
                 mp_context: Optional[str] = None, memory_budget=None,
                 pipeline_depth: int = 1):
        super().__init__(n_workers, label, pipeline_depth=pipeline_depth)
        self._ctx = get_context(start_method(mp_context))
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
        """Start the persistent worker pool."""
        # the tracker must exist BEFORE the first worker starts, or each
        # worker lazily starts its own and the one-tracker accounting
        # (and its crash safety-net) silently fragments
        try:
            from multiprocessing import resource_tracker
            resource_tracker.ensure_running()
        except Exception:
            pass
        if torch.cuda.is_available():
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
        p = self._ctx.Process(target=_worker_main,
                              args=(child, worker, tuple(close_fds), _torch_settings()),
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
        if counters:
            with self._counter_lock:
                self.worker_counters.update(counters)
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


BACKENDS = {"thread": ThreadExecutor, "process": ProcessExecutor}

# the slice of the port that will bring each backend that is not here yet
_LATER = {"cluster": "the cluster-backend slice"}


def make_executor(backend: str, n_workers: int, label: str = "rjax",
                  **kw) -> ExecutorBackend:
    if backend in _LATER:
        raise ValueError(
            f"executor backend {backend!r} is not ported yet (it comes with "
            f"{_LATER[backend]}); the port runs backend='thread' or 'process'")
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown executor backend {backend!r}; choose from {sorted(BACKENDS)}")
    return BACKENDS[backend](n_workers, label, **kw)
