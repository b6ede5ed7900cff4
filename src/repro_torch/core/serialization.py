"""Pluggable serialization codecs (paper §3.3.3 + Table 1), the port's copy.

COMPSs exchanges task parameters through a language-agnostic byte channel;
RCOMPSs benchmarked nine R serializers and picked RMVL (a low-overhead,
memory-mappable binary format).  This module keeps the methodology: a
codec registry with a common interface, a harness that measures serialize
and deserialize times of square blocks per codec (:func:`benchmark_codecs`,
Table 1), and a default chosen from the measurements.

* ``pickle`` — stdlib pickle protocol 5 (general; the fallback for
  non-array payloads).
* ``npy``    — ``numpy.save`` container (array-only, portable).
* ``raw``    — 24-byte header + raw buffer; the process backend's
  shared-memory plane lays every segment out as a ``raw`` blob body
  (header in the ref, buffer in the segment), so a reader rebuilds the
  array with ``np.frombuffer`` — zero copies.
* ``mmap``   — the RMVL analogue: header + raw buffer written to a file;
  deserialization returns a ``numpy.memmap`` view — *zero-copy
  reconstruction*; the memory governor spills through it, and
  :meth:`MmapCodec.spill` packages the write-then-own round trip.

In-process task hand-off passes values by reference (no codec):
serialization only happens at address-space boundaries — the process and
cluster backends' pipes, segments and frames, and spill.  A card tensor
crosses such a boundary as host bytes: it goes device -> host first.
"""
from __future__ import annotations

import io
import os
import pickle
import struct
import tempfile
import time
import weakref
from typing import Any, Callable, Dict, Tuple

import numpy as np

_MAGIC = b"RJX1"
_DTYPES = {
    "f2": np.float16, "f4": np.float32, "f8": np.float64,
    "i1": np.int8, "i2": np.int16, "i4": np.int32, "i8": np.int64,
    "u1": np.uint8, "u2": np.uint16, "u4": np.uint32, "u8": np.uint64,
    "b1": np.bool_,
}
_DTYPE_CODES = {np.dtype(v).str[1:]: k for k, v in _DTYPES.items()}


def _pack_header(arr: np.ndarray) -> bytes:
    code = arr.dtype.str[1:]
    if code not in _DTYPE_CODES:
        raise TypeError(f"raw codec does not support dtype {arr.dtype}")
    shape = arr.shape
    return (
        _MAGIC
        + struct.pack("<2sH", code.encode(), len(shape))
        + struct.pack(f"<{len(shape)}q", *shape)
    )


def _unpack_header(buf: memoryview) -> Tuple[np.dtype, tuple, int]:
    if bytes(buf[:4]) != _MAGIC:
        raise ValueError("bad magic")
    code, ndim = struct.unpack_from("<2sH", buf, 4)
    shape = struct.unpack_from(f"<{ndim}q", buf, 8)
    return np.dtype(_DTYPES[code.decode()]), tuple(shape), 8 + 8 * ndim


def as_c_contiguous(obj: Any) -> np.ndarray:
    """Copy-on-encode for non-contiguous inputs.  Unlike
    ``np.ascontiguousarray``, this keeps 0-d arrays 0-d."""
    return np.asarray(obj, order="C")


def _pickle_ser(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=5)


def _pickle_de(data: bytes) -> Any:
    return pickle.loads(data)


def _npy_ser(obj: Any) -> bytes:
    arr = np.asarray(obj)
    bio = io.BytesIO()
    np.save(bio, arr, allow_pickle=False)
    return bio.getvalue()


def _npy_de(data: bytes) -> Any:
    return np.load(io.BytesIO(data), allow_pickle=False)


def _raw_ser(obj: Any) -> bytes:
    arr = as_c_contiguous(obj)
    return _pack_header(arr) + arr.tobytes()


def _raw_de(data: bytes) -> Any:
    mv = memoryview(data)
    dtype, shape, off = _unpack_header(mv)
    return np.frombuffer(mv, dtype=dtype, offset=off).reshape(shape)


class Codec:
    def __init__(self, name: str, ser: Callable[[Any], bytes], de: Callable[[bytes], Any],
                 array_only: bool = False):
        self.name = name
        self.ser = ser
        self.de = de
        self.array_only = array_only


CODECS: Dict[str, Codec] = {
    "pickle": Codec("pickle", _pickle_ser, _pickle_de),
    "npy": Codec("npy", _npy_ser, _npy_de, array_only=True),
    "raw": Codec("raw", _raw_ser, _raw_de, array_only=True),
}

DEFAULT_CODEC = "raw"


def serialize(obj: Any, codec: str = DEFAULT_CODEC) -> bytes:
    c = CODECS[codec]
    if c.array_only and not isinstance(obj, np.ndarray):
        c = CODECS["pickle"]  # graceful fallback for non-array payloads
    return c.ser(obj)


def deserialize(data: bytes, codec: str = DEFAULT_CODEC) -> Any:
    # the pickle fallback is self-describing; raw and npy have magics to sniff
    if codec in ("raw", "npy") and not (data[:4] == _MAGIC or data[:6] == b"\x93NUMPY"):
        return CODECS["pickle"].de(data)
    return CODECS[codec].de(data)


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class MmapCodec:
    """RMVL analogue: file-backed zero-copy deserialization.

    ``owned=True`` ties the file's lifetime to the returned view (a
    ``weakref.finalize`` unlinks it at GC — on POSIX the mapping stays
    valid even after the unlink, so live slices keep working); :meth:`spill`
    packages the write-then-own round trip.
    """

    name = "mmap"
    array_only = True

    def ser_to_file(self, obj: Any, path: str) -> int:
        arr = as_c_contiguous(obj)
        header = _pack_header(arr)
        with open(path, "wb") as f:
            f.write(struct.pack("<I", len(header)))
            f.write(header)
            arr.tofile(f)
        return 4 + len(header) + arr.nbytes

    def de_from_file(self, path: str, owned: bool = False) -> np.ndarray:
        with open(path, "rb") as f:
            (hlen,) = struct.unpack("<I", f.read(4))
            header = f.read(hlen)
        dtype, shape, _ = _unpack_header(memoryview(header))
        view = np.memmap(path, dtype=dtype, mode="r", offset=4 + hlen, shape=shape)
        if owned:
            weakref.finalize(view, _unlink_quiet, path)
        return view

    def spill(self, obj: Any, dir: str = None) -> np.ndarray:
        """Write ``obj`` to a fresh temp file and return a self-cleaning
        zero-copy view: the file is unlinked when the view is collected."""
        fd, path = tempfile.mkstemp(prefix="rjax_spill_", suffix=".rjx", dir=dir)
        os.close(fd)
        try:
            self.ser_to_file(obj, path)
            return self.de_from_file(path, owned=True)
        except BaseException:
            _unlink_quiet(path)
            raise


# -------------------------------------------------------------- Table 1 bench
def benchmark_codecs(sizes=(1024, 4096, 8192), dtype=np.float64, repeats: int = 3):
    """Table 1's method: square blocks of increasing size, the best
    serialize (S) and deserialize (D) wall times of ``repeats`` per codec,
    and the file-backed ``mmap`` codec (D: the view and its first page).
    Returns ``{codec: {size: (s_seconds, d_seconds)}}``."""
    rng = np.random.default_rng(0)
    results: Dict[str, Dict[int, Tuple[float, float]]] = {}
    tmpdir = tempfile.mkdtemp(prefix="rjax_serbench_")
    mc = MmapCodec()
    try:
        for size in sizes:
            arr = rng.standard_normal((size, size)).astype(dtype)
            for name, codec in CODECS.items():
                s_best = d_best = float("inf")
                for _ in range(repeats):
                    t0 = time.perf_counter()
                    blob = codec.ser(arr)
                    t1 = time.perf_counter()
                    out = codec.de(blob)
                    t2 = time.perf_counter()
                    s_best = min(s_best, t1 - t0)
                    d_best = min(d_best, t2 - t1)
                assert np.asarray(out).shape == arr.shape
                del blob, out
                results.setdefault(name, {})[size] = (s_best, d_best)
            path = os.path.join(tmpdir, f"blk{size}.rjx")
            s_best = d_best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                mc.ser_to_file(arr, path)
                t1 = time.perf_counter()
                view = mc.de_from_file(path)
                _ = view[0, 0]  # touch the first page
                t2 = time.perf_counter()
                s_best = min(s_best, t1 - t0)
                d_best = min(d_best, t2 - t1)
                del view
            results.setdefault("mmap", {})[size] = (s_best, d_best)
            _unlink_quiet(path)
    finally:
        try:
            os.rmdir(tmpdir)
        except OSError:
            pass
    return results
