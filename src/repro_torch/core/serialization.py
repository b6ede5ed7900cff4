"""The raw-codec header and the mmap codec the memory governor spills
through (trimmed copy: only what :mod:`repro_torch.core.memory` needs).

``mmap`` is the RMVL analogue: header + raw buffer written to a file;
deserialization returns a ``numpy.memmap`` view — *zero-copy
reconstruction*.  In-process task hand-off passes values by reference
(no codec): serialization only happens at address-space boundaries, and
the thread backend has none except spill.
"""
from __future__ import annotations

import os
import struct
import weakref
from typing import Any, Tuple

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


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class MmapCodec:
    """RMVL analogue: file-backed zero-copy deserialization.

    ``owned=True`` ties the file's lifetime to the returned view (a
    ``weakref.finalize`` unlinks it at GC — on POSIX the mapping stays
    valid even after the unlink, so live slices keep working).
    """

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
