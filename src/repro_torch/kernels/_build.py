"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together) and linked into one shared library
with a plain C interface, loaded with :mod:`ctypes`.  No PyTorch headers
are involved, so the build takes seconds.  The library lands in
``build/repro_torch/<hash of the sources and flags>/`` under the
repository root (git-ignored); it is built at the first CUDA launch and
reused while the sources are unchanged.  Importing this module builds
nothing.  A missing or failing ``nvcc`` raises with its output: there is
no fallback.

Every kernel wrapper refuses what its kernels do not take through
:func:`require` and launches through :func:`launch`, which keeps the
launch counters: one a kernel, and one a route of the kernels that pick
a route (``knn_topk``).  ``ops.launch_counts()`` reads them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from collections import Counter
from typing import Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint64
# C entry points: name -> (argtypes, restype).  Every pointer and the
# stream travel as c_void_p: a bare Python int would be cut to 32 bits.
SIGNATURES = {
    "knn_topk_launch": ([_P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P, _P], _I),
    "kmeans_assign_launch": ([_P, _P, _I, _I, _I, _I, _I,
                              _P, _P, _P, _P, _P, _P, _P], _I),
    "kmeans_wide_launch": ([_P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _P, _P, _P, _P, _P, _P, _P, _P], _I),
    "knn_wide_launch": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P, _P, _P], _I),
    "rmsnorm_launch": ([_P, _P, _P, _L, _I, _I, _I, _I, _F, _I, _P], _I),
    "flash_attention_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                ctypes.POINTER(_L), _I, _I, _I, _P], _I),
    "rglru_scan_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "ssd_scan_launch": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         ctypes.POINTER(_L), _I, _P], _I),
    "normal_fill_launch": ([_U, _U, _U, _U, _L, _L, _I, _L, _P, _P, _P, _P, _P, _P, _I, _P],
                           _I),
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build
build_log = ""                          # nvcc's output (ptxas register/smem report)
_counts_lock = threading.Lock()
# (kernel, None): the kernel's launches since the last reset; (kernel,
# route): that route's calls since the same reset (plain ints)
_counts: Counter = Counter()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): the "
            "port's CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: pathlib.Path, sources) -> str:
    """Compile every source in parallel, then link; returns nvcc's output."""
    nvcc = _nvcc()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="tmp-", dir=out_dir))
    try:
        jobs = []
        for src in sources:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log))
        so = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(so), *(str(o) for _, o, _ in jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        # atomic publish: a concurrent builder of the same hash loses
        # nothing but its own work
        os.replace(so, out_dir / LIB_NAME)
        text = "\n".join(log)
        (out_dir / "build.log").write_text(text)
        return text
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources, headers = _sources()
        out_dir = BUILD_ROOT / _digest(sources + headers)
        so = out_dir / LIB_NAME
        t0 = time.perf_counter()
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            build_log = _compile(out_dir, sources)
        else:
            log = out_dir / "build.log"
            build_log = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(so))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        build_seconds = time.perf_counter() - t0
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def require(kernel: str, tensors, contiguous: bool = True) -> torch.device:
    """The one CUDA device of ``tensors``, (name, tensor, accepted dtypes or
    None) triples, checked before anything is built: a tensor elsewhere
    raises ValueError, one of another dtype TypeError, and, where
    ``contiguous``, one that is not contiguous ValueError."""
    dev = tensors[0][1].device
    for name, t, dtypes in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected one CUDA device")
        if dtypes is not None and t.dtype not in dtypes:
            want = " or ".join(str(dt).removeprefix("torch.") for dt in dtypes)
            raise TypeError(f"{kernel}: {name} is {t.dtype}, expected {want}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    return dev


def launch(kernel: str, symbol: str, device, *args, route: Optional[str] = None) -> None:
    """Call the library's ``symbol`` on ``device`` with ``args`` and that
    device's current stream (the last parameter of every ``*_launch``
    entry), raise through :func:`check` if it failed, else count one
    launch of ``kernel`` and, where given, one call of its ``route``."""
    lib = library()
    with torch.cuda.device(device):
        err = getattr(lib, symbol)(*args, torch.cuda.current_stream(device).cuda_stream)
    check(err, kernel)
    with _counts_lock:
        _counts[kernel, None] += 1
        if route is not None:
            _counts[kernel, route] += 1


def count(kernel: str, route: Optional[str] = None) -> int:
    """Launches of ``kernel`` (or calls of its ``route``) since the last
    :func:`reset_counts`."""
    with _counts_lock:
        return _counts[kernel, route]


def reset_counts() -> None:
    with _counts_lock:
        _counts.clear()


def copy_width(d: int, *tensors) -> int:
    """Floats per ``cp.async`` copy of the wide routes' depth slices (see
    ``repro::issue_slice`` in ``csrc/common.cuh``): 4 or 2 where every row
    of d floats of each tensor starts 16 or 8 bytes aligned, else 1."""
    for vec in (4, 2):
        if d % vec == 0 and all(t.data_ptr() % (4 * vec) == 0 for t in tensors):
            return vec
    return 1


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise where autograd would need the gradient of a kernel that has
    none (``knn_topk``, ``kmeans_assign``): an input requires grad and
    grad mode is on.  Their Pallas calls have no gradient under
    ``jax.grad`` either."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel} has no gradient: pass tensors that do not require "
                           f"grad, or call it under torch.no_grad()")
