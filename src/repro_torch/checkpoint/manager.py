"""Checkpoint / restart in the reference's on-disk format: the port of
``repro/checkpoint/manager.py``.

One ``.npy`` per leaf plus a ``manifest.json`` of names, shapes and
dtypes, under ``step_<8 digits>/``.  Leaf names are the reference's: the
JAX ``keystr`` of each leaf's path (``['params']['scan']['b0']['attn']
['wq']``, ``['opt'].count`` for a NamedTuple field) with every run of
other characters than ``[A-Za-z0-9_.-]`` made one ``_`` — e.g.
``params_scan_b0_attn_wq``, ``opt_.count``, ``opt_.mu_embed`` — in the
order JAX flattens the tree (dict keys sorted, lists and NamedTuples in
order).  bf16 leaves are stored as their uint16 bits with the dtype
``"bfloat16"``.  So a checkpoint of ``{"params": <JAX tree>, "opt":
AdamWState}`` written by either package restores in the other.  The
restore path needs no ``ml_dtypes``: bf16 leaves come back as torch
bf16 tensors from their bits.

Trees here are nested dicts, lists and NamedTuples; leaves are NumPy
arrays (:class:`~repro_torch.models.convert.BF16Bits` for bf16, as
:func:`~repro_torch.models.convert.to_jax_tree` gives them) or torch
tensors, copied to the host (a sharded caller gathers its DTensors to
full tensors first, and one rank writes).  A restore may place every
leaf on a device mesh (``shardings``): each rank loads the full leaf and
keeps its shard, so a checkpoint written from one mesh restores onto any
other — the reference's elastic resharding — and the files do not depend
on the mesh.  Saves are atomic (a temp dir, then a
rename) and may run as ``checkpoint_save`` tasks on the port's runtime,
retried on failure, so checkpoint I/O overlaps the next training step.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models.convert import BF16Bits, host_leaf

_BF16 = "bfloat16"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) in JAX's flattening order; ``None`` has no leaves."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _paths(tree[key], f"{prefix}[{key!r}]")
    elif _is_namedtuple(tree):
        for field, sub in zip(tree._fields, tree):
            yield from _paths(sub, f"{prefix}.{field}")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _paths(sub, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _rebuild(tree, leaf_of, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaf_of(keystr)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _rebuild(sub, leaf_of, f"{prefix}[{key!r}]") for key, sub in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(sub, leaf_of, f"{prefix}.{field}")
                            for field, sub in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(sub, leaf_of, f"{prefix}[{i}]") for i, sub in enumerate(tree))
    return leaf_of(prefix)


def _names(keystrs: List[str]) -> List[str]:
    """The reference's ``_leaf_files`` names of these paths."""
    out, seen = [], {}
    for k in keystrs:
        name = re.sub(r"[^A-Za-z0-9_.-]+", "_", k).strip("_") or "leaf"
        n = seen.get(name, 0)
        seen[name] = n + 1
        out.append(f"{name}__{n}" if n else name)
    return out


def _host(leaf) -> np.ndarray:
    return host_leaf(leaf) if isinstance(leaf, torch.Tensor) else np.asanyarray(leaf)


def save_checkpoint(path: str, tree: Any, step: int,
                    extra: Optional[dict] = None) -> str:
    """Write ``tree`` under ``path`` atomically; returns the final dir."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    final = path / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(dir=path, prefix=".tmp_"))
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    pairs = list(_paths(tree))
    for name, (_, leaf) in zip(_names([k for k, _ in pairs]), pairs):
        arr = _host(leaf)
        dtype = _BF16 if isinstance(arr, BF16Bits) else str(arr.dtype)
        arr = arr.view(np.ndarray)
        np.save(tmp / f"{name}.npy", arr, allow_pickle=False)
        manifest["leaves"].append({"name": name, "dtype": dtype, "shape": list(arr.shape)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return str(final)


def _load_leaf(dirpath: Path, meta: dict) -> torch.Tensor:
    arr = np.load(dirpath / f"{meta['name']}.npy", allow_pickle=False)
    if meta["dtype"] == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(path: str, target_tree: Any, *, shardings: Any = None,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of ``target_tree`` (its leaves name the
    files; their values are not read): (the tree with host torch tensors
    as leaves, the step).  ``step=None`` takes the newest checkpoint.
    ``shardings``: a tree of the same structure whose leaves are
    :class:`~repro_torch.distributed.sharding.Sharding` (or ``None``: that
    leaf stays a host tensor) — each such leaf comes back as a DTensor on
    its mesh, this rank holding its shard."""
    root = Path(path)
    if step is None:
        cands = sorted(root.glob("step_*"))
        if not cands:
            raise FileNotFoundError(f"no checkpoints under {path}")
        final = cands[-1]
    else:
        final = root / f"step_{step:08d}"
    manifest = json.loads((final / "manifest.json").read_text())
    by_name = {m["name"]: m for m in manifest["leaves"]}
    keystrs = [k for k, _ in _paths(target_tree)]
    names = _names(keystrs)
    if set(names) != set(by_name):
        missing = set(by_name) ^ set(names)
        raise ValueError(f"checkpoint/tree structure mismatch: {sorted(missing)[:5]}")
    loaded = {k: _load_leaf(final, by_name[n]) for k, n in zip(keystrs, names)}
    if shardings is not None:
        placed = dict(_paths(shardings))
        loaded = {k: placed[k].place(v) if k in placed else v for k, v in loaded.items()}
    return _rebuild(target_tree, loaded.__getitem__), manifest["step"]


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; with ``use_runtime``,
    non-blocking saves run as ``checkpoint_save`` tasks on the port's
    runtime (retried twice on failure like any other task)."""

    def __init__(self, path: str, keep: int = 3, use_runtime: bool = False):
        self.path = Path(path)
        self.keep = keep
        self.use_runtime = use_runtime
        self._save_task = None
        self._last_future = None
        if use_runtime:
            from ..core import api
            self._save_task = api.task(self._save_impl, name="checkpoint_save",
                                       max_retries=2)
        self._lock = threading.Lock()

    def _save_impl(self, host_tree, step: int, extra: Optional[dict]) -> str:
        out = save_checkpoint(str(self.path), host_tree, step, extra)
        self._gc()
        return out

    def _gc(self) -> None:
        with self._lock:
            cands = sorted(self.path.glob("step_*"))
            for old in cands[: max(0, len(cands) - self.keep)]:
                shutil.rmtree(old, ignore_errors=True)

    def save(self, tree: Any, step: int, extra: Optional[dict] = None,
             blocking: bool = True):
        """Save ``tree``.  Its torch leaves are copied to the host first;
        NumPy leaves are taken as they are, so a caller that goes on
        updating its tensors in place passes copies (``to_jax_tree``
        makes them)."""
        host_tree = _rebuild(tree, dict((k, _host(v)) for k, v in _paths(tree)).__getitem__)
        if not self.use_runtime or blocking:
            return self._save_impl(host_tree, step, extra)
        self._last_future = self._save_task(host_tree, step, extra)
        return self._last_future

    def wait(self) -> None:
        if self._last_future is not None:
            from ..core import api
            api.wait_on(self._last_future)
            self._last_future = None

    def latest_step(self) -> Optional[int]:
        cands = sorted(self.path.glob("step_*"))
        if not cands:
            return None
        return int(cands[-1].name.split("_")[1])

    def restore(self, target_tree: Any, *, shardings: Any = None, step: Optional[int] = None):
        return restore_checkpoint(str(self.path), target_tree, shardings=shardings, step=step)
