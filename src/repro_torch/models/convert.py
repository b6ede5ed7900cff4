"""Carry the JAX model's weights into the port: ``load_jax_params``.

The JAX package's ``init_params`` returns a tree
``{"embed", "scan": {"b<i>": {...}}, "tail": [...], "final_norm",
"lm_head"}`` in which every ``scan`` leaf has a leading ``n_super`` axis:
layer ``s · len(block_pattern) + i`` is ``scan["b<i>"][...][s]``, and the
``tail`` blocks follow.  The port's :class:`~repro_torch.models.lm.LM`
keeps one block per layer with the same key names, and the same
layouts — ``x @ W`` weights stay ``(in, out)``: **nothing is
transposed**.  Leaves arrive as NumPy arrays (bf16 ones from
``ml_dtypes`` included) and must have the parameter's dtype: the
recurrent layers keep some parameters in fp32 inside a bf16 model
(``A_log``, ``D``, ``dt_bias``; ``lam``, ``w_r``, ``b_r``, ``w_i``,
``b_i``), and a leaf that would be rounded or widened on the way in
means the two models disagree about a parameter.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from .lm import LM


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}.")
    else:
        yield prefix[:-1], tree


def flat_jax_params(model: LM, tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX tree's leaves under the port's parameter names."""
    period = len(model.cfg.block_pattern)
    flat = dict(_flatten({k: v for k, v in tree.items() if k not in ("scan", "tail")}))
    for i in range(period if "scan" in tree else 0):
        for name, leaf in _flatten(tree["scan"][f"b{i}"]):
            arr = np.asarray(leaf)
            for s in range(arr.shape[0]):
                flat[f"blocks.{s * period + i}.{name}"] = arr[s]
    first_tail = model.cfg.n_super * period
    for j, block in enumerate(tree.get("tail", [])):
        for name, leaf in _flatten(block):
            flat[f"blocks.{first_tail + j}.{name}"] = leaf
    return flat


@torch.no_grad()
def load_jax_params(model: LM, tree: Dict[str, Any]) -> LM:
    """Copy every leaf of a JAX ``init_params`` tree into ``model``.
    Raises on a missing or extra leaf, a shape mismatch or a dtype
    mismatch (an fp32 leaf for a bf16 parameter, or the reverse).
    Returns ``model``."""
    flat = flat_jax_params(model, tree)
    params = dict(model.named_parameters())
    missing, extra = sorted(params.keys() - flat.keys()), sorted(flat.keys() - params.keys())
    if missing or extra:
        raise KeyError(f"JAX tree does not fit the model: missing {missing}, extra {extra}")
    for name, p in params.items():
        leaf = flat[name]
        if np.shape(leaf) != tuple(p.shape):
            raise ValueError(f"{name}: JAX leaf {np.shape(leaf)} vs parameter {tuple(p.shape)}")
        kind = np.dtype(leaf.dtype).name
        if kind != str(p.dtype).removeprefix("torch."):
            raise TypeError(f"{name}: JAX leaf is {kind}, the parameter {p.dtype}")
        p.copy_(torch.from_numpy(np.array(leaf, dtype=np.float32)))   # exact for bf16
    return model
