"""Carry weights between the JAX model's tree and the port's model:
``load_jax_params`` and its inverse ``to_jax_tree``.

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
means the two models disagree about a parameter.  Leaves may also be
torch tensors (a restored checkpoint's, bf16 included) or the
:class:`BF16Bits` of :func:`to_jax_tree`.

:func:`to_jax_tree` builds the JAX tree from the port's model (or from
per-parameter tensors such as AdamW moments), for checkpoints that
either package restores.  Its bf16 leaves are :class:`BF16Bits`: the
uint16 bit patterns, marked, so that nothing needs ``ml_dtypes``.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

if TYPE_CHECKING:
    from .lm import LM, LMConfig


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}.")
    else:
        yield prefix[:-1], tree


def _layer_slice(leaf: Any, s: int) -> Any:
    arr = leaf if isinstance(leaf, torch.Tensor) else np.asanyarray(leaf)
    return arr[s]


def port_names(cfg: "LMConfig", tree: Dict[str, Any],
               take: Callable[[Any, int], Any] = _layer_slice) -> Dict[str, Any]:
    """A tree in the JAX model's layout, keyed by the port's parameter
    names: leaf ``<name>`` of scan group ``b<i>`` becomes
    ``blocks.<s·period + i>.<name>`` as ``take(leaf, s)`` for each of the
    ``n_super`` steps ``s`` (by default the leaf's slice ``s`` of its
    leading axis), tail block ``j`` becomes ``blocks.<n_super·period + j>``
    and the top-level leaves keep their names.  The layout of any
    per-parameter tree (values, gradients, logical axes, partition
    specs) maps so."""
    period = len(cfg.block_pattern)
    flat = dict(_flatten({k: v for k, v in tree.items() if k not in ("scan", "tail")}))
    for i in range(period if "scan" in tree else 0):
        for name, leaf in _flatten(tree["scan"][f"b{i}"]):
            for s in range(cfg.n_super):
                flat[f"blocks.{s * period + i}.{name}"] = take(leaf, s)
    first_tail = cfg.n_super * period
    for j, block in enumerate(tree.get("tail", [])):
        for name, leaf in _flatten(block):
            flat[f"blocks.{first_tail + j}.{name}"] = leaf
    return flat


def jax_layout(cfg: "LMConfig", named: Mapping[str, Any], stack: Callable[[List[Any]], Any],
               leaf: Callable[[Any], Any] = lambda x: x) -> Dict[str, Any]:
    """The inverse of :func:`port_names`: per-parameter values ``named``
    (port names) in the JAX model's layout — ``scan["b<i>"]`` leaves made
    by ``stack`` of the ``n_super`` layers' values in order, ``tail`` a
    list of blocks, every other value through ``leaf``."""
    period = len(cfg.block_pattern)
    n_scan = cfg.n_super * period
    top: Dict[str, Any] = {}
    per_block: Dict[int, Dict[str, Any]] = {}

    def put(tree: Dict[str, Any], path: str, value) -> None:
        *keys, last = path.split(".")
        for key in keys:
            tree = tree.setdefault(key, {})
        tree[last] = value

    for name, value in named.items():
        if name.startswith("blocks."):
            _, layer, rest = name.split(".", 2)
            put(per_block.setdefault(int(layer), {}), rest, value)
        else:
            put(top, name, leaf(value))

    def stacked(trees):
        if isinstance(trees[0], dict):
            return {key: stacked([tr[key] for tr in trees]) for key in trees[0]}
        return stack(trees)

    def leaves(tree):
        if isinstance(tree, dict):
            return {key: leaves(sub) for key, sub in tree.items()}
        return leaf(tree)

    out: Dict[str, Any] = {k: v for k, v in top.items() if k == "embed"}
    if n_scan:
        out["scan"] = {f"b{i}": stacked([per_block[s * period + i]
                                         for s in range(cfg.n_super)])
                       for i in range(period)}
    if cfg.n_layers > n_scan:
        out["tail"] = [leaves(per_block[j]) for j in range(n_scan, cfg.n_layers)]
    out.update({k: v for k, v in top.items() if k != "embed"})
    return out


def flat_jax_params(model: LM, tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX tree's leaves under the port's parameter names."""
    return port_names(model.cfg, tree)


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
        if isinstance(leaf, BF16Bits):
            leaf = torch.from_numpy(leaf.view(np.int16).copy()).view(torch.bfloat16)
        if tuple(leaf.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX leaf {tuple(leaf.shape)} vs parameter "
                             f"{tuple(p.shape)}")
        if isinstance(leaf, torch.Tensor):
            kind = str(leaf.dtype).removeprefix("torch.")
        else:
            kind = np.dtype(leaf.dtype).name
        if kind != str(p.dtype).removeprefix("torch."):
            raise TypeError(f"{name}: JAX leaf is {kind}, the parameter {p.dtype}")
        p.copy_(leaf if isinstance(leaf, torch.Tensor)
                else torch.from_numpy(np.array(leaf, dtype=np.float32)))   # exact for bf16
    return model


class BF16Bits(np.ndarray):
    """A uint16 array holding bf16 bit patterns: how :func:`to_jax_tree`
    carries a bf16 leaf without ``ml_dtypes`` (the checkpoint manager
    stores it as a ``"bfloat16"`` leaf).  ``.view(np.uint16)`` gives the
    bits as a plain array."""


def host_leaf(t: torch.Tensor) -> np.ndarray:
    """A NumPy copy of ``t`` on the host: :class:`BF16Bits` for bf16."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(BF16Bits)
    return t.numpy()


def to_jax_tree(model: LM, tensors: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Dict[str, Any]:
    """The JAX ``init_params`` tree of ``model``'s parameters, or of
    ``tensors`` (by parameter name, e.g. AdamW moments), as NumPy copies
    on the host: ``scan["b<i>"]`` leaves stacked on a leading ``n_super``
    axis, ``tail`` a list of blocks.  The inverse of
    :func:`flat_jax_params`."""
    named = dict(model.named_parameters()) if tensors is None else dict(tensors)
    return jax_layout(model.cfg, named, leaf=host_leaf,
                      stack=lambda ts: host_leaf(torch.stack([t.detach().to("cpu")
                                                              for t in ts])))
