"""Assigned input-shape sets, ``input_specs()`` and ``make_batch()``: the
port of ``repro/configs/shapes.py``.

Every architecture pairs with four shapes:

* ``train_4k``    — seq 4096,   global batch 256  (the train step)
* ``prefill_32k`` — seq 32768,  global batch 32   (the prefill step)
* ``decode_32k``  — seq 32768,  global batch 128  (the decode step: one
                    new token against a KV cache of 32768)
* ``long_500k``   — seq 524288, global batch 1    (the decode step; only
                    for sub-quadratic archs — SSM / hybrid)

``input_specs`` returns tensors on the ``meta`` device in place of the
reference's ``jax.ShapeDtypeStruct``: shapes and dtypes, no storage.
``make_batch`` materialises small concrete batches for smoke tests, the
same bytes as the reference's from the same seed: it draws from NumPy's
``default_rng`` in the order ``jax.tree.map`` visits the reference's
specs (dict keys sorted), and rounds a float draw as JAX does with 64-bit
off — float64 to float32, then to the spec's dtype.  Decode caches are a
list with one cache per layer, as :meth:`LM.init_caches` gives them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from ..algorithms.common import resolve_device
from ..models.lm import LMConfig, init_caches


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

SMOKE_SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 32, 2),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 48, 2),
    "decode_32k": ShapeSpec("decode_32k", "decode", 48, 2),
    "long_500k": ShapeSpec("long_500k", "decode", 64, 1),
}


def shape_applicable(cfg: LMConfig, shape_name: str) -> bool:
    """``long_500k`` only for sub-quadratic archs."""
    if shape_name == "long_500k":
        return cfg.sub_quadratic
    return True


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_batch_specs(cfg: LMConfig, batch: int, seq: int, with_loss: bool):
    i32 = torch.int32
    cd = cfg.compute_dtype
    specs: Dict[str, torch.Tensor] = {}
    if cfg.input_mode == "tokens":
        specs["tokens"] = _spec((batch, seq), i32)
    elif cfg.input_mode == "embeds":
        specs["embeds"] = _spec((batch, seq, cfg.d_model), cd)
    elif cfg.input_mode == "prefix_embeds":
        p = min(cfg.prefix_len, max(seq // 4, 1)) if seq <= 64 else cfg.prefix_len
        specs["prefix_embeds"] = _spec((batch, p, cfg.d_model), cd)
        specs["tokens"] = _spec((batch, seq - p), i32)
    if with_loss:
        specs["targets"] = _spec((batch, seq), i32)
        specs["loss_mask"] = _spec((batch, seq), torch.float32)
    return specs


def cache_specs(cfg: LMConfig, batch: int, cache_len: int):
    """The decode caches' shapes and dtypes: meta tensors."""
    return init_caches(cfg, batch, cache_len, "meta")


def input_specs(cfg: LMConfig, shape: ShapeSpec) -> Dict:
    """Meta-tensor stand-ins for one (arch × shape) cell.

    train:    {"batch": {...}}
    prefill:  {"batch": {...}}                       (no loss tensors)
    decode:   {"batch": one-token, "caches": [...], "pos": scalar}
    """
    if shape.kind == "train":
        return {"batch": _token_batch_specs(cfg, shape.batch, shape.seq, True)}
    if shape.kind == "prefill":
        return {"batch": _token_batch_specs(cfg, shape.batch, shape.seq, False)}
    if shape.kind == "decode":
        if cfg.input_mode == "embeds":
            tok = {"embeds": _spec((shape.batch, 1, cfg.d_model), cfg.compute_dtype)}
        else:
            tok = {"tokens": _spec((shape.batch, 1), torch.int32)}
        return {"batch": tok, "caches": cache_specs(cfg, shape.batch, shape.seq),
                "pos": _spec((), torch.int32)}
    raise ValueError(shape.kind)


def make_batch(cfg: LMConfig, shape: ShapeSpec, seed: int = 0, device=None) -> Dict[str, Any]:
    """Concrete batch for smoke tests (small shapes only), on ``device``
    (``None``: CUDA, raising without a card): the reference's values."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    specs = input_specs(cfg, shape)

    def concretize(s: torch.Tensor) -> torch.Tensor:
        if not s.dtype.is_floating_point:
            hi = cfg.vocab_size if s.shape[-1:] != () else shape.seq
            draw = rng.integers(0, max(2, min(hi, cfg.vocab_size)), size=tuple(s.shape))
            return torch.from_numpy(np.asarray(draw).astype(np.int32)).to(s.dtype)
        draw = rng.standard_normal(tuple(s.shape)).astype(np.float32)
        return torch.from_numpy(draw).to(s.dtype)

    # the batch's leaves in jax.tree.map's order; the caches and pos the
    # reference draws after them and then replaces are made here directly
    out: Dict[str, Any] = {"batch": {k: concretize(specs["batch"][k]).to(dev)
                                     for k in sorted(specs["batch"])}}
    if "loss_mask" in out["batch"]:
        out["batch"]["loss_mask"] = torch.ones_like(out["batch"]["loss_mask"])
    if "caches" in specs:
        # decode smoke: a real (zero) cache is semantically valid
        out["caches"] = init_caches(cfg, shape.batch, shape.seq, dev)
        out["pos"] = torch.tensor(min(4, shape.seq - 1), dtype=torch.int32, device=dev)
    return out
