"""Gradient compression with error feedback: the port of
``repro/optim/compress.py``.

Two codecs, each with EF-SGD-style residual accumulation (the error of
one step is added back the next):

* ``int8`` — per-tensor symmetric quantization to int8 (scale
  ``max|g| / 127``, round half to even, clipped to ±127);
* ``topk`` — keep the entries of ``|g|`` at or above the k-th largest,
  ``k = max(1, ⌊size · frac⌋)``; the residual carries the rest;

and ``none`` (the round trip is the identity).  Gradients are dicts
keyed by parameter name; the returned gradients are what every replica
would reconstruct from the wire, in each gradient's dtype.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

Tensors = Mapping[str, torch.Tensor]


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _topk_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    k = max(1, int(x.numel() * frac))
    thresh = torch.topk(x.abs().reshape(-1), k).values[-1]
    return (x.abs() >= thresh).to(x.dtype)


def init_error_feedback(grads: Tensors) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}


@torch.no_grad()
def compressed_gradients(grads: Tensors, ef_state: Optional[Tensors] = None, *,
                         codec: str = "int8", topk_frac: float = 0.01
                         ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(the gradients after a compression round trip, the new error
    feedback in fp32)."""
    if codec not in ("int8", "topk", "none"):
        raise ValueError(codec)
    if ef_state is None:
        ef_state = init_error_feedback(grads)
    out, ef = {}, {}
    for name, g in grads.items():
        gf = g.to(torch.float32) + ef_state[name]
        if codec == "int8":
            rec = _dequant_int8(*_quant_int8(gf))
        elif codec == "topk":
            rec = gf * _topk_mask(gf, topk_frac)
        else:
            rec = gf
        out[name], ef[name] = rec.to(g.dtype), gf - rec
    return out, ef
