"""MLP: gated (SwiGLU) or classic two-matrix GELU — the port of
``repro/layers/mlp.py``.  The products stay ``torch.matmul``, as the JAX
layer leaves them to XLA outside any Pallas kernel.  Weights keep the
JAX layout ``(in, out)`` and the layer computes ``x @ w``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


@torch.no_grad()
def init_normal_(w: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``w`` with ``N(0, 1) · std`` drawn in fp32 and cast to its dtype,
    as the JAX initialisers do (with other numbers: a torch generator)."""
    w.copy_(torch.randn(w.shape, generator=generator, device=w.device) * std)


def mlp_axes(gated: bool = True):
    """Logical axes of :class:`MLP`'s parameters (for placement)."""
    ax = {
        "w_up": ("embed", "mlp"),
        "w_down": ("mlp", "embed"),
    }
    if gated:
        ax["w_gate"] = ("embed", "mlp")
    return ax


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, gated: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()

        def w(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))

        self.w_up = w(d_model, d_ff)
        self.w_down = w(d_ff, d_model)
        self.w_gate = w(d_model, d_ff) if gated else None

    def init_weights(self, generator: torch.Generator) -> None:
        """The shapes and scales of ``repro.layers.mlp.init_mlp``."""
        d_model, d_ff = self.w_up.shape
        if self.w_gate is not None:
            init_normal_(self.w_gate, 1.0 / math.sqrt(d_model), generator)
        init_normal_(self.w_up, 1.0 / math.sqrt(d_model), generator)
        init_normal_(self.w_down, 1.0 / math.sqrt(d_ff), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.w_gate is not None:
            h = F.silu(x @ self.w_gate) * (x @ self.w_up)
        else:
            h = F.gelu(x @ self.w_up, approximate="tanh")   # jax.nn.gelu's default
        return h @ self.w_down
