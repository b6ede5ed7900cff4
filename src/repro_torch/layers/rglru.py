"""RG-LRU recurrent block (RecurrentGemma / Griffin): the port of
``repro/layers/rglru.py``.

Temporal mixing ``x -> [W_x -> causal conv -> RG-LRU]``, gated by a GeLU
branch, then an output projection.  The recurrence, per channel:

    r_t = sigmoid(w_r ⊙ u_t + b_r),   i_t = sigmoid(w_i ⊙ u_t + b_i)
    log a_t = -8 · softplus(Λ) · r_t
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t)

with the gates in fp32 (``expm1`` for ``1 - a²``, floored at 1e-12) and an
fp32 state.  Prefill runs the scan through
:func:`repro_torch.kernels.ops.rglru_scan` — *the port's choice*: the JAX
layer evaluates it with ``jax.lax.associative_scan`` and never calls its
Pallas kernel.  On a CUDA card that is the hand-written ``rglru_scan``
kernel; on the CPU its plain version (a loop over time).  The two orders
of evaluation differ by fp32 rounding only.  Decode is one plain step
(:func:`rglru_step`), as in JAX.

``lam``, ``w_r``, ``b_r``, ``w_i`` and ``b_i`` are fp32 whatever the
parameter dtype, as in the JAX init; the projections and the conv are in
the parameter dtype.  Weights keep the JAX layout ``(in, out)``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .mlp import init_normal_

_C = 8.0


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (K, C), b (C,), summed tap by
    tap in x's dtype as the jnp layers do."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def conv_history(u: torch.Tensor, K: int) -> torch.Tensor:
    """The last K-1 inputs of a prefill (front-padded with zeros when
    S < K-1): the conv part of a decode cache."""
    S = u.shape[1]
    hist = u[:, max(S - (K - 1), 0):]
    if S < K - 1:
        hist = F.pad(hist, (0, 0, K - 1 - S, 0))
    return hist


def conv_step(hist: torch.Tensor, u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode conv over ``hist`` (B, K-1, C) and the new inputs u (B, S, C):
    (conv output (B, S, C), the new history)."""
    K, S = w.shape[0], u.shape[1]
    full = torch.cat([hist, u], dim=1)
    out = full[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + full[:, i:i + S] * w[i]
    return out + b, full[:, -(K - 1):]


class RGLRU(nn.Module):
    def __init__(self, d_model: int, rnn_width: int, *, conv_width: int = 4,
                 dtype=torch.float32, device=None):
        super().__init__()

        def w(shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        R = rnn_width
        self.w_x = w((d_model, R))
        self.w_gate = w((d_model, R))
        self.conv_w = w((conv_width, R))
        self.conv_b = w((R,))
        self.lam = w((R,), torch.float32)
        self.w_r = w((R,), torch.float32)
        self.b_r = w((R,), torch.float32)
        self.w_i = w((R,), torch.float32)
        self.b_i = w((R,), torch.float32)
        self.w_out = w((R, d_model))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The shapes and scales of ``repro.layers.rglru.init_rglru``."""
        d_model, R = self.w_x.shape
        init_normal_(self.w_x, 1.0 / math.sqrt(d_model), generator)
        init_normal_(self.w_gate, 1.0 / math.sqrt(d_model), generator)
        init_normal_(self.conv_w, 0.1, generator)
        self.conv_b.zero_()
        self.lam.fill_(2.0)
        init_normal_(self.w_r, 0.5, generator)
        self.b_r.zero_()
        init_normal_(self.w_i, 0.5, generator)
        self.b_i.fill_(1.0)
        init_normal_(self.w_out, 1.0 / math.sqrt(R), generator)

    def gates(self, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(log a, b) in fp32 for u (B, S, R): the recurrence is
        ``h_t = exp(log a_t)·h_{t-1} + b_t``."""
        uf = u.to(torch.float32)
        r = torch.sigmoid(uf * self.w_r + self.b_r)
        i = torch.sigmoid(uf * self.w_i + self.b_i)
        log_a = -_C * F.softplus(self.lam) * r
        # sqrt(1 - a^2) computed stably via expm1: 1 - exp(2 log a)
        beta = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12))
        return log_a, beta * (i * uf)

    def scan(self, u: torch.Tensor, h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prefill scan of u (B, S, R): (y in u's dtype, h_S (B, R) fp32),
        through the ``rglru_scan`` op."""
        log_a, b = self.gates(u)
        y, h_last = ops.rglru_scan(log_a, b, h0)
        return y.to(u.dtype), h_last

    def step(self, u_t: torch.Tensor, h_prev: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decode step, plain PyTorch: u_t (B, R), h_prev (B, R) fp32 ->
        (y_t in u_t's dtype, h fp32)."""
        log_a, b = self.gates(u_t[:, None, :])
        h = torch.exp(log_a[:, 0]) * h_prev + b[:, 0]
        return h.to(u_t.dtype), h

    def forward(self, x: torch.Tensor, *, cache: Optional[dict] = None,
                make_cache: bool = False) -> Tuple[torch.Tensor, Optional[dict]]:
        """x (B, S, D) -> (out (B, S, D), new cache or None).

        ``cache = {"conv": (B, K-1, R), "h": (B, R) fp32}`` for decode;
        ``make_cache=True`` builds it from a prefill."""
        u = x @ self.w_x
        gate = F.gelu(x @ self.w_gate, approximate="tanh")   # jax.nn.gelu's default
        K = self.conv_w.shape[0]
        if cache is None:
            y, h_last = self.scan(causal_conv(u, self.conv_w, self.conv_b))
            new_cache = ({"conv": conv_history(u, K), "h": h_last} if make_cache else None)
        else:
            uc, hist = conv_step(cache["conv"], u, self.conv_w, self.conv_b)
            y_t, h = self.step(uc[:, 0, :], cache["h"])
            y = y_t[:, None, :]
            new_cache = {"conv": hist, "h": h}
        return (y * gate) @ self.w_out, new_cache


def init_rglru_cache(batch: int, rnn_width: int, *, conv_width: int = 4,
                     dtype=torch.float32, device=None) -> dict:
    return {
        "conv": torch.zeros((batch, conv_width - 1, rnn_width), dtype=dtype, device=device),
        "h": torch.zeros((batch, rnn_width), dtype=torch.float32, device=device),
    }


@torch.no_grad()
def rglru_reference(layer: RGLRU, u: torch.Tensor, h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step loop oracle for tests: (y in u's dtype, h_S fp32)."""
    B, S, R = u.shape
    log_a, b = layer.gates(u)
    a = torch.exp(log_a)
    h = (torch.zeros((B, R), dtype=torch.float32, device=u.device) if h0 is None
         else h0.to(torch.float32))
    ys = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1).to(u.dtype), h
