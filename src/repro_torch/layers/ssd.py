"""Mamba-2 SSD (state-space duality) block: the port of
``repro/layers/ssd.py``.

``d_inner = expand · d_model``, ``H = d_inner / headdim`` heads of width
``P = headdim``, state size ``N``, one B/C group shared by the heads, a
depthwise causal conv of width ``conv_width`` over the ``x``/``B``/``C``
channels.  Prefill runs the SSD scan through
:func:`repro_torch.kernels.ops.ssd_scan` — *the port's choice*: the JAX
layer runs its jnp ``ssd_chunked`` and never calls its Pallas kernel.  On
a CUDA card that is the hand-written ``ssd_scan`` kernel, which reads
x, B and C as views into the conv output (no copy) and needs no padding;
on the CPU its plain version, the chunked algorithm, which pads a ragged
S with dt = 0 as the JAX layer does.  Decode is the single-step
recurrence on the carried ``(H, P, N)`` fp32 state, in plain PyTorch as
in JAX.

Dtypes follow the JAX layer: ``softplus(dt + dt_bias)`` in fp32,
``A = -exp(A_log)``, y and ``D·x`` in fp32, then cast to x's dtype,
``· silu(z)``, then the gated RMSNorm (the ``rmsnorm`` op).  ``A_log``,
``D`` and ``dt_bias`` are fp32 whatever the parameter dtype.  Weights
keep the JAX layout ``(in, out)``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .mlp import init_normal_
from .norms import RMSNorm
from .rglru import causal_conv, conv_history, conv_step


def split_in(proj: torch.Tensor, d_inner: int, d_state: int):
    """(z, xc, B, C, dt) views of the input projection's last axis."""
    z = proj[..., :d_inner]
    xc = proj[..., d_inner: 2 * d_inner]
    B = proj[..., 2 * d_inner: 2 * d_inner + d_state]
    C = proj[..., 2 * d_inner + d_state: 2 * d_inner + 2 * d_state]
    dt = proj[..., 2 * d_inner + 2 * d_state:]
    return z, xc, B, C, dt


def ssd_axes():
    """Logical axes of :class:`SSD`'s parameters (for placement)."""
    return {
        "w_in": ("embed", "ssm_inproj"),
        "conv_w": (None, "ssm_conv"),
        "conv_b": ("ssm_conv",),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "norm": {"scale": ("ssm_inner",)},
        "w_out": ("ssm_inner", "embed"),
    }


class SSD(nn.Module):
    def __init__(self, d_model: int, *, expand: int = 2, headdim: int = 64,
                 d_state: int = 128, conv_width: int = 4, dtype=torch.float32, device=None):
        super().__init__()
        self.d_inner = expand * d_model
        self.n_heads = self.d_inner // headdim
        self.headdim, self.d_state = headdim, d_state
        conv_ch = self.d_inner + 2 * d_state

        def w(shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.w_in = w((d_model, 2 * self.d_inner + 2 * d_state + self.n_heads))
        self.conv_w = w((conv_width, conv_ch))
        self.conv_b = w((conv_ch,))
        self.A_log = w((self.n_heads,), torch.float32)
        self.D = w((self.n_heads,), torch.float32)
        self.dt_bias = w((self.n_heads,), torch.float32)
        self.norm = RMSNorm(self.d_inner, dtype=dtype, device=device)
        self.w_out = w((self.d_inner, d_model))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The shapes and scales of ``repro.layers.ssd.init_ssd``."""
        d_model = self.w_in.shape[0]
        init_normal_(self.w_in, 1.0 / math.sqrt(d_model), generator)
        init_normal_(self.conv_w, 0.1, generator)
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, self.n_heads)))
        self.D.fill_(1.0)
        self.dt_bias.zero_()
        self.norm.scale.fill_(1.0)
        init_normal_(self.w_out, 1.0 / math.sqrt(self.d_inner), generator)

    def forward(self, x: torch.Tensor, *, chunk: int = 256, cache: Optional[dict] = None,
                make_cache: bool = False) -> Tuple[torch.Tensor, Optional[dict]]:
        """x (B, S, D) -> (out (B, S, D), new cache or None).

        Without ``cache``: the prefill / training path (``make_cache=True``
        also returns the decode cache: the final state and the conv
        history).  With ``cache = {"conv": (B, K-1, C), "state": (B, H, P,
        N) fp32}`` (decode, S == 1): the single-step recurrence."""
        Bsz, S, _ = x.shape
        d_inner, N, H, P = self.d_inner, self.d_state, self.n_heads, self.headdim
        proj = x @ self.w_in
        z, xc, Bm, Cm, dt = split_in(proj, d_inner, N)
        conv_in = torch.cat([xc, Bm, Cm], dim=-1)
        K = self.conv_w.shape[0]
        if cache is None:
            conv_out = F.silu(causal_conv(conv_in, self.conv_w, self.conv_b))
            new_cache = {"conv": conv_history(conv_in, K)} if make_cache else None
        else:
            conv_out, hist = conv_step(cache["conv"], conv_in, self.conv_w, self.conv_b)
            conv_out = F.silu(conv_out)
            new_cache = {"conv": hist}

        # views into the conv output: the kernel reads them through strides
        xh = conv_out[..., :d_inner].reshape(Bsz, S, H, P)
        Bs = conv_out[..., d_inner: d_inner + N]
        Cs = conv_out[..., d_inner + N:]
        A = -torch.exp(self.A_log)
        dt = F.softplus(dt.to(torch.float32) + self.dt_bias)

        if cache is None:
            y, final_state = ops.ssd_scan(xh, dt, A, Bs, Cs, chunk=min(chunk, S))
            if make_cache:
                new_cache["state"] = final_state
        else:
            # state' = exp(dt A) state + dt (x ⊗ B);  y = C · state'
            dA = torch.exp(dt[:, 0, :] * A)                                  # (B, H)
            dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0, :], Bs[:, 0].to(torch.float32),
                               xh[:, 0].to(torch.float32))
            st = cache["state"] * dA[..., None, None] + dBx
            y = torch.einsum("bn,bhpn->bhp", Cs[:, 0].to(torch.float32), st)[:, None]
            new_cache["state"] = st

        y = y + self.D[None, None, :, None] * xh.to(torch.float32)
        y = y.reshape(Bsz, S, d_inner).to(x.dtype)
        y = self.norm(y * F.silu(z))
        return y @ self.w_out, new_cache


def init_ssd_cache(batch: int, d_model: int, *, expand: int, headdim: int, d_state: int,
                   conv_width: int, dtype=torch.float32, device=None) -> dict:
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    return {
        "conv": torch.zeros((batch, conv_width - 1, d_inner + 2 * d_state), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, n_heads, headdim, d_state), dtype=torch.float32,
                             device=device),
    }


def ssd_reference(xh, dt, A, B, C, initial_state=None):
    """Naive per-step recurrence oracle for tests: (y (b, s, h, p) fp32,
    final state (b, h, p, n) fp32)."""
    b, s, h, p = xh.shape
    n = B.shape[-1]
    st = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
          if initial_state is None else initial_state)
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t, :] * A)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, t, :], B[:, t].to(torch.float32),
                           xh[:, t].to(torch.float32))
        st = st * dA[..., None, None] + dBx
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t].to(torch.float32), st))
    return torch.stack(ys, dim=1), st
