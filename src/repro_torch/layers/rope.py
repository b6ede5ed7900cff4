"""Rotary positional embeddings (RoPE): the port of ``repro/layers/rope.py``,
in fp32 with the result cast back to x's dtype."""
from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float = 10_000.0):
    """positions: (...,) int -> (cos, sin) of shape (..., head_dim//2), fp32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, half) or (S, half)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:  # (S, half) -> broadcast over batch and heads
        cos_b, sin_b = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, half)
        cos_b, sin_b = cos[:, :, None, :], sin[:, :, None, :]
    xf = x.to(torch.float32)
    x1f, x2f = xf[..., :half], xf[..., half:]
    out = torch.cat([x1f * cos_b - x2f * sin_b, x2f * cos_b + x1f * sin_b], dim=-1)
    return out.to(x.dtype)
