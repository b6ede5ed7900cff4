"""RMSNorm: the port of ``repro/layers/norms.py``.

The JAX layer is plain jnp and never calls its Pallas twin.  The port's
layer calls :func:`repro_torch.kernels.ops.rmsnorm` on purpose, so on a
CUDA card every norm of the model (ln1, ln2, the q/k norms and the final
norm) runs the hand-written kernel; on the CPU the op's plain version
computes what the jnp layer computes (``1/sqrt``, fp32, cast back).
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels import ops


def rmsnorm_axes():
    """Logical axes of :class:`RMSNorm`'s parameters (for placement)."""
    return {"scale": ("embed",)}


class RMSNorm(nn.Module):
    """``x · (1/√(mean(x²) + eps)) · scale`` over the last dim; ``scale``
    is ``(d,)`` in the parameter dtype, cast to fp32 for the multiply."""

    def __init__(self, d: int, *, eps: float = 1e-6, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones((d,), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.rmsnorm(x.contiguous(), self.scale, eps=self.eps)


def rmsnorm_plain(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Scale-free RMS normalization (qk-norm without learned gain)."""
    return ops.rmsnorm(x.contiguous(), torch.ones(x.shape[-1], dtype=torch.float32,
                                                  device=x.device), eps=eps)
