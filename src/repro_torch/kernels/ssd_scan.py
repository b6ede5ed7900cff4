"""The Mamba-2 SSD scan from a zero state: the port of
``repro/kernels/ssd_scan.py``.

Two versions of one function: x ``(B, S, H, P)``, dt ``(B, S, H)`` after
softplus, A ``(H,)`` negative, Bm/Cm ``(B, S, N)`` (one group shared by
the heads).  Per (batch, head) the ``(P, N)`` state starts at zero and
follows ``state_t = exp(dt_t·A)·state_{t−1} + dt_t·x_t ⊗ B_t``,
``y_t = state_t · C_t``, all in fp32.  Both return ``(y, final_state)``:
y ``(B, S, H, P)`` fp32 and the state ``(B, H, P, N)`` fp32.  The Pallas
kernel returns y in x's dtype and no state; the SSD layer needs both the
state (its decode cache) and an unrounded y (it adds the ``D·x`` skip in
fp32 before rounding, as the JAX layer does), so parity with the Pallas
kernel is judged on y cast to x's dtype.

* :func:`ssd_scan_plain` — plain PyTorch: the chunked SSD algorithm of
  ``repro/layers/ssd.py``'s ``ssd_chunked`` (intra-chunk decay-masked
  ``C·Bᵀ`` products, inter-chunk state recurrence), with a ragged S
  padded by dt = 0 steps (decay 1, contribution 0) as the JAX layer pads
  it.  The CPU tests use it, and ``chip_smoke.py`` holds the kernel
  against it.
* :func:`ssd_scan_cuda` — the hand-written CUDA kernels
  (``csrc/ssd_scan.cu``, which documents their design and bound), one
  route per dtype.  bf16 x, B and C run the chunked SSD on the tensor
  cores (chunks of :data:`CHUNK` steps, the state in fp32 ``mma``
  accumulators, fp32 operands split into bf16 hi + lo); fp32 inputs run
  the recurrence step by step on the CUDA cores with the state in
  registers.  The function does not depend on the chunk length, so the
  kernel takes no ``chunk`` and any S unpadded.  It reads x, dt, Bm and
  Cm through their strides (the layer passes views into its conv output).

:func:`repro_torch.kernels.ops.ssd_scan` picks one by device.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
MAX_P = 128    # csrc/ssd_scan.cu: 16 state rows per warp, at most 8 warps;
MAX_N = 128    # the state of a warp in registers
CHUNK = 32     # steps per chunk of the bf16 route (kQ)
_STAGES = 2    # chunks in its shared ring (kStages)
_SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block may use


def smem_bytes(P: int, N: int) -> int:
    """Dynamic shared memory of one block of the bf16 route (mirrors
    ``tc::smem_bytes`` in the .cu source): two stages of x, B and C as
    bf16 tiles padded to 16 columns (N to 16, 32, 64 or 128) plus 16
    bytes a row, and dt; then M's hi and lo tiles."""
    pp = 16 * -(-P // 16)
    np_ = 16 * next(nk for nk in (1, 2, 4, 8) if 16 * nk >= N)
    stage = 2 * CHUNK * (pp + 8) + 4 * CHUNK * (np_ + 8) + 4 * CHUNK
    return _STAGES * stage + 4 * CHUNK * (CHUNK + 8)


def _check_shapes(x, dt, A, Bm, Cm) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 or Bm.shape != Cm.shape:
        raise ValueError(f"ssd_scan takes x (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm "
                         f"(B, S, N), got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, S, H, _ = x.shape
    if tuple(dt.shape) != (B, S, H) or A.shape[0] != H or tuple(Bm.shape[:2]) != (B, S):
        raise ValueError(f"ssd_scan: shapes do not fit x {tuple(x.shape)}: dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm/Cm {tuple(Bm.shape)}")


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, *, chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, chunks of ``min(chunk, S)``: (y (B, S, H, P)
    fp32, final state (B, H, P, N) fp32)."""
    _check_shapes(x, dt, A, Bm, Cm)
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:   # dt == 0: decay 1 and contribution 0, the state passes through
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (s + pad) // q
    f32 = torch.float32
    xc = x.to(f32).reshape(b, nc, q, h, p)
    dtc = dt.to(f32).reshape(b, nc, q, h)
    Bc = Bm.to(f32).reshape(b, nc, q, n)
    Cc = Cm.to(f32).reshape(b, nc, q, n)

    dA = dtc * A.to(f32)                       # (b, c, q, h)
    dA_cs = torch.cumsum(dA, dim=2)
    # 1) intra-chunk: L[i, j] = exp(cs_i - cs_j) for i >= j, else 0
    cs = dA_cs.permute(0, 1, 3, 2)             # (b, c, h, q)
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    L = torch.exp((cs[..., :, None] - cs[..., None, :]).masked_fill(~tril, float("-inf")))
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    M = scores[:, :, None] * L * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]   # (b,c,h,q,k)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", M, xc)
    # 2) each chunk's own final state
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)                    # (b, c, q, h)
    states = torch.einsum("bckn,bckhp->bchpn", Bc, xc * (decay_states * dtc)[..., None])
    # 3) inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                              # (b, c, h)
    carry = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(entering, dim=1)                                      # (b, c, h, p, n)
    # 4) the entering state's contribution to each position
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc, prev) * torch.exp(dA_cs)[..., None]
    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :s]
    return y, carry


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel.  x, Bm and Cm all bf16 or all fp32 with a
    contiguous last axis (any other strides); dt fp32 with any strides; A
    fp32; P and N at most 128; all on one CUDA device.  Returns (y (B, S,
    H, P) fp32, final state (B, H, P, N) fp32), both contiguous."""
    _check_shapes(x, dt, A, Bm, Cm)
    dev = _build.require("ssd_scan_cuda", [(name, t, None) for name, t in (
        ("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm))], contiguous=False)
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise TypeError(f"ssd_scan_cuda: {name} is {t.dtype}, x is {x.dtype}")
    if x.dtype not in DTYPES:
        raise TypeError(f"ssd_scan_cuda: x is {x.dtype}, expected float32 or bfloat16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan_cuda: dt and A must be float32, got {dt.dtype}, {A.dtype}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan_cuda: {name} needs a contiguous last axis")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N):
        raise ValueError(f"ssd_scan_cuda: head dim {P} and state size {N} must lie in "
                         f"[1, {MAX_P}] and [1, {MAX_N}]")
    A = A.contiguous()
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 10)(*x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                                       *Cm.stride()[:2])
    _build.launch("ssd_scan", "ssd_scan_launch", dev,
                  x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                  y.data_ptr(), state.data_ptr(), B, S, H, P, N, strides,
                  int(x.dtype == torch.bfloat16))
    return y, state
