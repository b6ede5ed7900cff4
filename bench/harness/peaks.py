"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the card's full 700 W power limit).  A card set
below that limit runs slower under load: the harness prints the card's
name and power limit beside every roofline share."""
from __future__ import annotations

PEAK_FLOPS = {
    "tf32": 495e12,
    "bf16": 989e12,
    "fp16": 989e12,
    "fp8": 1979e12,
    "int8": 1979e12,
    "fp32": 67e12,     # outside the tensor cores
    "fp64": 67e12,     # on the tensor cores
}
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def least_seconds(flops: float, nbytes: float, peak: str) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / PEAK_FLOPS[peak], nbytes / HBM_BYTES_PER_S)
