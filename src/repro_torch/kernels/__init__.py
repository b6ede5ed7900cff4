"""The port's hand-written Hopper kernels, each beside its plain PyTorch
version (``ops`` dispatches by device):

* ``knn_topk``        — fused distance + running top-k (the paper's KNN_frag)
* ``kmeans_assign``   — fused assign + partial sums (the paper's partial_sum)
* ``rmsnorm``         — fused RMSNorm (every LM block, and the final norm)
* ``flash_attention`` — GQA attention forward with an online softmax
  (cache-free prefill of the LM)
* ``rglru_scan``      — the RG-LRU linear recurrence (RG-LRU prefill)
* ``ssd_scan``        — the Mamba-2 SSD scan (SSD prefill)

CUDA C++ sources live in ``repro_torch/csrc``; ``_build`` compiles them
with ``nvcc`` at the first CUDA launch.
"""
from . import ops  # noqa: F401
