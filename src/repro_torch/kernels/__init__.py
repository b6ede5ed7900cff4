"""The port's hand-written Hopper kernels, each beside its plain PyTorch
version (``ops`` dispatches by device):

* ``knn_topk``      — fused distance + running top-k (the paper's KNN_frag)
* ``kmeans_assign`` — fused assign + partial sums (the paper's partial_sum)

CUDA C++ sources live in ``repro_torch/csrc``; ``_build`` compiles them
with ``nvcc`` at the first CUDA launch.  The other four Pallas kernels of
``repro.kernels`` are ported with later slices.
"""
from . import ops  # noqa: F401
