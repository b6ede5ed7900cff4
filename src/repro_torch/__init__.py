"""repro_torch — the PyTorch/CUDA port of the RCOMPSs reproduction.

The JAX package ``repro`` stays the reference; this package mirrors its
module paths (``repro_torch.kernels.knn_topk`` ↔ ``repro.kernels.knn_topk``)
and imports nothing of it.  This slice holds the task runtime
(:mod:`repro_torch.core`, thread backend), the KNN / K-means /
linear-regression pipelines (:mod:`repro_torch.algorithms`) and the two
hand-written CUDA kernels they run (:mod:`repro_torch.kernels`).
"""
