"""``knn_topk_roofline``: the share of its roofline that ``knn_topk``
reaches over the window, in percent: the least time the card could take
for every call of the window (``bench/counts/knn_topk.py``: the
algorithm's operations against the dense TF32 peak, its bytes against
HBM's bandwidth) over the device time of the kernels those calls launch
(torch.profiler).  The calls are the program's launch counter over the
window; their shapes are the cell's."""
from bench.harness.roofline import share


def read(run):
    return share(run, "knn_topk")
