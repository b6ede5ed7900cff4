"""``kmeans_assign_roofline``: the share of its roofline that
``kmeans_assign`` reaches over the window, in percent: the least time
the card could take for every call of the window
(``bench/counts/kmeans_assign.py``: the algorithm's operations against
the dense TF32 peak, its bytes against HBM's bandwidth) over the device
time of the kernels those calls launch (torch.profiler)."""
from bench.harness.roofline import share


def read(run):
    return share(run, "kmeans_assign")
