"""Task-parallel K-means (paper §4.2) on the PyTorch port — the twin of
``examples/kmeans_pipeline.py``: a sequential-style program, the
automatic DAG, locality scheduling and the execution trace, with the
fragments and the ``partial_sum`` tasks (the hand-written
``kmeans_assign`` kernel) on the card.

The JAX example also replays the measured DAG on a virtual machine of
more workers; the port has no simulator yet (ROADMAP item A7), so this
twin stops at the trace.

Run:  PYTHONPATH=src python examples/kmeans_pipeline_torch.py [--device cpu]
      [--points 60000] [--iters 6]
(the default device is the CUDA card)
"""
import argparse

import numpy as np

from repro_torch.algorithms import kmeans
from repro_torch.core import api


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--points", type=int, default=60_000)
    ap.add_argument("--iters", type=int, default=6)
    args = ap.parse_args()
    api.runtime_start(n_workers=4, policy="locality", tracing=True)
    try:
        res = kmeans.run_kmeans(n_points=args.points, d=16, k=8, fragments=8,
                                max_iters=args.iters, device=args.device)
        print(f"k-means: {res.iterations} iterations, SSE={res.sse:.1f}")
        cref, _, _ = kmeans.reference_kmeans(args.points, 16, 8, 8, args.iters, 1e-4)
        # fp32 partial sums on the device against the float64 oracle
        assert np.allclose(res.centroids, cref, atol=1e-4)
        print("matches the single-shot float64 oracle")

        rt = api.current_runtime()
        print("\nexecution trace (4 workers):")
        print(rt.tracer.ascii_gantt(width=88))
        print(f"utilization: {rt.tracer.utilization(4):.2f}")
    finally:
        api.runtime_stop()


if __name__ == "__main__":
    main()
