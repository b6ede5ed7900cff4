"""Task-parallel K-means (paper §4.2) on the PyTorch port — the twin of
``examples/kmeans_pipeline.py``: a sequential-style program, the
automatic DAG, locality scheduling, the execution trace, and a replay of
the measured DAG on a virtual machine of more workers to project scaling,
with the fragments and the ``partial_sum`` tasks (the hand-written
``kmeans_assign`` kernel) on the card.

With ``--backend process`` the tasks run in four persistent worker
processes, spawned, each with its own CUDA context; each fragment
crosses to a worker through the shared-memory plane as host bytes once,
and the worker's segment cache keeps the device copy it uploaded, so
later iterations upload nothing.  With ``--backend cluster`` they run on
two real TCP node agents on localhost, each with two spawned workers:
fragments stay node-resident and cross between nodes as host bytes over
the peer data plane; the agents never touch the card.

On the card a task's measured duration is host time around a body that
launches its kernel asynchronously: the replay charges device time to
the task that synchronises (``update_centroids``), so the projection is
a projection of the measured host-side DAG, not a measurement of a
many-core node.

Run:  PYTHONPATH=src python examples/kmeans_pipeline_torch.py [--device cpu]
      [--backend process|cluster] [--points 60000] [--iters 6]
(the default device is the CUDA card)
"""
import argparse

import numpy as np

from repro_torch.algorithms import kmeans
from repro_torch.core import api
from repro_torch.core.simulator import MachineModel, replay_graph, simulate


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--backend", default="thread", choices=("thread", "process", "cluster"))
    ap.add_argument("--points", type=int, default=60_000)
    ap.add_argument("--iters", type=int, default=6)
    args = ap.parse_args()
    if args.backend == "cluster":
        api.runtime_start(backend="cluster", n_agents=2, workers_per_node=2,
                          policy="locality", tracing=True)
    else:
        api.runtime_start(n_workers=4, policy="locality", tracing=True, backend=args.backend)
    try:
        res = kmeans.run_kmeans(n_points=args.points, d=16, k=8, fragments=8,
                                max_iters=args.iters, device=args.device)
        print(f"k-means: {res.iterations} iterations, SSE={res.sse:.1f}")
        cref, _, _ = kmeans.reference_kmeans(args.points, 16, 8, 8, args.iters, 1e-4)
        # fp32 partial sums on the device against the float64 oracle
        assert np.allclose(res.centroids, cref, atol=1e-4)
        print("matches the single-shot float64 oracle")

        rt = api.current_runtime()
        print(f"\nexecution trace (4 workers, backend {args.backend}):")
        print(rt.tracer.ascii_gantt(width=88))
        print(f"utilization: {rt.tracer.utilization(4):.2f}")

        sims = replay_graph(rt.graph)
        for w in (1, 8, 64):
            r = simulate(sims, MachineModel(n_nodes=1, workers_per_node=w))
            print(f"projected makespan on {w:3d} workers: "
                  f"{r.makespan*1e3:8.1f} ms (eff {r.efficiency:.2f})")
    finally:
        api.runtime_stop()


if __name__ == "__main__":
    main()
