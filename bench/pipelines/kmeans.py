"""The ``kmeans`` kind: one pipeline is one call of the port's own
``repro_torch.algorithms.kmeans.run_kmeans`` (the paper's Fig. 4
program), with the cell's configuration and traffic and a data seed of
its own.  ``tol`` is 0, so every pipeline runs its whole budget of
iterations.

What is checked is what the timed path produces: every iteration's sse
and the number of iterations, as ``run_kmeans`` returns them, and every
iteration's centroids, as the user program receives them from the
per-iteration ``wait_on`` (the reference follows the program step by
step: ``bench/reference/kmeans.py``).  The kind reads those by standing
a thin proxy in for the ``api`` module that ``run_kmeans`` calls: its
``wait_on`` keeps a reference to each iteration's centroids and passes
everything else through, with no copy or sync added.  Under the
``process`` backend they have crossed the shared-memory plane.
"""
from __future__ import annotations

import numpy as np


class _RecordingApi:
    """The runtime's ``api`` module, with ``wait_on`` keeping each
    iteration's centroids for the pipeline being recorded."""

    def __init__(self, api, pipeline):
        self._api = api
        self._pipeline = pipeline

    def __getattr__(self, name):
        return getattr(self._api, name)

    def wait_on(self, obj, timeout=None):
        out = self._api.wait_on(obj, timeout=timeout)
        states = self._pipeline._states
        if states is not None and isinstance(out, tuple) and len(out) == 3:
            states.append(out[0])
        return out


class Pipeline:
    fill_tasks = ("fill_fragment",)

    def __init__(self, cell, device):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.workload["traffic"]
        self.device = device
        if float(self.traffic["tol"]) != 0.0:
            raise ValueError("the kmeans kind runs whole budgets: the traffic's tol must be 0")
        from repro_torch.algorithms import kmeans
        self._kmeans = kmeans
        self._api = None
        self._states = None

    def _args(self, **over) -> dict:
        c, t = self.config, self.traffic
        args = dict(n_points=c["n_points"], d=c["d"], k=c["k"], fragments=c["fragments"],
                    max_iters=t["max_iters"], tol=t["tol"], merge_arity=c["merge_arity"])
        args.update(over)
        return args

    def install(self) -> None:
        self._api = self._kmeans.api
        self._kmeans.api = _RecordingApi(self._api, self)

    def uninstall(self) -> None:
        if self._api is not None:
            self._kmeans.api = self._api
            self._api = None

    def warm_up(self, seed: int) -> None:
        """One pipeline at the cell's own shapes (whole fragments), cut to
        as many fragments as the runtime has workers and two iterations."""
        c = self.config
        frags = max(2, int(self.cell.workload["workers"]))
        frag = c["n_points"] // c["fragments"]
        self._kmeans.run_kmeans(**self._args(n_points=frags * frag, fragments=frags,
                                             max_iters=2), seed=seed, device=self.device)

    def run(self, seed: int) -> dict:
        self._states = []
        try:
            res = self._kmeans.run_kmeans(**self._args(), seed=seed, device=self.device)
            states = self._states
        finally:
            self._states = None
        return {"result": res, "states": states}

    def kernel_calls(self) -> dict:
        c = self.config
        shape = dict(n=c["n_points"] // c["fragments"], d=c["d"], k=c["k"])
        return {"kmeans_assign": [shape] * (c["fragments"] * int(self.traffic["max_iters"]))}

    def sample(self, rng: np.random.Generator) -> dict:
        return {}

    def outputs(self, record: dict, sample: dict) -> dict:
        r = record["result"]
        return {"sse_history": list(r.sse_history), "iterations": int(r.iterations),
                "states": [s.cpu().numpy().astype(np.float64) for s in record["states"]]}

    def reference_args(self, sample: dict, outputs: dict) -> tuple:
        return (outputs["states"],)
