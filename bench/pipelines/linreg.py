"""The ``linreg`` kind: one pipeline is one call of the port's own
``repro_torch.algorithms.linreg.run_linreg`` (the paper's Fig. 5
program: fills, Gram and Z'y partials, two merge trees, the fit, then
the predictions behind it), with the cell's configuration and traffic
and a data seed of its own.

What is checked is what the timed path returns: beta and every
prediction row, as ``run_linreg`` hands them to the user program on the
host.  Nothing is recorded along the way, so the kind needs no hook into
the program and runs under any backend.
"""
from __future__ import annotations

import numpy as np


class Pipeline:
    fill_tasks = ("LR_fill_fragment", "LR_genpred")

    def __init__(self, cell, device):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.workload["traffic"]
        self.device = device
        from repro_torch.algorithms import linreg
        self._linreg = linreg
        # run_linreg fills every fragment with beta seed 1234 and noise 0.1
        if int(self.config["beta_seed"]) != 1234 or float(self.config["noise"]) != 0.1:
            raise ValueError("run_linreg generates with beta_seed 1234 and noise 0.1: "
                             "the configuration must state those")

    def _args(self, **over) -> dict:
        c, t = self.config, self.traffic
        args = dict(n_rows=c["n_rows"], p=c["p"], n_pred=t["n_pred"], fragments=c["fragments"],
                    pred_blocks=t["pred_blocks"], merge_arity=c["merge_arity"])
        args.update(over)
        return args

    def install(self) -> None:
        pass

    def uninstall(self) -> None:
        pass

    def warm_up(self, seed: int) -> None:
        """One pipeline at the cell's own fragment and block sizes, cut to
        as many fragments and prediction blocks as the runtime has
        workers."""
        c, t = self.config, self.traffic
        n = max(2, int(self.cell.workload["workers"]))
        frag = c["n_rows"] // c["fragments"]
        block = t["n_pred"] // t["pred_blocks"]
        self._linreg.run_linreg(**self._args(n_rows=n * frag, fragments=n, n_pred=n * block,
                                             pred_blocks=n), seed=seed, device=self.device)

    def run(self, seed: int) -> dict:
        return {"result": self._linreg.run_linreg(**self._args(), seed=seed, device=self.device)}

    def kernel_calls(self) -> dict:
        """The pipeline calls no kernel of the port: its products are
        cuBLAS's."""
        return {}

    def sample(self, rng: np.random.Generator) -> dict:
        return {}

    def outputs(self, record: dict, sample: dict) -> dict:
        r = record["result"]
        return {"beta": np.asarray(r.beta, dtype=np.float64),
                "predictions": np.asarray(r.predictions, dtype=np.float64)}

    def reference_args(self, sample: dict, outputs: dict) -> tuple:
        return ()
