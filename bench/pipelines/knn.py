"""The ``knn`` kind: one pipeline is one call of the port's own
``repro_torch.algorithms.knn.run_knn`` (the paper's Fig. 3 program), with
the cell's configuration and traffic and a data seed of its own.

What is checked comes from the timed path itself: the predictions that
``run_knn`` returns, and the candidate lists its merge trees hand to
``KNN_classify`` (the k squared distances of every test row).  The
predictions alone cannot tell an fp32 distance from a TF32 one, so the
kind records each ``KNN_classify`` input as it runs, by wrapping the
task body that ``run_knn`` submits (``knn.knn_classify``): the wrapper
keeps references to the device tensors and adds no copy or sync to the
path.  It is called in this process only, so the kind runs on the
``thread`` backend.
"""
from __future__ import annotations

import threading

import numpy as np


class Pipeline:
    fill_tasks = ("KNN_fill_fragment", "KNN_gen_test")

    def __init__(self, cell, device):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.workload["traffic"]
        self.device = device
        if cell.workload["backend"] != "thread":
            raise ValueError("the knn kind reads KNN_classify's inputs in this process: "
                             "it runs on the thread backend only")
        from repro_torch.algorithms import knn
        self._knn = knn
        self._lock = threading.Lock()
        self._records = None
        self._plain_classify = None

    def _args(self, **over) -> dict:
        c, t = self.config, self.traffic
        args = dict(n_train=c["n_train"], n_test=t["n_test"], d=c["d"], k=c["k"],
                    n_classes=c["n_classes"], train_fragments=c["train_fragments"],
                    test_blocks=t["test_blocks"], merge_arity=c["merge_arity"])
        args.update(over)
        return args

    # ------------------------------------------------------------ recording
    def install(self) -> None:
        plain = self._plain_classify = self._knn.knn_classify
        pipeline = self

        def knn_classify(merged, n_classes):
            out = plain(merged, n_classes)
            records = pipeline._records
            if records is not None:
                with pipeline._lock:
                    records.append((merged[0], out))
            return out

        self._knn.knn_classify = knn_classify

    def uninstall(self) -> None:
        if self._plain_classify is not None:
            self._knn.knn_classify = self._plain_classify
            self._plain_classify = None

    # ------------------------------------------------------------- running
    def warm_up(self, seed: int) -> None:
        """One whole pipeline at the cell's size.  A pipeline keeps every
        candidate list until its runtime stops (1,280 of them in
        ``knn_d50.bulk``): cut to fewer blocks, the warm-up left the
        caching allocator to grow through the window's first pipeline,
        which then ran ~1 s slower than the rest on an H100."""
        self._knn.run_knn(**self._args(), seed=seed, device=self.device)

    def run(self, seed: int) -> dict:
        self._records = []
        try:
            res = self._knn.run_knn(**self._args(), seed=seed, device=self.device)
            records = self._records
        finally:
            self._records = None
        return {"result": res, "records": records}

    def kernel_calls(self) -> dict:
        """kernel -> the argument shapes of every call one pipeline makes."""
        c, t = self.config, self.traffic
        m = t["n_test"] // t["test_blocks"]
        n = c["n_train"] // c["train_fragments"]
        shape = dict(m=m, n=n, d=c["d"], k=c["k"])
        return {"knn_topk": [shape] * (t["test_blocks"] * c["train_fragments"])}

    # ------------------------------------------------------------ checking
    def sample(self, rng: np.random.Generator) -> dict:
        rows = np.sort(rng.choice(self.traffic["n_test"], size=min(
            self.cell.workload["check"]["rows"], self.traffic["n_test"]), replace=False))
        return {"rows": rows}

    def outputs(self, record: dict, sample: dict) -> dict:
        """The program's answers at the sampled rows: predictions, and the
        distances the merge tree handed to the vote.  Each recorded vote
        is matched to its block by its predictions."""
        preds = np.asarray(record["result"].predictions)
        blocks = self.traffic["test_blocks"]
        sizes = [self.traffic["n_test"] // blocks] * blocks
        sizes[-1] += self.traffic["n_test"] - sum(sizes)
        starts = np.cumsum([0] + sizes[:-1])
        dists = [None] * blocks
        for d, out in record["records"]:
            got = out.cpu().numpy()
            for b in range(blocks):
                if dists[b] is None and len(got) == sizes[b] and \
                        np.array_equal(got, preds[starts[b]:starts[b] + sizes[b]]):
                    dists[b] = d.cpu().numpy().astype(np.float64)
                    break
        rows = sample["rows"]
        which = np.searchsorted(starts, rows, side="right") - 1
        k = self.config["k"]
        out_d = np.full((len(rows), k), np.inf)
        for j, (r, b) in enumerate(zip(rows, which)):
            if dists[b] is not None:
                out_d[j] = dists[b][r - starts[b]]
        return {"dists": out_d, "predictions": preds[rows]}

    def reference_args(self, sample: dict, outputs: dict) -> tuple:
        return (sample["rows"],)
