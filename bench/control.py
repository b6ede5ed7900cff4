"""The control of a cell's check: the plain reference computed in the
nearest precision below the configuration's (TF32 products for fp32),
put in the program's place and held against the float64 reference by
the cell's own comparison and limits.  It has to come out not correct.

``python3 bench/control.py --workload <cell> --seeds 1,2,3`` prints one
JSON line per seed with the numbers compared, their limits and whether
the control passed them; at the cell's own size it runs on the card.
The benchmark's runs do not run it.  ``bench/tests/test_bench_control.py``
runs it at a small size.
"""
from __future__ import annotations

import json
import pathlib
import sys


def control_readings(cell, seed: int, device) -> dict:
    """The cell's numbers for the control on the pipeline data of run
    seed ``seed`` (its window's first pipeline)."""
    import numpy as np

    from bench.harness import spec
    from bench.harness.runner import data_seed

    ref_mod = spec.module("reference", cell.kind)
    wl = cell.workload
    s = data_seed(seed, 0)
    args = ()
    if cell.kind == "knn":
        rng = np.random.default_rng([int(seed) % 2 ** 32, 1])
        n_test = wl["traffic"]["n_test"]
        args = (np.sort(rng.choice(n_test, size=min(wl["check"]["rows"], n_test),
                                   replace=False)),)
    got = ref_mod.control(cell.config, wl["traffic"], s, *args, device=device)
    if cell.kind == "kmeans":     # the reference follows the control's own steps
        args = (got["states"],)
    want = ref_mod.reference(cell.config, wl["traffic"], s, *args, device=device)
    limits = wl["check"]["limits"]
    numbers = ref_mod.compare(got, want, limits)
    return {"workload": cell.name, "seed": seed,
            "numbers": {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()},
            "passed": all(v <= limits[k] for k, v in numbers.items())}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated run seeds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from bench.harness import spec
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_readings(cell, seed, torch.device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])
    sys.exit(main())
