"""Spreads of a cell's metrics over sets of runs, as the bounds are set:
``python3 bench/tools/spread.py <series.jsonl> [--sets 6]``.

For each metric and each consecutive set of ``--sets`` runs (``--trace
0`` only): the median, the first and third quartiles by
``statistics.quantiles(values, n=4)`` and the spread, their distance as
a share of the median.  Also the spread with each set's run farthest from
its median left out.  A bound is about five times the widest spread,
never under 1%."""
from __future__ import annotations

import argparse
import json
import statistics
import sys


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="+")
    ap.add_argument("--sets", type=int, default=6)
    args = ap.parse_args(argv)
    rows = []
    for f in args.files:
        with open(f) as fh:
            rows += [json.loads(line) for line in fh if line.strip()]
    by_cell = {}
    for r in rows:
        if r["trace"] == 0 and r["result"]:
            by_cell.setdefault(r["workload"], []).append(r)
    for cell, rs in by_cell.items():
        names = sorted({m for r in rs for m in r["result"]["metrics"]})
        for name in names:
            vals = [r["result"]["metrics"][name]["value"] for r in rs
                    if name in r["result"]["metrics"]]
            sets = [vals[i:i + args.sets] for i in range(0, len(vals), args.sets)]
            out = []
            for s in sets:
                if len(s) < 3:
                    continue
                med = statistics.median(s)
                trimmed = sorted(s, key=lambda v: abs(v - med))[:-1]
                out.append({"n": len(s), "median": med, "spread": spread(s),
                            "spread_trimmed": spread(trimmed) if len(trimmed) >= 3 else None,
                            "min": min(s), "max": max(s)})
            print(json.dumps({"cell": cell, "metric": name, "sets": out,
                              "all": {"n": len(vals), "spread": spread(vals) if len(vals) >= 3
                                      else None}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
