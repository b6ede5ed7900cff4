"""Run one cell several times, each run a process of its own, and keep
every result line: ``python3 bench/tools/series.py --workload <cell>
--seeds 11,12,13 --seconds 30 [--trace 0,0,1] --out <file.jsonl>``.

Each run is ``python3 bench/run.py`` exactly as the benchmark's command
gives it; the line kept per run holds its seed, trace flag, exit code,
wall seconds, the result object (or null) and the last lines of its
standard error.  Used to measure spreads (``spread.py``) and to prove a
cell on the card."""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", default="", help="comma-separated 0/1 per seed (default all 0)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=1200.0)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    traces = [int(t) for t in args.trace.split(",")] if args.trace else [0] * len(seeds)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    bad = 0
    with out.open("a") as fh:
        for seed, trace in zip(seeds, traces):
            cmd = [sys.executable, "bench/run.py", "--workload", args.workload,
                   "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(trace)]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=args.timeout)
            wall = time.perf_counter() - t0
            lines = p.stdout.strip().splitlines()
            result = None
            if p.returncode == 0 and lines:
                try:
                    result = json.loads(lines[-1])
                except json.JSONDecodeError:
                    result = None
            row = {"workload": args.workload, "seed": seed, "trace": trace,
                   "rc": p.returncode, "wall_s": wall, "result": result,
                   "stderr_tail": p.stderr.strip().splitlines()[-12:]}
            fh.write(json.dumps(row) + "\n")
            fh.flush()
            bad += result is None or not result.get("correct")
            summary = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
            checks = {k: v["value"] for k, v in (result or {}).get("checks", {}).items()}
            print(json.dumps({"seed": seed, "trace": trace, "rc": p.returncode,
                              "wall_s": round(wall, 2),
                              "correct": (result or {}).get("correct"),
                              "attempted": (result or {}).get("attempted"),
                              "metrics": summary, "checks": checks}), flush=True)
            if result is None:
                print("\n".join(p.stderr.strip().splitlines()[-30:]), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
