"""One run of one cell: set-up, the measured window, the metrics, the check.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

Set-up (``setup_s``): imports, the cell's files, the kernel library (built
into ``build/repro_torch/<hash>/`` of the checkout on a first run) and
one warm-up pipeline at the cell's own shapes.  The window then runs
whole pipelines back to back through the port's own entry point, each
the user program as the paper writes it (a runtime started with the
cell's backend and workers, the program, the runtime stopped), each with
a data seed of its own, and starts none after ``--seconds`` have passed;
the one in flight is finished and counted.  After the window: the metrics (``--trace 0``:
the cell's end-to-end metrics; ``--trace 1``: its per-layer metrics, the
window traced by ``torch.profiler``), then the runtime is stopped, its
state freed, and a sample of the finished pipelines drawn from the seed
is held against the plain reference (its outputs are read to the host
when the sample takes it, and the rest of each pipeline is let go).  The last line of standard output
is the result; the numbers compared, each beside its limit, are the last
lines of standard error and the last key of the result.
"""
from __future__ import annotations

import bisect
import gc
import json
import os
import pathlib
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import spec as spec_mod

# the JAX package and JAX itself, by whole top-level module name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def data_seed(run_seed: int, j: int) -> int:
    """The data seed of the window's pipeline ``j`` (``j = -1``: the
    warm-up).  ``run_knn`` and ``run_kmeans`` seed fragment i with
    ``seed + i`` and test block b with ``10_000 + seed + b``: seeds
    100,000 apart keep every pipeline's fills its own."""
    return (int(run_seed) % 2 ** 32) * 2 ** 23 + 100_000 * (j + 1)


def forbidden_loaded() -> List[str]:
    return sorted(name for name in list(sys.modules)
                  if name.split(".", 1)[0] in FORBIDDEN_MODULES)


@dataclass
class Run:
    """What a metric reader reads (``metrics/<name>.py``: ``read(run)``)."""
    cell: spec_mod.Cell
    pipeline: object
    setup_s: float = 0.0
    window: tuple = (0.0, 0.0)
    pipelines: List[dict] = field(default_factory=list)   # result, t0, t1, seed
    task_events: list = field(default_factory=list)       # the tracer's, in the window
    n_workers: int = 0
    launches: Dict[str, int] = field(default_factory=dict)  # kernel launches in the window
    memory_peak_bytes: int = 0   # the process's max_memory_reserved() over set-up and window
    device_trace: object = None


def _nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def _cache_dirs(root: pathlib.Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = root / "build" / "bench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def _busy_integral(spans):
    """For one task name's spans, a function ``F(t)``: the summed time its
    tasks ran before ``t`` (several at once count several times)."""
    points = sorted([(a, 1) for a, _ in spans] + [(b, -1) for _, b in spans])
    xs, acc, counts = [], [], []
    running, total, last = 0, 0.0, None
    for t, step in points:
        if last is not None:
            total += running * (t - last)
        running += step
        xs.append(t)
        acc.append(total)
        counts.append(running)
        last = t

    def F(t: float) -> float:
        i = bisect.bisect_right(xs, t) - 1
        return 0.0 if i < 0 else acc[i] + counts[i] * (t - xs[i])
    return F


def _label_gaps(gaps, events, top: int = 10) -> list:
    """The device's idle seconds by the task the host spent most of each
    gap running, summed over the workers ("no task" where none ran)."""
    spans: Dict[str, list] = {}
    for e in events:
        spans.setdefault(e.name, []).append((e.t0, e.t1))
    integrals = {name: _busy_integral(spans[name]) for name in sorted(spans)}
    by_label: Dict[str, float] = {}
    for a, b in gaps:
        over = {name: F(b) - F(a) for name, F in integrals.items()}
        over = {name: v for name, v in over.items() if v > 0}
        label = max(over, key=over.get) if over else "no task"
        by_label[label] = by_label.get(label, 0.0) + (b - a)
    return sorted(([k, v] for k, v in by_label.items()), key=lambda kv: -kv[1])[:top]


def _shm_names() -> set:
    try:
        return set(os.listdir("/dev/shm"))
    except OSError:
        return set()


def run_cell(cell: spec_mod.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Run one cell on ``device``; returns the result object (and its
    checks).  ``t_start`` is the host clock at the start of the process."""
    import numpy as np
    import torch

    from repro_torch.core import api
    from repro_torch.kernels import _build, ops

    bench = spec_mod.load_benchmark(cell.root)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        _build.library()
    pipeline = spec_mod.module("pipelines", cell.kind).Pipeline(cell, device)
    reference = spec_mod.module("reference", cell.kind)
    wl = cell.workload
    rt_kwargs = dict(n_workers=int(wl["workers"]), backend=wl["backend"])
    run = Run(cell=cell, pipeline=pipeline, n_workers=int(wl["workers"]))
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    task_events: list = []

    def one_pipeline(fn):
        """The user program as the paper writes it: ``compss_start``, the
        program, ``compss_stop``.  The runtime keeps every task result
        until it is collected, and its reference cycles hold them past
        ``runtime_stop``: collect it, so that each pipeline starts from
        the same card memory."""
        rt = api.runtime_start(**rt_kwargs)
        n0 = len(rt.tracer.events("task"))
        try:
            out = fn()
            sync()
        finally:
            api.runtime_stop()
            task_events.extend(rt.tracer.events("task")[n0:])
            del rt
            gc.collect()
        return out

    # what is checked: a sample of the finished pipelines, drawn from the seed
    # as the window goes (a reservoir), so that only those are kept
    n_check = int(wl["check"]["pipelines"])
    rng = np.random.default_rng([int(seed) % 2 ** 32, 1])
    keep_rng = np.random.default_rng([int(seed) % 2 ** 32, 2])
    samples = [pipeline.sample(rng) for _ in range(n_check)]
    kept: List[Optional[tuple]] = [None] * n_check
    records: List[dict] = []
    failed = 0
    shm_before = _shm_names() if wl["backend"] == "process" else set()
    pipeline.install()
    try:
        one_pipeline(lambda: pipeline.warm_up(data_seed(seed, -1)))
        del task_events[:]
        run.setup_s = time.perf_counter() - t_start
        profiler = None
        if trace:
            from .trace import Profiler
            profiler = Profiler()
            profiler.start()
        launches_before = ops.launch_counts()
        w0 = time.perf_counter()
        j = 0
        while j == 0 or time.perf_counter() - w0 < seconds:
            s = data_seed(seed, j)
            j += 1
            t0 = time.perf_counter()
            try:
                rec = one_pipeline(lambda: pipeline.run(s))
            except Exception as err:   # a pipeline that fails is counted, then the window ends
                failed += 1
                print(f"pipeline {j - 1} (seed {s}) failed: {err!r}", file=sys.stderr)
                break
            t1 = time.perf_counter()
            n = len(records)
            slot = n if n < n_check else int(keep_rng.integers(n + 1))
            if slot < n_check:
                kept[slot] = (s, pipeline.outputs(rec, samples[slot]))
            records.append({"result": rec["result"], "t0": t0, "t1": t1, "seed": s})
            del rec
        attempted = j
        if records:
            run.window = (records[0]["t0"], records[-1]["t1"])
        if profiler is not None:
            run.device_trace = profiler.stop(run.window)
        run.pipelines = records
        after = ops.launch_counts()
        run.launches = {k: after.get(k, 0) - launches_before.get(k, 0) for k in after}
        run.task_events = [e for e in task_events if e.t0 >= run.window[0]]
        run.memory_peak_bytes = int(torch.cuda.max_memory_reserved()) if on_card else 0
        device_info = {"platform": "gpu" if on_card else "cpu",
                       "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                       "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
        if run.device_trace is not None:
            device_info["busy_s"] = run.device_trace.busy_s()
            device_info["window_s"] = run.device_trace.window_s

        group = "per_layer" if trace else "end_to_end"
        metrics = {}
        for m in spec_mod.metrics_for(bench, cell.name, group):
            value = spec_mod.module("metrics", m["name"]).read(run) if records else None
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        breakdown = None
        if run.device_trace is not None:
            dt = run.device_trace
            ops_s = sorted(dt.seconds_by_name().items(), key=lambda kv: -kv[1])[:10]
            breakdown = {"device_ops": [[k, v] for k, v in ops_s],
                         "idle_gaps": _label_gaps(dt.idle_gaps(), run.task_events)}
        pipeline_seconds = [r["t1"] - r["t0"] for r in records]
    finally:
        pipeline.uninstall()
    forbidden = forbidden_loaded()
    left = sorted(_shm_names() - shm_before) if wl["backend"] == "process" else []
    del records, run, profiler, task_events
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    limits = wl["check"]["limits"]
    checks: Dict[str, dict] = {}
    for i, item in enumerate(kept):
        if item is None:
            continue
        data_s, got = item
        want = reference.reference(cell.config, wl["traffic"], data_s,
                                   *pipeline.reference_args(samples[i], got), device=device)
        for name, value in reference.compare(got, want, limits).items():
            worst = checks.get(name, {}).get("value", float("-inf"))
            checks[name] = {"value": max(worst, value), "limit": limits[name]}
    if wl["backend"] == "process":
        checks["shm_segments_left"] = {"value": len(left), "limit": 0}
    correct = any(k is not None for k in kept) and failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["pipeline_seconds"] = pipeline_seconds
    out["checks"] = checks
    out["_forbidden_modules"] = forbidden
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Benchmark of the PyTorch and CUDA port "
                                             "(repro_torch) on one CUDA card.")
    ap.add_argument("--workload", required=True, help="the cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec_mod.load_cell(args.workload)
    root = cell.root
    _cache_dirs(root)
    if not (root / "src" / "repro_torch").is_dir():
        print(f"bench: the program (src/repro_torch) is not in {root}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: cell {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    forbidden = out.pop("_forbidden_modules")
    if forbidden:
        print(f"bench: the run loaded JAX or the JAX package: {forbidden}", file=sys.stderr)
        return 3
    print(f"card: {_nvidia_smi()}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
