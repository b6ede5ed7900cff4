"""CPU tests of the benchmark harness (``bench/``).  Run from the
repository root: ``PYTHONPATH=src python -m pytest -q bench/tests``."""
from __future__ import annotations

import ast
import hashlib
import json
import pathlib
import re
import shutil
import sys
import time

import pytest

from bench.harness import peaks, runner, spec
from bench.tests.tiny import tiny_cell

BENCH = spec.BENCH
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_resolves_to_its_files_by_name():
    b = benchmark()
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.entry["config"] in {c["name"] for c in b["configs"]}
        assert (BENCH / "pipelines" / f"{cell.kind}.py").exists()
        assert (BENCH / "reference" / f"{cell.kind}.py").exists()
        assert set(cell.workload["check"]["limits"]), w["name"]
        for m in spec.metrics_for(b, w["name"], "end_to_end") + \
                spec.metrics_for(b, w["name"], "per_layer"):
            assert callable(spec.module("metrics", m["name"]).read)
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists()
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
    for m in b["per_layer"]:
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in b["workloads"]}
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert (BENCH / "counts" / f"{m['name'][:-len('_roofline')]}.py").exists()


def test_names_units_and_keys_keep_to_the_contract():
    b = benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        names.append(w["name"])
    for group in ("end_to_end", "per_layer"):
        for m in b[group]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    moves = {m["name"] for m in b["end_to_end"]}
    assert all(m["moves"] in moves for m in b["per_layer"])
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for text in [c["source"] for c in b["configs"]] + [m["layer"] for m in b["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_a_new_cell_config_and_metric_are_found_with_no_file_edited(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = tmp_path / "bench"

    def digests():
        return {p: hashlib.sha256(p.read_bytes()).hexdigest()
                for p in bench.rglob("*") if p.is_file()}

    before = digests()
    config = json.loads((bench / "configs" / "knn_d50.json").read_text())
    config.update(name="knn_d64", d=64)
    (bench / "configs" / "knn_d64.json").write_text(json.dumps(config))
    workload = json.loads((bench / "workloads" / "knn_d50.paper.json").read_text())
    (bench / "workloads" / "knn_d64.paper.json").write_text(json.dumps(workload))
    (bench / "metrics" / "tasks_per_s.py").write_text(
        "def read(run):\n    return 42.0\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "knn_d64", "source": "test", "file": "bench/configs/knn_d64.json",
                         "reduced": ["n_train"], "why": "test"})
    b["workloads"].append({"name": "knn_d64.paper", "config": "knn_d64", "traffic": "paper",
                           "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "tasks_per_s", "unit": "1/s", "better": "higher",
                           "source": "program_span", "layer": "runtime", "moves": "pipeline_s",
                           "workloads": ["knn_d64.paper"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.load_cell("knn_d64.paper", root=tmp_path, bench=bench)
    assert cell.config["d"] == 64 and cell.kind == "knn"
    names = [m["name"] for m in spec.metrics_for(b, "knn_d64.paper", "per_layer")]
    assert "tasks_per_s" in names
    assert "tasks_per_s" not in [m["name"] for m in spec.metrics_for(b, "knn_d50.paper",
                                                                     "per_layer")]
    assert spec.module("metrics", "tasks_per_s", bench=bench).read(None) == 42.0
    after = digests()
    assert all(after[p] == d for p, d in before.items()), "an existing file changed"


def test_counts_equal_the_hand_values():
    knn = spec.module("counts", "knn_topk")
    km = spec.module("counts", "kmeans_assign")
    flops, nbytes = knn.work(m=12_500, n=125_000, d=50, k=5)
    assert flops == 1.5625e11
    assert peaks.least_seconds(flops, nbytes, knn.PEAK) == pytest.approx(0.316e-3, rel=2e-3)
    flops, nbytes = km.work(n=500_000, d=50, k=16)
    assert nbytes == pytest.approx(100e6, rel=1e-4)
    assert peaks.least_seconds(flops, nbytes, km.PEAK) == pytest.approx(0.0299e-3, rel=2e-3)


@pytest.mark.parametrize("name", ["knn_d50.bulk", "knn_d50.paper", "kmeans_d50.paper"])
def test_pipelines_and_references_agree_at_a_tiny_size(name):
    pytest.importorskip("torch")
    out = runner.run_cell(tiny_cell(name), 2 ** 31 + 77, 0.5, False, "cpu",
                          time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"pipeline_s", "peak_device_gib", "setup_s"}
    assert list(out)[-2:] == ["checks", "_forbidden_modules"]
    assert not out["_forbidden_modules"]


def test_the_process_backend_checks_its_results_and_leaves_no_segment():
    """The kmeans kind under ``"process"``: the centroids cross the
    shared-memory plane, and no segment made during the run is left."""
    pytest.importorskip("torch")
    cell = tiny_cell("kmeans_d50.paper", backend="process")
    cell.workload.update(workers=2)
    out = runner.run_cell(cell, 2 ** 31 + 78, 0.5, False, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["checks"]["shm_segments_left"] == {"value": 0, "limit": 0}


def test_the_data_seeds_keep_every_pipelines_fills_apart():
    seeds = [runner.data_seed(2 ** 31 + 5, j) for j in range(-1, 60)]
    ranges = [(s, s + 10_000 + 100) for s in seeds]   # fragments, then test blocks
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 <= b0
    assert runner.data_seed(7, 0) != runner.data_seed(8, 0)


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = _imports(path) & set(runner.FORBIDDEN_MODULES)
        assert not found, (path, found)
    for path in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path
    for path in (BENCH / "frozen").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path


def test_the_forbidden_names_are_compared_whole():
    sys.modules.setdefault("repro_torch_lookalike_for_test", sys)
    try:
        assert "repro_torch_lookalike_for_test" not in runner.forbidden_loaded()
    finally:
        sys.modules.pop("repro_torch_lookalike_for_test", None)


def test_the_trace_reduction_reads_busy_idle_and_kernels():
    from bench.harness.trace import DeviceTrace, base_name

    assert base_name("void (anonymous namespace)::knn_chunk_topk<8>(float const*, int)") \
        == "knn_chunk_topk"
    assert base_name("(anonymous namespace)::row_sqnorms(float const*, int)") == "row_sqnorms"
    dt = DeviceTrace(window=(0.0, 10.0), ops=[
        ("void (anonymous namespace)::knn_chunk_topk<8>(float const*)", 1.0, 3.0),
        ("Memcpy HtoD (Pageable -> Device)", 2.0, 4.0),
        ("(anonymous namespace)::row_sqnorms(float const*)", 6.0, 7.0),
        ("late", 9.5, 11.0)])
    assert dt.busy_s() == pytest.approx(4.5)
    assert dt.idle_gaps() == [(0.0, 1.0), (4.0, 6.0), (7.0, 9.5)]
    assert dt.seconds_matching(spec.module("counts", "knn_topk").KERNELS) == pytest.approx(3.0)

    class Ev:
        def __init__(self, name, t0, t1):
            self.name, self.t0, self.t1 = name, t0, t1
    labels = runner._label_gaps(dt.idle_gaps(), [Ev("fill", 0.0, 1.5), Ev("merge", 4.0, 4.5),
                                                 Ev("fill", 4.2, 6.0), Ev("fill", 4.2, 6.0)])
    assert dict(labels) == {"fill": pytest.approx(3.0), "no task": pytest.approx(2.5)}
