"""CPU tests of the ``linreg`` kind (``linreg_p1000.paper``): a tiny run
is correct, planted faults and the float32 control are not, the readers
``tail_ms`` and ``solve_ms`` give hand values, and the pipelines' seeds
stay apart.  The tiny cell keeps p 1000 and cuts the rows.  Run from
the repository root: ``PYTHONPATH=src python -m pytest -q bench/tests``."""
from __future__ import annotations

import copy
import time
from types import SimpleNamespace

import pytest

from bench.control import control_readings
from bench.frozen import linreg as frozen
from bench.harness import runner, spec

torch = pytest.importorskip("torch")

CELL = "linreg_p1000.paper"


def tiny_cell(n_rows: int = 8000) -> spec.Cell:
    cell = spec.load_cell(CELL)
    cell.config = dict(cell.config, n_rows=n_rows, fragments=4)
    cell.workload = copy.deepcopy(cell.workload)
    cell.workload["traffic"].update(n_pred=800, pred_blocks=4)
    return cell


def _run(seed: int = 2 ** 31 + 101) -> dict:
    return runner.run_cell(tiny_cell(), seed, 0.3, False, "cpu", time.perf_counter())


def test_a_tiny_run_is_correct_and_reports_the_end_to_end_metrics():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"pipeline_s", "peak_device_gib", "setup_s"}
    assert set(out["checks"]) == {"beta_gap", "pred_gap"}
    assert not out["_forbidden_modules"]


def _merge_drops_its_second_input(lr):
    return "merge_add", lambda a, b: a


def _gram_in_float32(lr):
    plain = lr.partial_ztz

    def partial_ztz(frag):
        X, y = frag
        return plain((X.float(), y.float())).double()
    return "partial_ztz", partial_ztz


def _intercept_sums_left_out(lr):
    plain = lr.partial_ztz

    def partial_ztz(frag):
        G = plain(frag).clone()
        G[0, 1:] = 0.0
        G[1:, 0] = 0.0
        return G
    return "partial_ztz", partial_ztz


def _predictions_without_the_intercept(lr):
    return "compute_prediction", lambda X_pred, beta: X_pred @ beta[1:]


@pytest.mark.parametrize("fault", [_merge_drops_its_second_input, _gram_in_float32,
                                   _intercept_sums_left_out,
                                   _predictions_without_the_intercept])
def test_a_planted_fault_fails_the_check(monkeypatch, fault):
    from repro_torch.algorithms import linreg
    name, body = fault(linreg)
    monkeypatch.setattr(linreg, name, body)
    out = _run()
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 12])
def test_the_float32_control_fails_the_check_at_a_small_size(seed):
    out = control_readings(tiny_cell(), seed, "cpu")
    assert not out["passed"], out["numbers"]


@pytest.mark.gpu
def test_the_float32_control_fails_the_check_at_the_cells_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = control_readings(spec.load_cell(CELL), 2 ** 31 + 21, torch.device("cuda"))
    assert not out["passed"], out["numbers"]


def test_compare_reads_inf_for_a_missing_row_or_a_wrong_shape():
    ref = spec.module("reference", "linreg")
    want = {"beta": torch.arange(1.0, 4.0).numpy(), "predictions": torch.ones(5).numpy()}
    assert ref.compare(want, want, {}) == {"beta_gap": 0.0, "pred_gap": 0.0}
    short = dict(want, predictions=want["predictions"][:4])
    assert ref.compare(short, want, {})["pred_gap"] == float("inf")
    wide = dict(want, beta=want["beta"][None])
    assert ref.compare(wide, want, {})["beta_gap"] == float("inf")
    off = dict(want, beta=want["beta"] + [0.0, 0.0, 0.3])
    assert ref.compare(off, want, {})["beta_gap"] == pytest.approx(0.1)


def ev(name, t0, t1, spans=()):
    return SimpleNamespace(name=name, worker=0, t0=t0, t1=t1, spans=spans)


def make_run(events, pipelines):
    run = runner.Run(cell=None, pipeline=SimpleNamespace(
        fill_tasks=("LR_fill_fragment", "LR_genpred")), task_events=list(events), n_workers=4)
    run.pipelines = [{"t0": a, "t1": b} for a, b in pipelines]
    run.window = (pipelines[0][0], pipelines[-1][1])
    return run


def read(name, run):
    return spec.module("metrics", name).read(run)


def test_the_tail_and_solve_readers_equal_the_hand_values():
    run = make_run([
        # pipeline 1: data on the card at 2.0, last prediction at 2.5
        ev("LR_fill_fragment", 0.0, 1.5), ev("LR_genpred", 0.1, 2.0),
        ev("partial_ztz", 1.5, 1.8),
        ev("compute_model_parameters", 2.1, 2.3, spans=(("solve", 2.1, 2.25),)),
        ev("compute_prediction", 2.3, 2.4), ev("compute_prediction", 2.3, 2.5),
        # pipeline 2: data at 4.0, last prediction at 4.2
        ev("LR_fill_fragment", 3.0, 4.0), ev("LR_genpred", 3.0, 3.5),
        ev("compute_model_parameters", 4.0, 4.1, spans=(("solve", 4.0, 4.05),)),
        ev("compute_prediction", 4.1, 4.2)], pipelines=[(0.0, 3.0), (3.0, 5.0)])
    assert read("tail_ms", run) == pytest.approx(1000.0 * (0.5 + 0.2) / 2)
    assert read("solve_ms", run) == pytest.approx(1000.0 * (0.15 + 0.05) / 2)


def test_without_predictions_or_solve_spans_the_readers_read_nothing():
    plain = [ev("LR_fill_fragment", 0.0, 1.0), ev("compute_model_parameters", 1.0, 2.0),
             ev("compute_prediction", 2.0, 3.0)]
    run = make_run(plain, pipelines=[(0.0, 4.0)])
    assert read("solve_ms", run) is None
    assert read("tail_ms", run) == pytest.approx(2000.0)
    assert read("tail_ms", make_run(plain[:2], pipelines=[(0.0, 4.0)])) is None


def test_a_tiny_pipeline_through_the_runtime_feeds_the_span_readers():
    from repro_torch.core import api

    cell = tiny_cell(n_rows=4000)
    pipeline = spec.module("pipelines", "linreg").Pipeline(cell, "cpu")
    rt = api.runtime_start(n_workers=4)
    try:
        t0 = time.perf_counter()
        rec = pipeline.run(runner.data_seed(2 ** 31 + 91, 0))
        t1 = time.perf_counter()
    finally:
        api.runtime_stop()
    run = runner.Run(cell=cell, pipeline=pipeline, window=(t0, t1),
                     task_events=rt.tracer.events("task"), n_workers=4)
    run.pipelines = [{"result": rec["result"], "t0": t0, "t1": t1}]
    got = {m: read(m, run) for m in ("tail_ms", "solve_ms", "fill_generate_s", "fill_upload_s")}
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    assert rec["result"].n_tasks == len(run.task_events) == 4 * 3 + 2 * 3 + 1 + 2 * 4


def test_the_seed_offsets_of_consecutive_pipelines_never_overlap():
    config = spec.load_cell(CELL).config
    traffic = spec.load_cell(CELL).workload["traffic"]
    used = []
    for j in range(-1, 60):
        s = runner.data_seed(2 ** 31 + 5, j)
        seeds = [a[0] for a in frozen.fragment_args(s, config["n_rows"], config["p"],
                                                    config["fragments"])]
        seeds += [a[0] for a in frozen.prediction_args(s, traffic["n_pred"], config["p"],
                                                       traffic["pred_blocks"])]
        assert seeds[:config["fragments"]] == list(range(s, s + 16))
        assert seeds[config["fragments"]:] == list(range(s + 50_000, s + 50_004))
        used += seeds
    assert len(used) == len(set(used))
