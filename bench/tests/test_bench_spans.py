"""CPU tests of the readers of the runtime's own stamps and spans
(``queue_wait_ms``, ``runtime_self_us``, ``fill_generate_s``,
``fill_upload_s``, ``idle_kernel_queued_pct``).  Run from the repository
root: ``PYTHONPATH=src python -m pytest -q bench/tests``."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from bench.harness import runner, spec
from bench.harness.trace import DeviceTrace
from bench.tests.tiny import tiny_cell

PROGRAM_SPAN = ("queue_wait_ms", "runtime_self_us", "fill_generate_s", "fill_upload_s")
NEW = PROGRAM_SPAN + ("idle_kernel_queued_pct",)


def ev(name, t0, t1, t_ready=None, t_run=None, t_body=None, spans=()):
    return SimpleNamespace(name=name, worker=0, t0=t0, t1=t1, t_ready=t_ready,
                           t_run=t_run, t_body=t_body, spans=spans)


def make_run(events, pipelines=1, ops=None, window=(0.0, 10.0)):
    run = runner.Run(cell=None, pipeline=SimpleNamespace(fill_tasks=("fill",)),
                     window=window, task_events=list(events), n_workers=1)
    run.pipelines = [{"t0": 0.0, "t1": 10.0}] * pipelines
    if ops is not None:
        run.device_trace = DeviceTrace(window=window, ops=ops)
    return run


def read(name, run):
    return spec.module("metrics", name).read(run)


def test_the_runtime_means_equal_the_hand_values():
    run = make_run([ev("frag", 1.0, 2.0, t_ready=0.5, t_run=1.25, t_body=1.75),
                    ev("merge", 3.0, 4.0, t_ready=3.0, t_run=3.5, t_body=3.5),
                    ev("fill", 5.0, 6.0, t_ready=4.0, t_run=5.0, t_body=6.0)])
    # waits 0.5, 0, 1 s; self (0.25 + 0.25), (0.5 + 0.5), (0 + 0) s
    assert read("queue_wait_ms", run) == pytest.approx(1000.0 * 1.5 / 3)
    assert read("runtime_self_us", run) == pytest.approx(1e6 * 1.5 / 3)


def test_the_fill_spans_sum_over_workers_per_pipeline():
    run = make_run([ev("fill", 0.0, 3.0, spans=(("generate", 0.1, 1.1), ("upload", 1.1, 1.6))),
                    ev("fill", 0.0, 3.0, spans=(("generate", 0.2, 2.2), ("upload", 2.2, 2.4))),
                    ev("frag", 3.0, 4.0, spans=(("generate", 3.0, 4.0), ("upload", 3.0, 4.0)))],
                   pipelines=2)
    assert read("fill_generate_s", run) == pytest.approx(3.0 / 2)
    assert read("fill_upload_s", run) == pytest.approx(0.7 / 2)


def test_a_gap_covered_by_a_ready_kernel_task_reads_100():
    ops = [("k", 0.0, 2.0), ("k", 6.0, 10.0)]           # one gap: [2, 6)
    run = make_run([ev("frag", 6.0, 7.0, t_ready=1.0)], ops=ops)
    assert read("idle_kernel_queued_pct", run) == pytest.approx(100.0)


def test_a_gap_covered_only_by_a_ready_fill_reads_0():
    ops = [("k", 0.0, 2.0), ("k", 6.0, 10.0)]
    run = make_run([ev("fill", 6.0, 7.0, t_ready=1.0),
                    ev("frag", 8.0, 9.0, t_ready=7.0)], ops=ops)   # ready after the gap
    assert read("idle_kernel_queued_pct", run) == pytest.approx(0.0)


def test_overlapping_waits_count_once_and_only_inside_the_gaps():
    ops = [("k", 0.0, 2.0), ("k", 6.0, 8.0)]            # gaps [2, 6) and [8, 10)
    run = make_run([ev("frag", 3.0, 4.0, t_ready=1.0),  # waits [1, 3): 1 s in a gap
                    ev("merge", 4.0, 5.0, t_ready=2.5),  # [2.5, 4): overlaps the first
                    ev("frag", 9.5, 9.8, t_ready=9.0)],  # [9, 9.5): 0.5 s
                   ops=ops)
    # waiting in the gaps: [2, 4) and [9, 9.5) = 2.5 s of 6 s idle
    assert read("idle_kernel_queued_pct", run) == pytest.approx(100.0 * 2.5 / 6.0)


def test_a_program_without_stamps_or_spans_reads_nothing():
    """The parent program's events carry only ``t0`` and ``t1``: each
    new reader returns ``None`` and raises nothing."""
    plain = [SimpleNamespace(name=n, worker=0, t0=1.0, t1=2.0) for n in ("fill", "frag")]
    run = make_run(plain, ops=[("k", 0.0, 0.5)])
    assert {name: read(name, run) for name in NEW} == dict.fromkeys(NEW)
    assert read("idle_kernel_queued_pct", make_run([ev("frag", 1.0, 2.0, t_ready=0.0)])) is None


@pytest.mark.parametrize("name", ["knn_d50.paper", "kmeans_d50.paper"])
def test_a_tiny_pipeline_through_the_runtime_feeds_every_program_span_reader(name):
    pytest.importorskip("torch")
    from repro_torch.core import api

    cell = tiny_cell(name)
    pipeline = spec.module("pipelines", cell.kind).Pipeline(cell, "cpu")
    rt = api.runtime_start(n_workers=int(cell.workload["workers"]),
                           backend=cell.workload["backend"])
    try:
        t0 = time.perf_counter()
        rec = pipeline.run(runner.data_seed(2 ** 31 + 91, 0))
        t1 = time.perf_counter()
    finally:
        api.runtime_stop()
    run = runner.Run(cell=cell, pipeline=pipeline, window=(t0, t1),
                     task_events=rt.tracer.events("task"),
                     n_workers=int(cell.workload["workers"]))
    run.pipelines = [{"result": rec["result"], "t0": t0, "t1": t1}]
    got = {m: read(m, run) for m in PROGRAM_SPAN}
    assert all(isinstance(v, float) and v >= 0 for v in got.values()), got
    assert got["fill_generate_s"] > 0 and got["fill_upload_s"] >= 0
    # the spans lie inside the fill bodies, which fill_s times whole
    assert got["fill_generate_s"] + got["fill_upload_s"] <= read("fill_s", run)
