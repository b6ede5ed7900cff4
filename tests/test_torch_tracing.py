"""The port's task tracing (``repro_torch.core.tracing``): the lifecycle
stamps every task event carries, the child spans a task body records
with ``tracing.span``, the Chrome-trace export of both, and the
telemetry ring that only a dashboard or ``telemetry=True`` turns on.
The file imports nothing of the JAX package.

An attempt's event is recorded after its outputs are published (``t1``),
so a caller woken by the result may run ahead of it: the tests read the
tracer once the runtime has stopped, which joins the workers."""
import json
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.algorithms import kmeans, knn, linreg  # noqa: E402
from repro_torch.core import api, tracing  # noqa: E402

FILLS = {
    "KNN_fill_fragment": (knn.knn_fill_fragment, (3, 64, 5, 4, "cpu")),
    "KNN_gen_test": (knn.knn_gen_test, (4, 64, 5, 4, "cpu")),
    "fill_fragment": (kmeans.fill_fragment, (5, 64, 5, 8, 5.0, "cpu")),
    "LR_fill_fragment": (linreg.lr_fill_fragment, (6, 64, 5, 1234, 0.1, "cpu")),
    "LR_genpred": (linreg.lr_genpred, (50_006, 64, 5, "cpu")),
}
# every device's span shape: the host's small draws, their move to the
# device, the normals drawn there (LR_genpred draws no host values)
FILL_SPANS = {name: ["generate"] if name == "LR_genpred" else ["generate", "upload", "generate"]
              for name in FILLS}


def _add(a, b):
    return a + b


def _slow(x, s=0.01):
    time.sleep(s)
    return x


def _diamond():
    """Two roots, their sum, and a fan-out of four readers of it."""
    leaf, add = api.task(_slow, name="leaf"), api.task(_add, name="add")
    a, b = leaf(1), leaf(2, 0.05)
    c = add(a, b)
    outs = [add(c, i) for i in range(4)]
    return api.wait_on(outs)


def test_every_task_carries_its_lifecycle_stamps_in_order():
    with api.runtime_start(n_workers=2) as rt:
        assert _diamond() == [3, 4, 5, 6]
    evs = rt.tracer.events("task")
    assert len(evs) == 7
    for e in evs:
        assert e.t_ready <= e.t0 <= e.t_run <= e.t_body <= e.t1, e
        assert e.spans == ()


def test_a_child_becomes_ready_when_its_last_parent_completes():
    with api.runtime_start(n_workers=2) as rt:
        _diamond()
    evs = {e.task_id: e for e in rt.tracer.events("task")}
    nodes = {tid: rt.graph.get(tid) for tid in evs}
    children = [n for n in nodes.values() if n.parents]
    assert len(children) == 5
    for child in children:
        ends = [nodes[p].end_t for p in child.parents]
        # released under the graph lock by its last parent, at that
        # parent's own completion stamp: the same float, not a later read
        assert evs[child.task_id].t_ready == child.ready_t == max(ends)
        # ... which lies between that parent's body and its trace event
        last = max(child.parents, key=lambda p: nodes[p].end_t)
        assert evs[last].t_body <= child.ready_t <= evs[last].t1


def test_a_retried_attempt_is_ready_afresh():
    calls = {"n": 0}
    lock = threading.Lock()

    def flaky():
        with lock:
            calls["n"] += 1
            first = calls["n"] == 1
        if first:
            raise RuntimeError("first attempt fails")
        return 7

    with api.runtime_start(n_workers=1, max_retries=1) as rt:
        assert api.wait_on(api.task(flaky, name="flaky")()) == 7
    evs = sorted(rt.tracer.events("task"), key=lambda e: e.meta["attempt"])
    assert [(e.meta["attempt"], e.meta["ok"], e.meta["retried"]) for e in evs] == \
        [(1, False, True), (2, True, False)]
    first, second = evs
    assert first.t_ready <= first.t0 <= first.t_run <= first.t_body <= first.t1
    # requeued after the failed attempt was traced: a ready time of its own
    assert second.t_ready >= first.t1 > first.t_ready
    assert second.t_ready <= second.t0


@pytest.mark.parametrize("name", sorted(FILLS))
def test_a_fill_records_generate_then_upload_inside_its_body(name):
    fn, args = FILLS[name]
    with api.runtime_start(n_workers=2) as rt:
        got = api.wait_on(api.task(fn, name=name)(*args))
    ev, = rt.tracer.events("task")
    want = fn(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    assert [s[0] for s in ev.spans] == FILL_SPANS[name]
    # each span ends before the next starts, all inside the body
    stamps = [ev.t_run, *(t for _, t0, t1 in ev.spans for t in (t0, t1)), ev.t_body]
    assert stamps == sorted(stamps)


@pytest.mark.parametrize("name", sorted(FILLS))
def test_a_fill_records_nothing_with_tracing_off(name):
    fn, args = FILLS[name]
    seen = []

    def body(*a):
        seen.append(getattr(tracing._local, "sink", None))
        return fn(*a)

    with api.runtime_start(n_workers=2, tracing=False) as rt:
        api.wait_on(api.task(body, name=name)(*args))
    assert rt.tracer.events() == []
    assert seen == [None]


def test_the_fit_records_one_solve_span_inside_its_body():
    X, y = linreg.lr_fill_fragment(7, 64, 5, device="cpu")
    with api.runtime_start(n_workers=2) as rt:
        fit = api.task(linreg.compute_model_parameters, name="compute_model_parameters")
        beta = api.wait_on(fit(linreg.partial_ztz((X, y)), linreg.partial_zty((X, y))))
    assert beta.shape == (6,)
    ev, = rt.tracer.events("task")
    assert [s[0] for s in ev.spans] == ["solve"]
    (_, s0, s1), = ev.spans
    assert ev.t_run <= s0 <= s1 <= ev.t_body


def test_a_span_outside_a_runtime_is_a_no_op():
    assert getattr(tracing._local, "sink", None) is None
    with tracing.span("generate") as s:
        pass
    assert s._sink is None
    X = kmeans.fill_fragment(5, 64, 5, device="cpu")
    assert X.shape == (64, 5) and X.dtype == torch.float32
    assert getattr(tracing._local, "sink", None) is None


def test_the_span_sink_is_per_thread():
    sink = []
    tracing.set_span_sink(sink)
    try:
        other = []
        t = threading.Thread(target=lambda: other.append(
            getattr(tracing._local, "sink", None)))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and other == [None]
        with tracing.span("upload"):
            pass
    finally:
        tracing.set_span_sink(None)
    assert [s[0] for s in sink] == ["upload"]


def test_the_ring_is_written_only_when_asked_for():
    with api.runtime_start(n_workers=2) as rt:
        _diamond()
    assert not rt.telemetry.enabled
    assert rt.telemetry.stream.last_seq == 0 and len(rt.telemetry.stream) == 0
    assert len(rt.tracer.events("task")) == 7
    with api.runtime_start(n_workers=2, telemetry=True) as rt:
        _diamond()
    assert rt.telemetry.enabled
    kinds = [e["kind"] for e in rt.telemetry.stream.since(0)]
    assert kinds.count("submit") == 7 and kinds.count("dispatch") == 7
    assert kinds.count("done") == 7


def test_the_chrome_trace_nests_each_attempts_phases_on_its_worker_row():
    fn, args = FILLS["fill_fragment"]
    with api.runtime_start(n_workers=2) as rt:
        fill = api.task(fn, name="fill_fragment")
        api.wait_on([fill(*args), api.task(_add, name="add")(1, 2)])
    evs = {e.name: e for e in rt.tracer.events("task")}
    doc = json.loads(rt.tracer.to_chrome_trace())
    assert doc["metadata"]["perf_counter_origin_s"] == rt.tracer.t_start
    assert doc["metadata"]["clock"] == "time.perf_counter"
    recs = doc["traceEvents"]
    origin = doc["metadata"]["perf_counter_origin_s"]

    def us(t):
        return (t - origin) * 1e6

    for name, e in evs.items():
        row = [r for r in recs if r["ph"] == "X" and r["tid"] == e.worker
               and r["pid"] == e.node]
        task, = [r for r in row if r["name"] == name]
        assert task["args"]["task_id"] == e.task_id
        assert task["ts"] == pytest.approx(us(e.t0), abs=1e-3)
        inside = [r for r in row if r["cat"] in ("phase", "span")
                  and task["ts"] <= r["ts"] <= task["ts"] + task["dur"]]
        want = ["resolve"] + [s[0] for s in e.spans] + ["publish"]
        assert [r["name"] for r in sorted(inside, key=lambda r: r["ts"])] == want
        for r in inside:   # nested: each ends inside the task's event
            assert r["ts"] + r["dur"] <= task["ts"] + task["dur"] + 1e-6
        queued = [r for r in recs if r["name"] == "queued"
                  and r["id"] == f"{e.task_id}.1"]
        assert [r["ph"] for r in queued] == ["b", "e"]
        assert queued[0]["ts"] == pytest.approx(us(e.t_ready), abs=1e-3)
        assert queued[1]["ts"] == pytest.approx(us(e.t0), abs=1e-3)
        assert all(r["tid"] == e.worker and r["pid"] == e.node for r in queued)
    assert [s[0] for s in evs["fill_fragment"].spans] == FILL_SPANS["fill_fragment"]


def test_many_no_op_tasks_keep_every_stamp():
    """A stress of the stamps under contention: more workers than cores,
    a short switch interval, every event still ordered and complete."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with api.runtime_start(n_workers=8) as rt:
            noop = api.task(_add, name="noop")
            roots = api.map_tasks(noop, [(i, 1) for i in range(200)])
            api.wait_on([noop(r, 1) for r in roots])
    finally:
        sys.setswitchinterval(old)
    evs = rt.tracer.events("task")
    assert len(evs) == 400 and len({e.task_id for e in evs}) == 400
    assert all(e.t_ready <= e.t0 <= e.t_run <= e.t_body <= e.t1 for e in evs)
    assert all(e.spans == () for e in evs)
