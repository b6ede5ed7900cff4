"""The port's copy of the task runtime, on its one backend (``thread``).

Mirrors the thread cases of ``tests/test_runtime.py`` and the shape and
bitwise-order cases of ``tests/test_collectives.py`` against
``repro_torch.core``, and checks that what the port does not have yet
(process and cluster backends, their knobs, the dashboard) is refused
rather than silently ignored.
"""
import math
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.algorithms.common import tree_reduce_spec as jax_tree_reduce_spec  # noqa: E402
from repro.core.collectives import reduce_spec as jax_reduce_spec  # noqa: E402
from repro_torch.algorithms.common import tree_reduce as client_tree_reduce  # noqa: E402
from repro_torch.algorithms.common import tree_reduce_spec  # noqa: E402
from repro_torch.core import api, collectives  # noqa: E402
from repro_torch.core.collectives import reduce_spec, spec_depth  # noqa: E402
from repro_torch.core.dag import TaskState  # noqa: E402
from repro_torch.core.futures import TaskFailedError  # noqa: E402


@pytest.fixture()
def rt():
    r = api.runtime_start(n_workers=4, backend="thread")
    yield r
    api.runtime_stop(wait=False)


def _append(path, tag, dep=None):
    with open(path, "a") as f:
        f.write(f"{tag}\n")
    return tag


def add(a, b):
    return a + b


def test_fig2_add_four_numbers(rt):
    """The paper's Fig. 2 program."""
    add_t = api.task(lambda x, y: x + y, name="add")
    r1 = add_t(4, 5)
    r2 = add_t(6, 7)
    r3 = add_t(r1, r2)
    assert api.wait_on(r3) == 22
    assert api.compss_wait_on(add_t(r3, 1)) == 23


def test_dependency_order_is_respected(rt, tmp_path):
    log = str(tmp_path / "order.log")
    t = api.task(_append)
    a = t(log, "a")
    b = t(log, "b", dep=a)
    c = t(log, "c", dep=b)
    api.wait_on(c)
    seen = open(log).read().split()
    assert seen.index("a") < seen.index("b") < seen.index("c")


def test_wide_fanout_barrier(rt):
    t = api.task(lambda i: i * i, name="sq")
    futs = [t(i) for i in range(50)]
    api.barrier()
    assert all(f.done() for f in futs)
    assert api.wait_on(futs) == [i * i for i in range(50)]


def test_map_tasks_fanout(rt):
    t = api.task(lambda i, j: i * j, name="mul")
    futs = api.map_tasks(t, [(i, 2) for i in range(20)])
    assert api.wait_on(futs) == [2 * i for i in range(20)]


def test_nested_future_args(rt):
    t = api.task(lambda xs: sum(xs["vals"]), name="sum")
    mk = api.task(lambda i: i, name="mk")
    futs = {"vals": [mk(i) for i in range(5)]}
    assert api.wait_on(t(futs)) == 10


def _flaky(counter_path, x):
    with open(counter_path, "a") as f:
        f.write("x")
    if os.path.getsize(counter_path) < 3:
        raise ValueError("transient")
    return x


def test_retry_then_success(rt, tmp_path):
    counter = str(tmp_path / "attempts")
    f = api.task(_flaky, max_retries=5)(counter, 42)
    assert api.wait_on(f) == 42
    assert os.path.getsize(counter) == 3


def test_permanent_failure_propagates(rt):
    def boom():
        raise RuntimeError("dead")

    add_t = api.task(lambda x, y: x + y, name="add")
    g = api.task(boom)()
    h = add_t(g, 1)
    i = add_t(h, 1)  # transitive dependent
    with pytest.raises(TaskFailedError):
        api.wait_on(i)
    api.barrier()  # must not hang
    states = {n.name: n.state for n in api.current_runtime().graph.nodes()}
    assert states["boom"] == TaskState.FAILED


def test_exception_type_survives(rt):
    def typed_boom():
        raise KeyError("missing-widget")

    with pytest.raises(TaskFailedError) as exc_info:
        api.wait_on(api.task(typed_boom)())
    assert isinstance(exc_info.value.cause, KeyError)


def test_multiple_returns(rt):
    t = api.task(lambda x: (x + 1, x - 1), returns=2, name="pm")
    hi, lo = t(10)
    assert api.wait_on(hi) == 11 and api.wait_on(lo) == 9


def test_inout_versioning():
    rt = api.runtime_start(n_workers=2)
    try:
        mk = api.task(lambda: np.zeros(3), name="mk")
        buf = mk()
        v1 = buf.version
        rt.submit(lambda x: x + 1, (buf,), name="bump", returns=0, inout=[buf])
        assert buf.version == v1 + 1
        np.testing.assert_array_equal(api.wait_on(buf), np.ones(3))
    finally:
        api.runtime_stop()


def test_tensor_payloads_and_locality_policy():
    api.runtime_start(n_workers=4, workers_per_node=2, policy="locality")
    try:
        gen = api.task(lambda n: torch.arange(n, dtype=torch.float64), name="gen")
        s = api.task(lambda a, b: float(a.sum() + b.sum()), name="s")
        parts = [gen(100) for _ in range(8)]
        outs = [s(parts[i], parts[(i + 1) % 8]) for i in range(8)]
        assert sum(api.wait_on(outs)) == pytest.approx(2 * 8 * (99 * 100 / 2))
        # the store books tensor bytes like ndarray bytes
        assert api.current_runtime().store.nbytes(parts[0].key) == 800
    finally:
        api.runtime_stop()


def test_worksteal_policy_completes():
    api.runtime_start(n_workers=4, policy="worksteal")
    try:
        t = api.task(lambda i: i, name="id")
        assert sorted(api.wait_on([t(i) for i in range(40)])) == list(range(40))
    finally:
        api.runtime_stop()


def test_speculation_duplicates_straggler():
    api.runtime_start(n_workers=4, speculation=True, speculation_factor=2.0)
    try:
        def work(i, delay):
            time.sleep(delay)
            return i

        t = api.task(work, name="work")
        [t(i, 0.02) for i in range(6)]
        straggler = t(99, 1.0)  # way beyond 2x median
        assert api.wait_on(straggler) == 99
        api.barrier()
        assert api.current_runtime().stats()["speculative"] >= 1
    finally:
        api.runtime_stop(wait=False)


def test_dot_export_and_tracer(rt):
    add_t = api.task(lambda x, y: x + y, name="add")
    api.wait_on(add_t(add_t(1, 2), add_t(3, 4)))
    dot = api.current_runtime().graph.to_dot()
    assert "main" in dot and "sync" in dot and dot.count("add") >= 3
    sl = api.task(lambda: time.sleep(0.01), name="sleep")
    for _ in range(8):
        sl()
    api.barrier()
    tr = api.current_runtime().tracer
    assert 0.0 < tr.utilization(4) <= 1.0
    assert "w00" in tr.ascii_gantt(width=40)
    assert tr.to_prv().startswith("#Paraver")


def test_barrier_timeout(rt):
    api.task(lambda: time.sleep(1.0), name="slow", speculatable=False)()
    with pytest.raises(TimeoutError):
        api.barrier(timeout=0.05)


def test_stats_and_context_manager():
    with api.runtime_start(n_workers=2) as rt:
        api.wait_on(api.task(lambda: 1, name="one")())
        stats = rt.stats()
    assert stats["tasks_done"] == 1 and stats["executor"]["backend"] == "thread"
    with pytest.raises(RuntimeError):
        api.current_runtime()


# ------------------------------------------------- what the port lacks yet
@pytest.mark.parametrize("backend", ["process", "cluster"])
def test_other_backends_raise(backend):
    with pytest.raises(ValueError, match="not ported"):
        api.runtime_start(n_workers=2, backend=backend)
    with pytest.raises(RuntimeError):
        api.current_runtime()


@pytest.mark.parametrize("knob,value", [("pipeline_depth", 8), ("n_agents", 2),
                                        ("p2p", False), ("replication", 1)])
def test_later_backend_knobs_raise(knob, value):
    with pytest.raises(ValueError, match=knob):
        api.runtime_start(n_workers=2, **{knob: value})


def test_dashboard_raises():
    with pytest.raises(NotImplementedError):
        api.runtime_start(n_workers=2, dashboard_port=0)


def test_unknown_knob_raises():
    with pytest.raises(TypeError):
        api.runtime_start(n_workers=2, not_a_knob=1)


# ---------------------------------------------------------------- collectives
def test_arity_validation():
    for bad in (1, 0, -3):
        with pytest.raises(ValueError):
            tree_reduce_spec(8, arity=bad)
        with pytest.raises(ValueError):
            client_tree_reduce([1, 2, 3], add, arity=bad)
        with pytest.raises(ValueError):
            reduce_spec(8, arity=bad)
        with pytest.raises(ValueError):
            collectives.tree_reduce([1, 2, 3], add, arity=bad)
    with pytest.raises(ValueError):
        collectives.tree_reduce([], add)


def test_spec_is_balanced_and_equals_the_jax_package():
    for n in range(2, 40):
        for arity in (2, 3, 4, 8):
            spec = tree_reduce_spec(n, arity=arity)
            assert spec == jax_tree_reduce_spec(n, arity=arity)
            assert reduce_spec(n, arity=arity) == jax_reduce_spec(n, arity=arity)
            assert spec_depth(reduce_spec(n, arity=arity), n) == math.ceil(
                math.log(n) / math.log(arity))
    assert spec_depth(tree_reduce_spec(16, arity=4), 16) == 4


def test_live_reduction_isomorphic_to_spec():
    for n in range(1, 18):
        for arity in (2, 3, 4):
            log = []

            def rec(a, b):
                log.append((a, b))
                return len(log) + n - 1

            client_tree_reduce(list(range(n)), rec, arity=arity)
            assert log == [pair for _, pair in tree_reduce_spec(n, arity)]


def test_collective_matches_client_fold_bitwise(rt):
    merge_t = api.task(add, name="merge")
    for n in (1, 2, 5, 8, 13):
        leaves = [torch.from_numpy(np.random.default_rng(i).standard_normal(257))
                  for i in range(n)]
        for arity in (2, 3, 4, 8):
            expect = client_tree_reduce(leaves, add, arity=arity)
            got = api.wait_on(collectives.tree_reduce(list(leaves), merge_t, arity=arity))
            assert torch.equal(got, expect)


def test_collective_accepts_future_leaves(rt):
    gen_t = api.task(lambda i: torch.full((16,), float(i)), name="gen")
    merge_t = api.task(add, name="merge")
    leaves = api.map_tasks(gen_t, [(i,) for i in range(7)])
    got = api.wait_on(collectives.tree_reduce(leaves, merge_t, arity=3))
    assert torch.equal(got, torch.full((16,), 21.0))
