"""The port's copy of the task runtime, on its thread backend.

Mirrors the thread cases of ``tests/test_runtime.py`` and the shape and
bitwise-order cases of ``tests/test_collectives.py`` against
``repro_torch.core``, and checks that every cluster knob is accepted on
``backend="cluster"`` and shows in ``stats()``.  The process backend is
tested in ``test_torch_process.py``, the cluster backend in
``test_torch_cluster*.py``, the dashboard in ``test_torch_dashboard.py``.
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


# ------------------------------------------------------ the cluster's knobs
BIG = 4096   # float64 elements: 32 KiB, above the inline threshold (8 KiB)


def _settled(read, want, timeout=30.0):
    deadline = time.monotonic() + timeout
    while read() != want and time.monotonic() < deadline:
        time.sleep(0.05)
    return read()


@pytest.mark.parametrize("knob,value", [("control_plane", "threads"),
                                        ("control_plane", "async"), ("n_agents", 1),
                                        ("p2p", False), ("replication", 1)])
def test_cluster_knobs_take_effect(knob, value):
    """Each knob only the cluster backend reads is accepted there and
    shows in ``stats()``.  The task body is ``np.ones`` (pickled by
    reference), so the agents never import this module, which loads JAX."""
    opts = {"n_agents": 2, "workers_per_node": 1, knob: value}
    with api.runtime_start(backend="cluster", **opts) as rt:
        ones = api.task(np.ones, name="ones")(BIG)
        assert api.wait_on(ones).tobytes() == np.ones(BIG).tobytes()
        st = rt.stats()["executor"]
        assert st["backend"] == "cluster"
        if knob == "n_agents":
            assert st["n_agents"] == value and rt.n_workers == value
        elif knob == "control_plane":
            assert st["control_plane"] == value
        elif knob == "p2p":
            # every result relayed through the scheduler, none node-resident
            assert st["p2p"] is False and st["remote_results"] == 0
            assert st["relay_result_bytes"] >= BIG * 8
        else:
            # the node-resident result is pushed to the other agent
            assert st["remote_results"] == 1
            assert _settled(lambda: rt.executor.stats()["replica_bytes"], BIG * 8) == BIG * 8


def test_process_knobs_are_accepted_on_the_thread_backend():
    # pipeline_depth and mp_context configure the process backend; the
    # thread backend reads neither, and neither is refused
    with api.runtime_start(n_workers=2, pipeline_depth=8, mp_context="spawn") as rt:
        assert rt.pipeline_depth == 8
        assert api.wait_on(api.task(lambda: 3, name="three")()) == 3


def test_dashboard_from_the_environment(monkeypatch):
    import json
    import urllib.error
    import urllib.request
    monkeypatch.setenv("RJAX_DASHBOARD", "0")
    with api.runtime_start(n_workers=1) as rt:
        assert rt.dashboard is not None and rt.telemetry.enabled
        with urllib.request.urlopen(rt.dashboard.url + "api/status", timeout=10) as resp:
            assert json.loads(resp.read())["n_workers"] == 1
        url = rt.dashboard.url
    with pytest.raises(urllib.error.URLError):   # closed with the runtime
        urllib.request.urlopen(url + "api/status", timeout=2)


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


# ------------------------------------------- collectives against the reference
def _np_rows(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d))


def _by_thirds(block, n_out):
    return [block[i::n_out] for i in range(n_out)]


def _add_rows(a, b):
    return a + b


def _scaled_total(shared, block):
    return float((shared * 0.5).sum() + block.sum())


def _collective_program(api_mod, coll_mod, n_out, combine):
    """shuffle (plain values and Futures mixed) and broadcast, read back."""
    gen = api_mod.task(_np_rows, name="rows")
    frags = [gen(0, 64, 8), _np_rows(1, 64, 8), gen(2, 64, 8)]
    merge = None if combine is None else api_mod.task(combine, name="combine")
    parts = api_mod.wait_on(coll_mod.shuffle(frags, _by_thirds, n_out, combine=merge))
    shared = coll_mod.broadcast(np.arange(6000, dtype=np.float32))
    total = api_mod.wait_on(api_mod.task(_scaled_total, name="use")(shared, frags[0]))
    return parts, total, api_mod.wait_on(shared)


@pytest.mark.parametrize("n_out", [1, 2, 3])
@pytest.mark.parametrize("combine", [None, _add_rows], ids=["concat", "combine"])
def test_shuffle_and_broadcast_equal_the_reference_bitwise(n_out, combine):
    """The same NumPy fragments through the port's and the JAX package's
    ``shuffle`` and ``broadcast``: the same pieces in the same order,
    byte for byte."""
    from repro.core import api as japi
    from repro.core import collectives as jcoll
    with japi.runtime_start(n_workers=3, backend="thread"):
        want = _collective_program(japi, jcoll, n_out, combine)
    with api.runtime_start(n_workers=3, backend="thread"):
        got = _collective_program(api, collectives, n_out, combine)
    assert len(got[0]) == len(want[0]) == n_out
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    assert got[1] == want[1]
    assert got[2].tobytes() == want[2].tobytes()


def _json_shape(obj):
    """Keys and value types of a JSON document, lists by their first item."""
    if isinstance(obj, dict):
        return {k: _json_shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_json_shape(obj[0])] if obj else []
    return type(obj).__name__


def _dashboard_views(api_mod):
    import json
    import urllib.request

    def _gen(seed, n):
        return np.random.default_rng(seed).standard_normal(n)

    rt = api_mod.runtime_start(n_workers=2, backend="thread", dashboard_port=0)
    try:
        gen, tot = api_mod.task(_gen, name="gen"), api_mod.task(_add_rows, name="tot")
        frags = [gen(i, 4096) for i in range(6)]
        api_mod.wait_on([tot(frags[i], frags[(i + 1) % 6]) for i in range(6)])
        deadline = time.time() + 10    # the sampler's first beat fills /api/status
        while time.time() < deadline and not rt.telemetry.nodes():
            time.sleep(0.05)
        out = {}
        for path in ("", "api/status", "api/tasks?since=0", "api/transfers"):
            with urllib.request.urlopen(rt.dashboard.url + path, timeout=10) as resp:
                body = resp.read()
            out[path] = body if path == "" else _json_shape(json.loads(body))
        return out
    finally:
        api_mod.runtime_stop()


def test_dashboard_page_and_views_equal_the_reference():
    """The same task program under the port's and the JAX package's
    runtime: the same page, byte for byte, and the same keys (with the
    same value types) in ``/api/status``, ``/api/tasks`` and
    ``/api/transfers``."""
    from repro.core import api as japi
    want = _dashboard_views(japi)
    got = _dashboard_views(api)
    assert got[""] == want[""]
    for path in ("api/status", "api/tasks?since=0", "api/transfers"):
        assert got[path] == want[path], path
    assert got["api/tasks?since=0"]["events"], "no task event was served"


# ------------------------------------------------------------ serialization
@pytest.mark.parametrize("arr", [np.arange(12, dtype=np.float32).reshape(3, 4),
                                 np.array(7, dtype=np.int64), np.ones((0, 5), np.float64),
                                 np.arange(10, dtype=np.int16)[::2]],
                         ids=["matrix", "0d", "empty", "strided"])
def test_raw_codec_equals_the_reference(arr):
    """The raw codec lays out the process backend's segments: its blob is
    the JAX package's, byte for byte, and decodes to the same array."""
    from repro.core import serialization as jser
    from repro_torch.core import serialization as ser
    blob = ser.serialize(arr)
    assert blob == jser.serialize(arr, "raw")
    back = ser.deserialize(blob)
    assert back.dtype == arr.dtype and back.shape == arr.shape
    assert np.array_equal(back, arr)
    assert ser.deserialize(ser.serialize({"not": "an array"})) == {"not": "an array"}
