"""The port's cluster backend: real TCP node agents on localhost, each with
a spawned worker pool (``repro_torch.cluster``, ``ClusterExecutor``).

Mirrors the tier-1 cases of ``tests/test_cluster.py`` and
``tests/test_p2p.py`` against ``repro_torch``.  One module-scoped cluster
of two agents x two workers serves most tests (each agent and each of its
workers imports torch, which takes seconds); the cases that need another
configuration (the relay kill switches) run first, each on its own
cluster, because the API runs one runtime at a time.  The thread- and
process-backend results the cluster is held against are computed first,
in a module-scoped fixture.  Every comparison is bitwise.  The task
bodies live here, and the file imports nothing of the JAX package: the
agents and their pools import it by name to find them.
"""
import hashlib
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.algorithms import kmeans, knn, linreg  # noqa: E402
from repro_torch.core import api, collectives  # noqa: E402
from repro_torch.core.futures import RemoteValue, TaskFailedError  # noqa: E402

CPU = "cpu"
KNN = dict(n_train=2400, n_test=600, d=12, k=5, n_classes=4, train_fragments=4,
           test_blocks=2)
KMEANS = dict(n_points=24_000, d=8, k=5, fragments=4, max_iters=4, tol=0.0)
LINREG = dict(n_rows=6000, p=12, n_pred=900, fragments=4, pred_blocks=2)
BIG = 4096    # float64 elements = 32 KiB, above the inline threshold (8 KiB)
SMALL = 64    # 512 B, below it


# ------------------------------------------------------------- task bodies
def gen_big(n):
    return np.arange(n, dtype=np.float64)


def gen_small(n):
    return np.ones(n, dtype=np.float64)


def consume(a):
    return float(a.sum())


def consume_slowly(a):
    """A consumer that holds its worker long enough for sixteen of them
    to fill every worker's credits before any completes."""
    time.sleep(0.3)
    return float(a.sum())


def gen_pair(n):
    return np.arange(n, dtype=np.float64), np.ones(n)


def use_pair(p):
    time.sleep(0.3)
    x, y = p
    return float(x.sum() + y.sum())


def boom(x):
    raise ValueError(f"bad value {x}")


def _pipelines():
    return {"knn": knn.run_knn(**KNN, device=CPU).predictions,
            "kmeans": kmeans.run_kmeans(**KMEANS, device=CPU),
            "linreg": linreg.run_linreg(**LINREG, device=CPU)}


def _rows(seed, n, d):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, d)))


def _by_parity(block, n_out):
    return [block[i::n_out] for i in range(n_out)]


def _collectives():
    blocks = [api.task(_rows, name="rows")(s, 64, 8) for s in range(3)]
    parts = api.wait_on(collectives.shuffle(blocks, _by_parity, 2))
    shared = collectives.broadcast(torch.arange(6000, dtype=torch.float32))
    total = api.wait_on(api.task(lambda v, b: (v * 2).sum() + b.sum(), name="use")(
        shared, blocks[0]))
    return parts, total


DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.int32, torch.int64, torch.bool)


def _tensors(seed):
    """Every dtype the port moves, above the inline threshold (node-resident,
    pulled peer to peer) and below it (inline in the reply), plus a
    strided view and an empty tensor."""
    g = torch.Generator().manual_seed(seed)
    big = torch.randn(64, 128, generator=g) * 100
    out = {}
    for dt in DTYPES:
        name = str(dt).split(".")[1]
        t = big > 0 if dt is torch.bool else big.to(dt)
        out[name] = t
        out[f"small_{name}"] = t[:2, :8]
    out["strided"] = big.t()
    out["empty"] = torch.empty(0, 3, dtype=torch.bfloat16)
    return out


def _bytes(v):
    return v.contiguous().view(torch.uint8).numpy().tobytes()


def _describe(values):
    return {k: (str(v.dtype), v.device.type, tuple(v.shape),
                hashlib.sha1(_bytes(v)).hexdigest()) for k, v in values.items()}


@pytest.fixture(scope="module")
def reference_results():
    with api.runtime_start(n_workers=2, backend="thread"):
        thread = {**_pipelines(), "collectives": _collectives()}
    with api.runtime_start(n_workers=2, backend="process"):
        process = _pipelines()
    return {"thread": thread, "process": process}


# ------------------------------------------- other configurations, first
def test_p2p_kill_switch_restores_relay(monkeypatch):
    monkeypatch.setenv("RJAX_P2P", "0")
    with api.runtime_start(backend="cluster", n_agents=2, workers_per_node=1) as rt:
        part = api.task(gen_big, name="gen")(BIG)
        api.barrier()
        assert isinstance(rt.store.get_nowait(part.key, materialize=False), np.ndarray)
        assert rt.executor.relay_result_bytes == BIG * 8
        assert rt.executor.remote_results == 0
        # a small result is relayed as before
        small = api.task(gen_small, name="gen_small")(SMALL)
        assert api.wait_on(small).tobytes() == gen_small(SMALL).tobytes()
        assert rt.executor.remote_results == 0


def test_inline_max_zero_defers_everything(monkeypatch):
    monkeypatch.setenv("RJAX_INLINE_MAX", "0")
    with api.runtime_start(backend="cluster", n_agents=2, workers_per_node=1) as rt:
        part = api.task(gen_small, name="gen_small")(SMALL)
        api.barrier()
        assert isinstance(rt.store.get_nowait(part.key, materialize=False), RemoteValue)
        assert api.wait_on(part).tobytes() == gen_small(SMALL).tobytes()
        tiny = api.task(torch.ones, name="ones")(3)
        api.barrier()
        assert isinstance(rt.store.get_nowait(tiny.key, materialize=False), RemoteValue)
        assert torch.equal(api.wait_on(tiny), torch.ones(3))


# ------------------------------------------------------ the shared cluster
@pytest.fixture(scope="module")
def crt(reference_results):
    r = api.runtime_start(backend="cluster", n_agents=2, workers_per_node=2)
    yield r
    api.runtime_stop(wait=False)


def test_cluster_geometry_and_locality_domains(crt):
    assert crt.n_workers == 4 and crt.workers_per_node == 2
    s = crt.stats()["executor"]
    assert s["backend"] == "cluster" and s["control_plane"] == "async"
    assert s["n_agents"] == 2 and s["workers_per_node"] == 2
    # 2 workers per agent: workers 0,1 on node 0 and 2,3 on node 1
    assert [crt.locality_domain(w) for w in range(4)] == [0, 0, 1, 1]


def test_quickstart_dag(crt):
    """The paper's Fig. 2 program against real TCP agents."""
    add = api.task(lambda x, y: x + y, name="add")
    assert api.wait_on(add(add(4, 5), add(6, 7))) == 22


def test_send_once_reuse_many(crt):
    """A keyed input is shipped to a given node at most once, no matter
    how many tasks there read it."""
    ex = crt.executor
    part = api.task(gen_small, name="gen_small")(SMALL)   # inline: scheduler-held
    api.wait_on(part)
    puts0, refs0 = ex.puts, ex.refs
    outs = [api.task(consume, name="consume")(part) for _ in range(10)]
    assert api.wait_on(outs) == [float(SMALL)] * 10
    new_puts = ex.puts - puts0
    # the producing node got it via alias (no wire crossing); the other
    # node needed one Put or one peer pull — never more
    assert new_puts <= 1
    assert ex.refs - refs0 >= 10 - 2


def test_remote_exception_propagates_with_type(crt):
    f = api.task(boom, name="boom")(7)
    with pytest.raises(TaskFailedError) as exc_info:
        api.wait_on(f)
    assert isinstance(exc_info.value.cause, ValueError)
    assert "bad value 7" in str(exc_info.value.cause)


def test_closures_cross_the_wire(crt):
    offset = 29
    t = api.task(lambda x: x + offset, name="closured")
    assert api.wait_on(t(13)) == 42


def test_agent_stats_rpc(crt):
    stats = crt.executor.agent_stats()
    assert len(stats) == 2 and all(s is not None for s in stats)
    for s in stats:
        assert s["backend"] == "process" and s["start_method"] == "spawn"
        assert "plane_entries" in s and "node_id" in s
        assert len(s["worker_pids"]) == 2
        assert "kernel_launches" in s and "card_bytes_by_pid" in s
        # the agent holds host bytes only: it never made a CUDA context
        assert s["cuda_initialized"] is False


def test_results_stay_node_resident_and_gather_materializes(crt):
    ex = crt.executor
    relay0, deferred0 = ex.relay_result_bytes, ex.deferred_result_bytes
    part = api.task(gen_big, name="gen")(BIG)
    api.barrier()
    rv = crt.store.get_nowait(part.key, materialize=False)
    assert isinstance(rv, RemoteValue) and rv.nbytes == BIG * 8
    assert rv.addr is not None and rv.node in crt.store.locations(part.key)
    # nothing crossed the scheduler link for this result
    assert ex.relay_result_bytes == relay0
    assert ex.deferred_result_bytes - deferred0 == BIG * 8
    assert api.wait_on(part).tobytes() == gen_big(BIG).tobytes()
    assert isinstance(crt.store.get_nowait(part.key, materialize=False), np.ndarray)


def test_small_results_ride_the_reply_inline(crt):
    remote0 = crt.executor.remote_results
    part = api.task(gen_small, name="gen_small")(SMALL)
    api.barrier()
    assert isinstance(crt.store.get_nowait(part.key, materialize=False), np.ndarray)
    assert crt.executor.remote_results == remote0
    assert api.wait_on(part).tobytes() == gen_small(SMALL).tobytes()


def test_cross_node_consumers_pull_peer_to_peer(crt):
    ex = crt.executor
    fetches0, fetch_bytes0, relay0 = ex.fetches, ex.fetch_bytes, ex.relay_result_bytes
    p2p0 = crt.stats()["p2p_bytes"]
    part = api.task(gen_big, name="gen")(BIG)
    api.barrier()
    outs = [api.task(consume_slowly, name="consume")(part) for _ in range(16)]
    assert api.wait_on(outs) == [float(np.arange(BIG).sum())] * 16
    # sixteen ready consumers fill all four workers' credits (depth 4):
    # both nodes ran some, and the non-producing node pulled the datum
    # exactly once, from its home
    assert ex.fetches - fetches0 == 1 and ex.fetch_bytes - fetch_bytes0 == BIG * 8
    assert crt.stats()["p2p_bytes"] - p2p0 == BIG * 8
    assert ex.relay_result_bytes == relay0


def test_tuple_datum_is_cached_at_datum_level(crt):
    ex = crt.executor
    fetches0, puts0, refs0 = ex.fetches, ex.puts, ex.refs
    pair = api.task(gen_pair, name="gen_pair")(BIG)
    api.barrier()
    assert isinstance(crt.store.get_nowait(pair.key, materialize=False), RemoteValue)
    outs = [api.task(use_pair, name="use_pair")(pair) for _ in range(16)]
    assert api.wait_on(outs) == [float(np.arange(BIG).sum() + BIG)] * 16
    # one peer pull for the non-producing node, refs ever after
    assert ex.fetches - fetches0 == 1 and ex.puts == puts0
    assert ex.refs - refs0 >= 14


@pytest.mark.parametrize("name", ["knn", "kmeans", "linreg"])
def test_pipelines_are_bitwise_equal_to_the_thread_and_process_backends(
        crt, reference_results, name):
    got = _pipelines()[name]
    for backend in ("thread", "process"):
        want = reference_results[backend][name]
        if name == "knn":
            assert got.tobytes() == want.tobytes(), backend
        elif name == "kmeans":
            assert got.centroids.tobytes() == want.centroids.tobytes(), backend
            assert got.sse_history == want.sse_history and got.shifts == want.shifts
        else:
            assert got.beta.tobytes() == want.beta.tobytes(), backend
            assert got.predictions.tobytes() == want.predictions.tobytes(), backend
    assert crt.stats()["executor"]["remote_results"] > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_tensors_cross_with_their_dtype_and_device(crt, seed):
    made = api.task(_tensors, name="tensors")(seed)
    api.barrier()
    # a dict of tensors above the threshold is one node-resident datum
    assert isinstance(crt.store.get_nowait(made.key, materialize=False), RemoteValue)
    # read on both nodes (sixteen readers fill every worker's credits):
    # pulled peer to peer by the other node
    described = [api.task(_describe, name="describe")(made) for _ in range(16)]
    got = api.wait_on(made)
    want = _tensors(seed)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].device == v.device, k
        assert tuple(got[k].shape) == tuple(v.shape) and _bytes(got[k]) == _bytes(v), k
    assert api.wait_on(described) == [_describe(want)] * 16


def test_broadcast_and_shuffle_equal_their_thread_results(crt, reference_results):
    bcasts0 = crt.executor.broadcasts
    parts, total = _collectives()
    want_parts, want_total = reference_results["thread"]["collectives"]
    assert len(parts) == 2
    for got, want in zip(parts, want_parts):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(total, want_total)
    assert crt.executor.broadcasts == bcasts0 + 1


def test_stop_leaves_no_agent_and_no_segment(crt):
    """Last in the module: stop the cluster and check that no agent
    process is left and no segment an agent's pool plane reported is left
    in /dev/shm."""
    names = set()
    for s in crt.executor.agent_stats():
        names.update(s["segment_names"])
    assert names, "the agents' planes held no segment"
    pids = [p.pid for p in crt.cluster._procs]
    api.runtime_stop()
    for pid in pids:
        assert not os.path.exists(f"/proc/{pid}") or \
            open(f"/proc/{pid}/stat").read().split()[2] == "Z", pid
    deadline = time.monotonic() + 10
    left = names
    while left and time.monotonic() < deadline:
        left = {n for n in names if os.path.exists(os.path.join("/dev/shm", n))}
        time.sleep(0.05)
    assert not left, f"segments left behind: {sorted(left)}"
