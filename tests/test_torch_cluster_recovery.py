"""The port's cluster backend under failure: crash containment, agent
respawn, lineage re-execution of lost node-resident results, liveness,
session resumption and replicas (DESIGN.md §15, §19, §20).

Mirrors the crash cases of ``tests/test_cluster.py`` and
``tests/test_p2p.py``, and ``tests/test_recovery.py`` and
``tests/test_liveness.py``, against ``repro_torch``.  The reference's
tier-1 cases run in tier-1 here; its ``chaos`` cases (SIGSTOP liveness,
resumption, replicas) keep the ``chaos`` marker.  One module-scoped
cluster of two agents x two workers (heartbeats every 0.2 s, telemetry
on, a 1 s resumption grace window) serves the liveness views first and
the crash cases after them; a
second one, with liveness and resumption off, serves the default-path
cases.  Every recovered value is held bitwise against the body run
directly.  The task bodies live here, and the file imports nothing of
the JAX package: the agents and their pools import it by name.
"""
import os
import signal
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.cluster.agent import NodePlane  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core.dag import TaskGraph, TaskNode, TaskState  # noqa: E402
from repro_torch.core.executors import WorkerCrashedError  # noqa: E402
from repro_torch.core.futures import RemoteValue, TaskFailedError  # noqa: E402
from repro_torch.core.telemetry import EXECUTOR_STAT_KEYS, normalize_executor_stats  # noqa: E402

BIG = 4096   # float64 elements = 32 KiB, above the inline threshold


# ------------------------------------------------------------- task bodies
def gen_big(n):
    return np.arange(n, dtype=np.float64)


def gen_card(n):
    """A bf16 tensor result (node-resident): lineage must rebuild its bytes."""
    return torch.sin(torch.arange(n, dtype=torch.float32) * 0.001).to(torch.bfloat16)


def consume(a):
    if isinstance(a, torch.Tensor):
        return float(a.float().sum())
    return float(a.sum())


def work(i: int) -> float:
    """Deterministic, small-result body (inline replies: no peer pull can
    block on a frozen node's data plane)."""
    time.sleep(0.1)
    a = np.arange(200, dtype=np.float64) * (i + 1)
    return float(np.sqrt(a).sum())


def expected(i: int) -> float:
    a = np.arange(200, dtype=np.float64) * (i + 1)
    return float(np.sqrt(a).sum())


def crash_once(path):
    if not os.path.exists(path):
        with open(path, "w") as fh:
            fh.write("x")
        os._exit(11)   # the pool worker dies; its agent lives
    return "recovered"


def kill_my_agent_once(path):
    if not os.path.exists(path):
        with open(path, "w") as fh:
            fh.write("x")
        os.kill(os.getppid(), signal.SIGKILL)   # the agent process
    return "recovered"


def kill_my_agent():
    os.kill(os.getppid(), signal.SIGKILL)


def produce(i: int):
    return np.sin(np.arange(4000, dtype=np.float64) * 0.001 * (i + 1))


def slow_produce(i: int):
    time.sleep(0.25)
    return np.cos(np.arange(20000, dtype=np.float64) * 0.0005 * (i + 1))


def produce_small(i: int):
    """Below the inline threshold: the result rides the reply inline and
    lives scheduler-side, so consuming it ships a keyed ``Put``."""
    return np.arange(500, dtype=np.float64) * (i + 1)


def root_abs(a):
    return float(np.sqrt(np.abs(a)).sum())


def tiny(i: int) -> int:
    return i * 2


def sever(rt, a: int):
    """Break agent ``a``'s control connection without touching the
    process: both read loops observe EOF, as after a transient partition."""
    ch = rt.executor._channels[a]
    assert ch is not None and not ch.closed
    ch.sock.shutdown(socket.SHUT_RDWR)
    return ch


def _settle(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.05)
    return cond()


# --------------------------------------------------------------- no cluster
def test_node_plane_generations_and_manifest():
    """Every residency mark bumps the key's generation exactly once, and
    the manifest reports (key, generation, nbytes) for resident data
    only — tensors and card results by their host bytes."""
    plane = NodePlane()
    k1, k2, k3 = (1, 0), (2, 0), (3, 0)
    assert plane.note_mark(k1) == 1
    assert plane.note_mark(k1) == 2
    assert plane.note_mark(k2) == 1
    a = np.arange(16, dtype=np.float64)
    t = torch.arange(12, dtype=torch.bfloat16)
    plane.store(k1, a)
    plane.store(k3, t)
    m = {tuple(key): (gen, nb) for key, gen, nb in plane.manifest()}
    # k2 was marked but its bytes never landed: not in the manifest
    assert set(m) == {k1, k3}
    assert m[k1] == (2, a.nbytes) and m[k3] == (0, 24)
    # a pending peer fetch is not manifest-resident either
    assert plane.begin_fetch(k2)
    assert {tuple(key) for key, _, _ in plane.manifest()} == {k1, k3}


def test_resurrect_rearms_edges_to_pending_children():
    """Resurrecting a DONE parent re-arms its released edges to
    still-PENDING children, or its second completion would release them
    while other parents are still running."""
    g = TaskGraph()

    def node(name, deps=(), out=()):
        return TaskNode(task_id=g.next_task_id(), name=name, fn=None, args=(),
                        kwargs={}, dep_keys=set(deps), out_keys=list(out))

    a = node("A", out=[(1, 1)])
    b = node("B", out=[(2, 1)])
    g.add_task(a)
    g.add_task(b)
    g.claim_running(a.task_id, 0, 0)
    g.claim_running(b.task_id, 1, 1)
    c = node("C", deps=[(1, 1), (2, 1)], out=[(3, 1)])
    g.add_task(c)
    assert c.unresolved == 2
    g.mark_done(a.task_id)
    assert c.unresolved == 1
    assert g.producer_of((1, 1)) == a.task_id
    assert g.resurrect(a.task_id)       # A's output was lost: re-run it
    assert c.unresolved == 2            # edge re-armed
    assert not g.resurrect(a.task_id)   # already READY: nothing to do
    g.claim_running(a.task_id, 0, 0)
    assert g.mark_done(a.task_id) == []  # B still running: C stays PENDING
    assert c.state == TaskState.PENDING
    assert g.mark_done(b.task_id) == [c.task_id]
    assert c.state == TaskState.READY


def test_recovery_counters_in_executor_stats_schema():
    """The recovery counters ride ``EXECUTOR_STAT_KEYS``: the cluster
    reports them live, thread and process read 0 through normalization."""
    for key in ("reconnects", "replica_bytes", "replica_hits", "agent_restarts",
                "liveness_kills"):
        assert key in EXECUTOR_STAT_KEYS
    norm = normalize_executor_stats({"backend": "thread"})
    assert norm["reconnects"] == 0
    assert norm["replica_bytes"] == 0 and norm["replica_hits"] == 0


# ------------------------------------------- liveness and resumption off
@pytest.fixture(scope="module")
def quiet():
    r = api.runtime_start(backend="cluster", n_agents=2, workers_per_node=1,
                          liveness=False, reconnect_grace_s=0)
    yield r
    api.runtime_stop(wait=False)


def test_default_path_resumption_disabled(quiet):
    """``reconnect_grace_s=0``: the executor never arms resumption and the
    recovery counters stay at zero."""
    assert not quiet.executor.resumption
    t = api.task(tiny, name="tiny")
    assert api.wait_on(t.map([(i,) for i in range(8)]), timeout=60) == \
        [i * 2 for i in range(8)]
    s = quiet.executor.stats()
    assert s["reconnects"] == 0
    assert s["replica_bytes"] == 0 and s["replica_hits"] == 0


def test_liveness_disabled_runs_clean(quiet):
    """``liveness=False``: no detector thread, no kills, everything works."""
    assert quiet.executor._liveness_thread is None
    assert api.wait_on(api.task(lambda x: x * 3, name="tri")(5), timeout=60) == 15
    assert quiet.executor.liveness_kills == 0
    api.runtime_stop()


# --------------------------------------------------- the shared cluster
@pytest.fixture(scope="module")
def crt():
    # a SIGKILLed agent is first parked for the resumption grace window
    # (it cannot re-dial); 1 s instead of the default 5 s keeps each kill
    # case short
    r = api.runtime_start(backend="cluster", n_agents=2, workers_per_node=2,
                          heartbeat_s=0.2, telemetry=True, reconnect_grace_s=1.0)
    yield r
    api.runtime_stop(wait=False)


def test_no_false_kills_with_default_settings(crt):
    """Default liveness settings on a healthy cluster: zero kills, zero
    restarts."""
    out = api.wait_on(api.task(work, name="work").map([(i,) for i in range(12)]),
                      timeout=60)
    assert out == [expected(i) for i in range(12)]
    assert crt.executor.liveness_kills == 0 and crt.executor.agent_restarts == 0
    assert {v["state"] for v in crt.executor.liveness().values()} == {"alive"}


def test_liveness_surfaces_in_api_status(crt):
    """``/api/status`` node entries carry the detector's verdict and the
    beat age it is based on, and each beat carries the agent's counters."""
    def ready():
        nodes = crt.telemetry.snapshot_status(crt).get("nodes", {})
        return {"0", "1"} <= set(nodes) and all("state" in n for n in nodes.values())

    assert _settle(ready, 10.0)
    nodes = crt.telemetry.snapshot_status(crt)["nodes"]
    for n in (nodes["0"], nodes["1"]):
        assert n["state"] == "alive"
        assert n["beat_age_s"] is not None and n["beat_age_s"] < 5.0


def test_inner_pool_worker_crash_is_contained_and_retryable(crt, tmp_path):
    """A pool-worker death inside an agent respawns inside the agent and
    surfaces as a retryable WorkerCrashedError; the agent lives on."""
    restarts = crt.executor.agent_restarts
    f = api.task(crash_once, name="crash_once", max_retries=3)(str(tmp_path / "crash"))
    assert api.wait_on(f, timeout=60) == "recovered"
    assert crt.executor.agent_restarts == restarts
    stats = [s for s in crt.executor.agent_stats() if s]
    assert sum(s["worker_restarts"] for s in stats) == 1


def test_agent_crash_respawns_and_retries(crt, tmp_path):
    """Killing a whole node agent mid-task surfaces as a retryable
    WorkerCrashedError; the executor respawns the agent and the retry
    re-ships whatever the replacement needs."""
    restarts = crt.executor.agent_restarts
    f = api.task(kill_my_agent_once, max_retries=4)(str(tmp_path / "agent"))
    assert api.wait_on(f, timeout=90) == "recovered"
    # the respawn runs on the recovery pool concurrently with the retry
    assert _settle(lambda: crt.executor.agent_restarts >= restarts + 1)
    assert crt.stats()["retries"] >= 1


def test_agent_crash_without_retries_is_worker_crashed(crt):
    restarts = crt.executor.agent_restarts
    f = api.task(kill_my_agent, name="die", max_retries=0)()
    with pytest.raises(TaskFailedError) as exc_info:
        api.wait_on(f, timeout=90)
    assert isinstance(exc_info.value.cause, WorkerCrashedError)
    assert _settle(lambda: crt.executor.agent_restarts >= restarts + 1)


@pytest.mark.parametrize("gen,n", [(gen_big, BIG), (gen_card, 20_000)])
def test_producer_crash_before_fetch_reexecutes_from_lineage(crt, gen, n):
    """SIGKILL the producing agent while a consumer holds an unfetched
    RemoteValue: the producer re-executes from graph lineage, the consumer
    completes, and the recomputed datum is bitwise the body's own."""
    expect = gen(n)
    ex = crt.executor
    restarts = ex.agent_restarts
    part = api.task(gen, name=gen.__name__)(n)
    api.barrier()
    rv = crt.store.get_nowait(part.key, materialize=False)
    assert isinstance(rv, RemoteValue)
    os.kill(crt.cluster._procs[rv.node].pid, signal.SIGKILL)
    cons = api.task(consume, name="consume", max_retries=4)(part)
    assert api.wait_on(cons, timeout=90) == consume(expect)
    assert _settle(lambda: ex.agent_restarts >= restarts + 1)
    got = api.wait_on(part, timeout=90)
    if isinstance(expect, torch.Tensor):
        assert got.dtype == expect.dtype and torch.equal(got, expect)
    else:
        assert got.tobytes() == expect.tobytes()
    assert crt.store.locations(part.key), "recomputed datum has no recorded residency"


def test_producer_crash_recovers_under_default_retries(crt):
    """With the default max_retries=0 a consumer whose INPUT vanished with
    a dead node still recovers: lost-input failures get their own bounded
    retry allowance."""
    part = api.task(gen_big, name="gen")(BIG)
    api.barrier()
    rv = crt.store.get_nowait(part.key, materialize=False)
    assert isinstance(rv, RemoteValue)
    restarts = crt.executor.agent_restarts
    os.kill(crt.cluster._procs[rv.node].pid, signal.SIGKILL)
    # let the on_close recovery replace the agent first: a submit racing
    # the undetected-dead channel fails as a plain WorkerCrashedError
    assert _settle(lambda: crt.executor.agent_restarts > restarts)
    cons = api.task(consume, name="consume")(part)   # no max_retries
    assert api.wait_on(cons, timeout=90) == float(np.arange(BIG).sum())


def test_no_agent_is_left_after_stop(crt):
    """Last of the shared cluster: every agent process, respawned ones
    too, is gone after ``runtime_stop``."""
    procs = [p for p in crt.cluster._procs if p is not None]
    api.runtime_stop()
    assert all(p.poll() is not None for p in procs)


# ------------------------------------------------------------------ chaos
@pytest.mark.chaos
def test_sigstop_agent_detected_and_job_completes_bitwise():
    """SIGSTOP an agent mid-run: no TCP disconnect ever happens, yet the
    failure detector declares it dead, the channel close drives the
    respawn path, and every result is bitwise the reference."""
    n_tasks = 60
    with api.runtime_start(backend="cluster", n_agents=2, workers_per_node=2,
                           heartbeat_s=0.2, suspicion_s=0.6, max_retries=4) as rt:
        futures = api.task(work, name="work", max_retries=4).map(
            [(i,) for i in range(n_tasks)])
        time.sleep(0.5)
        victim = rt.executor.cluster._procs[1]
        assert victim is not None and victim.poll() is None
        os.kill(victim.pid, signal.SIGSTOP)
        results = api.wait_on(futures, timeout=120)
        assert rt.executor.liveness_kills >= 1
        assert _settle(lambda: rt.executor.agent_restarts >= 1)
    assert results == [expected(i) for i in range(n_tasks)]


@pytest.mark.chaos
def test_reconnect_mid_pipeline_zero_reexecution_bitwise():
    """Sever agent 1's control socket mid-pipeline: the session resumes
    inside the grace window, no respawn, no re-execution, every result
    bitwise the reference."""
    n = 24
    with api.runtime_start(backend="cluster", n_agents=2, workers_per_node=2,
                           reconnect_grace_s=5.0, max_retries=2) as rt:
        prod = api.task(produce, name="produce")
        cons = api.task(root_abs, name="root_abs")
        futs = [cons(prod(i)) for i in range(n)]
        time.sleep(0.4)
        sever(rt, 1)
        results = api.wait_on(futs, timeout=120)
        ex = rt.executor
        assert ex.reconnects >= 1 and ex.agent_restarts == 0
        assert rt.graph.counters().get("retries", 0) == 0
        assert api.wait_on(cons(prod(0)), timeout=60) == root_abs(produce(0))
    assert results == [root_abs(produce(i)) for i in range(n)]


@pytest.mark.chaos
def test_resume_reconciles_manifest_strikes_stale_keys():
    """A Put key whose scheduler-side generation was perturbed is struck
    from the residency set on resume (it re-ships on next use, costing no
    re-execution) while every agreeing key survives."""
    with api.runtime_start(backend="cluster", n_agents=1, workers_per_node=1,
                           reconnect_grace_s=5.0) as rt:
        ps = api.task(produce_small, name="ps")
        cons = api.task(root_abs, name="root_abs")
        srcs = ps.map([(i,) for i in range(3)])
        out = api.wait_on([cons(s) for s in srcs], timeout=60)
        assert out == [root_abs(produce_small(i)) for i in range(3)]
        ex = rt.executor
        by_key = {s.key: i for i, s in enumerate(srcs)}
        with ex._order_locks[0]:
            resident = set(ex._resident[0])
            put_resident = sorted(resident & set(by_key))
            assert len(put_resident) == 3, "Put inputs should be resident"
            victim = put_resident[0]
            ex._res_gen[0][victim] += 1   # the agent never saw this mark
        sever(rt, 0)
        assert _settle(lambda: ex.reconnects == 1, 10.0)
        with ex._order_locks[0]:
            after = set(ex._resident[0])
        assert victim not in after and resident - {victim} <= after
        assert rt.graph.counters().get("retries", 0) == 0
        i = by_key[victim]
        assert api.wait_on(cons(srcs[i]), timeout=60) == root_abs(produce_small(i))
        assert rt.graph.counters().get("retries", 0) == 0


@pytest.mark.chaos
def test_sigstop_takes_respawn_path_not_resume():
    """A wedged process (SIGSTOP) is dead to the failure detector: the
    liveness kill bypasses park-and-resume and respawns, while a plain
    socket sever on the same configuration resumes."""
    with api.runtime_start(backend="cluster", n_agents=2, workers_per_node=2,
                           heartbeat_s=0.2, suspicion_s=0.6,
                           reconnect_grace_s=5.0, max_retries=4) as rt:
        t = api.task(root_abs, name="root_abs")
        futs = [t(produce(i)) for i in range(16)]
        time.sleep(0.4)
        os.kill(rt.executor.cluster._procs[1].pid, signal.SIGSTOP)
        results = api.wait_on(futs, timeout=120)
        ex = rt.executor
        assert ex.liveness_kills >= 1
        assert _settle(lambda: ex.agent_restarts >= 1)
        assert ex.reconnects == 0
    assert results == [root_abs(produce(i)) for i in range(16)]

    with api.runtime_start(backend="cluster", n_agents=2, workers_per_node=2,
                           heartbeat_s=0.2, reconnect_grace_s=5.0, max_retries=2) as rt:
        futs = [api.task(root_abs, name="root_abs")(produce(i)) for i in range(16)]
        time.sleep(0.3)
        sever(rt, 1)
        results = api.wait_on(futs, timeout=120)
        assert rt.executor.reconnects >= 1 and rt.executor.agent_restarts == 0
    assert results == [root_abs(produce(i)) for i in range(16)]


@pytest.mark.chaos
def test_replica_hit_recovery_zero_reexecution():
    """Replication on: SIGKILL the agent homing replicated results; the
    consumers are served from buddy replicas, the replicated producers
    never re-execute, and results stay bitwise the reference."""
    n = 6
    with api.runtime_start(backend="cluster", n_agents=3, workers_per_node=1,
                           replication=1, reconnect_grace_s=0, heartbeat_s=0.2,
                           max_retries=4) as rt:
        # near-zero costs first, so the slow producers clear the mean
        api.wait_on(api.task(tiny, name="tiny").map([(i,) for i in range(12)]),
                    timeout=60)
        frags = api.task(slow_produce, name="slow_produce").map([(i,) for i in range(n)])
        api.wait_on([api.task(root_abs, name="root_abs")(f) for f in frags], timeout=120)
        ex = rt.executor

        def covered():
            homed = [k for a in range(3) for k in rt.store.homed_keys(a)]
            with ex._stats_lock:
                return bool(homed) and all(ex._replicas.get(k) for k in homed)

        assert _settle(covered, 20.0), "replicas were never fully placed"
        assert ex.replica_bytes > 0
        retries_before = rt.graph.counters().get("retries", 0)
        os.kill(rt.executor.cluster._procs[1].pid, signal.SIGKILL)
        assert _settle(lambda: ex.agent_restarts >= 1)
        out = api.wait_on([api.task(root_abs, name="root_abs")(f) for f in frags],
                          timeout=120)
        assert ex.replica_hits > 0
        assert rt.graph.counters().get("retries", 0) == retries_before
    assert out == [root_abs(slow_produce(i)) for i in range(n)]


@pytest.mark.chaos
def test_unreplicated_keys_still_resurrect_via_lineage():
    """Replication off: the same kill pays lineage re-execution."""
    n = 6
    with api.runtime_start(backend="cluster", n_agents=3, workers_per_node=1,
                           replication=0, reconnect_grace_s=0, heartbeat_s=0.2,
                           max_retries=4) as rt:
        frags = api.task(slow_produce, name="slow_produce").map([(i,) for i in range(n)])
        api.wait_on([api.task(root_abs, name="root_abs")(f) for f in frags], timeout=120)
        ex = rt.executor
        assert ex.replica_bytes == 0
        os.kill(rt.executor.cluster._procs[1].pid, signal.SIGKILL)
        out = api.wait_on([api.task(root_abs, name="root_abs")(f) for f in frags],
                          timeout=120)
        assert ex.replica_hits == 0
        assert rt.graph.counters().get("retries", 0) > 0
    assert out == [root_abs(slow_produce(i)) for i in range(n)]


@pytest.mark.chaos
def test_disconnected_state_surfaces_in_api_status():
    """While parked, ``/api/status`` shows the node as ``disconnected`` (or
    already ``reconnecting``), and rows carry a replica count."""
    with api.runtime_start(backend="cluster", n_agents=2, workers_per_node=1,
                           heartbeat_s=0.2, reconnect_grace_s=8.0, telemetry=True) as rt:
        t = api.task(tiny, name="tiny")
        assert api.wait_on(t(3), timeout=60) == 6
        ex = rt.executor
        victim = rt.executor.cluster._procs[1]
        os.kill(victim.pid, signal.SIGSTOP)
        try:
            sever(rt, 1)
            assert _settle(lambda: ex.liveness().get(1, {}).get("state")
                           in ("disconnected", "reconnecting"), 6.0)
            node1 = rt.telemetry.snapshot_status(rt)["nodes"].get("1", {})
            assert node1.get("state") in ("disconnected", "reconnecting")
            assert "replicas" in node1
        finally:
            os.kill(victim.pid, signal.SIGCONT)
        assert api.wait_on(t(4), timeout=60) == 8
