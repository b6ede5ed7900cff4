"""The port's simulator, calibration and DAG generators against the JAX
package's (``repro.core.simulator``, ``repro.algorithms.*.dag_spec``).

The port's ``simulate`` must schedule random DAGs exactly as the
reference does (makespan, schedule, transfers: equal, not close) at every
policy and on machines with transport and dispatch costs; ``CostModel.fit``
must give the reference's coefficients; each ``dag_spec`` must emit the
reference's task list — names, durations, deps and ``out_bytes`` — for
the same cost models.  Graham's bounds hold for zero-overhead machines.
``calibrate`` runs on the CPU at tiny units, and ``replay_graph`` replays
a real port run.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.algorithms import kmeans as jkmeans  # noqa: E402
from repro.algorithms import knn as jknn  # noqa: E402
from repro.algorithms import linreg as jlinreg  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro_torch.algorithms import common, kmeans, knn, linreg  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402

POLICIES = ("fifo", "lifo", "locality")


def random_dag(draw, n, mod=sim):
    """The reference's random DAG (``tests/test_simulator.py``), with
    random output sizes so transfers matter."""
    tasks = []
    for i in range(n):
        k = draw(st.integers(0, min(i, 3)))
        deps = tuple(sorted(set(draw(st.integers(0, i - 1)) for _ in range(k)))) if i else ()
        dur = draw(st.floats(0.01, 1.0))
        out = draw(st.integers(0, 10**8))
        tasks.append(mod.SimTask(i, f"t{i % 3}", dur, deps, out_bytes=out))
    return tasks


def _as_reference(tasks):
    return [jsim.SimTask(t.tid, t.name, t.duration, t.deps, t.out_bytes) for t in tasks]


def _schedule(res):
    return [(s.tid, s.name, s.worker, s.node, s.start, s.transfer, s.end) for s in res.schedule]


@pytest.mark.parametrize("policy", POLICIES)
@settings(max_examples=25, deadline=None)
@given(data=st.data(), n=st.integers(1, 30), nodes=st.integers(1, 3),
       workers=st.integers(1, 6), dispatch=st.sampled_from([0.0, 1e-3]))
def test_simulate_equals_the_reference(policy, data, n, nodes, workers, dispatch):
    tasks = random_dag(data.draw, n)
    kw = dict(n_nodes=nodes, workers_per_node=workers, bandwidth_Bps=1e9,
              dispatch_overhead_s=dispatch, worker_init_s=0.01)
    got = sim.simulate(tasks, sim.MachineModel(**kw), policy=policy)
    want = jsim.simulate(_as_reference(tasks), jsim.MachineModel(**kw), policy=policy)
    assert got.makespan == want.makespan
    assert got.transfer_total == want.transfer_total
    assert got.critical_path == want.critical_path and got.total_work == want.total_work
    assert _schedule(got) == _schedule(want)
    assert sim.critical_path(tasks) == jsim.critical_path(_as_reference(tasks))


@settings(max_examples=40, deadline=None)
@given(data=st.data(), n=st.integers(1, 30), workers=st.integers(1, 8))
def test_graham_bounds(data, n, workers):
    """For zero-overhead machines: max(T1/P, Tinf) <= T_P <= T1/P + Tinf."""
    tasks = random_dag(data.draw, n)
    m = sim.MachineModel(n_nodes=1, workers_per_node=workers, ser_Bps=None,
                         dispatch_overhead_s=0.0)
    r = sim.simulate(tasks, m)
    assert r.makespan >= max(r.total_work / workers, r.critical_path) - 1e-9
    assert r.makespan <= r.total_work / workers + r.critical_path + 1e-9


@settings(max_examples=30, deadline=None)
@given(samples=st.lists(st.tuples(st.floats(1, 1e6), st.floats(0, 10)), min_size=1,
                        max_size=6))
def test_cost_model_fit_equals_the_reference(samples):
    got, want = sim.CostModel.fit(samples, "x"), jsim.CostModel.fit(samples, "x")
    assert (got.a, got.b, got.name) == (want.a, want.b, want.name)
    assert got(12345.0) == want(12345.0)


def _costs(n):
    """``n`` pairs of equal cost models, one for each package."""
    rng = np.random.default_rng(n)
    ab = [(float(a), float(b)) for a, b in zip(rng.uniform(0, 0.1, n), rng.uniform(0, 1e-5, n))]
    return [sim.CostModel(a, b, f"c{i}") for i, (a, b) in enumerate(ab)], \
        [jsim.CostModel(a, b, f"c{i}") for i, (a, b) in enumerate(ab)]


def _fields(tasks):
    return [(t.tid, t.name, t.duration, t.deps, t.out_bytes) for t in tasks]


@pytest.mark.parametrize("cfg", [
    dict(n_train=2_000_000, n_test=50_000, d=50, k=5, train_fragments=16, test_blocks=4,
         calib_frag_rows=125_000),
    dict(n_train=2000, n_test=20_000, d=50, k=5, train_fragments=4, test_blocks=3,
         merge_arity=3),
    dict(n_train=1_228_800, n_test=64_000, d=50, k=5, train_fragments=128, test_blocks=8),
], ids=["chip_smoke", "arity3", "paper_strong"])
def test_knn_dag_spec_equals_the_reference(cfg):
    mine, ref = _costs(4)
    assert _fields(knn.dag_spec(knn.KNNCosts(*mine), **cfg)) == \
        _fields(jknn.dag_spec(jknn.KNNCosts(*ref), **cfg))


@pytest.mark.parametrize("cfg", [
    dict(n_points=8_000_000, d=50, k=16, fragments=16, iterations=10),
    dict(n_points=12_800_000, d=50, k=8, fragments=128, iterations=5, merge_arity=4),
], ids=["chip_smoke", "paper_strong"])
def test_kmeans_dag_spec_equals_the_reference(cfg):
    mine, ref = _costs(4)
    assert _fields(kmeans.dag_spec(kmeans.KMeansCosts(*mine), **cfg)) == \
        _fields(jkmeans.dag_spec(jkmeans.KMeansCosts(*ref), **cfg))


@pytest.mark.parametrize("cfg", [
    dict(n_rows=2_000_000, p=100, n_pred=100_000, fragments=16, pred_blocks=4),
    dict(n_rows=6_400_000, p=200, n_pred=1_600_000, fragments=128, pred_blocks=128,
         merge_arity=2),
], ids=["chip_smoke", "paper_strong"])
def test_linreg_dag_spec_equals_the_reference(cfg):
    mine, ref = _costs(7)
    assert _fields(linreg.dag_spec(linreg.LinRegCosts(*mine), **cfg)) == \
        _fields(jlinreg.dag_spec(jlinreg.LinRegCosts(*ref), **cfg))


@pytest.mark.parametrize("name,calibrate,kw", [
    ("knn", knn.calibrate, dict(d=8, k=3, units=(40, 80, 120), n_train_frag=200)),
    ("kmeans", kmeans.calibrate, dict(d=8, k=4, units=(200, 400, 800))),
    ("linreg", linreg.calibrate, dict(p=6, units=(50, 100, 200))),
])
def test_calibrate_at_tiny_units(name, calibrate, kw):
    costs = calibrate(**kw, device="cpu")
    models = list(vars(costs).values())
    assert models and all(isinstance(m, sim.CostModel) for m in models)
    for m in models:
        assert m.a >= 0.0 and m.b >= 0.0 and m.name
        assert all(s > 0.0 for _, s in m.samples)      # every call was timed
        assert m(1e4) >= 0.0


def test_the_timer_reads_the_wall_on_the_cpu():
    import time
    t = common.timeit_median(lambda: time.sleep(0.02), repeats=3, device="cpu")
    assert 0.02 <= t < 0.5


def test_replay_graph_of_a_real_port_run():
    with api.runtime_start(n_workers=3) as rt:
        res = kmeans.run_kmeans(n_points=6000, d=4, k=3, fragments=4, max_iters=3, tol=0.0,
                                device="cpu")
        tasks = sim.replay_graph(rt.graph)
        counts = rt.stats()
    assert len(res.sse_history) == 3
    assert len(tasks) == counts["tasks_done"]
    by_name = {}
    for t in tasks:
        by_name[t.name] = by_name.get(t.name, 0) + 1
    # the live DAG is the dag_spec's: same task counts per name
    mine, _ = _costs(4)
    spec = kmeans.dag_spec(kmeans.KMeansCosts(*mine), 6000, 4, 3, 4, 3)
    want = {}
    for t in spec:
        want[t.name] = want.get(t.name, 0) + 1
    assert by_name == want
    assert all(t.duration >= 0.0 for t in tasks)
    one = sim.simulate(tasks, sim.MachineModel(n_nodes=1, workers_per_node=1))
    assert one.makespan == pytest.approx(sum(t.duration for t in tasks))
    many = sim.simulate(tasks, sim.MachineModel(n_nodes=1, workers_per_node=4, ser_Bps=None))
    assert one.critical_path <= many.makespan <= one.makespan + 1e-12
