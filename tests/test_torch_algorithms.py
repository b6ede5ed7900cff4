"""The PyTorch port's three pipelines against the JAX package's.

Each port pipeline runs on ``device="cpu"`` (the kernels' plain versions)
under the port's thread runtime, and is compared with the JAX package's
``run_*`` under ``repro``'s own thread runtime and with the ``reference_*``
NumPy oracles, at the sizes of ``tests/test_algorithms.py``.  The data
generators of both packages must give bit-identical inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.algorithms import common as jcommon  # noqa: E402
from repro.algorithms import kmeans as jkmeans  # noqa: E402
from repro.algorithms import knn as jknn  # noqa: E402
from repro.algorithms import linreg as jlinreg  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro_torch.algorithms import common, kmeans, knn, linreg  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CPU = "cpu"


@pytest.fixture()
def rt():
    api.runtime_start(n_workers=4)
    yield
    api.runtime_stop(wait=False)


@pytest.fixture()
def both_rt():
    """The port's runtime and the JAX package's, side by side."""
    api.runtime_start(n_workers=4)
    japi.runtime_start(n_workers=4)
    yield
    japi.runtime_stop(wait=False)
    api.runtime_stop(wait=False)


def test_knn_matches_jax_pipeline_and_oracle(both_rt):
    cfg = dict(n_train=400, n_test=300, d=16, k=5, n_classes=4,
               train_fragments=4, test_blocks=3)
    res = knn.run_knn(**cfg, device=CPU)
    jres = jknn.run_knn(**cfg)
    ref = jknn.reference_knn(400, 300, 16, 5, 4, 4, 3)
    np.testing.assert_array_equal(res.predictions, jres.predictions)
    np.testing.assert_array_equal(res.predictions, ref)
    np.testing.assert_array_equal(knn.reference_knn(400, 300, 16, 5, 4, 4, 3), ref)
    assert res.n_tasks == jres.n_tasks


def test_knn_merge_arity(rt):
    r2 = knn.run_knn(n_train=300, n_test=100, d=8, k=3, train_fragments=5,
                     merge_arity=2, device=CPU)
    r3 = knn.run_knn(n_train=300, n_test=100, d=8, k=3, train_fragments=5,
                     merge_arity=3, device=CPU)
    np.testing.assert_array_equal(r2.predictions, r3.predictions)


def test_knn_fragment_smaller_than_k(both_rt):
    """A fragment with fewer rows than k hands the kernel k = its rows
    (and the merges keep that width), as in the JAX package."""
    cfg = dict(n_train=12, n_test=20, d=4, k=5, n_classes=2, train_fragments=4)
    np.testing.assert_array_equal(knn.run_knn(**cfg, device=CPU).predictions,
                                  jknn.run_knn(**cfg).predictions)


def test_knn_tasks_keep_tensors_on_the_device():
    frag = knn.knn_fill_fragment(0, 50, 6, 3, device=CPU)
    test = knn.knn_gen_test(1, 20, 6, 3, device=CPU)
    assert frag[0].dtype == torch.float32 and frag[1].dtype == torch.int32
    local = knn.knn_frag(frag, test, 4)
    merged = knn.knn_merge(local, knn.knn_frag(frag, test, 4))
    assert merged[0].shape == (20, 4)
    assert torch.all(merged[0][:, :-1] <= merged[0][:, 1:])
    votes = knn.knn_classify(merged, 3)
    assert isinstance(votes, torch.Tensor) and votes.shape == (20,)


def test_kmeans_matches_jax_pipeline_and_oracle(both_rt):
    cfg = dict(n_points=3000, d=6, k=5, fragments=4, max_iters=7, tol=0.0)
    res = kmeans.run_kmeans(**cfg, device=CPU)
    jres = jkmeans.run_kmeans(**cfg)
    cref, itref, sseref = jkmeans.reference_kmeans(3000, 6, 5, 4, 7, 0.0)
    assert res.iterations == jres.iterations == itref == 7
    # fp32 partial sums against float64 ones
    np.testing.assert_allclose(res.centroids, jres.centroids, atol=1e-4)
    np.testing.assert_allclose(res.centroids, cref, atol=1e-4)
    assert res.sse == pytest.approx(sseref, rel=1e-5)
    np.testing.assert_allclose(res.shifts, jres.shifts, rtol=1e-4, atol=1e-5)
    assert len(res.sse_history) == 7 and res.sse_history[-1] == res.sse
    pc, pit, psse = kmeans.reference_kmeans(3000, 6, 5, 4, 7, 0.0)
    np.testing.assert_array_equal(pc, cref)
    assert (pit, psse) == (itref, sseref)


def test_kmeans_sse_monotone_and_runs_repeat_bitwise(rt):
    cfg = dict(n_points=4000, d=4, k=6, fragments=4, max_iters=10, tol=0.0, device=CPU)
    a = kmeans.run_kmeans(**cfg)
    b = kmeans.run_kmeans(**cfg)
    assert all(y <= x * (1 + 1e-6) for x, y in zip(a.sse_history, a.sse_history[1:]))
    assert a.centroids.tobytes() == b.centroids.tobytes()


def test_kmeans_merge_widens_before_adding():
    s = torch.ones((2, 3), dtype=torch.float32)
    c = torch.tensor([2**31 - 1, 1], dtype=torch.int32)
    e = torch.tensor(1.5, dtype=torch.float32)
    sums, counts, sse = kmeans.merge((s, c, e), (s, c, e))
    assert sums.dtype == torch.float64 and sse.dtype == torch.float64
    assert counts.dtype == torch.int64 and counts[0].item() == 2 * (2**31 - 1)


def test_linreg_matches_jax_pipeline_and_oracle(both_rt):
    cfg = dict(n_rows=3000, p=20, n_pred=400, fragments=4, pred_blocks=2)
    res = linreg.run_linreg(**cfg, device=CPU)
    jres = jlinreg.run_linreg(**cfg)
    bref, pref = jlinreg.reference_linreg(3000, 20, 400, 4, 2)
    np.testing.assert_allclose(res.beta, jres.beta, atol=1e-8)
    np.testing.assert_allclose(res.beta, bref, atol=1e-8)
    np.testing.assert_allclose(res.predictions, pref, atol=1e-8)
    assert res.n_tasks == jres.n_tasks
    pb, pp = linreg.reference_linreg(3000, 20, 400, 4, 2)
    np.testing.assert_allclose(pb, bref, atol=1e-12)
    np.testing.assert_allclose(pp, pref, atol=1e-12)


def test_linreg_ridge_and_ground_truth(rt):
    res = linreg.run_linreg(n_rows=8000, p=10, n_pred=100, fragments=4, ridge=1e-3,
                            device=CPU)
    truth = np.random.default_rng(1234).standard_normal(11)
    np.testing.assert_allclose(res.beta, truth, atol=0.05)
    bref, _ = jlinreg.reference_linreg(8000, 10, 100, 4, 2, ridge=1e-3)
    np.testing.assert_allclose(res.beta, bref, atol=1e-8)


def test_linreg_bodies_equal_the_z_form_at_the_papers_width():
    """At p 1000 the three bodies that once formed Z = [1 X] equal that
    form and the JAX package's bodies to float64 rounding."""
    X, y = linreg.lr_fill_fragment(11, 2000, 1000, device=CPU)
    Xp = linreg.lr_genpred(50_011, 300, 1000, device=CPU)
    beta = torch.from_numpy(np.random.default_rng(1234).standard_normal(1001))
    Z = torch.cat([torch.ones((2000, 1), dtype=torch.float64), X], dim=1)
    Zp = torch.cat([torch.ones((300, 1), dtype=torch.float64), Xp], dim=1)
    ztz, zty = linreg.partial_ztz((X, y)), linreg.partial_zty((X, y))
    pred = linreg.compute_prediction(Xp, beta)
    assert ztz.shape == (1001, 1001) and zty.shape == (1001,) and pred.shape == (300,)
    assert ztz[0, 0].item() == 2000.0
    for got, z_form, jax_form in (
            (ztz, Z.T @ Z, jlinreg.partial_ztz((X.numpy(), y.numpy()))),
            (zty, Z.T @ y, jlinreg.partial_zty((X.numpy(), y.numpy()))),
            (pred, Zp @ beta, jlinreg.compute_prediction(Xp.numpy(), beta.numpy()))):
        np.testing.assert_allclose(got.numpy(), z_form.numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(got.numpy(), jax_form, rtol=0, atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generators_are_bit_identical(seed):
    X, y = common.make_blobs(seed, 500, 9, 3)
    jX, jy = jcommon.make_blobs(seed, 500, 9, 3)
    assert X.tobytes() == jX.tobytes() and y.tobytes() == jy.tobytes()
    fX, fy = knn.knn_fill_fragment(seed, 500, 9, 3, device=CPU)
    assert fX.numpy().tobytes() == jX.astype(np.float32).tobytes()
    assert fy.numpy().tobytes() == jy.astype(np.int32).tobytes()
    t = knn.knn_gen_test(seed, 40, 9, 3, device=CPU)
    assert t.numpy().tobytes() == jknn.knn_gen_test(seed, 40, 9, 3).astype(np.float32).tobytes()
    km = jkmeans.fill_fragment(seed, 400, 7)
    assert kmeans._np_fill_fragment(seed, 400, 7).tobytes() == km.tobytes()
    assert kmeans.fill_fragment(seed, 400, 7, device=CPU).numpy().tobytes() == \
        km.astype(np.float32).tobytes()
    lX, ly = linreg.lr_fill_fragment(seed, 300, 12, device=CPU)
    jlX, jly = jlinreg.lr_fill_fragment(seed, 300, 12)
    assert lX.numpy().tobytes() == jlX.tobytes() and ly.numpy().tobytes() == jly.tobytes()
    assert linreg.lr_genpred(seed, 30, 12, device=CPU).numpy().tobytes() == \
        jlinreg.lr_genpred(seed, 30, 12).tobytes()


# each fill body of the port on the CPU, and the JAX package's bytes for it
FILLS = {
    "KNN_fill_fragment": (
        lambda seed: knn.knn_fill_fragment(seed, 500, 9, 3, device=CPU),
        lambda seed: tuple(a.astype(t) for a, t in zip(jcommon.make_blobs(seed, 500, 9, 3),
                                                       (np.float32, np.int32)))),
    "KNN_gen_test": (lambda seed: knn.knn_gen_test(seed, 40, 9, 3, device=CPU),
                     lambda seed: jknn.knn_gen_test(seed, 40, 9, 3).astype(np.float32)),
    "fill_fragment": (lambda seed: kmeans.fill_fragment(seed, 400, 7, device=CPU),
                      lambda seed: jkmeans.fill_fragment(seed, 400, 7).astype(np.float32)),
    "LR_fill_fragment": (lambda seed: linreg.lr_fill_fragment(seed, 300, 12, device=CPU),
                         lambda seed: jlinreg.lr_fill_fragment(seed, 300, 12)),
    "LR_genpred": (lambda seed: linreg.lr_genpred(seed, 30, 12, device=CPU),
                   lambda seed: jlinreg.lr_genpred(seed, 30, 12)),
}


@pytest.mark.parametrize("name", sorted(FILLS))
def test_each_fill_draws_its_normals_through_the_op_on_the_cpu(name, monkeypatch):
    """A fill body takes the card's path on the CPU too: it reaches
    ``ops.normal_fill`` exactly once, and its bytes are the JAX
    package's."""
    calls = []
    op = ops.normal_fill
    monkeypatch.setattr(ops, "normal_fill", lambda *a, **kw: calls.append(a) or op(*a, **kw))
    port, jax_fill = FILLS[name]
    got, want = port(7), jax_fill(7)
    assert len(calls) == 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [g.numpy().tobytes() for g in got] == [np.asarray(w).tobytes() for w in want]


def test_tree_reduce_helpers_match_the_jax_package():
    for n in range(1, 12):
        for arity in (2, 3, 4):
            assert common.tree_reduce_spec(n, arity) == jcommon.tree_reduce_spec(n, arity)
    assert common.tree_reduce(list(range(10)), lambda a, b: a + b) == 45


def test_without_cuda_the_default_device_raises(rt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        common.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        knn.run_knn(n_train=40, n_test=10, d=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        kmeans.run_kmeans(n_points=40, d=4, k=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        linreg.run_linreg(n_rows=40, p=4, n_pred=10)
    assert common.resolve_device("cpu") == torch.device("cpu")
