"""The PyTorch port's kernels against the JAX package's Pallas kernels.

On the CPU the port's ops run each kernel's plain PyTorch version; these
tests hold it against the Pallas kernel run in interpret mode (with small
blocks, so several grid steps and ragged edges are covered) and against
``repro.kernels.ref``.  Inputs come from seeded NumPy and go to both.
Integer-valued inputs make every distance and dot product exact, so those
cases compare exactly, ties included; random normal inputs compare within
the tolerances stated at each assertion.  The CUDA kernels themselves
are held against the plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.kmeans_assign import kmeans_assign as pallas_kmeans_assign  # noqa: E402
from repro.kernels.knn_topk import knn_topk as pallas_knn_topk  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import kmeans_assign as tkm  # noqa: E402
from repro_torch.kernels import knn_topk as tknn  # noqa: E402


def _knn_inputs(seed, m, n, d, integer):
    rng = np.random.default_rng(seed)
    if integer:
        train = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
        train[n // 2:n // 2 + n // 4] = train[:n // 4]      # duplicate rows
        test = rng.integers(-3, 4, size=(m, d)).astype(np.float32)
        test[:m // 4] = train[:m // 4]                     # zero distances
    else:
        train = rng.standard_normal((n, d)).astype(np.float32)
        test = rng.standard_normal((m, d)).astype(np.float32)
    labels = rng.integers(0, 4, size=n).astype(np.int32)
    return test, train, labels


def _pallas_knn(test, train, labels, k):
    d, lab = pallas_knn_topk(jnp.asarray(test), jnp.asarray(train), jnp.asarray(labels),
                             k=k, block_m=32, block_n=64, interpret=True)
    return np.asarray(d), np.asarray(lab)


def _port_knn(test, train, labels, k):
    d, lab = ops.knn_topk(torch.from_numpy(test), torch.from_numpy(train),
                          torch.from_numpy(labels), k=k)
    return d.numpy(), lab.numpy()


@pytest.mark.parametrize("k", [1, 5, 8])
def test_knn_topk_integer_inputs_match_pallas_and_ref_exactly(k):
    test, train, labels = _knn_inputs(k, 70, 300, 16, integer=True)
    got_d, got_l = _port_knn(test, train, labels, k)
    pal_d, pal_l = _pallas_knn(test, train, labels, k)
    np.testing.assert_array_equal(got_d, pal_d)
    np.testing.assert_array_equal(got_l, pal_l)   # the tie rule: lower index first
    ref_d, ref_l = jref.knn_topk_ref(jnp.asarray(test), jnp.asarray(train),
                                     jnp.asarray(labels), k)
    np.testing.assert_array_equal(got_d, np.asarray(ref_d))
    np.testing.assert_array_equal(got_l, np.asarray(ref_l))
    assert got_d.dtype == np.float32 and got_l.dtype == np.int32


def test_knn_topk_random_inputs_match_pallas():
    k = 5
    test, train, labels = _knn_inputs(11, 70, 300, 16, integer=False)
    got_d, got_l = _port_knn(test, train, labels, k + 1)
    pal_d, pal_l = _pallas_knn(test, train, labels, k)
    # fp32 distances from two summation orders: rtol 1e-5, atol 1e-3
    np.testing.assert_allclose(got_d[:, :k], pal_d, rtol=1e-5, atol=1e-3)
    # labels agree wherever the k-th and (k+1)-th distances are apart
    clear = (got_d[:, k] - got_d[:, k - 1]) > 1e-3
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(np.sort(got_l[clear, :k], axis=1),
                                  np.sort(pal_l[clear], axis=1))


def test_knn_topk_plain_streams_blocks_like_the_pallas_grid():
    """Small training blocks in the plain version change nothing: the
    running best goes before each new block, as in the Pallas kernel."""
    test, train, labels = _knn_inputs(3, 40, 257, 9, integer=True)
    args = (torch.from_numpy(test), torch.from_numpy(train), torch.from_numpy(labels), 7)
    whole = tknn.knn_topk_plain(*args)
    blocked = tknn.knn_topk_plain(*args, block_n=16)
    assert all(torch.equal(a, b) for a, b in zip(whole, blocked))


def test_knn_topk_plain_computes_fp64_for_fp64_inputs():
    test, train, labels = _knn_inputs(4, 20, 100, 8, integer=False)
    d64, _ = tknn.knn_topk_plain(torch.from_numpy(test.astype(np.float64)),
                                 torch.from_numpy(train.astype(np.float64)),
                                 torch.from_numpy(labels), 3)
    assert d64.dtype == torch.float64
    exact = ((test.astype(np.float64)[:, None] - train.astype(np.float64)[None]) ** 2).sum(-1)
    np.testing.assert_allclose(d64.numpy(), np.sort(exact, axis=1)[:, :3], rtol=1e-10)


def _km_inputs(seed, n, d, k, integer):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
        c = rng.integers(-2, 3, size=(k, d)).astype(np.float32)
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
        c = rng.standard_normal((k, d)).astype(np.float32)
    return x, c


def _pallas_km(x, c):
    s, n, e = pallas_kmeans_assign(jnp.asarray(x), jnp.asarray(c), block_m=64,
                                   interpret=True)
    return np.asarray(s), np.asarray(n), float(e)


def _port_km(x, c):
    s, n, e = ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    assert s.dtype == torch.float32 and n.dtype == torch.int32 and e.dim() == 0
    return s.numpy(), n.numpy(), float(e)


@pytest.mark.parametrize("n,d,k", [(300, 16, 8), (257, 7, 5)])
def test_kmeans_assign_integer_inputs_match_pallas_and_ref_exactly(n, d, k):
    x, c = _km_inputs(n, n, d, k, integer=True)
    got = _port_km(x, c)
    pal = _pallas_km(x, c)
    np.testing.assert_array_equal(got[0], pal[0])
    np.testing.assert_array_equal(got[1], pal[1])   # first index wins ties
    assert got[2] == pal[2]
    rs, rn, re = jref.kmeans_assign_ref(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_array_equal(got[0], np.asarray(rs))
    np.testing.assert_array_equal(got[1], np.asarray(rn))
    assert got[2] == float(re)


def test_kmeans_assign_random_inputs_match_pallas():
    x, c = _km_inputs(5, 300, 16, 8, integer=False)
    # keep points whose two best centroids score at least 1e-4 apart, so
    # two fp32 summation orders cannot assign them differently
    half = x.astype(np.float64) @ c.T.astype(np.float64) - 0.5 * (c.astype(np.float64) ** 2).sum(1)
    top2 = np.sort(half, axis=1)[:, -2:]
    x = np.ascontiguousarray(x[(top2[:, 1] - top2[:, 0]) >= 1e-4])
    got, pal = _port_km(x, c), _pallas_km(x, c)
    np.testing.assert_array_equal(got[1], pal[1])
    # fp32 sums of ~40 points: rtol 1e-5 against the largest sum
    np.testing.assert_allclose(got[0], pal[0], rtol=1e-5, atol=1e-5 * np.abs(pal[0]).max())
    assert got[2] == pytest.approx(pal[2], rel=1e-5)


def test_ops_dispatch_by_device_and_count_only_kernel_launches():
    ops.reset_launch_counts()
    test, train, labels = _knn_inputs(0, 10, 50, 4, integer=False)
    ops.knn_topk(torch.from_numpy(test), torch.from_numpy(train), torch.from_numpy(labels), k=3)
    x, c = _km_inputs(0, 50, 4, 3, integer=False)
    ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    # plain versions never count
    assert ops.launch_counts() == {"knn_topk": 0, "kmeans_assign": 0}
    with pytest.raises(ValueError):
        ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c).to("meta"))


def test_cuda_wrappers_refuse_cpu_tensors_without_building():
    """On a CPU tensor the CUDA wrapper raises: it never falls back to the
    plain version, and the refusal happens before any build."""
    test, train, labels = _knn_inputs(0, 10, 50, 4, integer=False)
    with pytest.raises(ValueError, match="CUDA"):
        tknn.knn_topk_cuda(torch.from_numpy(test), torch.from_numpy(train),
                           torch.from_numpy(labels), 3)
    x, c = _km_inputs(0, 50, 4, 3, integer=False)
    with pytest.raises(ValueError, match="CUDA"):
        tkm.kmeans_assign_cuda(torch.from_numpy(x), torch.from_numpy(c))
    assert _build._lib is None


def test_argument_checks():
    test, train, labels = _knn_inputs(0, 10, 50, 4, integer=False)
    t = (torch.from_numpy(test), torch.from_numpy(train), torch.from_numpy(labels))
    with pytest.raises(ValueError):
        ops.knn_topk(*t, k=51)                      # k > n_train
    with pytest.raises(ValueError):
        ops.knn_topk(t[0][:, :3], t[1], t[2], k=3)  # d mismatch
    with pytest.raises(ValueError):
        tknn.list_length(tknn.MAX_K + 1)
    assert [tknn.list_length(k) for k in (1, 8, 9, 32)] == [8, 8, 16, 32]
    with pytest.raises(ValueError):
        ops.kmeans_assign(torch.zeros((4, 3)), torch.zeros((2, 5)))
