"""The PyTorch port's kernels against the JAX package's Pallas kernels.

On the CPU the port's ops run each kernel's plain PyTorch version; these
tests hold it against the Pallas kernel run in interpret mode (with small
blocks, so several grid steps and ragged edges are covered) and against
``repro.kernels.ref``.  Inputs come from seeded NumPy and go to both.
Integer-valued inputs make every distance and dot product exact, so those
cases compare exactly, ties included; random normal inputs compare within
the tolerances stated at each assertion; bf16 cases feed both sides the
same bf16 values and allow one bf16 rounding step (2^-7 relative) where
two fp32 results round to neighbouring bf16 values.  The CUDA kernels
themselves
are held against the plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import contextlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.kmeans_assign import kmeans_assign as pallas_kmeans_assign  # noqa: E402
from repro.kernels.knn_topk import knn_topk as pallas_knn_topk  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd  # noqa: E402
from repro_torch.algorithms.kmeans import _np_fill_fragment  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import kmeans_assign as tkm  # noqa: E402
from repro_torch.kernels import knn_topk as tknn  # noqa: E402
from repro_torch.kernels import rglru_scan as trglru  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402


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
    x2 = torch.from_numpy(np.ones((3, 8), np.float32))
    ops.rmsnorm(x2, x2[0])
    q = torch.zeros((1, 2, 5, 16))
    ops.flash_attention(q, q[:, :1], q[:, :1])
    la, b = torch.zeros((2, 3, 5)), torch.ones((2, 3, 5))
    y, h = ops.rglru_scan(la, b)
    assert torch.equal(y[:, -1], torch.full((2, 5), 3.0)) and torch.equal(h, y[:, -1])
    y, st = ops.ssd_scan(torch.ones((1, 4, 2, 3)), torch.ones((1, 4, 2)), -torch.ones(2),
                         torch.ones((1, 4, 5)), torch.ones((1, 4, 5)), chunk=2)
    assert y.shape == (1, 4, 2, 3) and st.shape == (1, 2, 3, 5) and y.dtype == torch.float32
    ops.normal_fill(np.random.default_rng(0).bit_generator.state,
                    torch.empty(6, dtype=torch.float64))
    # plain versions never count
    assert ops.launch_counts() == {"knn_topk": 0, "kmeans_assign": 0, "rmsnorm": 0,
                                   "flash_attention": 0, "rglru_scan": 0, "ssd_scan": 0,
                                   "normal_fill": 0}
    with pytest.raises(ValueError):
        ops.rglru_scan(la, b, torch.zeros((2, 5), device="meta"))
    with pytest.raises(ValueError):
        ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c).to("meta"))


def test_knn_route_counts_move_per_route_and_reset_with_launches(monkeypatch):
    """``_build.launch`` counts knn_topk's launches and, beside them, its
    calls per route: a route's count moves only for that route's calls,
    the plain version and a failed launch count nothing, and
    ops.reset_launch_counts zeroes both.  The library and the stream are
    stand-ins here; the launch passes the device's stream last."""
    calls = []

    class Lib:
        err = 0

        def __getattr__(self, symbol):
            return lambda *args: calls.append((symbol, args)) or self.err

        def repro_cuda_error_string(self, err):
            return b"stand-in error"

    lib = Lib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    ops.reset_launch_counts()
    assert ops.launch_counts()["knn_topk"] == 0
    assert ops.route_counts("knn_topk") == {"tensor_cores": 0, "wide": 0}
    _build.launch("knn_topk", "knn_topk_launch", "cuda:0", 1, 2, route=tknn.route(5, 50))
    assert calls == [("knn_topk_launch", (1, 2, 7))]
    assert ops.launch_counts()["knn_topk"] == 1
    assert ops.route_counts("knn_topk") == {"tensor_cores": 1, "wide": 0}
    for k, d in ((33, 50), (5, 65)):
        _build.launch("knn_topk", "knn_wide_launch", "cuda:0", route=tknn.route(k, d))
    assert ops.launch_counts()["knn_topk"] == 3
    assert ops.route_counts("knn_topk") == {"tensor_cores": 1, "wide": 2}
    lib.err = 1
    with pytest.raises(RuntimeError, match="stand-in error"):
        _build.launch("knn_topk", "knn_wide_launch", "cuda:0", route="wide")
    test, train, labels = _knn_inputs(0, 10, 50, 4, integer=False)
    ops.knn_topk(torch.from_numpy(test), torch.from_numpy(train), torch.from_numpy(labels), k=3)
    assert ops.launch_counts()["knn_topk"] == 3 and ops.route_counts("knn_topk")["wide"] == 2
    ops.reset_launch_counts()
    assert ops.launch_counts()["knn_topk"] == 0
    assert ops.route_counts("knn_topk") == {"tensor_cores": 0, "wide": 0}


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
    with pytest.raises(ValueError, match="CUDA"):
        trms.rmsnorm_cuda(torch.from_numpy(x), torch.ones(4))
    q = torch.zeros((1, 2, 5, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        trglru.rglru_scan_cuda(torch.zeros((2, 3, 5)), torch.zeros((2, 3, 5)))
    x, bm = torch.zeros((1, 4, 2, 3)), torch.zeros((1, 4, 5))
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan_cuda(x, torch.zeros((1, 4, 2)), -torch.ones(2), bm, bm)
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


# ------------------------------------------------------------------ rmsnorm
BF16_STEP = 2.0 ** -7   # one bf16 rounding step, relative


def _bf16_pair(a):
    """The same bf16 values as a torch tensor and a jnp array."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.to(torch.float32).numpy()).astype(jnp.bfloat16)


def _np(t):
    return np.asarray(t, dtype=np.float32) if not isinstance(t, torch.Tensor) \
        else t.to(torch.float32).numpy()


@pytest.mark.parametrize("shape", [(300, 64), (2, 37, 1024), (5, 6144), (1, 64)])
def test_rmsnorm_plain_matches_pallas_and_ref_fp32(shape):
    rng = np.random.default_rng(shape[-1] + len(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))
    assert got.dtype == torch.float32 and got.shape == shape
    pal = pallas_rmsnorm(jnp.asarray(x), jnp.asarray(scale), block_rows=64, interpret=True)
    ref = jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(scale))
    # fp32 sums of squares in two orders; the Pallas kernel's rsqrt vs
    # 1/sqrt: a few ulps
    np.testing.assert_allclose(got.numpy(), _np(pal), rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=2e-6, atol=1e-6)


def test_rmsnorm_plain_matches_pallas_bf16():
    rng = np.random.default_rng(7)
    xt, xj = _bf16_pair((rng.standard_normal((77, 3, 64)) * 2).astype(np.float32))
    st, sj = _bf16_pair(rng.standard_normal(64).astype(np.float32))
    got = ops.rmsnorm(xt, st)
    assert got.dtype == torch.bfloat16
    pal = pallas_rmsnorm(xj, sj, block_rows=64, interpret=True)
    ref = jref.rmsnorm_ref(xj, sj)
    for want in (pal, ref):
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_STEP, atol=1e-6)


# ------------------------------------------------------------ flash attention
# (B, H, K, Sq, Skv, d, causal, window): ragged causal GQA; non-causal with
# Sq != Skv both ways; a window whose first KV block (16 keys) is wholly
# masked for the later q blocks; MQA with G = 16; d = 128
FLASH_CASES = [
    (2, 4, 2, 77, 77, 64, True, None),
    (1, 4, 4, 40, 72, 32, False, None),
    (1, 4, 2, 72, 40, 16, True, None),
    (1, 2, 1, 70, 70, 16, True, 20),
    (1, 16, 1, 24, 24, 16, True, None),
    (1, 2, 1, 20, 33, 128, False, 7),
]


def _flash_inputs(case):
    B, H, K, Sq, Skv, d = case[:6]
    rng = np.random.default_rng(sum(case[:6]))
    return (rng.standard_normal((B, H, Sq, d)).astype(np.float32),
            rng.standard_normal((B, K, Skv, d)).astype(np.float32),
            rng.standard_normal((B, K, Skv, d)).astype(np.float32))


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
def test_flash_attention_plain_matches_pallas_and_ref_fp32(case):
    causal, window = case[6], case[7]
    q, k, v = _flash_inputs(case)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    pal = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                       window=window, block_q=32, block_k=16, interpret=True)
    ref = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, window=window)
    # fp32 softmax over <= 77 keys in two orders (online vs dense)
    np.testing.assert_allclose(got.numpy(), _np(pal), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", FLASH_CASES[:4], ids=[str(c) for c in FLASH_CASES[:4]])
def test_flash_attention_plain_matches_pallas_bf16(case):
    causal, window = case[6], case[7]
    (qt, qj), (kt, kj), (vt, vj) = (_bf16_pair(a) for a in _flash_inputs(case))
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    pal = pallas_flash(qj, kj, vj, causal=causal, window=window, block_q=32, block_k=16,
                       interpret=True)
    np.testing.assert_allclose(_np(got), _np(pal), rtol=BF16_STEP, atol=1e-5)


def test_flash_attention_plain_takes_strided_views():
    """The attention layer passes (B, S, H, d) tensors as (B, H, S, d) views."""
    q, k, v = _flash_inputs(FLASH_CASES[0])
    views = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))).transpose(1, 2)
             for a in (q, k, v)]
    assert not views[0].is_contiguous()
    got = ops.flash_attention(*views)
    want = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert torch.equal(got, want)


def test_flash_attention_argument_checks():
    q = torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, q[:, :3], q[:, :3])          # H % K != 0
    with pytest.raises(ValueError):
        ops.flash_attention(q, q[..., :8], q[..., :8])      # d mismatch
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError):
        ops.rmsnorm(q, torch.ones(8))                      # scale width


# ------------------------------------------------------------------ rglru_scan
# (B, S, R, block_r of the Pallas run): R a multiple of the block; R = 100
# and 37 off it (the Pallas wrapper pads R, the port's versions do not)
RGLRU_CASES = [(2, 24, 64, 32), (1, 33, 100, 64), (3, 8, 37, 16)]


def _rglru_inputs(B, S, R, seed):
    rng = np.random.default_rng(seed)
    log_a = -np.log1p(np.exp(rng.standard_normal((B, S, R)))).astype(np.float32)
    return (log_a, rng.standard_normal((B, S, R)).astype(np.float32),
            rng.standard_normal((B, R)).astype(np.float32))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("case", RGLRU_CASES, ids=[str(c) for c in RGLRU_CASES])
def test_rglru_scan_plain_matches_pallas_and_ref_fp32(case, with_h0):
    B, S, R, blk = case
    la, b, h0 = _rglru_inputs(B, S, R, sum(case))
    h0 = h0 if with_h0 else None
    y, hT = ops.rglru_scan(torch.from_numpy(la), torch.from_numpy(b),
                           None if h0 is None else torch.from_numpy(h0))
    assert y.dtype == torch.float32 and hT.dtype == torch.float32 and hT.shape == (B, R)
    pal_y, pal_h = pallas_rglru(jnp.asarray(la), jnp.asarray(b),
                                None if h0 is None else jnp.asarray(h0), block_r=blk,
                                interpret=True)
    ref_y, ref_h = jref.rglru_scan_ref(jnp.asarray(la), jnp.asarray(b),
                                       None if h0 is None else jnp.asarray(h0))
    # the same fp32 steps in the same order: exp and a*h + b may round an
    # ulp apart between the frameworks, over <= 33 contracting steps
    for want_y, want_h in ((pal_y, pal_h), (ref_y, ref_h)):
        np.testing.assert_allclose(y.numpy(), _np(want_y), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(hT.numpy(), _np(want_h), rtol=1e-6, atol=1e-6)


def test_rglru_scan_plain_matches_pallas_bf16():
    """bf16 log_a and b: y in bf16 (each step's fp32 state rounded), h_T in
    fp32."""
    la, b, h0 = _rglru_inputs(2, 24, 100, 5)
    (lat, laj), (bt, bj) = _bf16_pair(la), _bf16_pair(b)
    y, hT = ops.rglru_scan(lat, bt, torch.from_numpy(h0))
    assert y.dtype == torch.bfloat16 and hT.dtype == torch.float32
    pal_y, pal_h = pallas_rglru(laj, bj, jnp.asarray(h0), block_r=64, interpret=True)
    assert pal_y.dtype == jnp.bfloat16
    # the fp32 states agree to an ulp or so (above), so the bf16 outputs
    # are within one bf16 rounding step
    np.testing.assert_allclose(_np(y), _np(pal_y), rtol=BF16_STEP, atol=1e-6)
    np.testing.assert_allclose(hT.numpy(), _np(pal_h), rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------------- ssd_scan
# (B, S, H, P, N, chunk): chunk divides S; S ragged against the chunk; S
# shorter than the chunk (one chunk of S)
SSD_CASES = [(2, 24, 3, 8, 16, 8), (1, 24, 2, 16, 8, 10), (2, 13, 2, 4, 4, 32)]


def _ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)   # softplus
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    return (rng.standard_normal((B, S, H, P)).astype(np.float32), dt, A,
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32))


@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_ssd_scan_plain_matches_pallas_and_ref_fp32(case):
    *shape, chunk = case
    x, dt, A, Bm, Cm = _ssd_inputs(*shape, seed=sum(case))
    y, st = ops.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk=chunk)
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert st.shape == (shape[0], shape[2], shape[3], shape[4])
    pal = pallas_ssd(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=chunk,
                     interpret=True)
    ref_y, ref_st = jref.ssd_scan_ref(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    # fp32: the chunked form's exp(cs_i - cs_j) of cumulative sums against
    # the per-step products of the reference, sums in other orders
    np.testing.assert_allclose(y.numpy(), _np(pal), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), _np(ref_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), _np(ref_st), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", SSD_CASES[:2], ids=[str(c) for c in SSD_CASES[:2]])
def test_ssd_scan_plain_matches_pallas_bf16(case):
    """bf16 x, B and C (dt and A fp32, as the layer passes them): the port
    returns an fp32 y, the Pallas kernel y in bf16 — compared in bf16."""
    *shape, chunk = case
    x, dt, A, Bm, Cm = _ssd_inputs(*shape, seed=sum(case) + 1)
    (xt, xj), (bt, bj), (ct, cj) = (_bf16_pair(a) for a in (x, Bm, Cm))
    y, st = ops.ssd_scan(xt, torch.from_numpy(dt), torch.from_numpy(A), bt, ct, chunk=chunk)
    assert y.dtype == torch.float32
    pal = pallas_ssd(xj, jnp.asarray(dt), jnp.asarray(A), bj, cj, chunk=chunk, interpret=True)
    assert pal.dtype == jnp.bfloat16
    # the fp32 results agree to ~1e-5 (above): one bf16 rounding step apart
    np.testing.assert_allclose(_np(y.to(torch.bfloat16)), _np(pal), rtol=BF16_STEP, atol=1e-5)
    _, ref_st = jref.ssd_scan_ref(xj, jnp.asarray(dt), jnp.asarray(A), bj, cj)
    np.testing.assert_allclose(st.numpy(), _np(ref_st), rtol=1e-5, atol=1e-5)


def test_ssd_scan_plain_takes_strided_views_and_any_chunk():
    """The SSD layer passes x, B and C as views into its conv output; the
    chunk length does not change the function (fp32 rounding aside)."""
    x, dt, A, Bm, Cm = _ssd_inputs(2, 20, 3, 4, 5, seed=9)
    packed = torch.from_numpy(np.concatenate([x.reshape(2, 20, 12), Bm, Cm], axis=-1))
    views = (packed[..., :12].reshape(2, 20, 3, 4), torch.from_numpy(dt), torch.from_numpy(A),
             packed[..., 12:17], packed[..., 17:])
    assert not views[0].is_contiguous()
    want = ops.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk=8)
    assert all(torch.equal(a, b) for a, b in zip(ops.ssd_scan(*views, chunk=8), want))
    for chunk in (1, 3, 20, 64):
        for got, ref in zip(ops.ssd_scan(*views, chunk=chunk), want):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_scan_argument_checks():
    with pytest.raises(ValueError):
        ops.rglru_scan(torch.zeros((2, 3, 5)), torch.zeros((2, 3, 4)))
    with pytest.raises(ValueError):
        ops.rglru_scan(torch.zeros((2, 3, 5)), torch.zeros((2, 3, 5)), torch.zeros((2, 4)))
    x = torch.zeros((1, 4, 2, 3))
    with pytest.raises(ValueError):
        ops.ssd_scan(x, torch.zeros((1, 4, 3)), -torch.ones(2), torch.zeros((1, 4, 5)),
                     torch.zeros((1, 4, 5)))
    with pytest.raises(ValueError):
        ops.ssd_scan(x, torch.zeros((1, 4, 2)), -torch.ones(2), torch.zeros((1, 4, 5)),
                     torch.zeros((1, 4, 6)))


# ------------------------------------------------- the tensor-core designs
# The CUDA kernels of flash_attention (bf16 route) and knn_topk run their
# products on the tensor cores.  No card runs here, so these tests
# emulate each kernel's arithmetic in PyTorch and hold it to the
# tolerance the card checks apply to the kernel (tests/test_torch_cuda.py,
# chip_smoke.py); a control with the cheaper rounding must fail it, so the
# check can tell the two designs apart.
SMEM_LIMIT = 232448     # dynamic shared memory a Hopper block may use


def _flash_tc_emulation(q, k, v, causal, window, split_p, block_k=64):
    """The bf16 route's arithmetic: fp32 scores of bf16 operands, the scale
    (times log2 e) applied after the product, an online softmax over
    64-key tiles in base 2 with fp32 max and row sum, and P.V with P as
    bf16 hi + bf16 lo (or one bf16 P where not ``split_p``)."""
    B, H, Sq, d = q.shape
    K, Skv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, K, H // K, Sq, d)
    kf, vf = k.float(), v.float()
    scale_log2 = float(np.float32(1.4426950408889634 / np.sqrt(d)))
    m = torch.full((B, K, H // K, Sq), tflash.NEG_INF)
    l = torch.zeros((B, K, H // K, Sq))
    acc = torch.zeros((B, K, H // K, Sq, d))
    q_pos = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        x = torch.einsum("bkgqd,bksd->bkgqs", qf, kt) * scale_log2
        kv_pos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones((Sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            ok &= kv_pos <= q_pos
        if window is not None:
            ok &= (q_pos - kv_pos) < window
        x = torch.where(ok, x, torch.tensor(tflash.NEG_INF))
        mx = torch.maximum(m, x.amax(-1))
        alpha, p = torch.exp2(m - mx), torch.exp2(x - mx[..., None])
        l, m = l * alpha + p.sum(-1), mx
        hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bkgqs,bksd->bkgqd", hi, vt)
        if split_p:
            lo = (p - hi).to(torch.bfloat16).float()
            pv = pv + torch.einsum("bkgqs,bksd->bkgqd", lo, vt)
        acc = acc * alpha[..., None] + pv
    return (acc / l.clamp(min=1e-30)[..., None]).reshape(B, H, Sq, d).to(torch.bfloat16)


# (B, H, K, Sq, Skv, d, causal, window): the card checks' d 64 and d 256
# cases, causal and windowed; the first is qwen3's prefill at batch 1, the
# last recurrentgemma's (window 2048) at batch 1 and 2 heads
FLASH_TC_CASES = [(1, 16, 8, 512, 512, 64, True, None),
                  (1, 4, 2, 300, 300, 64, True, 100),
                  (2, 4, 1, 300, 300, 256, True, 100),
                  (1, 16, 1, 200, 200, 256, True, 64),
                  (1, 2, 1, 512, 512, 256, True, 2048)]


@pytest.mark.parametrize("case", FLASH_TC_CASES, ids=[str(c) for c in FLASH_TC_CASES])
def test_flash_split_p_emulation_meets_the_card_tolerance(case):
    B, H, K, Sq, Skv, d, causal, window = case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
               for s in ((B, H, Sq, d), (B, K, Skv, d), (B, K, Skv, d)))
    want = tflash.flash_attention_plain(q, k, v, causal=causal, window=window).float()
    got = _flash_tc_emulation(q, k, v, causal, window, split_p=True)
    # the card's check of a bf16 kernel: within one bf16 rounding step
    torch.testing.assert_close(got.float(), want, rtol=BF16_STEP, atol=1e-5)
    # control: one bf16 P (8 bits per weight) leaves that step
    single = _flash_tc_emulation(q, k, v, causal, window, split_p=False)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(single.float(), want, rtol=BF16_STEP, atol=1e-5)


def _tf32_rna(a):
    """fp32 -> TF32 by round to nearest, ties away from zero (``cvt.rna``):
    add half of the 13 dropped bits to the magnitude, then drop them."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _knn_tc_emulation(test, train, labels, k, three_products):
    """knn_topk's arithmetic on the tensor cores: the cross term from TF32
    operands, x_lo y_hi + x_hi y_lo + x_hi y_hi (or x_hi y_hi alone), in
    fp32; fp32 norms; the k smallest with the lower index first on ties."""
    xh, yh = _tf32_rna(test), _tf32_rna(train)
    cross = torch.from_numpy(xh) @ torch.from_numpy(yh).T
    if three_products:
        xl, yl = _tf32_rna(test - xh), _tf32_rna(train - yh)
        cross = (torch.from_numpy(xl) @ torch.from_numpy(yh).T
                 + torch.from_numpy(xh) @ torch.from_numpy(yl).T) + cross
    x, y = torch.from_numpy(test), torch.from_numpy(train)
    d2 = ((x * x).sum(1)[:, None] - 2.0 * cross) + (y * y).sum(1)[None, :]
    order = torch.sort(d2, dim=1, stable=True).indices[:, :k]
    return torch.gather(d2, 1, order), torch.from_numpy(labels)[order].to(torch.int32)


@pytest.mark.parametrize("d", [50, 13])
def test_knn_3xtf32_emulation_meets_the_card_tolerance(d):
    test, train, labels = _knn_inputs(d, 500, 3000, d, integer=False)
    want_d, _ = tknn.knn_topk_plain(torch.from_numpy(test), torch.from_numpy(train),
                                    torch.from_numpy(labels), 5)
    got_d, _ = _knn_tc_emulation(test, train, labels, 5, three_products=True)
    # the card's check of the kernel's distances
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-3)
    # control: one TF32 product keeps ~3 digits
    single_d, _ = _knn_tc_emulation(test, train, labels, 5, three_products=False)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(single_d, want_d, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("k", [1, 5, 32])
def test_knn_3xtf32_emulation_is_exact_on_integer_inputs(k):
    """Integers in [-3, 3] are exact in TF32 (lo = 0): distances, ties and
    labels equal the plain version's bit for bit."""
    test, train, labels = _knn_inputs(k + 100, 70, 300, 50, integer=True)
    want = tknn.knn_topk_plain(torch.from_numpy(test), torch.from_numpy(train),
                               torch.from_numpy(labels), k)
    got = _knn_tc_emulation(test, train, labels, k, three_products=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("d", tflash.HEAD_DIMS)
def test_flash_blocks_fit_in_shared_memory(d):
    for dtype in tflash.DTYPES:
        assert 0 < tflash.smem_bytes(d, dtype) <= SMEM_LIMIT
    # the bf16 route's rows are 16-byte multiples (cp.async, ldmatrix)
    assert (d + 8) * 2 % 16 == 0


@pytest.mark.parametrize("d", list(range(1, tknn.MAX_D + 1)))
def test_knn_blocks_fit_in_shared_memory(d):
    """The tensor-core route's block (three split stages, three raw
    stages, the distance tiles, the selector's lists) fits a Hopper
    block's shared memory at every depth it takes, for every k it takes,
    with two distance tiles per consumer warpgroup wherever they fit:
    always at k <= 8 (the benchmark's d 50, k 5 among them)."""
    for k in (1, 5, 8, 16, tknn.MAX_K):
        smem, bufs = tknn.tc_layout(d, k)
        assert smem <= SMEM_LIMIT and bufs in (1, 2)
        assert smem == tknn.smem_bytes(d, k)
        if bufs == 1:
            assert smem + 2 * 64 * tknn.TC_DIST_LD * 4 > SMEM_LIMIT
        if k <= 8:
            assert bufs == 2


def _knn_block_of(p, units, blocks):
    """csrc/knn_topk.cu :: block_of, the merge's way to the runs."""
    return ((p + 1) * blocks + units - 1) // units - 1


def _knn_runs(m, n, sms):
    """Per block, its segments (slab, first tile, end tile) as the kernel
    walks its run of units."""
    blocks, slabs, tiles = tknn.partition(m, n, sms)
    units = slabs * tiles
    runs = []
    for b in range(blocks):
        u0, u1 = tknn.run_of(b, blocks, units)
        segs, u = [], u0
        while u < u1:
            s = u // tiles
            end = min(u1, (s + 1) * tiles)
            segs.append((s, u - s * tiles, end - s * tiles))
            u = end
        runs.append(segs)
    return blocks, slabs, tiles, runs


@pytest.mark.parametrize("m,n", [(12_700, 76_800), (8_000, 76_800), (12_500, 125_000),
                                 (1037, 10013), (129, 3), (5, 64), (300, 700), (1, 1),
                                 (100_000, 1000), (128, 64 * 132 + 1)])
def test_knn_partition_covers_the_training_rows(m, n):
    """The persistent grid's runs cover every (slab, tile) unit exactly
    once, so every pair of a test row and a training row meets once; each
    block has work; a segment's list index (block + slab) is unique and
    within the scratch the wrapper allocates; the merge finds a slab's
    blocks from the run formula alone.  At the benchmark's two shapes and
    at 12,500 x 125,000 the most loaded SM's work (units by the consumer
    warpgroups with rows, by the training rows of the tile) is within 5%
    of the mean."""
    sms = 132
    blocks, slabs, tiles, runs = _knn_runs(m, n, sms)
    assert 1 <= blocks <= sms and slabs == -(-m // 128) and tiles == -(-n // 64)
    seen = np.zeros((slabs, tiles), dtype=np.int64)
    index = set()
    holders = [set() for _ in range(slabs)]
    for b, segs in enumerate(runs):
        assert segs, f"block {b} has no work"
        for s, t0, t1 in segs:
            assert 0 <= t0 < t1 <= tiles
            seen[s, t0:t1] += 1
            assert b + s not in index and 0 <= b + s < blocks + slabs - 1
            index.add(b + s)
            holders[s].add(b)
    assert (seen == 1).all()
    rows_t = np.zeros(m, dtype=np.int64)
    rows_y = np.zeros(n, dtype=np.int64)
    for s in range(slabs):
        rows_t[128 * s:128 * s + 128] += 1
    for t in range(tiles):
        rows_y[64 * t:64 * t + 64] += 1
    assert (rows_t == 1).all() and (rows_y == 1).all()
    units = slabs * tiles
    for s in range(slabs):
        first = _knn_block_of(s * tiles, units, blocks)
        last = _knn_block_of(s * tiles + tiles - 1, units, blocks)
        assert holders[s] == set(range(first, last + 1))
    if (m, n) in ((12_700, 76_800), (8_000, 76_800), (12_500, 125_000)):
        groups = [min(2, -(-(m - 128 * s) // 64)) for s in range(slabs)]
        width = [min(64, n - 64 * t) for t in range(tiles)]
        csum = np.concatenate([[0], np.cumsum(width)])
        work = [sum(groups[s] * (csum[t1] - csum[t0]) for s, t0, t1 in segs) for segs in runs]
        assert blocks == sms and max(work) <= 1.05 * np.mean(work)


# ------------------------------------------ kmeans_assign on the tensor cores
def _tf32_terms(v, terms):
    """v (fp32) as ``terms`` TF32 values (cvt.rna), highest first, each the
    rounding of what the ones before it miss."""
    out, rest = [], v.numpy()
    for _ in range(terms):
        t = _tf32_rna(rest)
        out.append(torch.from_numpy(t))
        rest = rest - t
    return out


def _kmeans_tc_emulation(x, c, terms=2, sms=8, scores=None, cut=False):
    """kmeans_assign as the kernel forms it: the assignment from 3xTF32
    scores (with ``scores`` "fresh" or "carried", in the narrow route's
    step schedule, _stream_3xtf32: each 8-deep step's three products in a
    fresh accumulator added in fp32, or all of them carried in one; ``cut``
    rounds each product's add toward zero); per block (tiles b, b + blocks, ...) and per 8 points one
    ``mma`` per TF32 term of x, lo first, each adding the exact sum of its
    one-hot products to its fp32 accumulator chain with one rounding (per
    term and 8-point half of a 16-point step where the kernel keeps four
    chains), the chains added in order; then the per-block partials added
    by 32 lanes striding over the blocks and a shuffle tree.  Returns
    (sums, counts, sse)."""
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    (n, d), k = x.shape, c.shape[0]
    # the scores in 3xTF32 (x_lo c_hi + x_hi c_lo + x_hi c_hi), fp32 |c|^2/2
    if scores is None:
        xh, ch = _tf32_rna(x), _tf32_rna(c)
        xl, cl = _tf32_rna(x - xh), _tf32_rna(c - ch)
        cross = ((torch.from_numpy(xl) @ torch.from_numpy(ch).T
                  + torch.from_numpy(xh) @ torch.from_numpy(cl).T)
                 + torch.from_numpy(xh) @ torch.from_numpy(ch).T)
    else:
        cross = torch.from_numpy(_stream_3xtf32(x, c, cut=cut, fresh_steps=scores == "fresh"))
    half = cross - 0.5 * (ct * ct).sum(1)
    assign = torch.argmax(half, dim=1)        # the first index on ties
    sse = ((xt * xt).sum(1) - 2.0 * half.amax(1)).sum()
    T = tkm.tile_points(k, d)
    n_tiles = -(-n // T)
    blocks = min(n_tiles, 2 * sms)
    its = -(-n_tiles // blocks)
    xp = torch.zeros((its * blocks * T, d))
    xp[:n] = xt
    onehot = torch.zeros((its * blocks * T, k), dtype=torch.float64)
    onehot[torch.arange(n), assign] = 1.0
    xp = xp.reshape(its, blocks, T // 8, 8, d)
    onehot = onehot.reshape(its, blocks, T // 8, 8, k)
    chains = tkm.mma_chains(k, d)
    acc = torch.zeros((4, blocks, k, d))      # chain term + 2 * half, term 0 = lo
    for it in range(its):
        for k8 in range(T // 8):
            split = _tf32_terms(xp[it, :, k8], terms)
            for t, part in enumerate(reversed(split)):
                ch = {4: t + 2 * (k8 % 2), 2: t, 1: 0}[chains] if terms == 2 else 0
                prod = torch.einsum("bpk,bpd->bkd", onehot[it, :, k8], part.double())
                acc[ch] = (acc[ch].double() + prod).float()
    total = acc[0]
    for ch in range(1, 4):
        total = total + acc[ch]
    lanes = torch.zeros((32, k, d))
    for b in range(blocks):
        lanes[b % 32] = lanes[b % 32] + total[b]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[torch.arange(32) ^ off]
    return lanes[0], torch.bincount(assign, minlength=k).to(torch.int32), sse


def test_tf32_hi_lo_split_keeps_22_bits():
    """hi + lo (each TF32 by round to nearest) lie within 2^-22 of x over
    normal values of every scale the sums meet, and are x itself for the
    integers of the exact checks; hi alone keeps only ~11 bits."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000) *
                          10.0 ** rng.uniform(-6, 6, 100_000)).astype(np.float32))
    hi, lo = _tf32_terms(x, 2)
    err = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -22
    assert float(((hi.double() - x.double()).abs() / x.double().abs()).max()) > 2.0 ** -13
    ints = torch.arange(-2, 3, dtype=torch.float32)
    assert torch.equal(_tf32_terms(ints, 2)[0], ints)


@pytest.mark.parametrize("n,d,k", [(5000, 50, 16), (1001, 13, 5), (3000, 100, 64)])
def test_kmeans_tc_emulation_is_exact_on_integer_inputs(n, d, k):
    x, c = _km_inputs(n + d, n, d, k, integer=True)
    sums, counts, sse = _kmeans_tc_emulation(x, c)
    want = tkm.kmeans_assign_plain(torch.from_numpy(x), torch.from_numpy(c))
    assert torch.equal(sums, want[0]) and torch.equal(counts, want[1])
    assert torch.equal(sse, want[2])


@pytest.mark.parametrize("n,d,k", [(20_000, 50, 16), (1007, 13, 5)])
def test_kmeans_tc_emulation_meets_the_card_tolerance(n, d, k):
    x, c = _km_inputs(n, n, d, k, integer=False)
    # drop the points whose two best centroids score within 1e-4, as the card checks do
    half = x.astype(np.float64) @ c.T.astype(np.float64) - 0.5 * (c.astype(np.float64) ** 2).sum(1)
    top2 = np.sort(half, axis=1)[:, -2:]
    x = np.ascontiguousarray(x[(top2[:, 1] - top2[:, 0]) >= 1e-4])
    want, counts, want_sse = tkm.kmeans_assign_plain(torch.from_numpy(x), torch.from_numpy(c))
    got, got_counts, got_sse = _kmeans_tc_emulation(x, c)
    assert torch.equal(got_counts, counts)
    torch.testing.assert_close(got_sse, want_sse, rtol=1e-5, atol=0.0)
    # the card's check of the sums: rtol 1e-5 against the largest sum
    atol = 1e-5 * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
    # control: one TF32 term keeps 11 bits of each point
    single = _kmeans_tc_emulation(x, c, terms=1)[0]
    with pytest.raises(AssertionError):
        torch.testing.assert_close(single, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("d,k", [(256, 64), (50, 16)])
def test_kmeans_tc_emulation_fresh_steps_keep_the_sse_on_far_data(d, k):
    """The narrow route's scores on run_kmeans's own fills (points ~5
    sqrt(d) from the origin), centroids drawn from the points plus 0.3
    N(0, 1), each product's add cut toward zero: an accumulator carried
    through all ceil(d / 8) steps leaves the card's sse tolerance (rtol
    1e-5 of the plain version's); a fresh one per step stays within."""
    rng = np.random.default_rng(0)
    n = 1500
    x = _np_fill_fragment(0, n, d).astype(np.float32)
    c = (x[rng.choice(n, k, replace=False)] + 0.3 * rng.standard_normal((k, d))).astype(np.float32)
    want = float(tkm.kmeans_assign_plain(torch.from_numpy(x), torch.from_numpy(c))[2])
    fresh = float(_kmeans_tc_emulation(x, c, scores="fresh", cut=True)[2])
    carried = float(_kmeans_tc_emulation(x, c, scores="carried", cut=True)[2])
    assert abs(fresh - want) <= 1e-5 * want
    assert abs(carried - want) > 1e-5 * want


@pytest.mark.parametrize("integer", [True, False])
def test_kmeans_tc_emulation_matches_pallas(integer):
    x, c = _km_inputs(21, 300, 16, 8, integer=integer)
    if not integer:
        half = x.astype(np.float64) @ c.T.astype(np.float64) \
            - 0.5 * (c.astype(np.float64) ** 2).sum(1)
        top2 = np.sort(half, axis=1)[:, -2:]
        x = np.ascontiguousarray(x[(top2[:, 1] - top2[:, 0]) >= 1e-4])
    sums, counts, _ = _kmeans_tc_emulation(x, c, sms=2)
    pal = _pallas_km(x, c)
    np.testing.assert_array_equal(counts.numpy(), pal[1])
    if integer:
        np.testing.assert_array_equal(sums.numpy(), pal[0])
    else:
        # fp32 sums of ~40 points: rtol 1e-5 against the largest sum
        np.testing.assert_allclose(sums.numpy(), pal[0], rtol=1e-5,
                                   atol=1e-5 * np.abs(pal[0]).max())


@pytest.mark.parametrize("k,d", [(16, 50), (5, 13), (64, 100), (1, 1), (64, 256), (16, 74),
                                 (32, 200)])
def test_kmeans_blocks_fit_in_shared_memory(k, d):
    """Every k <= 64 and d <= 256 fits a block; tiles hold 256 points while
    two blocks fit an SM (the path's d 50 among them), else fewer, down to
    32 (where one block may fill the SM)."""
    T = tkm.tile_points(k, d)
    assert 32 <= T <= 256 and T % 32 == 0
    two_blocks = 233472   # one SM's shared memory, 1 KB of it reserved per block
    assert tkm.smem_bytes(k, d) <= SMEM_LIMIT
    assert T == 32 or 2 * (tkm.smem_bytes(k, d) + 1024) <= two_blocks
    assert T == 256 or 2 * (tkm.smem_bytes(k, d, 2 * T) + 1024) > two_blocks
    if (k, d) == (16, 50):
        assert T == 256 and tkm.mma_chains(k, d) == 4


# ------------------------------------------------ ssd_scan on the tensor cores
def _ssd_tc_emulation(x, dt, A, Bm, Cm, split=True):
    """ssd_scan's bf16 route as the kernel computes it, in fp32: chunks of
    CHUNK steps; cs added in step order; y = exp(cs) o (C . state^T)
    + M . X with M = (C . B^T) o exp(cs_i - cs_j) o dt below the diagonal;
    state = exp(cs_last) state + (X o exp(cs_last - cs) dt)^T . B.  Each
    fp32 operand (the state, M, the scaled x) enters as bf16 hi + lo (or
    hi alone where not ``split``), one product per term, lo first."""
    b, s, h, p = x.shape
    q = tssd.CHUNK
    pad = (-s) % q

    def terms(v):
        hi = v.to(torch.bfloat16).float()
        return [(v - hi).to(torch.bfloat16).float(), hi] if split else [hi]

    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    Bf = torch.nn.functional.pad(Bm.float(), (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(Cm.float(), (0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    state = torch.zeros((b, h, p, Bm.shape[-1]))
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool))
    ys = []
    for t0 in range(0, s + pad, q):
        X = xf[:, t0:t0 + q].permute(0, 2, 1, 3)                # (b, h, q, p)
        Bc, Cc = Bf[:, t0:t0 + q], Cf[:, t0:t0 + q]             # (b, q, n)
        dtc = dtf[:, t0:t0 + q].permute(0, 2, 1)                # (b, h, q)
        da = dtc * A.float()[None, :, None]
        cs = torch.zeros_like(da)
        run = torch.zeros_like(da[..., 0])
        for t in range(q):                                      # in step order, fp32
            run = run + da[..., t]
            cs[..., t] = run
        y = sum(torch.einsum("bqn,bhpn->bhqp", Cc, t) for t in terms(state))
        y = y * torch.exp(cs)[..., None]
        G = torch.einsum("bin,bjn->bij", Cc, Bc)[:, None]       # (b, 1, q, q)
        L = torch.exp(cs[..., :, None] - cs[..., None, :])
        M = torch.where(tril, G * L * dtc[..., None, :], torch.zeros(()))
        y = y + sum(t @ X for t in terms(M))
        ys.append(y)
        w = torch.exp(cs[..., -1:] - cs) * dtc
        state = state * torch.exp(cs[..., -1])[..., None, None] + sum(
            torch.einsum("bhqp,bqn->bhpn", t, Bc) for t in terms(X * w[..., None]))
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)[:, :s]
    return y, state


def _ssd_card_inputs(B, S, H, P, N, seed, dt=None):
    """The card checks' inputs: x, B and C as bf16 views into one packed
    tensor, dt = softplus(normal) unless given, A = -linspace(1, 16, H)."""
    rng = np.random.default_rng(seed)
    packed = torch.from_numpy(rng.standard_normal((B, S, H * P + 2 * N)).astype(np.float32))
    packed = packed.to(torch.bfloat16)
    if dt is None:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    return (packed[..., :H * P].reshape(B, S, H, P), torch.from_numpy(dt.astype(np.float32)),
            -torch.linspace(1.0, 16.0, H), packed[..., H * P:H * P + N], packed[..., H * P + N:])


def _close_ssd(got, want):
    """The card's check of the SSD kernel: rtol 1e-4, atol 1e-4 of the
    largest value."""
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def _extreme_dt(H):
    rng = np.random.default_rng(5)
    near = np.where(np.arange(H) % 2 == 0, 1e-3, 20.0)
    dt = rng.uniform(0.0, 1.0, (2, 300, H)) * near
    return np.where(np.arange(H) % 2 == 0, dt, np.maximum(dt, 5.0))


# the card checks' cases: S 543, the extreme decays (dt < 1e-3 and
# 5..20 in alternate heads), P 40 / N 100 (padded to the tiles)
SSD_TC_CASES = {"S 543": (2, 543, 8, 64, 128, None), "extreme decays": (2, 300, 8, 64, 128, "x"),
                "P 40, N 100": (2, 77, 3, 40, 100, None)}


@pytest.mark.parametrize("case", list(SSD_TC_CASES))
def test_ssd_chunked_bf16_emulation_meets_the_card_tolerance(case):
    B, S, H, P, N, dt = SSD_TC_CASES[case]
    args = _ssd_card_inputs(B, S, H, P, N, seed=S + P, dt=_extreme_dt(H) if dt else None)
    want_y, want_st = tssd.ssd_scan_plain(*args, chunk=256 if S > 256 else 32)
    y, st = _ssd_tc_emulation(*args)
    _close_ssd(y, want_y)
    _close_ssd(st, want_st)
    # control: one bf16 term for the state, M and the scaled x
    y1, st1 = _ssd_tc_emulation(*args, split=False)
    with pytest.raises(AssertionError):
        _close_ssd(y1, want_y)
        _close_ssd(st1, want_st)


def test_ssd_chunked_bf16_emulation_matches_pallas():
    """Against the Pallas kernel in interpret mode on the same bf16-exact
    values (fp32 arrays there), at a small size with a ragged last chunk."""
    x, dt, A, Bm, Cm = _ssd_card_inputs(1, 70, 2, 16, 32, seed=3)
    y, _ = _ssd_tc_emulation(x, dt, A, Bm, Cm)
    pal = pallas_ssd(*(jnp.asarray(t.float().contiguous().numpy()) for t in (x, dt, A, Bm, Cm)),
                     chunk=35, interpret=True)
    _close_ssd(y, torch.from_numpy(np.array(pal, dtype=np.float32)))


@pytest.mark.parametrize("P,N", [(64, 128), (128, 128), (40, 100), (8, 16), (16, 16), (1, 1),
                                 (128, 17)])
def test_ssd_blocks_fit_in_shared_memory(P, N):
    """Every P, N <= 128 fits, at least three blocks per SM at the serve
    path's P 64, N 128; tile rows are 16-byte multiples (cp.async, ldmatrix)."""
    assert tssd.smem_bytes(P, N) <= SMEM_LIMIT
    if (P, N) == (64, 128):
        assert 3 * (tssd.smem_bytes(P, N) + 1024) <= 233472
    pp = 16 * -(-P // 16)
    assert (pp + 8) * 2 % 16 == 0 and (tssd.CHUNK + 8) * 2 % 16 == 0


# ------------------------------------------- the wide routes (any k and d)
@pytest.mark.parametrize("k,d,want", [(64, 256, "tensor_cores"), (65, 256, "wide"),
                                      (64, 257, "wide"), (65, 50, "wide"), (16, 257, "wide"),
                                      (16, 50, "tensor_cores"), (1, 1, "tensor_cores"),
                                      (1000, 300, "wide"), (100, 384, "wide")])
def test_kmeans_route_by_shape(k, d, want):
    """The tensor-core route holds k <= 64 and d <= 256; every other shape
    takes the depth-streamed wide route, chosen before launch, whose pass
    covers k in 16-centroid tiles (k 65: 80 columns, not 128)."""
    assert tkm.route(k, d) == want
    if want == "wide":
        assert tkm.wide_pass(k) == min(128, -(-k // 16) * 16)
    assert tkm.wide_ring_bytes(65) == 3 * ((128 + 80) * 36 + 80) * 4


@pytest.mark.parametrize("k,d,want", [(32, 64, "tensor_cores"), (33, 64, "wide"),
                                      (32, 65, "wide"), (5, 64, "tensor_cores"), (5, 65, "wide"),
                                      (32, 272, "wide"), (33, 272, "wide"),
                                      (32, 273, "wide"), (33, 50, "wide"), (5, 273, "wide"),
                                      (5, 50, "tensor_cores"), (1, 1, "tensor_cores"),
                                      (257, 1024, "wide"), (50, 384, "wide")])
def test_knn_route_by_shape(k, d, want):
    """The tensor-core route holds k <= 32 (its merge's register lists)
    and d up to 64 (its A fragments stay in registers), where it is the
    faster; every other shape takes the depth-streamed wide route, whose
    shared memory does not depend on d."""
    assert tknn.route(k, d) == want
    if want == "tensor_cores":
        assert tknn.smem_bytes(d, k) <= SMEM_LIMIT and tknn.list_length(k) >= k
    assert tknn.smem_bytes(tknn.MAX_D, tknn.MAX_K) <= SMEM_LIMIT
    assert tknn.wide_smem(k)[0] <= SMEM_LIMIT


@pytest.mark.parametrize("n", [1, 1000, 100_003, 500_000])
@pytest.mark.parametrize("k,d", [(65, 50), (16, 257), (1000, 300), (65, 1), (1, 5000),
                                 (4096, 1024), (100_000, 64)])
def test_kmeans_wide_route_has_bounded_scratch(n, k, d):
    """The wide route's ring does not depend on d; a block fits the SM's
    shared memory for every k and d (its partials there only where they
    fit); the partials stay within 2^22 floats unless one alone is larger
    (then there is one block); no block is without a tile."""
    smem, shared = tkm.wide_smem(k, d)
    assert smem <= SMEM_LIMIT
    # beside the partials (where they fit), nothing depends on d
    assert smem - shared * 4 * (k * d + k) == tkm.wide_ring_bytes(k) + 128 * 8 + 272 * 4
    assert shared or tkm.wide_ring_bytes(k) + 128 * 8 + 272 * 4 + 4 * (k * d + k) > SMEM_LIMIT
    blocks = tkm.wide_blocks(n, k, d, sms=132)
    per_block = k * d + k + 1
    assert 1 <= blocks <= -(-n // 128) and blocks <= tkm.wide_blocks_per_sm(k) * 132
    assert blocks * per_block <= max(tkm.WIDE_SCRATCH_FLOATS, per_block)


@pytest.mark.parametrize("m", [1, 300, 12_500, 100_000])
@pytest.mark.parametrize("k,d", [(33, 50), (257, 50), (5, 273), (40, 1024), (5000, 3)])
def test_knn_wide_route_has_bounded_scratch(m, k, d):
    """The wide route's shared memory depends on k alone (the lists where
    128 x k keys fit beside the ring and buffers, k <= 85); its splits
    cover the training rows once in whole tiles of at least 64 tiles each
    (one split where n is smaller), and the splits' lists stay within
    2^24 keys unless one split alone is larger."""
    smem, shared = tknn.wide_smem(k)
    assert smem <= SMEM_LIMIT and shared == (k <= 85)
    assert smem == tknn.WIDE_RING_BYTES + tknn.WIDE_BUF_BYTES + shared * 128 * k * 8
    for n in (k, 10 * k + 77, 125_000):
        splits, chunk = tknn.wide_partition(m, n, k, sms=132)
        assert chunk % tknn.WIDE_TILE == 0 and 1 <= splits <= tknn.WIDE_MAX_SPLITS
        assert (splits - 1) * chunk < n <= splits * chunk
        assert splits * m * k <= max(tknn.WIDE_SCRATCH_KEYS, m * k)
        assert splits == 1 or chunk >= tknn.WIDE_MIN_TILES * tknn.WIDE_TILE
    # one KNN_frag task at k 33: four splits fill 3 waves of 132 SMs
    assert tknn.wide_partition(12_500, 125_000, 33, sms=132)[0] == 4


def _ordered_bits(f):
    """csrc/knn_topk.cu :: ordered_bits: fp32 bits that order as the values."""
    u = np.ascontiguousarray(f, dtype=np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _from_ordered_bits(u):
    u = np.asarray(u, dtype=np.uint32)
    return np.where(u & np.uint32(0x80000000), u & np.uint32(0x7FFFFFFF), ~u) \
        .astype(np.uint32).view(np.float32)


def test_ordered_bits_order_as_the_floats_and_invert():
    rng = np.random.default_rng(0)
    f = np.concatenate([(rng.standard_normal(10_000) * 10.0 ** rng.uniform(-30, 30, 10_000)),
                        [0.0, 1e-45, -1e-45, 3e38, -3e38, 1.0, -1.0]]).astype(np.float32)
    u = _ordered_bits(f)
    order = np.argsort(f, kind="stable")
    assert np.all(np.diff(u[order].astype(np.int64)) >= 0)
    np.testing.assert_array_equal(_from_ordered_bits(u).view(np.uint32), f.view(np.uint32))


_NONE = np.uint64(2 ** 64 - 1)


def _place_merge(a, b, k):
    """The k smallest of two ascending key lists by the kernels' place rule
    (merge_row, knn_wide_merge): a_i goes to i + (b's keys below it), b_j
    to j + (a's keys below it), and the places below k are kept."""
    out = np.full(k, _NONE)
    to_a = np.arange(a.size) + np.searchsorted(b, a, side="left")
    to_b = np.arange(b.size) + np.searchsorted(a, b, side="left")
    out[to_a[to_a < k]] = a[to_a < k]
    out[to_b[to_b < k]] = b[to_b < k]
    return out


def _knn_wide_emulation(test, train, labels, k, chunk, buf_keys=32):
    """knn_topk's wide route as csrc/knn_topk.cu selects (the distances
    here from the plain version's formula): per split of ``chunk``
    training rows and warp of 16 test rows, tiles of 128 columns walked
    one n8 tile at a time; a distance at or below its row's threshold
    (the k-th key's distance, inf until the list is full) is appended to
    the row's buffer, and when a row holds more than buf_keys - 8 after a
    tile, or the split ends, every buffered row of the warp is merged into
    its list; then the splits' lists are merged in split order."""
    x, y = torch.from_numpy(test), torch.from_numpy(train)
    d2 = (((x * x).sum(1)[:, None] - 2.0 * (x @ y.T)) + (y * y).sum(1)[None, :]).numpy()
    m, n = d2.shape
    keys = (_ordered_bits(d2).astype(np.uint64) << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    parts = []
    for n0 in range(0, n, chunk):
        n1 = min(n, n0 + chunk)
        lists = np.full((m, k), _NONE)
        for w0 in range(0, m, 16):
            rows = list(range(w0, min(m, w0 + 16)))
            thr = np.full(m, np.inf, dtype=np.float32)
            buf = {r: [] for r in rows}

            def flush():
                for r in rows:
                    if buf[r]:
                        lists[r] = _place_merge(lists[r], np.sort(np.array(buf[r])), k)
                        buf[r] = []
                        kth = lists[r, k - 1]
                        thr[r] = np.inf if kth == _NONE else \
                            _from_ordered_bits(np.uint32(kth >> np.uint64(32)))
            for c0 in range(n0, n1, 8):          # n8 tiles of the 128-row tiles
                cols = np.arange(c0, min(n1, c0 + 8))
                passed = False
                for r in rows:
                    hit = cols[d2[r, cols] <= thr[r]]
                    buf[r].extend(keys[r, hit])
                    passed |= hit.size > 0
                if passed and max(len(buf[r]) for r in rows) > buf_keys - 8:
                    flush()
            flush()
        parts.append(lists)
    best = parts[0]
    for lists in parts[1:]:
        best = np.stack([_place_merge(a, b, k) for a, b in zip(best, lists)])
    dist = _from_ordered_bits((best >> np.uint64(32)).astype(np.uint32))
    return dist, labels[(best & np.uint64(0xFFFFFFFF)).astype(np.int64)]


@pytest.mark.parametrize("m,n,d,k,chunk", [(40, 300, 16, 33, 128), (30, 500, 9, 100, 256),
                                           (20, 300, 5, 257, 128), (25, 400, 12, 400, 256)])
def test_knn_wide_selection_emulation_is_exact_on_integer_inputs(m, n, d, k, chunk):
    """Integer inputs with duplicated rows (ties everywhere): the
    threshold, buffers, flushes, merges and the split merge give the plain
    version's distances and labels bit for bit, at k 33, 100, 257 and
    k = n_train, over two to three splits."""
    test, train, labels = _knn_inputs(m + k, m, n, d, integer=True)
    got_d, got_l = _knn_wide_emulation(test, train, labels, k, chunk)
    want_d, want_l = tknn.knn_topk_plain(torch.from_numpy(test), torch.from_numpy(train),
                                         torch.from_numpy(labels), k)
    np.testing.assert_array_equal(got_d, want_d.numpy())
    np.testing.assert_array_equal(got_l, want_l.numpy())


def test_knn_wide_selection_emulation_matches_pallas_on_random_inputs():
    test, train, labels = _knn_inputs(17, 40, 300, 16, integer=False)
    got_d, got_l = _knn_wide_emulation(test, train, labels, 33, 128)
    pal_d, pal_l = _pallas_knn(test, train, labels, 33)
    # fp32 distances from two summation orders: rtol 1e-5, atol 1e-3
    np.testing.assert_allclose(got_d, pal_d, rtol=1e-5, atol=1e-3)
    assert (got_l == pal_l).mean() > 0.98


def _toward_zero(v):
    """fp64 -> fp32, cut toward zero (how an mma's sum is rounded)."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _stream_3xtf32(a, b, three_products=True, cut=False, fresh_steps=True):
    """a (m, d) . b (n, d)^T as repro::mma_slice_3xtf32 forms it: per
    8-deep step the products x_lo y_hi, x_hi y_lo, x_hi y_hi of TF32
    operands (cvt.rna), each added with one rounding (the 8 products of a
    step are exact in fp64) into a fresh step accumulator, which an fp32
    add carries into the running one.  ``cut`` models the tensor cores'
    rounding toward zero of each product's add (no guard bits: a bound
    on the card's drift); without ``fresh_steps`` the products go
    straight into the running accumulator."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    terms = ((al, bh), (ah, bl), (ah, bh)) if three_products else ((ah, bh),)
    rnd = _toward_zero if cut else (lambda v: v.astype(np.float32))
    acc = np.zeros((a.shape[0], b.shape[0]), dtype=np.float32)
    for j in range(0, a.shape[1], 8):
        step = np.zeros_like(acc) if fresh_steps else acc
        for p, q in terms:
            prod = p[:, j:j + 8].astype(np.float64) @ q[:, j:j + 8].T.astype(np.float64)
            step = rnd(step.astype(np.float64) + prod)
        acc = (acc + step).astype(np.float32) if fresh_steps else step
    return acc


def test_depth_streamed_3xtf32_fresh_steps_keep_the_sse_on_far_data():
    """Points ~80 from the origin at d 384 (the K-means fragments of
    phase wide): with each product's add cut toward zero, an accumulator
    carried through all 48 steps drifts and the sse leaves rtol 1e-5;
    a fresh accumulator per step keeps it within."""
    rng = np.random.default_rng(0)
    d, k, n = 384, 100, 1500
    x = _np_fill_fragment(0, n, d).astype(np.float32)
    c = (x[rng.choice(n, k, replace=False)] + 0.3 * rng.standard_normal((k, d))).astype(np.float32)
    h = (0.5 * (c.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    q = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)

    def sse(cross):
        best = (cross - h[None, :]).astype(np.float32).max(1)
        return float((q - 2 * best).astype(np.float64).sum())

    want = sse((x.astype(np.float64) @ c.T.astype(np.float64)).astype(np.float32))
    fresh = sse(_stream_3xtf32(x, c, cut=True))
    carried = sse(_stream_3xtf32(x, c, cut=True, fresh_steps=False))
    assert abs(fresh - want) <= 1e-5 * want
    assert abs(carried - want) > 1e-5 * want


def test_knn_far_data_fresh_steps_stay_within_the_plain_versions_error():
    """Points ~40 from the origin at d 64 (run_kmeans's fills, the narrow
    knn route's widest): the plain fp32 distances themselves lie past
    atol 1e-3 of the float64 ones.  With each product's add cut toward
    zero, the fresh-step 3xTF32 product stays no further from them than
    the plain fp32 version; an accumulator carried through the 8 steps
    does not (what the card's far check holds)."""
    m, n, d, k = 200, 10_000, 64, 32
    pts = _np_fill_fragment(0, m + n, d).astype(np.float32)
    test, train = pts[:m], pts[m:]
    x64, y64 = test.astype(np.float64), train.astype(np.float64)
    exact = ((x64 ** 2).sum(1)[:, None] - 2.0 * x64 @ y64.T) + (y64 ** 2).sum(1)[None, :]
    near = np.argpartition(exact, k, axis=1)[:, :k]      # the k nearest, any order
    x, y = torch.from_numpy(test), torch.from_numpy(train)
    xsq, ysq = (x * x).sum(1)[:, None].numpy(), (y * y).sum(1)[None, :].numpy()

    def err(cross):
        d2 = ((xsq - 2.0 * cross).astype(np.float32) + ysq).astype(np.float32)
        return np.abs(np.take_along_axis(d2, near, 1) - np.take_along_axis(exact, near, 1)).max()

    plain = err((x @ y.T).numpy())
    assert plain > 1e-3
    assert err(_stream_3xtf32(test, train, cut=True)) <= plain
    assert err(_stream_3xtf32(test, train, cut=True, fresh_steps=False)) > plain


@pytest.mark.parametrize("d", [273, 300, 1024])
def test_knn_depth_streamed_3xtf32_meets_the_card_tolerance(d):
    """The wide route's distances from the depth-streamed 3xTF32 product
    lie within the card's tolerance of the plain version's at depths past
    the tensor-core route; one TF32 product does not."""
    test, train, labels = _knn_inputs(d, 64, 500, d, integer=False)
    want_d, _ = tknn.knn_topk_plain(torch.from_numpy(test), torch.from_numpy(train),
                                    torch.from_numpy(labels), 5)
    x, y = torch.from_numpy(test), torch.from_numpy(train)
    xsq, ysq = (x * x).sum(1)[:, None], (y * y).sum(1)[None, :]

    def top(cross):
        return torch.sort((xsq - 2.0 * torch.from_numpy(cross)) + ysq, dim=1).values[:, :5]
    # the card's check of the kernel's distances: rtol 1e-5, atol 1e-3
    torch.testing.assert_close(top(_stream_3xtf32(test, train)), want_d, rtol=1e-5, atol=1e-3)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(top(_stream_3xtf32(test, train, three_products=False)),
                                   want_d, rtol=1e-5, atol=1e-3)


def _kmeans_wide_sums(x, assign, k, blocks, sort_segments=True):
    """The wide route's per-block partial sums (tiles b, b + blocks, ...
    of 128 points): with sort_segments, each tile's points sorted by the
    key cluster << 7 | point and each cluster's segment added in point
    order into a running sum that starts from the partial (the kernel's
    way); else every point added to its cluster in point order."""
    n, d = x.shape
    part = np.zeros((blocks, k, d), dtype=np.float32)
    for t in range(-(-n // 128)):
        b, idx = t % blocks, np.arange(128 * t, min(n, 128 * t + 128))
        if not sort_segments:
            for p in idx:
                part[b, assign[p]] += x[p]
            continue
        order = np.sort((assign[idx].astype(np.int64) << 7) | (idx - 128 * t))
        cl, pt = order >> 7, 128 * t + (order & 127)
        starts = np.flatnonzero(np.r_[True, cl[1:] != cl[:-1]])
        for s0, s1 in zip(starts, np.r_[starts[1:], cl.size]):
            acc = part[b, cl[s0]].copy()
            for p in pt[s0:s1]:
                acc += x[p]
            part[b, cl[s0]] = acc
    return part


def _kmeans_wide_emulation(x, c, sms=2):
    """kmeans_assign's wide route: the assignment from 3xTF32 scores, the
    sums from the sorted segments per block, the block partials reduced by
    32 lanes striding over the blocks and a shuffle tree."""
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    (n, d), k = x.shape, c.shape[0]
    half = torch.from_numpy(_stream_3xtf32(x, c)) - 0.5 * (ct * ct).sum(1)
    assign = torch.argmax(half, dim=1)        # the first index on ties
    sse = ((xt * xt).sum(1) - 2.0 * half.amax(1)).sum()
    blocks = tkm.wide_blocks(n, k, d, sms)
    part = torch.from_numpy(_kmeans_wide_sums(x, assign.numpy(), k, blocks))
    lanes = torch.zeros((32, k, d))
    for b in range(blocks):
        lanes[b % 32] = lanes[b % 32] + part[b]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[torch.arange(32) ^ off]
    return lanes[0], torch.bincount(assign, minlength=k).to(torch.int32), sse


@pytest.mark.parametrize("n,d,k", [(3000, 13, 300), (1001, 5, 65), (700, 40, 7)])
def test_kmeans_sorted_segment_sums_equal_the_in_order_sums(n, d, k):
    """The cluster-sorted segments, each added in point order, give every
    block partial of the in-order sums bit for bit, on random inputs."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, d)).astype(np.float32)
    assign = rng.integers(0, k, size=n)
    got = _kmeans_wide_sums(x, assign, k, blocks=3)
    want = _kmeans_wide_sums(x, assign, k, blocks=3, sort_segments=False)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n,d,k", [(2000, 50, 65), (700, 257, 16), (1500, 20, 200)])
def test_kmeans_wide_emulation_is_exact_on_integer_inputs(n, d, k):
    x, c = _km_inputs(n + d, n, d, k, integer=True)
    sums, counts, sse = _kmeans_wide_emulation(x, c)
    want = tkm.kmeans_assign_plain(torch.from_numpy(x), torch.from_numpy(c))
    assert torch.equal(sums, want[0]) and torch.equal(counts, want[1])
    assert torch.equal(sse, want[2])


@pytest.mark.parametrize("n,d,k", [(5000, 50, 65), (1000, 257, 16)])
def test_kmeans_wide_emulation_meets_the_card_tolerance(n, d, k):
    x, c = _km_inputs(n, n, d, k, integer=False)
    # drop the points whose two best centroids score within 1e-4, as the card checks do
    half = x.astype(np.float64) @ c.T.astype(np.float64) - 0.5 * (c.astype(np.float64) ** 2).sum(1)
    top2 = np.sort(half, axis=1)[:, -2:]
    x = np.ascontiguousarray(x[(top2[:, 1] - top2[:, 0]) >= 1e-4])
    want, counts, want_sse = tkm.kmeans_assign_plain(torch.from_numpy(x), torch.from_numpy(c))
    got, got_counts, got_sse = _kmeans_wide_emulation(x, c)
    assert torch.equal(got_counts, counts)
    torch.testing.assert_close(got_sse, want_sse, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


# the oracle of the wide routes, anchored to the Pallas kernels in
# interpret mode at the shapes that select them
@pytest.mark.parametrize("n,d,k", [(300, 50, 65), (200, 257, 16)])
def test_kmeans_assign_plain_matches_pallas_at_wide_shapes(n, d, k):
    assert tkm.route(k, d) == "wide"
    x, c = _km_inputs(n + k, n, d, k, integer=True)
    got, pal = _port_km(x, c), _pallas_km(x, c)
    np.testing.assert_array_equal(got[0], pal[0])
    np.testing.assert_array_equal(got[1], pal[1])
    assert got[2] == pal[2]
    x, c = _km_inputs(n + d, n, d, k, integer=False)
    got, pal = _port_km(x, c), _pallas_km(x, c)
    half = x.astype(np.float64) @ c.T.astype(np.float64) - 0.5 * (c.astype(np.float64) ** 2).sum(1)
    top2 = np.sort(half, axis=1)[:, -2:]
    if np.all(top2[:, 1] - top2[:, 0] >= 1e-4):
        np.testing.assert_array_equal(got[1], pal[1])
    np.testing.assert_allclose(got[0], pal[0], rtol=1e-5, atol=1e-5 * np.abs(pal[0]).max())
    assert got[2] == pytest.approx(pal[2], rel=1e-5)


@pytest.mark.parametrize("m,n,d,k", [(40, 300, 273, 33), (30, 200, 50, 65), (20, 300, 300, 5)])
def test_knn_topk_plain_matches_pallas_at_wide_shapes(m, n, d, k):
    assert tknn.route(k, d) == "wide"
    test, train, labels = _knn_inputs(m + d, m, n, d, integer=True)
    got_d, got_l = _port_knn(test, train, labels, k)
    pal_d, pal_l = _pallas_knn(test, train, labels, k)
    np.testing.assert_array_equal(got_d, pal_d)
    np.testing.assert_array_equal(got_l, pal_l)


# --------------------------------------- rmsnorm: short rows packed per warp
def _fma32(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _rmsnorm_layout_emulation(x, scale, itemsize, vec, eps=1e-6, segmented=True):
    """csrc/rmsnorm.cu's arithmetic, lane by lane, in float32: warp w's lane
    l serves row w * (32 / LPR) + l / LPR and its units (16-byte packs,
    or elements off the packs) q = l % LPR + i * LPR, i < PPL; it sums the
    squares of its units in order (fmaf), then a butterfly adds lanes at
    offsets below LPR (all offsets from 16 where not ``segmented``).
    Checks that every lane of a row ends with one sum and that every
    element is written once; returns y in float32."""
    rows, d = x.shape
    lpr, ppl, _ = trms.layout(d, itemsize, vec)
    unit = 16 // itemsize if vec else 1
    units = d // unit
    lane = np.arange(32)
    row = np.arange(-(-rows // (32 // lpr)))[:, None] * (32 // lpr) + lane // lpr   # (warps, 32)
    ok = row < rows
    xr = x[np.minimum(row, rows - 1)]                                         # (warps, 32, d)
    ss = np.zeros(row.shape, np.float32)
    for i in range(ppl):
        q = lane % lpr + i * lpr
        has = ok & (q < units)
        for e in range(unit):
            col = np.minimum(q * unit + e, d - 1)
            f = xr[:, lane, col]
            ss = np.where(has, _fma32(f, f, ss), ss)
    o = (lpr if segmented else 32) // 2
    while o > 0:
        ss = ss + ss[:, lane ^ o]
        o //= 2
    for r in range(rows):
        assert np.unique(ss[row == r]).size == 1, "the lanes of a row disagree"
    inv = np.float32(1.0) / np.sqrt(ss / np.float32(d) + np.float32(eps))
    y = np.zeros((rows, d), np.float32)
    written = np.zeros((rows, d), np.int64)
    for i in range(ppl):
        q = lane % lpr + i * lpr
        has = ok & (q < units)
        for e in range(unit):
            col = np.broadcast_to(np.minimum(q * unit + e, d - 1), row.shape)
            vals = (xr[:, lane, col[0]] * inv) * scale[col]
            y[row[has], col[has]] = vals[has]
            written[row[has], col[has]] += 1
    assert np.all(written == 1), "an element is written other than once"
    return y


def _close_in_dtype(got, want):
    """The card's check of a kernel against its plain version
    (chip_smoke.py :: close_in_dtype)."""
    if got.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_STEP, atol=1e-5)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("d", [64, 37, 100, 1024, 6144])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_packed_layout_emulation(d, dtype):
    """At 64 (4 bf16 or 2 fp32 rows per warp), 37 (off the packs), 100
    (fp32: 25 packs; bf16: off the packs), 1024 (packs in registers) and
    6144 (past them: two passes), against the plain version and the
    Pallas kernel in interpret mode."""
    rows = 13 if d <= 1024 else 3
    rng = np.random.default_rng(d)
    xt = torch.from_numpy((rng.standard_normal((rows, d)) * 2).astype(np.float32)).to(dtype)
    st = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(dtype)
    x, scale = xt.float().numpy(), st.float().numpy()
    itemsize = xt.element_size()
    vec = d * itemsize % 16 == 0
    got = torch.from_numpy(_rmsnorm_layout_emulation(x, scale, itemsize, vec)).to(dtype)
    _close_in_dtype(got, trms.rmsnorm_plain(xt, st))
    pal = pallas_rmsnorm(jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                else jnp.float32),
                         jnp.asarray(scale).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                   else jnp.float32),
                         block_rows=8, interpret=True)
    _close_in_dtype(got, torch.from_numpy(np.array(pal, dtype=np.float32)).to(dtype))
    if vec and trms.layout(d, itemsize)[0] < 32:
        # control: a butterfly over the whole warp adds the rows that share it
        mixed = _rmsnorm_layout_emulation(x, scale, itemsize, vec, segmented=False)
        with pytest.raises(AssertionError):
            _close_in_dtype(torch.from_numpy(mixed).to(dtype), trms.rmsnorm_plain(xt, st))
