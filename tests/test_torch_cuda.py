"""The port's hand-written CUDA kernels on the card (marker ``gpu``).

Every test here needs a CUDA card and skips without one: a CUDA kernel
has no CPU mode.  The file imports only torch and the port — no JAX — so
it runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same
inputs: exactly on integer-valued inputs (every distance and dot product
is exact there, ties included), within stated tolerances on random
ones (bf16 results within one bf16 rounding step); two launches must
agree bitwise.  The pipelines and LM serving on the card must agree with
the same runs on the CPU.
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.algorithms import kmeans, knn  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import kmeans_assign as tkm  # noqa: E402
from repro_torch.kernels import knn_topk as tknn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan as trglru  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _to(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


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
    return test, train, rng.integers(0, 4, size=n).astype(np.int32)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("k", [1, 5, 16, 32])
def test_knn_topk_exact_on_integer_inputs(cuda, k):
    test, train, labels = _to(cuda, *_knn_inputs(k, 300, 1000, 50, integer=True))
    got = tknn.knn_topk_cuda(test, train, labels, k)
    assert _same(got, tknn.knn_topk_plain(test, train, labels, k))
    assert _same(got, tknn.knn_topk_cuda(test, train, labels, k))


@pytest.mark.parametrize("m,n,d,k", [(1037, 10013, 50, 5), (77, 5000, 13, 20), (129, 3, 50, 3),
                                     (300, 700, 140, 8), (5, 64, 1, 1),
                                     (12_500, 125_000, 50, 5)])   # one KNN_frag task
def test_knn_topk_close_on_random_inputs(cuda, m, n, d, k):
    test, train, labels = _to(cuda, *_knn_inputs(m + n, m, n, d, integer=False))
    got_d, _ = tknn.knn_topk_cuda(test, train, labels, k)
    want_d, _ = tknn.knn_topk_plain(test, train, labels, k)
    # fp32 distances from two summation orders: rtol 1e-5, atol 1e-3
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n,d,k", [(5000, 50, 16), (1001, 13, 5), (3000, 100, 64), (7, 3, 1)])
def test_kmeans_assign_exact_on_integer_inputs(cuda, n, d, k):
    rng = np.random.default_rng(n)
    x, c = _to(cuda, rng.integers(-2, 3, size=(n, d)).astype(np.float32),
               rng.integers(-2, 3, size=(k, d)).astype(np.float32))
    got = tkm.kmeans_assign_cuda(x, c)
    assert _same(got, tkm.kmeans_assign_plain(x, c))
    assert _same(got, tkm.kmeans_assign_cuda(x, c))


def test_kmeans_assign_close_on_random_inputs(cuda):
    rng = np.random.default_rng(3)
    x, c = _to(cuda, rng.standard_normal((100_003, 50)).astype(np.float32),
               rng.standard_normal((16, 50)).astype(np.float32))
    # drop points whose two best centroids score within 1e-4 of each other
    top2 = (x @ c.T - 0.5 * (c * c).sum(1)).topk(2, dim=1).values
    x = x[(top2[:, 0] - top2[:, 1]) >= 1e-4].contiguous()
    sums, counts, sse = tkm.kmeans_assign_cuda(x, c)
    psums, pcounts, psse = tkm.kmeans_assign_plain(x, c)
    assert torch.equal(counts, pcounts)
    # fp32 sums of ~6k points: rtol 1e-5 against the largest sum
    torch.testing.assert_close(sums, psums, rtol=1e-5, atol=1e-5 * psums.abs().max().item())
    torch.testing.assert_close(sse, psse, rtol=1e-5, atol=0.0)


def test_kmeans_assign_at_the_path_shape(cuda):
    """One partial_sum task of run_kmeans on 8M points: 500k x 50, k 16."""
    rng = np.random.default_rng(11)
    x, c = _to(cuda, rng.standard_normal((500_000, 50)).astype(np.float32),
               rng.standard_normal((16, 50)).astype(np.float32))
    top2 = (x @ c.T - 0.5 * (c * c).sum(1)).topk(2, dim=1).values
    x = x[(top2[:, 0] - top2[:, 1]) >= 1e-4].contiguous()
    got = tkm.kmeans_assign_cuda(x, c)
    assert _same(got, tkm.kmeans_assign_cuda(x, c))
    psums, pcounts, psse = tkm.kmeans_assign_plain(x, c)
    assert torch.equal(got[1], pcounts)
    torch.testing.assert_close(got[0], psums, rtol=1e-5, atol=1e-5 * psums.abs().max().item())
    torch.testing.assert_close(got[2], psse, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("n,d,k", [(5000, 50, 65), (3001, 257, 16), (20_000, 300, 1000)])
def test_kmeans_assign_wide_route_matches_plain(cuda, n, d, k):
    """Past the tensor-core route (k > 64 or d > 256) the wide route
    answers at the main route's tolerances: integer inputs bitwise,
    filtered random inputs with equal counts, sums and sse at rtol 1e-5;
    two launches bitwise equal."""
    assert tkm.route(k, d) == "wide"
    rng = np.random.default_rng(n + k)
    x, c = _to(cuda, rng.integers(-2, 3, size=(n, d)).astype(np.float32),
               rng.integers(-2, 3, size=(k, d)).astype(np.float32))
    assert _same(tkm.kmeans_assign_cuda(x, c), tkm.kmeans_assign_plain(x, c))
    x, c = _to(cuda, rng.standard_normal((n, d)).astype(np.float32),
               rng.standard_normal((k, d)).astype(np.float32))
    top2 = (x @ c.T - 0.5 * (c * c).sum(1)).topk(2, dim=1).values
    x = x[(top2[:, 0] - top2[:, 1]) >= 1e-4].contiguous()
    got = tkm.kmeans_assign_cuda(x, c)
    assert _same(got, tkm.kmeans_assign_cuda(x, c))
    psums, pcounts, psse = tkm.kmeans_assign_plain(x, c)
    assert torch.equal(got[1], pcounts)
    torch.testing.assert_close(got[0], psums, rtol=1e-5, atol=1e-5 * psums.abs().max().item())
    torch.testing.assert_close(got[2], psse, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("m,n,d,k", [(300, 1000, 50, 33), (300, 1000, 50, 100),
                                     (200, 5000, 20, 257), (300, 1000, 273, 5),
                                     (100, 700, 1024, 40), (70, 9000, 7, 1000),
                                     (100, 700, 1024, 257), (40, 300, 5, 300)])
def test_knn_topk_wide_route_exact_on_integer_inputs(cuda, m, n, d, k):
    """Past the tensor-core route (k > 32 or d > 272): the plain version's
    distances and labels bit for bit on tied integer inputs (the tie
    rule), and two launches bitwise equal."""
    assert tknn.route(k, d) == "wide"
    test, train, labels = _to(cuda, *_knn_inputs(m + k, m, n, d, integer=True))
    got = tknn.knn_topk_cuda(test, train, labels, k)
    assert _same(got, tknn.knn_topk_plain(test, train, labels, k))
    assert _same(got, tknn.knn_topk_cuda(test, train, labels, k))


@pytest.mark.parametrize("m,n,d,k", [(300, 9000, 20, 100), (200, 3000, 300, 5),
                                     (100, 5000, 1024, 33), (1000, 20_000, 50, 257)])
def test_knn_topk_wide_route_close_on_random_inputs(cuda, m, n, d, k):
    test, train, labels = _to(cuda, *_knn_inputs(m + n, m, n, d, integer=False))
    got_d, _ = tknn.knn_topk_cuda(test, train, labels, k)
    want_d, _ = tknn.knn_topk_plain(test, train, labels, k)
    # fp32 distances from two summation orders: rtol 1e-5, atol 1e-3
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("k,d", [(32, 50), (33, 50), (257, 50), (5, 64), (5, 65), (32, 64),
                                 (32, 65), (5, 272), (5, 273), (5, 1024)])
def test_knn_topk_at_the_route_edges(cuda, k, d):
    """One either side of each edge of the tensor-core route (k 32 | 33,
    d 64 | 65), either side of its shared memory's edge (d 272 | 273, both
    wide now) and far past them: tied integer inputs bitwise the plain
    version's, random inputs within rtol 1e-5 / atol 1e-3 with labels
    equal away from near-ties, two launches bitwise equal."""
    m, n = 300, 5000
    test, train, labels = _to(cuda, *_knn_inputs(k + d, m, n, d, integer=True))
    got = tknn.knn_topk_cuda(test, train, labels, k)
    assert _same(got, tknn.knn_topk_plain(test, train, labels, k))
    assert _same(got, tknn.knn_topk_cuda(test, train, labels, k))
    test, train, labels = _to(cuda, *_knn_inputs(k * d, m, n, d, integer=False))
    got = tknn.knn_topk_cuda(test, train, labels, k)
    assert _same(got, tknn.knn_topk_cuda(test, train, labels, k))
    want_d, want_l = tknn.knn_topk_plain(test, train, labels, k + 1)
    torch.testing.assert_close(got[0], want_d[:, :k], rtol=1e-5, atol=1e-3)
    sep = torch.ones((m, k + 2), dtype=torch.bool, device=cuda)
    sep[:, 1:k + 1] = (want_d[:, 1:] - want_d[:, :-1]) > 1e-3
    isolated = sep[:, :k] & sep[:, 1:k + 1]
    assert torch.equal(got[1][isolated], want_l[:, :k][isolated])


@pytest.mark.parametrize("k,d", [(64, 50), (65, 50), (1000, 50), (16, 256), (16, 257)])
def test_kmeans_assign_at_the_route_edges(cuda, k, d):
    """One either side of each edge of the tensor-core route (k 64 | 65,
    d 256 | 257) and far past them: integer inputs bitwise the plain
    version's; filtered random inputs with equal counts, sums and sse at
    rtol 1e-5; two launches bitwise equal."""
    rng = np.random.default_rng(k + d)
    n = 20_000
    x, c = _to(cuda, rng.integers(-2, 3, size=(n, d)).astype(np.float32),
               rng.integers(-2, 3, size=(k, d)).astype(np.float32))
    got = tkm.kmeans_assign_cuda(x, c)
    assert _same(got, tkm.kmeans_assign_plain(x, c))
    assert _same(got, tkm.kmeans_assign_cuda(x, c))
    x, c = _to(cuda, rng.standard_normal((n, d)).astype(np.float32),
               rng.standard_normal((k, d)).astype(np.float32))
    top2 = (x @ c.T - 0.5 * (c * c).sum(1)).topk(2, dim=1).values
    x = x[(top2[:, 0] - top2[:, 1]) >= 1e-4].contiguous()
    got = tkm.kmeans_assign_cuda(x, c)
    assert _same(got, tkm.kmeans_assign_cuda(x, c))
    psums, pcounts, psse = tkm.kmeans_assign_plain(x, c)
    assert torch.equal(got[1], pcounts)
    torch.testing.assert_close(got[0], psums, rtol=1e-5, atol=1e-5 * psums.abs().max().item())
    torch.testing.assert_close(got[2], psse, rtol=1e-5, atol=0.0)


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py, loaded by path: its far-data checks are the card's."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("d", [50, 128, 192, 256])
def test_kmeans_assign_narrow_route_on_far_data(cuda, smoke, d, k):
    """The tensor-core route on run_kmeans's own fills (points ~5 sqrt(d)
    from the origin), centroids drawn from the points plus 0.3 N(0, 1):
    with the near-ties scaled to the data dropped, counts equal, sums
    within rtol 1e-5 of the largest sum, sse within rtol 1e-5, two
    launches bitwise (chip_smoke.kmeans_against_plain(far=True)).  An
    accumulator carried through all ceil(d / 8) steps of the scores
    drifts past that sse tolerance; a fresh one per step does not."""
    assert tkm.route(k, d) == "tensor_cores"
    rng = np.random.default_rng(d + k)
    n = 100_000
    xn = kmeans._np_fill_fragment(d + k, n, d).astype(np.float32)
    cn = (xn[rng.choice(n, k, replace=False)] + 0.3 * rng.standard_normal((k, d)))
    x, c = _to(cuda, xn, cn.astype(np.float32))
    kept, sums_err, sse_err = smoke.kmeans_against_plain(tkm, x, c, far=True)
    assert kept.shape[0] > 0.9 * n
    print(f"d {d} k {k}: sums {sums_err} off, sse {sse_err} relative")


def test_knn_topk_narrow_route_on_far_data(cuda, smoke):
    """The tensor-core route at its edge (d 64, k 32) on points ~40 from
    the origin, where fp32's own rounding of the distances passes atol
    1e-3: the distances no further from the float64 ones than the plain
    fp32 version's (an accumulator carried through the depth was), labels
    equal away from near-ties, two launches bitwise
    (chip_smoke.knn_against_float64)."""
    m, n, d, k = 2000, 100_000, 64, 32
    assert tknn.route(k, d) == "tensor_cores"
    pts = kmeans._np_fill_fragment(7, m + n, d).astype(np.float32)
    labels = np.random.default_rng(7).integers(0, 4, size=n).astype(np.int32)
    test, train, labels = _to(cuda, pts[:m], pts[m:], labels)
    err, plain_err = smoke.knn_against_float64(tknn, test, train, labels, k, cuda)
    print(f"knn d {d} k {k}: {err} off the float64 distances, the plain fp32 {plain_err}")


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((10, 4), device=cuda)
    with pytest.raises(TypeError):
        tkm.kmeans_assign_cuda(x.double(), x[:2].double())
    with pytest.raises(ValueError):
        tkm.kmeans_assign_cuda(x.T.contiguous().T, x[:2])          # not contiguous
    with pytest.raises(ValueError):
        tknn.knn_topk_cuda(x, x.cpu(), torch.zeros(10, dtype=torch.int32, device=cuda), 3)


def test_pipelines_on_the_card_match_the_cpu(cuda):
    cfg = dict(n_train=4000, n_test=1000, d=16, k=5, n_classes=4, train_fragments=4,
               test_blocks=2)
    kcfg = dict(n_points=20_000, d=8, k=6, fragments=4, max_iters=5, tol=0.0)
    with api.runtime_start(n_workers=4):
        ops.reset_launch_counts()
        on_card = knn.run_knn(**cfg, device=cuda)
        assert ops.launch_counts()["knn_topk"] == 4 * 2
        on_cpu = knn.run_knn(**cfg, device="cpu")
        km_card = kmeans.run_kmeans(**kcfg, device=cuda)
        km_cpu = kmeans.run_kmeans(**kcfg, device="cpu")
        assert ops.launch_counts()["kmeans_assign"] == 4 * 5
    assert (on_card.predictions == on_cpu.predictions).mean() >= 0.999
    np.testing.assert_allclose(km_card.centroids, km_cpu.centroids, atol=1e-4)


def test_wide_pipelines_on_the_card_match_the_cpu(cuda):
    """run_kmeans at k 65 and run_knn at d 300 (both past the tensor-core
    routes) on the card give the CPU path's results."""
    kcfg = dict(n_points=20_000, d=8, k=65, fragments=4, max_iters=5, tol=0.0)
    cfg = dict(n_train=4000, n_test=1000, d=300, k=5, n_classes=4, train_fragments=4,
               test_blocks=2)
    assert tkm.route(65, 8) == "wide" and tknn.route(5, 300) == "wide"
    with api.runtime_start(n_workers=4):
        ops.reset_launch_counts()
        km_card = kmeans.run_kmeans(**kcfg, device=cuda)
        km_cpu = kmeans.run_kmeans(**kcfg, device="cpu")
        on_card = knn.run_knn(**cfg, device=cuda)
        on_cpu = knn.run_knn(**cfg, device="cpu")
        counts = ops.launch_counts()
    assert counts["kmeans_assign"] == 4 * 5 and counts["knn_topk"] == 4 * 2
    np.testing.assert_allclose(km_card.centroids, km_cpu.centroids, atol=1e-4)
    assert (on_card.predictions == on_cpu.predictions).mean() >= 0.999


BF16_STEP = 2.0 ** -7


def _close(got, want):
    if got.dtype == torch.bfloat16:
        # fp32 results that round to neighbouring bf16 values
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_STEP, atol=1e-5)
    else:
        # fp32 sums in another order
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(4096, 1024), (1001, 64), (77, 6144), (3, 5, 100), (9, 37),
                                   (65_536, 64), (32_768, 64), (8, 4096), (300, 1536),
                                   (70, 3072), (33, 2048)])
@pytest.mark.parametrize("xdt,sdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32)])
def test_rmsnorm_matches_plain(cuda, shape, xdt, sdt):
    rng = np.random.default_rng(shape[-1])
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda).to(xdt)
    scale = torch.from_numpy(rng.standard_normal(shape[-1]).astype(np.float32)).to(cuda).to(sdt)
    got = trms.rmsnorm_cuda(x, scale)
    assert got.dtype == xdt and got.shape == x.shape
    _close(got, trms.rmsnorm_plain(x, scale))
    assert torch.equal(got, trms.rmsnorm_cuda(x, scale))


@pytest.mark.parametrize("case", [(8, 16, 8, 512, 512, 64, True, None),      # qwen3's prefill
                                  (8, 16, 1, 512, 512, 256, True, 2048),   # recurrentgemma's
                                  (2, 16, 8, 128, 128, 64, True, None),
                                  (2, 4, 2, 77, 77, 64, True, None),
                                  (1, 4, 4, 40, 200, 64, False, None),
                                  (1, 4, 2, 150, 70, 128, True, None),
                                  (1, 4, 2, 300, 300, 64, True, 100),
                                  (1, 16, 1, 100, 100, 64, True, None),
                                  (1, 48, 1, 64, 64, 128, True, None),
                                  (1, 4, 2, 65, 65, 16, False, 9),
                                  (2, 4, 1, 130, 130, 32, True, 16),
                                  (1, 4, 2, 40, 90, 32, False, None),
                                  (1, 16, 1, 200, 200, 256, True, 64),
                                  (2, 2, 1, 77, 77, 256, True, None),
                                  (1, 2, 2, 30, 70, 256, False, None)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_matches_plain(cuda, case, dtype):
    B, H, K, Sq, Skv, d, causal, window = case
    rng = np.random.default_rng(sum(case[:6]))

    def view(heads, S):    # (B, S, heads, d) in memory, as the layer holds it
        a = rng.standard_normal((B, S, heads, d)).astype(np.float32)
        return torch.from_numpy(a).to(cuda).to(dtype).transpose(1, 2)

    q, k, v = view(H, Sq), view(K, Skv), view(K, Skv)
    got = tflash.flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape and got.stride() == q.stride()
    _close(got, tflash.flash_attention_plain(q, k, v, causal=causal, window=window))
    assert torch.equal(got, tflash.flash_attention_cuda(q, k, v, causal=causal, window=window))


def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 2, 8, 16), device=cuda)
    with pytest.raises(TypeError):
        trms.rmsnorm_cuda(x.half(), torch.ones(16, device=cuda))
    with pytest.raises(ValueError):
        trms.rmsnorm_cuda(x.transpose(0, 1), torch.ones(16, device=cuda))
    with pytest.raises(TypeError):
        tflash.flash_attention_cuda(x, x.bfloat16(), x)
    with pytest.raises(ValueError):
        tflash.flash_attention_cuda(x[..., :12], x[..., :12], x[..., :12])   # d = 12
    with pytest.raises(ValueError):
        tflash.flash_attention_cuda(x.transpose(2, 3), x, x)


def test_bf16_flash_refuses_views_off_16_bytes(cuda):
    """The bf16 route copies 16-byte pieces: an address or a stride off a
    multiple of 16 bytes is refused, not served another way."""
    bf = torch.bfloat16
    q = torch.zeros((1, 2, 8, 16), dtype=bf, device=cuda)
    tflash.flash_attention_cuda(q, q, q)                           # aligned: launches
    shifted = torch.zeros(2 * 8 * 16 + 1, dtype=bf, device=cuda)[1:].view(1, 2, 8, 16)
    with pytest.raises(ValueError, match="16 bytes"):
        tflash.flash_attention_cuda(shifted, q, q)                 # address off by 2 bytes
    def padded(dtype, width):    # (1, 2, 8, 16) views into rows of `width`
        return torch.zeros((1, 8, 2, width), dtype=dtype, device=cuda)[..., :16].transpose(1, 2)

    with pytest.raises(ValueError, match="16 bytes"):
        tflash.flash_attention_cuda(q, padded(bf, 20), padded(bf, 20))   # strides of 40 bytes
    # the fp32 route takes strides off 16 bytes (72 here)
    kv = padded(torch.float32, 18)
    assert tflash.flash_attention_cuda(q.float(), kv, kv).shape == q.shape


@pytest.mark.parametrize("B,S,R", [(8, 512, 4096), (2, 33, 100), (1, 1, 37), (3, 9, 4097)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_plain(cuda, B, S, R, dtype, with_h0):
    rng = np.random.default_rng(B * S + R)
    log_a = -np.log1p(np.exp(rng.standard_normal((B, S, R)))).astype(np.float32)
    b = rng.standard_normal((B, S, R)).astype(np.float32)
    la, bb = (torch.from_numpy(a).to(cuda).to(dtype) for a in (log_a, b))
    h0 = torch.from_numpy(rng.standard_normal((B, R)).astype(np.float32)).to(cuda) \
        if with_h0 else None
    y, h = trglru.rglru_scan_cuda(la, bb, h0)
    assert y.dtype == dtype and h.dtype == torch.float32 and h.shape == (B, R)
    py, ph = trglru.rglru_scan_plain(la, bb, h0)
    _close(y, py)
    # the fp32 state: the kernel's fmaf and expf against exp, *, + on
    # the same values, over up to 512 contracting steps
    torch.testing.assert_close(h, ph, rtol=1e-5, atol=1e-5)
    assert _same((y, h), trglru.rglru_scan_cuda(la, bb, h0))


def _ssd_args(dev, B, S, H, P, N, dtype, seed, dt_range=None):
    """x, B and C as views into one (B, S, H*P + 2N) tensor, as the SSD
    layer passes them; dt = softplus(normal) or uniform in ``dt_range``."""
    rng = np.random.default_rng(seed)
    packed = torch.from_numpy(rng.standard_normal((B, S, H * P + 2 * N)).astype(np.float32))
    packed = packed.to(dev).to(dtype)
    x = packed[..., :H * P].reshape(B, S, H, P)
    if dt_range is None:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    else:
        dt = rng.uniform(*dt_range, size=(B, S, H))
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    dt = torch.from_numpy(dt.astype(np.float32)).to(dev)
    return x, dt, A, packed[..., H * P:H * P + N], packed[..., H * P + N:]


def _close_ssd(got, want):
    """The kernel steps the recurrence; the plain version forms
    exp(cs_i - cs_j) from fp32 cumulative sums over up to a chunk of
    steps, whose rounding is relative to |cs|: within 1e-4 of the largest
    value, and 1e-4 relative."""
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(8, 512, 48, 64, 128, 256),    # mamba2's prefill
                                             (2, 512, 8, 64, 128, 256), (1, 543, 4, 64, 128, 256),
                                             (2, 77, 3, 40, 100, 32), (1, 5, 2, 8, 16, 8),
                                             (2, 300, 2, 16, 16, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_matches_plain(cuda, B, S, H, P, N, chunk, dtype):
    args = _ssd_args(cuda, B, S, H, P, N, dtype, seed=S + P + N)
    assert not args[0].is_contiguous()
    y, st = tssd.ssd_scan_cuda(*args)
    assert y.shape == (B, S, H, P) and st.shape == (B, H, P, N) and y.dtype == torch.float32
    py, pst = tssd.ssd_scan_plain(*args, chunk=chunk)
    _close_ssd(y, py)
    _close_ssd(st, pst)
    assert _same((y, st), tssd.ssd_scan_cuda(*args))


@pytest.mark.parametrize("dt_range", [(0.0, 1e-3), (5.0, 20.0)], ids=["decay~1", "decay~0"])
def test_ssd_scan_extreme_decays(cuda, dt_range):
    args = _ssd_args(cuda, 2, 300, 4, 64, 128, torch.bfloat16, seed=7, dt_range=dt_range)
    y, st = tssd.ssd_scan_cuda(*args)
    py, pst = tssd.ssd_scan_plain(*args, chunk=256)
    _close_ssd(y, py)
    _close_ssd(st, pst)


def test_scan_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    z = torch.zeros((2, 3, 5), device=cuda)
    with pytest.raises(TypeError):
        trglru.rglru_scan_cuda(z.half(), z)
    with pytest.raises(ValueError):
        trglru.rglru_scan_cuda(z.transpose(0, 1).contiguous().transpose(0, 1), z)
    x, dt, A, bm, cm = _ssd_args(cuda, 1, 4, 2, 8, 16, torch.float32, seed=0)
    with pytest.raises(TypeError):
        tssd.ssd_scan_cuda(x, dt, A, bm.bfloat16(), cm)
    with pytest.raises(TypeError):
        tssd.ssd_scan_cuda(x, dt.double(), A, bm, cm)
    with pytest.raises(ValueError):
        tssd.ssd_scan_cuda(x.transpose(2, 3), dt, A, bm, cm)
    wide = torch.zeros((1, 4, 129), device=cuda)
    with pytest.raises(ValueError):
        tssd.ssd_scan_cuda(x, dt, A, wide, wide)                      # N > 128


@pytest.mark.parametrize("arch,kernel", [("mamba2-780m", "ssd_scan"),
                                         ("recurrentgemma-9b", "rglru_scan")])
def test_recurrent_serve_on_the_card_matches_the_cpu(cuda, arch, kernel):
    """The reduced recurrent models (fp32) served on the card and on the CPU
    from the same weights give the same tokens (every step's top-2 margin
    is above 2.5e-3 on the CPU), through the scan kernels."""
    cfg = get_config(arch, reduced=True)
    cpu_model = lm.init_params(cfg, seed=0, device="cpu")
    card_model = lm.init_params(cfg, seed=0, device="cpu").to(cuda)
    kw = dict(batch=2, prompt_len=40, gen_len=6, seed=0)
    on_cpu = serve.serve_batch(cfg, device="cpu", params=cpu_model, **kw)
    ops.reset_launch_counts()
    on_card = serve.serve_batch(cfg, device=cuda, params=card_model, **kw)
    counts = ops.launch_counts()
    kinds = [blk.btype for blk in card_model.blocks]
    assert counts["ssd_scan"] == kinds.count("ssd")
    assert counts["rglru_scan"] == kinds.count("rglru")
    assert counts["flash_attention"] == kinds.count("local_attn")
    assert counts[kernel] > 0
    np.testing.assert_array_equal(on_card["tokens"], on_cpu["tokens"])
    prompts = serve.make_prompts(cfg, 2, 40, 0)
    torch.testing.assert_close(serve.replay_logits(card_model, prompts, on_card["tokens"]).cpu(),
                               serve.replay_logits(cpu_model, prompts, on_cpu["tokens"]),
                               rtol=1e-4, atol=1e-4)


def test_serve_on_the_card_matches_the_cpu(cuda):
    """qwen3-0.6b (reduced, fp32) served on the card and on the CPU from the
    same weights gives the same tokens, through both kernels."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    cpu_model = lm.init_params(cfg, seed=0, device="cpu")
    card_model = lm.init_params(cfg, seed=0, device="cpu").to(cuda)
    kw = dict(batch=2, prompt_len=40, gen_len=6, seed=0)
    on_cpu = serve.serve_batch(cfg, device="cpu", params=cpu_model, **kw)
    ops.reset_launch_counts()
    on_card = serve.serve_batch(cfg, device=cuda, params=card_model, **kw)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    assert ops.launch_counts()["rmsnorm"] == 6 * (cfg.n_layers * 4 + 1)
    np.testing.assert_array_equal(on_card["tokens"], on_cpu["tokens"])
    prompts = serve.make_prompts(cfg, 2, 40, 0)
    torch.testing.assert_close(serve.replay_logits(card_model, prompts, on_card["tokens"]).cpu(),
                               serve.replay_logits(cpu_model, prompts, on_cpu["tokens"]),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- gradients
def _grads_of(fn, leaves, views, dev):
    """Gradients of Σ g·out (fixed random cotangents on every output) with
    respect to fresh copies of ``leaves``."""
    xs = [t.detach().clone().requires_grad_() for t in leaves]
    out = fn(*views(xs))
    out = out if isinstance(out, tuple) else (out,)
    gen = torch.Generator(device=dev).manual_seed(1)
    loss = sum((o.float() * torch.randn(o.shape, generator=gen, device=dev)).sum() for o in out)
    return torch.autograd.grad(loss, xs)


def _grad_cases(dev, dt):
    rng = np.random.default_rng(0)

    def n(*shape, dtype=dt):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev).to(dtype)

    def same(xs):
        return xs

    def heads(xs):
        return [t.transpose(1, 2) for t in xs]

    def ssd_views(xs, H=4, P=16, N=16):
        p, d, a = xs
        return (p[..., :H * P].reshape(*p.shape[:2], H, P), d, a, p[..., H * P:H * P + N],
                p[..., H * P + N:])

    la = -torch.nn.functional.softplus(n(2, 33, 100, dtype=torch.float32)).to(dt)
    return {
        "rmsnorm": (lambda x, s: ops.rmsnorm(x, s), trms.rmsnorm_plain, [n(37, 128), n(128)],
                    same),
        "flash_attention": (lambda q, k, v: ops.flash_attention(q, k, v, window=20),
                            lambda q, k, v: tflash.flash_attention_plain(q, k, v, window=20),
                            [n(2, 70, 8, 64), n(2, 70, 2, 64), n(2, 70, 2, 64)], heads),
        "ssd_scan": (lambda *a: ops.ssd_scan(*a, chunk=16),
                     lambda *a: tssd.ssd_scan_plain(*a, chunk=16),
                     [n(2, 45, 4 * 16 + 32), torch.nn.functional.softplus(
                         n(2, 45, 4, dtype=torch.float32)),
                      -torch.linspace(1.0, 4.0, 4, device=dev)], ssd_views),
        "rglru_scan": (lambda *a: ops.rglru_scan(*a), trglru.rglru_scan_plain,
                       [la, n(2, 33, 100), n(2, 100, dtype=torch.float32)], same),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["rmsnorm", "flash_attention", "ssd_scan", "rglru_scan"])
def test_kernel_gradients_match_the_plain_version(cuda, kernel, dtype):
    """Through its autograd Function each kernel launches once and gives
    every input the gradient autograd gives through the plain version on
    the card (the Function's backward recomputes that version on the same
    inputs, views included): equal within the forward's tolerance."""
    op, plain, leaves, views = _grad_cases(cuda, dtype)[kernel]
    before = ops.launch_counts()[kernel]
    got = _grads_of(op, leaves, views, cuda)
    assert ops.launch_counts()[kernel] == before + 1
    want = _grads_of(plain, leaves, views, cuda)
    for a, b in zip(got, want):
        assert a is not None and a.dtype == b.dtype
        _close(a, b)


def _model_grads(cfg, model, batch, remat):
    model.zero_grad(set_to_none=True)
    total, _ = lm.loss_fn(model, batch, remat=remat)
    total.backward()
    return float(total.detach()), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-780m", "recurrentgemma-9b",
                                  "deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_model_gradients_on_the_card_match_the_cpu(cuda, arch, remat):
    """The C3 regression: on the card ``loss.backward()`` gives every
    parameter — norm scales, and everything before a norm, an attention
    or a scan — the gradient the CPU gives from the same weights and
    batch (fp32, reduced configs); the kernels launched in the forward,
    and again under remat "full"."""
    from repro_torch.data.pipeline import synth_batch
    cfg = get_config(arch, reduced=True)
    batch = synth_batch(cfg, 2, 24, step=0)
    cpu_model = lm.init_params(cfg, seed=0, device="cpu")
    card_model = lm.init_params(cfg, seed=0, device="cpu").to(cuda)
    loss_cpu, g_cpu = _model_grads(cfg, cpu_model, {k: torch.from_numpy(v)
                                                    for k, v in batch.items()}, remat)
    ops.reset_launch_counts()
    loss_card, g_card = _model_grads(cfg, card_model, {k: torch.from_numpy(v).to(cuda)
                                                       for k, v in batch.items()}, remat)
    kinds = cfg.layer_types
    again = 2 if remat == "full" else 1
    assert ops.launch_counts()["flash_attention"] == again * (kinds.count("dense")
                                                              + kinds.count("local_attn")
                                                              + kinds.count("moe"))
    assert ops.launch_counts()["ssd_scan"] == again * kinds.count("ssd")
    assert ops.launch_counts()["rglru_scan"] == again * kinds.count("rglru")
    assert loss_card == pytest.approx(loss_cpu, rel=1e-5)
    for name, g in g_cpu.items():
        assert g_card[name] is not None, f"{name} got no gradient on the card"
        # the RG-LRU gates' gradients sum terms of both signs over every
        # position (measured against JAX on the CPU: 3.3e-4 of the leaf's
        # largest magnitude); every other leaf within 1e-4 of it
        tol = 1e-3 if name.split(".")[-1] in ("lam", "w_r", "b_r", "w_i", "b_i") else 1e-4
        err = float((g_card[name].cpu() - g).abs().max())
        assert err <= tol * float(g.abs().max()), (name, err, float(g.abs().max()))


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One ``make_train_step`` step (loss, gradients, clipping, AdamW) on
    the reduced qwen3 (fp32) from the same weights and batch: the same
    loss and gradient norm; every parameter within 2.2·lr of the CPU's,
    and 99% of them within 1e-6.  The first AdamW step moves each by
    about lr·sign(g) (m̂/√v̂ = g/|g|), so where a gradient is at the noise
    level of the two devices' sums its sign, and the step, may differ."""
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.optim.adamw import adamw
    cfg = get_config("qwen3-0.6b", reduced=True)
    batch = synth_batch(cfg, 4, 32, step=0)
    out = {}
    for dev in ("cpu", cuda):
        model = lm.init_params(cfg, seed=0, device="cpu").to(dev)
        opt = adamw(1e-3)
        state = opt.init(dict(model.named_parameters()))
        m = make_train_step(opt)(model, state, {k: torch.from_numpy(v).to(dev)
                                                for k, v in batch.items()})
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                         {n: p.detach().cpu() for n, p in model.named_parameters()})
    (l0, n0, p0), (l1, n1, p1) = out["cpu"], out[str(cuda)]
    assert l1 == pytest.approx(l0, rel=1e-5) and n1 == pytest.approx(n0, rel=1e-4)
    diff = torch.cat([(p1[name] - p0[name]).abs().reshape(-1) for name in p0])
    assert float(diff.max()) <= 2.2e-3, float(diff.max())
    assert float((diff <= 1e-6).float().mean()) >= 0.99, float((diff <= 1e-6).float().mean())


# ---------------------------------------------------------------------- MoE
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_moe_serve_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced MoE models (fp32) on the card and on the CPU from the
    same weights: the forward's logits within 1e-4 and its balance loss
    within 1e-5 relative; served tokens identical (through rmsnorm and
    flash: one flash launch per layer in the prefill), and identical
    again in a second serve."""
    cfg = get_config(arch, reduced=True)
    cpu_model = lm.init_params(cfg, seed=0, device="cpu")
    card_model = lm.init_params(cfg, seed=0, device="cpu").to(cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)))
    with torch.no_grad():
        l_cpu, _, a_cpu = cpu_model({"tokens": tokens}, return_aux=True)
        l_card, _, a_card = card_model({"tokens": tokens.to(cuda)}, return_aux=True)
    torch.testing.assert_close(l_card.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
    assert float(a_card) == pytest.approx(float(a_cpu), rel=1e-5)
    kw = dict(batch=2, prompt_len=40, gen_len=6, seed=0)
    on_cpu = serve.serve_batch(cfg, device="cpu", params=cpu_model, **kw)
    ops.reset_launch_counts()
    on_card = serve.serve_batch(cfg, device=cuda, params=card_model, **kw)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    norms = 4 if cfg.qk_norm else 2
    assert ops.launch_counts()["rmsnorm"] == 6 * (cfg.n_layers * norms + 1)
    np.testing.assert_array_equal(on_card["tokens"], on_cpu["tokens"])
    again = serve.serve_batch(cfg, device=cuda, params=card_model, **kw)
    np.testing.assert_array_equal(again["tokens"], on_card["tokens"])


@pytest.mark.parametrize("N,cf", [(8, 1.25), (8 * 64, 1.25), (8 * 64, 64 / 6)],
                         ids=["decode", "prefill", "prefill-no-drop"])
def test_moe_layer_on_the_card_is_repeatable_and_matches_the_cpu(cuda, N, cf):
    """deepseek's routing (64 experts, top-6) in bf16 at a decode step's
    8 tokens (C = 4: assignments drop) and at a 512-token prefill, with
    and without drops: two launches bitwise equal (the combine adds in a
    fixed order, no atomics); the same assignments dropped as on the CPU;
    the output within two bf16 steps of the CPU's scale.  The layer never
    waits for the card: no op of it synchronises (so the host runs ahead
    of the device, as a decode step needs)."""
    from repro_torch.layers import moe
    rng = np.random.default_rng(3)
    D, F, E = 256, 128, 64
    p = {"w_router": rng.standard_normal((D, E)) / D ** 0.5,
         "w_gate": rng.standard_normal((E, D, F)) / D ** 0.5,
         "w_up": rng.standard_normal((E, D, F)) / D ** 0.5,
         "w_down": rng.standard_normal((E, F, D)) / F ** 0.5}
    cpu = {k: torch.from_numpy(v.astype(np.float32)).to(
        torch.float32 if k == "w_router" else torch.bfloat16) for k, v in p.items()}
    card = {k: v.to(cuda) for k, v in cpu.items()}
    # tokens that share a direction crowd the same experts
    x = rng.standard_normal((1, N, D)) + 2.0 * rng.standard_normal(D)
    x_cpu = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    x_card = x_cpu.to(cuda)
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, aux = moe.moe_apply_local(card, x_card, top_k=6, capacity_factor=cf)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        again, _ = moe.moe_apply_local(card, x_card, top_k=6, capacity_factor=cf)
        want, want_aux = moe.moe_apply_local(cpu, x_cpu, top_k=6, capacity_factor=cf)
        d_card, _ = moe.dropped_assignments(card, x_card, top_k=6, capacity_factor=cf)
        d_cpu, _ = moe.dropped_assignments(cpu, x_cpu, top_k=6, capacity_factor=cf)
    assert torch.equal(got, again)
    assert int(d_card) == int(d_cpu)
    assert (int(d_cpu) > 0) == (cf < 2)
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2 * 2.0 ** -7,
                               atol=2 * 2.0 ** -7 * scale)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


def test_knn_and_kmeans_refuse_inputs_that_require_grad(cuda):
    """Neither kernel has a gradient (nor has its Pallas call under
    jax.grad): the CUDA wrappers and the ops refuse inputs that require
    grad, and take them under torch.no_grad()."""
    x = torch.randn((64, 8), device=cuda, requires_grad=True)
    labels = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no gradient"):
        tknn.knn_topk_cuda(x, x.detach(), labels, 3)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.knn_topk(x.detach(), x, labels, k=3)
    with pytest.raises(RuntimeError, match="no gradient"):
        tkm.kmeans_assign_cuda(x, x[:4].detach())
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.kmeans_assign(x.detach(), x[:4])
    with torch.no_grad():
        assert ops.knn_topk(x, x, labels, k=3)[0].shape == (64, 3)
        assert ops.kmeans_assign(x, x[:4])[0].shape == (4, 8)


def _card_tensors(n):
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, 64, generator=g)
    return {"fp32": x.cuda(), "bf16": x.to(torch.bfloat16).cuda(),
            "int32": (x * 100).to(torch.int32).cuda()}


def test_process_backend_on_the_card_equals_the_thread_backend(cuda):
    """The three pipelines in two spawned workers, each its own CUDA
    context, give the thread backend's bytes; the workers' launch counts,
    gathered from their replies, are the thread run's; card tensors cross
    the boundary with their dtype, wait in the parent as host bytes until
    they are read, and come back on the card."""
    from repro_torch.algorithms import linreg
    from repro_torch.core import executors
    kcfg = dict(n_train=4000, n_test=1000, d=16, k=5, n_classes=4, train_fragments=4,
                test_blocks=2)
    mcfg = dict(n_points=20_000, d=8, k=6, fragments=4, max_iters=5, tol=0.0)
    lcfg = dict(n_rows=8000, p=20, n_pred=1000, fragments=4, pred_blocks=2)

    def run():
        return (knn.run_knn(**kcfg, device=cuda), kmeans.run_kmeans(**mcfg, device=cuda),
                linreg.run_linreg(**lcfg, device=cuda))

    with api.runtime_start(n_workers=2):
        ops.reset_launch_counts()
        want = run()
        want_counts = ops.launch_counts()
    with api.runtime_start(n_workers=2, backend="process") as rt:
        ops.reset_launch_counts()
        got = run()
        fut = api.task(_card_tensors, name="card_tensors")(512)
        rt.barrier()
        held = rt.store.get(fut.key)     # not read yet: still host bytes
        assert all(isinstance(v, executors.CardResult) for v in held.values())
        crossed = api.wait_on(fut)
        st = rt.stats()["executor"]
        assert ops.launch_counts() == only(ops)     # nothing ran in this process
    assert got[0].predictions.tobytes() == want[0].predictions.tobytes()
    assert got[1].centroids.tobytes() == want[1].centroids.tobytes()
    assert got[1].sse_history == want[1].sse_history
    assert got[2].beta.tobytes() == want[2].beta.tobytes()
    assert st["kernel_launches"]["knn_topk"] == want_counts["knn_topk"] == 4 * 2
    assert st["kernel_launches"]["kmeans_assign"] == want_counts["kmeans_assign"] == 4 * 5
    assert st["device_uploads"] > 0 and st["device_uploads_saved"] > 0
    ref = _card_tensors(512)
    for k, v in ref.items():
        assert crossed[k].device.type == "cuda" and crossed[k].dtype == v.dtype
        assert torch.equal(crossed[k], v)


def only(ops_mod, **nonzero):
    return {k: nonzero.get(k, 0) for k in ops_mod.KERNELS}


def test_the_calibration_timer_synchronises_the_card(cuda):
    """A host clock around an asynchronous launch reads the launch;
    ``timeit_median`` on the card reads the work."""
    from repro_torch.algorithms import common
    cycles = 200_000_000
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(cycles)
    stop.record()
    torch.cuda.synchronize()
    device_s = start.elapsed_time(stop) / 1e3
    synced = common.timeit_median(lambda: torch.cuda._sleep(cycles), device=cuda)
    unsynced = common.timeit_median(lambda: torch.cuda._sleep(cycles), device=None)
    torch.cuda.synchronize()
    assert synced >= 0.9 * device_s
    assert unsynced < 0.5 * device_s
