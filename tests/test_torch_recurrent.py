"""The PyTorch port's recurrent layers against the JAX package's.

``repro_torch.layers.ssd.SSD`` and ``repro_torch.layers.rglru.RGLRU`` take
the parameters of ``repro.layers.ssd.init_ssd`` / ``repro.layers.rglru.
init_rglru`` (NumPy copies) and the same seeded NumPy inputs as
``ssd_forward`` / ``rglru_forward``: prefill, prefill with a cache, one
decode step over that cache, and the empty caches' shapes.  On the CPU the
prefill scans run the ``ssd_scan`` / ``rglru_scan`` plain versions (the
JAX layers run ``ssd_chunked`` and ``associative_scan``).  Everything is
fp32; tolerances are stated at each assertion.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.layers import rglru as jrglru  # noqa: E402
from repro.layers import ssd as jssd  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.layers import rglru, ssd  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}.")
    else:
        yield prefix[:-1], tree


@torch.no_grad()
def _load(module, tree):
    flat = dict(_flatten(tree))
    params = dict(module.named_parameters())
    assert flat.keys() == params.keys()
    for name, p in params.items():
        assert np.asarray(flat[name]).dtype.name == str(p.dtype).removeprefix("torch.")
        p.copy_(torch.from_numpy(np.array(flat[name], np.float32)))
    return module


def _np(x):
    return x.detach().to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


def _cmp_cache(got, want, tol):
    assert got.keys() == want.keys()
    for key in got:
        assert tuple(got[key].shape) == tuple(want[key].shape)
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), rtol=tol, atol=tol)


# ------------------------------------------------------------------------ SSD
SSD_KW = dict(expand=2, headdim=8, d_state=16, conv_width=4)


def _ssd_pair(D=32, seed=0):
    p = jssd.init_ssd(jax.random.PRNGKey(seed), D, **SSD_KW)
    # non-trivial D, dt_bias, conv bias and norm gain
    rng = np.random.default_rng(seed)
    H = 2 * D // SSD_KW["headdim"]
    p["D"] = jnp.asarray(rng.uniform(0.5, 1.5, H).astype(np.float32))
    p["dt_bias"] = jnp.asarray(rng.uniform(-1, 1, H).astype(np.float32))
    p["conv_b"] = jnp.asarray(rng.uniform(-0.1, 0.1, p["conv_b"].shape).astype(np.float32))
    p["norm"]["scale"] = jnp.asarray(rng.uniform(0.5, 1.5, 2 * D).astype(np.float32))
    layer = _load(ssd.SSD(D, **SSD_KW), jax.tree.map(np.asarray, p))
    return p, layer


@pytest.mark.parametrize("S,chunk", [(12, 4), (11, 4), (2, 8)],
                         ids=["chunks", "ragged", "shorter-than-conv"])
def test_ssd_layer_prefill_cache_and_decode_match_jnp(S, chunk):
    p, layer = _ssd_pair()
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    with torch.no_grad():
        got, cache = layer(torch.from_numpy(x), chunk=chunk, make_cache=True)
    want, jcache = jssd.ssd_forward(p, jnp.asarray(x), chunk=chunk, make_cache=True, **SSD_KW)
    # fp32; the same chunked algorithm, products and sums in other orders
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    _cmp_cache(cache, jcache, 1e-5)
    for step in range(2):
        xs = rng.standard_normal((2, 1, 32)).astype(np.float32)
        with torch.no_grad():
            got, cache = layer(torch.from_numpy(xs), cache=cache)
        want, jcache = jssd.ssd_forward(p, jnp.asarray(xs), cache=jcache, **SSD_KW)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
        _cmp_cache(cache, jcache, 1e-5)


def test_ssd_cache_shapes_and_reference():
    empty = ssd.init_ssd_cache(3, 32, **SSD_KW)
    jempty = jssd.init_ssd_cache(3, 32, **SSD_KW)
    _cmp_cache(empty, jempty, 0.0)
    assert empty["state"].dtype == torch.float32
    # the per-step oracle against the JAX one
    rng = np.random.default_rng(1)
    xh = rng.standard_normal((2, 9, 3, 4)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, 9, 3)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(3)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((2, 9, 5)).astype(np.float32) for _ in range(2))
    got = ssd.ssd_reference(*(torch.from_numpy(a) for a in (xh, dt, A, Bm, Cm)))
    want = jssd.ssd_reference(*(jnp.asarray(a) for a in (xh, dt, A, Bm, Cm)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-6)


def test_ssd_scan_op_matches_the_per_step_reference():
    """The chunked plain version (what the layer's prefill runs on the CPU)
    computes the per-step recurrence (what the CUDA kernel runs)."""
    rng = np.random.default_rng(2)
    xh = torch.from_numpy(rng.standard_normal((2, 19, 3, 4)).astype(np.float32))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((2, 19, 3)))).astype(np.float32))
    A = -torch.exp(torch.from_numpy(rng.standard_normal(3).astype(np.float32)))
    Bm, Cm = (torch.from_numpy(rng.standard_normal((2, 19, 5)).astype(np.float32))
              for _ in range(2))
    from repro_torch.kernels import ops
    for chunk in (4, 19, 32):
        for got, want in zip(ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk),
                             ssd.ssd_reference(xh, dt, A, Bm, Cm)):
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_ssd_chunk_invariance():
    """Mirror of tests/test_models.py::test_ssd_chunk_invariance: chunk 8
    and chunk 4 compute the same model."""
    base = dict(name="s8", n_layers=4, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                vocab_size=97, block_pattern=("ssd",), ssm_state=16, ssm_headdim=8,
                ssm_chunk=8)
    jcfg = jlm.LMConfig(**base, cache_dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    cfg8 = lm.LMConfig(**base, cache_dtype=torch.float32)
    model = convert.load_jax_params(lm.LM(cfg8, device="cpu"), tree)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 97, (2, 8)).astype(np.int32))
    with torch.no_grad():
        l8, _ = model({"tokens": tokens})
        model.cfg = dataclasses.replace(cfg8, ssm_chunk=4)
        for blk in model.blocks:
            blk.cfg = model.cfg
        l4, _ = model({"tokens": tokens})
    # logits ~0.1 through 4 layers of fp32
    np.testing.assert_allclose(_np(l8), _np(l4), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------- RG-LRU
def _rglru_pair(D=16, R=24, seed=0):
    p = jrglru.init_rglru(jax.random.PRNGKey(seed), D, R)
    rng = np.random.default_rng(seed)
    p["conv_b"] = jnp.asarray(rng.uniform(-0.1, 0.1, R).astype(np.float32))
    p["b_r"] = jnp.asarray(rng.uniform(-1, 1, R).astype(np.float32))
    layer = _load(rglru.RGLRU(D, R), jax.tree.map(np.asarray, p))
    return p, layer


@pytest.mark.parametrize("S", [10, 2], ids=["prefill", "shorter-than-conv"])
def test_rglru_layer_prefill_cache_and_decode_match_jnp(S):
    p, layer = _rglru_pair()
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 16)).astype(np.float32)
    with torch.no_grad():
        got, cache = layer(torch.from_numpy(x), make_cache=True)
    want, jcache = jrglru.rglru_forward(p, jnp.asarray(x), make_cache=True)
    # fp32: a loop over time (the port) against an associative scan (JAX)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    _cmp_cache(cache, jcache, 1e-5)
    for step in range(2):
        xs = rng.standard_normal((2, 1, 16)).astype(np.float32)
        with torch.no_grad():
            got, cache = layer(torch.from_numpy(xs), cache=cache)
        want, jcache = jrglru.rglru_forward(p, jnp.asarray(xs), cache=jcache)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
        _cmp_cache(cache, jcache, 1e-5)


def test_rglru_gates_step_cache_and_reference_match_jnp():
    p, layer = _rglru_pair(seed=3)
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 7, 24)).astype(np.float32)
    h0 = rng.standard_normal((2, 24)).astype(np.float32)
    with torch.no_grad():
        log_a, b = layer.gates(torch.from_numpy(u))
        ja, jb = jrglru._gates(p, jnp.asarray(u))
        np.testing.assert_allclose(_np(torch.exp(log_a)), _np(ja), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(_np(b), _np(jb), rtol=1e-6, atol=1e-7)
        y, h = layer.step(torch.from_numpy(u[:, 0]), torch.from_numpy(h0))
        jy, jh = jrglru.rglru_step(p, jnp.asarray(u[:, 0]), jnp.asarray(h0))
        np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(h), _np(jh), rtol=1e-6, atol=1e-6)
        for got, want in zip(rglru.rglru_reference(layer, torch.from_numpy(u),
                                                   torch.from_numpy(h0)),
                             jrglru.rglru_reference(p, jnp.asarray(u), jnp.asarray(h0))):
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
        for got, want in zip(layer.scan(torch.from_numpy(u), torch.from_numpy(h0)),
                             jrglru.rglru_scan(p, jnp.asarray(u), jnp.asarray(h0))):
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    _cmp_cache(rglru.init_rglru_cache(3, 24), jrglru.init_rglru_cache(3, 24), 0.0)


def test_rglru_state_continuation():
    """Mirror of tests/test_models.py::test_rglru_state_continuation:
    scanning in two halves with the carried state is one scan."""
    _, layer = _rglru_pair()
    u = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 10, 24))
                         .astype(np.float32))
    with torch.no_grad():
        y_full, h_full = layer.scan(u)
        y1, h1 = layer.scan(u[:, :6])
        y2, h2 = layer.scan(u[:, 6:], h0=h1)
    np.testing.assert_allclose(_np(h2), _np(h_full), atol=1e-5)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], dim=1)), _np(y_full), atol=1e-5)


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_recurrent_layers_keep_their_fp32_parameters(param_dtype):
    """As in the JAX init, the recurrence's own parameters are fp32 in a
    bf16 model; the projections and the conv take the parameter dtype."""
    layer = rglru.RGLRU(16, 24, dtype=param_dtype)
    for name in ("lam", "w_r", "b_r", "w_i", "b_i"):
        assert getattr(layer, name).dtype == torch.float32
    for name in ("w_x", "w_gate", "conv_w", "conv_b", "w_out"):
        assert getattr(layer, name).dtype == param_dtype
    block = ssd.SSD(32, dtype=param_dtype, **SSD_KW)
    for name in ("A_log", "D", "dt_bias"):
        assert getattr(block, name).dtype == torch.float32
    for name in ("w_in", "conv_w", "conv_b", "w_out"):
        assert getattr(block, name).dtype == param_dtype
    assert block.norm.scale.dtype == param_dtype
