"""The PyTorch port's LM layers and model against the JAX package's.

The same seeded NumPy parameters and inputs go to the jnp layer and to
the port's module (on the CPU, where the port's norms and cache-free
attention run the kernels' plain versions).  Whole models start from the
JAX ``init_params`` tree, carried across by ``load_jax_params``.  All of
it runs in fp32, where the two frameworks differ only in the order of
their sums: tolerances are stated at each assertion.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import mlp as jmlp  # noqa: E402
from repro.layers import norms as jnorms  # noqa: E402
from repro.layers import rope as jrope  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.layers import attention, mlp, norms, rope  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}.")
    else:
        yield prefix[:-1], tree


@torch.no_grad()
def _load(module, tree):
    """Copy a (nested dict) tree of NumPy arrays into a module's parameters."""
    flat = dict(_flatten(tree))
    params = dict(module.named_parameters())
    assert flat.keys() == params.keys()
    for name, p in params.items():
        p.copy_(torch.from_numpy(np.array(flat[name], np.float32)))
    return module


def _np(x):
    return x.detach().to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


# ------------------------------------------------------------------ configs
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_match_the_jax_configs(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for reduced in (False, True):
        mine = dataclasses.asdict(configs.get_config(arch, reduced))
        ref = dataclasses.asdict(jconfigs.get_config(arch, reduced))
        for key in ("param_dtype", "compute_dtype", "cache_dtype"):
            ref[key] = DTYPES[ref[key]]
        assert mine == ref
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


def test_qwen3_full_width():
    cfg = configs.get_config("qwen3-0.6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
            cfg.vocab_size, cfg.qk_norm, cfg.rope_theta) == \
        (28, 1024, 16, 8, 64, 3072, 151936, True, 1e6)
    assert cfg.param_dtype == cfg.compute_dtype == cfg.cache_dtype == torch.bfloat16


# ------------------------------------------------------------------- layers
def test_rmsnorm_layer_matches_jnp():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    layer = _load(norms.RMSNorm(32), {"scale": scale})
    got = layer(torch.from_numpy(x))
    want = jnorms.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(_np(norms.rmsnorm_plain(torch.from_numpy(x))),
                               _np(jnorms.rmsnorm_plain(jnp.asarray(x))), rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("batched", [False, True])
def test_rope_matches_jnp(batched):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = (np.arange(9)[None].repeat(2, 0) + np.array([[0], [100]])) if batched \
        else np.arange(500, 509)
    pos = pos.astype(np.int32)
    cos, sin = rope.rope_angles(torch.from_numpy(pos), 16, 1e6)
    jcos, jsin = jrope.rope_angles(jnp.asarray(pos), 16, 1e6)
    # fp32 angles up to ~600 rad: cos/sin agree to a few fp32 ulps of the angle
    np.testing.assert_allclose(_np(cos), _np(jcos), atol=2e-5)
    np.testing.assert_allclose(_np(sin), _np(jsin), atol=2e-5)
    got = rope.apply_rope(torch.from_numpy(x), cos, sin)
    want = jrope.apply_rope(jnp.asarray(x), jcos, jsin)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)
    # the same angles in both: the rotation itself agrees to fp32 rounding
    same = jrope.apply_rope(jnp.asarray(x), jnp.asarray(_np(cos)), jnp.asarray(_np(sin)))
    np.testing.assert_allclose(_np(got), _np(same), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_jnp(gated):
    p = jmlp.init_mlp(jax.random.PRNGKey(2), 32, 64, gated=gated)
    x = np.random.default_rng(2).standard_normal((2, 7, 32)).astype(np.float32)
    layer = _load(mlp.MLP(32, 64, gated=gated), p)
    # fp32 products of depth 32 and 64 in two orders
    np.testing.assert_allclose(_np(layer(torch.from_numpy(x))),
                               _np(jmlp.mlp_forward(p, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def _attn_pair(qk_norm, H=4, K=2, hd=16, D=32, seed=3):
    p = jattn.init_attention(jax.random.PRNGKey(seed), D, H, K, hd, qk_norm)
    if qk_norm:   # non-trivial gains
        rng = np.random.default_rng(seed)
        p["q_norm"]["scale"] = jnp.asarray(rng.uniform(0.5, 1.5, hd).astype(np.float32))
        p["k_norm"]["scale"] = jnp.asarray(rng.uniform(0.5, 1.5, hd).astype(np.float32))
    layer = _load(attention.Attention(D, H, K, hd, qk_norm=qk_norm, rope_theta=1e4), p)
    kw = dict(n_heads=H, n_kv_heads=K, head_dim=hd, rope_theta=1e4, qk_norm=qk_norm)
    return p, layer, kw


def _cmp_cache(got, want):
    assert torch.equal(got["pos_map"], torch.from_numpy(np.asarray(want["pos_map"])))
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window,cache_len", [(None, 16), (None, 11), (5, 5), (5, 16)],
                         ids=["full", "full-tight", "ring", "window-full"])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_prefill_and_decode_match_jnp(window, cache_len, qk_norm):
    p, layer, kw = _attn_pair(qk_norm)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, 32)).astype(np.float32)
    # prefill: the port runs the flash kernel's plain version
    got, cache = layer(torch.from_numpy(x), window=window, make_cache_len=cache_len,
                       cache_dtype=torch.float32)
    want, jcache = jattn.attn_forward(p, jnp.asarray(x), window=window,
                                      make_cache_len=cache_len, cache_dtype=jnp.float32, **kw)
    # fp32: the dense softmax of the plain flash version vs the jnp dense path
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    _cmp_cache(cache, jcache)
    # decode two steps over the cache (a full cache needs room for them)
    if window is None and cache_len < 13:
        return
    for step in range(2):
        xs = rng.standard_normal((2, 1, 32)).astype(np.float32)
        got, cache = layer(torch.from_numpy(xs), window=window, pos_offset=11 + step,
                           cache=cache)
        want, jcache = jattn.attn_forward(p, jnp.asarray(xs), window=window,
                                          pos_offset=11 + step, cache=jcache, **kw)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
        _cmp_cache(cache, jcache)


def test_attention_chunked_path_matches_dense():
    """impl="chunked" (the > 2048-key path) computes the dense result."""
    p, layer, kw = _attn_pair(False)
    x = np.random.default_rng(5).standard_normal((2, 11, 32)).astype(np.float32)
    _, cache = layer(torch.from_numpy(x), make_cache_len=14, cache_dtype=torch.float32)
    xs = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 3, 32))
                          .astype(np.float32))
    dense, _ = layer(xs, pos_offset=11, cache={k: v.clone() for k, v in cache.items()})
    chunked, _ = layer(xs, pos_offset=11, cache=cache, impl="chunked", chunk=4)
    np.testing.assert_allclose(_np(chunked), _np(dense), rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------------- model
def tiny(name, mod, **kw):
    base = dict(name=name, n_layers=4, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab_size=97, cache_dtype=mod.float32)
    base.update(kw)
    return base


FAMILIES = {
    "dense": {},
    "mqa_qknorm": dict(n_kv_heads=1, qk_norm=True),
    "gelu": dict(mlp_gated=False),
    "vlm": dict(input_mode="prefix_embeds", prefix_len=3),
    "audio": dict(input_mode="embeds", vocab_size=64),
    "local_tied": dict(block_pattern=("dense", "local_attn"), local_window=3, n_layers=5,
                       tie_embeddings=True),
    # tests/test_models.py's recurrent families
    "ssd": dict(block_pattern=("ssd",), ssm_state=16, ssm_headdim=8, ssm_chunk=4),
    "hybrid": dict(n_layers=7, block_pattern=("rglru", "rglru", "local_attn"), rnn_width=32,
                   local_window=4),
    # dense and MoE layers in turn (qk-norm, one shared expert); capacity
    # factor E / k: no assignment drops, so a prefill, a decode step and
    # one full forward route every token alike
    "moe": dict(block_pattern=("dense", "moe"), qk_norm=True, n_experts=4, top_k=2,
                d_ff_expert=32, n_shared_experts=1, moe_capacity_factor=2.0),
}


def _family(fam):
    jcfg = jlm.LMConfig(**tiny(fam, jnp, **FAMILIES[fam]))
    cfg = lm.LMConfig(**tiny(fam, torch, **FAMILIES[fam]))
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    model = convert.load_jax_params(lm.LM(cfg, device="cpu"), tree)
    return jcfg, cfg, tree, model


def _batch(cfg, B=2, S=8, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.input_mode == "embeds":
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    return {"prefix_embeds": rng.standard_normal((B, cfg.prefix_len, cfg.d_model))
            .astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S - cfg.prefix_len)).astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_forward_matches_jax(fam):
    jcfg, cfg, tree, model = _family(fam)
    batch = _batch(cfg)
    got, caches, aux = model(_t(batch), return_aux=True)
    aux = aux.detach()
    assert caches is None and got.dtype == torch.float32
    want, _, jaux = jlm.forward(jcfg, tree, {k: jnp.asarray(v) for k, v in batch.items()})
    # fp32 through 4-5 layers; logits ~0.1: products and softmaxes summed in
    # other orders
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=2e-5)
    # the summed balance loss of the moe blocks (fp32 routing), zero without one
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5, abs=0)
    assert (float(aux) > 0) == ("moe" in cfg.block_pattern)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_prefill_decode_matches_full_forward(fam):
    """As tests/test_models.py does for the JAX model: prefill S-1 positions
    with a cache, decode the last one over it (dense path), compare with
    one cache-free forward (flash path), atol 5e-4."""
    _, cfg, _, model = _family(fam)
    B, S = 2, 8
    batch = _t(_batch(cfg, B, S))
    with torch.no_grad():
        full, _ = model(batch)
        if cfg.input_mode == "prefix_embeds":
            pre = {"prefix_embeds": batch["prefix_embeds"], "tokens": batch["tokens"][:, :-1]}
            dec = {"tokens": batch["tokens"][:, -1:]}
        else:
            key = "embeds" if cfg.input_mode == "embeds" else "tokens"
            pre, dec = {key: batch[key][:, :S - 1]}, {key: batch[key][:, -1:]}
        logits_pre, caches = model(pre, make_cache_len=S + 2)
        logits_dec, _ = model(dec, caches=caches, pos_offset=S - 1)
        last, _ = model(pre, make_cache_len=S + 2, last_only=True)
    np.testing.assert_allclose(_np(logits_dec), _np(full[:, -1:]), atol=5e-4)
    np.testing.assert_allclose(_np(logits_pre), _np(full[:, :S - 1]), atol=5e-4)
    assert torch.equal(last, logits_pre[:, -1:])


@pytest.mark.parametrize("fam", ["local_tied", "ssd", "hybrid", "moe"])
def test_token_by_token_decode_from_empty_caches_matches_full_forward(fam):
    """``init_caches`` has the JAX caches' shapes and values (ring caches of
    ``local_window`` slots for ``local_attn``, zero SSD / RG-LRU states and
    conv histories), and decoding one token at a time from them
    reproduces the full forward."""
    jcfg, cfg, _, model = _family(fam)
    caches = model.init_caches(2, 8)
    jcaches = jlm.init_caches(jcfg, 2, 8)
    period = len(cfg.block_pattern)
    for i, cache in enumerate(caches):
        want = jcaches["tail"][i - cfg.n_super * period] if i >= cfg.n_super * period \
            else jax.tree.map(lambda a: a[i // period], jcaches["scan"][f"b{i % period}"])
        assert cache.keys() == want.keys()
        for key in cache:
            assert tuple(cache[key].shape) == tuple(want[key].shape)
            assert str(cache[key].dtype).removeprefix("torch.") == np.asarray(want[key]).dtype.name
            assert np.array_equal(cache[key].float().numpy(), _np(want[key]))
        if model.blocks[i].btype == "local_attn":
            assert cache["k"].shape[1] == cfg.local_window
    batch = _t(_batch(cfg, 2, 8))
    with torch.no_grad():
        full, _ = model(batch)
        for t in range(8):
            step, caches = model({"tokens": batch["tokens"][:, t:t + 1]}, caches=caches,
                                 pos_offset=t)
            np.testing.assert_allclose(_np(step), _np(full[:, t:t + 1]), atol=5e-4)


def test_init_params_has_the_jax_shapes_and_scales():
    cfg = configs.get_config("qwen3-0.6b", reduced=True)
    model = lm.init_params(cfg, seed=0, device="cpu")
    jcfg = jconfigs.get_config("qwen3-0.6b", reduced=True)
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    flat = convert.flat_jax_params(model, tree)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        {n: tuple(a.shape) for n, a in flat.items()}
    std = {n: float(p.detach().std()) for n, p in model.named_parameters()}
    assert abs(std["embed"] - 0.02) < 2e-3
    assert abs(std["blocks.0.attn.wq"] - 128 ** -0.5) < 0.01
    assert abs(std["blocks.2.mlp.w_down"] - 256 ** -0.5) < 0.01
    assert torch.equal(model.blocks[1].attn.q_norm.scale, torch.ones(16))
    again = lm.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def test_converter_refuses_a_tree_that_does_not_fit():
    jcfg, cfg, tree, model = _family("dense")
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="extra"):
        convert.load_jax_params(model, bad)
    bad = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(KeyError, match="missing"):
        convert.load_jax_params(model, bad)
    bad = dict(tree, embed=tree["embed"][:, :5])
    with pytest.raises(ValueError):
        convert.load_jax_params(model, bad)


def test_model_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = configs.get_config("qwen3-0.6b", reduced=True)
    for build in (lambda: lm.init_params(cfg, seed=0), lambda: lm.LM(cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert lm.LM(cfg, device="cpu").device.type == "cpu"


MOE_ARCHS = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]


def _converted(arch, param_dtype=None):
    """(JAX config, JAX tree, the port's model loaded from it): the reduced
    config, optionally with bf16 parameters (the router stays fp32)."""
    jcfg, cfg = jconfigs.get_config(arch, reduced=True), configs.get_config(arch, reduced=True)
    if param_dtype is not None:
        jcfg = dataclasses.replace(jcfg, param_dtype=param_dtype)
        cfg = dataclasses.replace(cfg, param_dtype=DTYPES[param_dtype])
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tree, convert.load_jax_params(lm.LM(cfg, device="cpu"), tree)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_models_build_on_the_cpu(arch):
    """Both MoE families build (reduced, on the CPU) with the JAX tree's
    parameters: attention, ln2, the routed experts under ``moe`` and, for
    deepseek, the shared experts under ``shared``; fp32 router."""
    cfg = configs.get_config(arch, reduced=True)
    model = lm.LM(cfg, device="cpu")
    names = {n.split(".", 2)[2] for n, _ in model.named_parameters() if n.startswith("blocks.0.")}
    want = {"ln1.scale", "ln2.scale", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
            "moe.w_router", "moe.w_gate", "moe.w_up", "moe.w_down"}
    if cfg.qk_norm:
        want |= {"attn.q_norm.scale", "attn.k_norm.scale"}
    if cfg.n_shared_experts:
        want |= {"shared.w_gate", "shared.w_up", "shared.w_down"}
    assert names == want
    assert model.blocks[0].shared.w_up.shape == (cfg.d_model, 2 * cfg.d_ff_expert) \
        if cfg.n_shared_experts else not hasattr(model.blocks[0], "shared")
    built = lm.init_params(cfg, seed=0, device="cpu")
    assert all(bool(torch.isfinite(p).all()) for p in built.parameters())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_models_forward_matches_jax(arch):
    """The reduced MoE models from the JAX tree: logits as the dense
    families' (fp32, 1e-4 relative, 2e-5 absolute) and the summed balance
    loss within 1e-5 relative; their capacity (cf 2.0) is the config's."""
    jcfg, tree, model = _converted(arch)
    batch = _batch(model.cfg, 2, 16, seed=1)
    with torch.no_grad():
        got, _, aux = model(_t(batch), return_aux=True)
    want, _, jaux = jlm.forward(jcfg, tree, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=2e-5)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5) and float(aux) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_to_jax_tree_round_trip(arch):
    """A bf16 MoE model (fp32 router) to the JAX tree and back: the tree has
    the JAX leaves' paths, shapes and dtypes and their values bit for
    bit, and loads into a fresh model as the same parameters."""
    _, tree, model = _converted(arch, jnp.bfloat16)
    assert model.blocks[0].moe.w_router.dtype == torch.float32
    assert model.blocks[0].moe.w_gate.dtype == torch.bfloat16
    mine = convert.to_jax_tree(model)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        if isinstance(a, convert.BF16Bits):
            assert b.dtype.name == "bfloat16", jax.tree_util.keystr(path)
            assert np.array_equal(a.view(np.uint16), b.view(np.uint16))
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), jax.tree_util.keystr(path)
    back = convert.load_jax_params(lm.LM(model.cfg, device="cpu"), mine)
    for (n, p), (_, q) in zip(model.named_parameters(), back.named_parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), n


@pytest.mark.parametrize("arch,n_params", [("deepseek-moe-16b", 16_879_568_896),
                                           ("qwen3-moe-235b-a22b", 231_742_373_632)])
def test_moe_models_at_full_width_have_the_jax_shapes_and_dtypes(arch, n_params):
    """As for the recurrent models below (meta device, ``jax.eval_shape``):
    every parameter has its JAX leaf's shape and dtype; only the routers
    are fp32.  deepseek-moe-16b is 33.8 GB in bf16 and fits one 80 GB
    card; qwen3-moe-235b-a22b, 463 GB, does not."""
    shapes = jax.eval_shape(lambda: jlm.init_params(jconfigs.get_config(arch),
                                                    jax.random.PRNGKey(0)))
    tree = jax.tree.map(lambda a: np.broadcast_to(np.zeros((), a.dtype), a.shape), shapes)
    model = lm.LM(configs.get_config(arch), device="meta")
    flat = convert.flat_jax_params(model, tree)
    params = dict(model.named_parameters())
    assert flat.keys() == params.keys()
    for name, p in params.items():
        assert (tuple(p.shape), str(p.dtype).removeprefix("torch.")) == \
            (flat[name].shape, flat[name].dtype.name), name
    assert sum(p.numel() for p in params.values()) == n_params
    assert {n.split(".")[-1] for n, p in params.items() if p.dtype == torch.float32} == \
        {"w_router"}


@pytest.mark.parametrize("arch,n_params", [("mamba2-780m", 857_379_072),
                                           ("recurrentgemma-9b", 9_572_782_080)])
def test_recurrent_models_at_full_width_have_the_jax_shapes_and_dtypes(arch, n_params):
    """Every parameter of the full-width model (built on the meta device:
    nothing is allocated) has the shape and dtype of the JAX leaf that
    ``convert`` maps onto it — from ``jax.eval_shape`` of ``init_params``,
    whose leaves stand in as zero-stride NumPy views."""
    shapes = jax.eval_shape(lambda: jlm.init_params(jconfigs.get_config(arch),
                                                    jax.random.PRNGKey(0)))
    tree = jax.tree.map(lambda a: np.broadcast_to(np.zeros((), a.dtype), a.shape), shapes)
    model = lm.LM(configs.get_config(arch), device="meta")
    flat = convert.flat_jax_params(model, tree)
    params = dict(model.named_parameters())
    assert flat.keys() == params.keys()
    for name, p in params.items():
        assert (tuple(p.shape), str(p.dtype).removeprefix("torch.")) == \
            (flat[name].shape, flat[name].dtype.name), name
    assert sum(p.numel() for p in params.values()) == n_params
    fp32 = {n.split(".")[-1] for n, p in params.items() if p.dtype == torch.float32}
    assert fp32 == ({"A_log", "D", "dt_bias"} if arch == "mamba2-780m"
                    else {"lam", "w_r", "b_r", "w_i", "b_i"})


def test_converter_refuses_a_leaf_of_another_dtype():
    """A bf16 model keeps the RG-LRU's gate parameters in fp32: they load
    from the JAX bf16 tree exactly, and a leaf whose dtype differs from
    its parameter's is refused, either way round."""
    arch = "recurrentgemma-9b"
    jcfg = dataclasses.replace(jconfigs.get_config(arch, reduced=True), param_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True), param_dtype=torch.bfloat16)
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    model = convert.load_jax_params(lm.LM(cfg, device="cpu"), tree)
    lam = model.blocks[0].rec.lam
    assert lam.dtype == torch.float32
    assert np.array_equal(lam.detach().numpy(), tree["scan"]["b0"]["rec"]["lam"][0])
    assert model.blocks[0].rec.w_x.dtype == torch.bfloat16
    wide = jax.tree.map(lambda a: a, tree)
    wide["scan"]["b0"]["rec"]["w_x"] = tree["scan"]["b0"]["rec"]["w_x"].astype(np.float32)
    with pytest.raises(TypeError, match="w_x"):
        convert.load_jax_params(lm.LM(cfg, device="cpu"), wide)
    narrow = jax.tree.map(lambda a: a, tree)
    narrow["tail"][0]["rec"]["lam"] = tree["tail"][0]["rec"]["lam"].astype(jnp.bfloat16)
    with pytest.raises(TypeError, match="lam"):
        convert.load_jax_params(lm.LM(cfg, device="cpu"), narrow)
