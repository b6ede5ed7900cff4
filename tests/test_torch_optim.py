"""The PyTorch port's optimizer, gradient compression, data pipeline and
checkpoints against the JAX package's.

The same seeded NumPy inputs go to ``repro.optim`` / ``repro.data`` /
``repro.checkpoint`` and to their ports.  The optimizer's arithmetic is
fp32 in both, in the same order, so fp32 results agree to within a few
ulps of the schedule's fp32 ``pow`` and ``cos`` (tolerances stated at each
assertion); batches are bit-identical; checkpoints written by either
package restore in the other with identical leaves.
"""
import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import manager as jckpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.optim import compress  # noqa: E402

# the modules (each package's optim/__init__ re-exports a function named adamw)
adamw = importlib.import_module("repro_torch.optim.adamw")
jadamw = importlib.import_module("repro.optim.adamw")
jcompress = importlib.import_module("repro.optim.compress")

BF16_STEP = 2.0 ** -7   # one bf16 rounding step, relative


def _np(x):
    """fp32 NumPy copy of a torch tensor or a JAX/NumPy array (bf16 too)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def _leaves(seed):
    """Named leaves of several shapes and sizes, sorted by name (the order
    JAX flattens a dict in)."""
    rng = np.random.default_rng(seed)
    return {"a_embed": rng.standard_normal((13, 8)).astype(np.float32),
            "b_norm": (1 + 0.1 * rng.standard_normal(8)).astype(np.float32),
            "c_w": (rng.standard_normal((8, 5)) / 3).astype(np.float32)}


# ------------------------------------------------------------------ adamw
def test_cosine_schedule_matches_jax():
    mine = adamw.cosine_schedule(3e-3, warmup_steps=4, total_steps=20, min_ratio=0.1)
    ref = jadamw.cosine_schedule(3e-3, warmup_steps=4, total_steps=20, min_ratio=0.1)
    for step in range(0, 25):
        got, want = mine(step), ref(step)
        assert got.dtype == torch.float32
        # fp32 in both; cos of the same fp32 argument, to an ulp
        assert float(got) == pytest.approx(float(want), rel=2e-7, abs=1e-12)
    assert float(mine(0)) == 0.0 and float(mine(4)) == pytest.approx(3e-3, rel=1e-6)


def test_clip_by_global_norm_matches_jax():
    g = _leaves(1)
    g["c_w"] *= 40.0
    got, norm = adamw.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    want, jnorm = jadamw.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    for k in g:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-6, atol=1e-9)
    # bf16 gradients come back in bf16, as in JAX
    gb = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in g.items()}
    got, _ = adamw.clip_by_global_norm(gb, 1.0)
    assert all(t.dtype == torch.bfloat16 for t in got.values())


@pytest.mark.parametrize("param_dtype,moment_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_adamw_matches_jax_over_five_updates(param_dtype, moment_dtype):
    """Five AdamW updates (cosine schedule with warmup, clipping that
    bites on the first steps, weight decay on every leaf) from the same
    parameters and gradients.  fp32 parameters and moments agree within
    2e-6 relative (fp32 pow/cos/sqrt of the two libraries, to an ulp);
    bf16 ones within one bf16 step, where an fp32 ulp can round them to
    neighbouring values."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    sched = dict(warmup_steps=2, total_steps=5)
    mine_opt = adamw.adamw(adamw.cosine_schedule(1e-2, **sched), weight_decay=0.1,
                           moment_dtype=moment_dtype)
    ref_opt = jadamw.adamw(jadamw.cosine_schedule(1e-2, **sched), weight_decay=0.1,
                           moment_dtype=jdt[moment_dtype])
    p0 = _leaves(2)
    # copies: the port updates in place, and jnp.asarray may alias a NumPy buffer
    mine = {k: torch.tensor(v).to(param_dtype) for k, v in p0.items()}
    ref = {k: jnp.array(v).astype(jdt[param_dtype]) for k, v in p0.items()}
    m_state, r_state = mine_opt.init(mine), ref_opt.init(ref)
    assert m_state.count.dtype == torch.int32 and m_state.count.dim() == 0
    assert all(t.dtype == moment_dtype for t in m_state.mu.values())
    rng = np.random.default_rng(3)
    for step in range(5):
        g = {k: (rng.standard_normal(v.shape) * (3.0 if step < 2 else 0.05)).astype(np.float32)
             for k, v in p0.items()}
        gnorm = mine_opt.update({k: torch.from_numpy(v).to(param_dtype) for k, v in g.items()},
                                m_state, mine)
        ref, r_state, rnorm = ref_opt.update(
            {k: jnp.asarray(v).astype(jdt[param_dtype]) for k, v in g.items()}, r_state, ref)
        assert float(gnorm) == pytest.approx(float(rnorm), rel=1e-5)
    assert int(m_state.count) == int(r_state.count) == 5

    def close(got, want, dtype):
        if dtype == torch.bfloat16:
            np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_STEP, atol=1e-6)
        else:
            np.testing.assert_allclose(_np(got), _np(want), rtol=2e-6, atol=1e-7)

    for k in p0:
        assert mine[k].dtype == param_dtype
        close(mine[k], ref[k], param_dtype)
        close(m_state.mu[k], r_state.mu[k], moment_dtype)
        close(m_state.nu[k], r_state.nu[k], moment_dtype)


def test_adamw_without_clipping_and_constant_lr():
    opt = adamw.adamw(0.1, weight_decay=0.0, max_grad_norm=None)
    w = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(w)
    for _ in range(120):
        assert float(opt.update({"w": 2 * w["w"]}, state, w)) == 0.0
    assert float(w["w"].abs().max()) < 0.1


# ---------------------------------------------------------------- compress
@pytest.mark.parametrize("codec", ["int8", "topk", "none"])
def test_compressed_gradients_match_jax(codec):
    """The round trip and the error feedback, twice (the second step adds
    the first's residual back).  int8: the same quantisation levels
    (rounding half to even in both), values within 1e-6 relative of the
    scale; topk: the same kept entries, exactly."""
    g1, g2 = _leaves(4), _leaves(5)
    kw = dict(codec=codec, topk_frac=0.1)
    mine, m_ef = compress.compressed_gradients({k: torch.from_numpy(v) for k, v in g1.items()},
                                               None, **kw)
    ref, r_ef = jcompress.compressed_gradients({k: jnp.asarray(v) for k, v in g1.items()},
                                               None, **kw)
    mine, m_ef = compress.compressed_gradients({k: torch.from_numpy(v) for k, v in g2.items()},
                                               m_ef, **kw)
    ref, r_ef = jcompress.compressed_gradients({k: jnp.asarray(v) for k, v in g2.items()},
                                               r_ef, **kw)
    for k in g1:
        np.testing.assert_allclose(_np(mine[k]), np.asarray(ref[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(_np(m_ef[k]), np.asarray(r_ef[k]), rtol=1e-6, atol=1e-7)
        if codec == "topk":
            np.testing.assert_array_equal(_np(mine[k]) != 0, np.asarray(ref[k]) != 0)
            assert (_np(mine[k]) != 0).sum() >= max(1, int(g1[k].size * 0.1))
        if codec == "int8":
            scale = np.abs(g2[k] + _np(m_ef[k]) * 0).max() / 127.0
            assert np.unique(np.round(_np(mine[k]) / max(scale, 1e-12))).size <= 255
    with pytest.raises(ValueError):
        compress.compressed_gradients({"a": torch.ones(3)}, codec="fp4")


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "musicgen-medium", "internvl2-26b"])
def test_synth_batch_is_bit_identical_to_jax(arch):
    """tokens, embeds (audio) and prefix_embeds (VLM) input modes, two
    steps, two shards."""
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch, reduced=True)
    for step, shard, n_shards in ((0, 0, 1), (7, 1, 2)):
        got = pipeline.synth_batch(cfg, 4, 16, step, seed=3, shard=shard, n_shards=n_shards)
        want = jpipe.synth_batch(jcfg, 4, 16, step, seed=3, shard=shard, n_shards=n_shards)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_data_pipeline_prefetches_on_the_ports_runtime():
    cfg = get_config("qwen3-0.6b", reduced=True)
    with api.runtime_start(n_workers=2) as rt:
        pipe = pipeline.DataPipeline(cfg, 4, 16, prefetch_depth=2)
        b0, b1 = pipe.get(), pipe.get()
        b5 = pipe.get(5)
        assert {6, 7} <= set(pipe._pending)             # two steps ahead of the consumer
        stats = rt.tracer.task_duration_stats()
    assert stats["data_prefetch"]["count"] >= 5
    for step, got in ((0, b0), (1, b1), (5, b5)):
        want = pipeline.synth_batch(cfg, 4, 16, step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    direct = pipeline.DataPipeline(cfg, 4, 16, use_runtime=False)
    np.testing.assert_array_equal(direct.get(5)["tokens"], b5["tokens"])


# ------------------------------------------------------------- checkpoints
def _jax_state(arch, moment_dtype=jnp.float32):
    jcfg = jget_config(arch, reduced=True)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    opt = jadamw.adamw(1e-3, moment_dtype=moment_dtype)
    state = opt.init(params)
    # moments and count that are not all zeros
    state = jadamw.AdamWState(jnp.asarray(3, jnp.int32),
                              jax.tree.map(lambda p: (p * 0.5).astype(moment_dtype), params),
                              jax.tree.map(lambda p: (p * p).astype(moment_dtype), params))
    return {"params": params, "opt": state}


def _port_state(arch, moment_dtype=torch.float32, param_dtype=None):
    from repro_torch.launch.train import state_tree
    cfg = get_config(arch, reduced=True)
    if param_dtype is not None:
        import dataclasses
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    model = lm.init_params(cfg, seed=0, device="cpu")
    opt = adamw.adamw(1e-3, moment_dtype=moment_dtype)
    state = opt.init(dict(model.named_parameters()))
    state.count.fill_(3)
    for n, p in model.named_parameters():
        state.mu[n].copy_(p * 0.5)
        state.nu[n].copy_(p * p)
    return model, state, state_tree(model, state)


def _jax_leaf_list(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-780m", "recurrentgemma-9b",
                                  "deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_checkpoint_names_and_manifest_equal_jaxs(tmp_path, arch):
    """The port's ``{"params", "opt"}`` tree saves under the JAX package's
    leaf names, in its order, with its shapes and dtypes: the manifests
    are equal.  Reduced qwen3 has 43 leaves (14 parameters, the count,
    14 + 14 moments)."""
    _, _, tree = _port_state(arch)
    jtree = _jax_state(arch)
    ckpt.save_checkpoint(str(tmp_path / "port"), tree, step=3)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jtree, step=3)
    mine = json.loads((tmp_path / "port" / "step_00000003" / "manifest.json").read_text())
    ref = json.loads((tmp_path / "jax" / "step_00000003" / "manifest.json").read_text())
    assert mine == ref
    assert [m["name"] for m in mine["leaves"]] == [n for n, _ in jckpt._leaf_files(jtree)]
    if arch == "qwen3-0.6b":
        names = [m["name"] for m in mine["leaves"]]
        assert len(names) == 43
        assert {"params_scan_b0_attn_wq", "opt_.count", "opt_.mu_embed"} <= set(names)
        shape = {m["name"]: m["shape"] for m in mine["leaves"]}
        assert shape["params_scan_b0_attn_wq"] == [3, 128, 128] and shape["opt_.count"] == []


FP32 = (torch.float32, torch.float32, jnp.float32)
BF16 = (torch.bfloat16, torch.bfloat16, jnp.bfloat16)


@pytest.mark.parametrize("arch,dtypes", [("qwen3-0.6b", FP32), ("qwen3-0.6b", BF16),
                                         ("deepseek-moe-16b", BF16),
                                         ("qwen3-moe-235b-a22b", BF16)],
                         ids=["fp32", "bf16", "deepseek-moe-16b-bf16", "qwen3-moe-235b-bf16"])
def test_checkpoints_restore_across_the_two_packages(tmp_path, arch, dtypes):
    """A port checkpoint restores in JAX and a JAX checkpoint in the port,
    with identical leaves (bf16 parameters and moments bit for bit; a bf16
    MoE model keeps its routers in fp32, so its leaves mix the two)."""
    param_dtype, moment_dtype, jmoment = dtypes
    model, state, tree = _port_state(arch, moment_dtype, param_dtype)
    # port -> JAX
    ckpt.save_checkpoint(str(tmp_path / "a"), tree, step=3)
    jcfg = jget_config(arch, reduced=True)
    if param_dtype == torch.bfloat16:
        import dataclasses
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    jtarget = {"params": jparams, "opt": jadamw.adamw(1e-3, moment_dtype=jmoment).init(jparams)}
    restored, step = jckpt.restore_checkpoint(str(tmp_path / "a"), jtarget)
    assert step == 3
    for (kp, got), (kq, want) in zip(_jax_leaf_list(restored), ckpt._paths(tree)):
        assert kp == kq
        want = np.asanyarray(want)
        if isinstance(want, convert.BF16Bits):
            assert got.dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
        else:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    # JAX -> port: restore the JAX leaves into a fresh port model and state
    jckpt.save_checkpoint(str(tmp_path / "b"), restored, step=4)
    from repro_torch.launch.train import load_state, state_tree
    fresh, fstate, _ = _port_state(arch, moment_dtype, param_dtype)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    back, step = ckpt.restore_checkpoint(str(tmp_path / "b"), state_tree(fresh, fstate))
    assert step == 4
    load_state(fresh, fstate, back)
    for (n, p), (_, q) in zip(model.named_parameters(), fresh.named_parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), n
    for name in state.mu:
        assert torch.equal(state.mu[name], fstate.mu[name])
        assert torch.equal(state.nu[name], fstate.nu[name])
    assert int(fstate.count) == 3
    if arch != "qwen3-0.6b":    # the mixed dtypes crossed both ways
        assert fresh.blocks[0].moe.w_router.dtype == torch.float32
        assert fresh.blocks[0].moe.w_gate.dtype == param_dtype


def test_checkpoint_manager_keeps_the_newest_and_saves_as_a_task(tmp_path):
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "nested": {"b": torch.ones((2, 2), dtype=torch.bfloat16) * 1.5,
                       "c": [np.zeros(3, np.int32), np.ones(1)]}}
    with api.runtime_start(n_workers=2) as rt:
        m = ckpt.CheckpointManager(str(tmp_path), keep=2, use_runtime=True)
        for s in (1, 2, 3):
            m.save(tree, s, blocking=False)
            m.wait()
        m.save(tree, 4)
        assert rt.tracer.task_duration_stats()["checkpoint_save"]["count"] == 3
    assert m.latest_step() == 4
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000003", "step_00000004"]
    back, step = m.restore(tree)
    assert step == 4 and back["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(back["nested"]["b"], tree["nested"]["b"])
    np.testing.assert_array_equal(back["a"].numpy(), tree["a"])
    # the JAX package reads it too
    jback, _ = jckpt.restore_checkpoint(str(tmp_path), {
        "a": jnp.zeros((3, 4)), "nested": {"b": jnp.zeros((2, 2), jnp.bfloat16),
                                           "c": [jnp.zeros(3, jnp.int32), jnp.zeros(1)]}})
    assert np.asarray(jback["nested"]["b"]).astype(np.float32).tolist() == [[1.5, 1.5]] * 2
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(str(tmp_path), {"a": np.ones(3)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), tree)
