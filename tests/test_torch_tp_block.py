"""The port's tensor-parallel sublayers (``layers/tp_block.py``) against
the replicated model and against the JAX package's shard_map TP path.

On four gloo ranks (one spawn, ``tests/_torch_dist_jobs.py``), reduced
granite-3-2b (GQA 8 / 2: K/V shard with their q-head groups at tp 2 and
are replicated at tp 4) and recurrentgemma-9b (MQA, RG-LRU + local
attention: K/V replicated) with ``tp_block="shard_map"`` go through the
train step's gradient path (``steps.mesh_gradients``) on (2, 2) and
(1, 4) meshes, from the reference's seed-0 weights and the SMOKE
``train_4k`` batch of 4.  Held as the reference's own
``test_tp_shard_map_equals_gspmd`` holds its TP path: the loss within
1e-4 and every gradient within 1e-3 of the replicated model (the same
model on one device), and the loss within 1e-4 of the reference's
shard_map loss (``repro.models.lm.loss_fn`` on an Auto-axes mesh of four
forced host devices, in a subprocess).  At one rank the sublayers equal
the plain layers they slice; the routing conditions and the gradient
rule are held against the reference's conditions.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_dist_jobs as jobs  # noqa: E402
import torch.distributed as dist  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
ARCHS = ["granite-3-2b", "recurrentgemma-9b"]
SHAPES = [(2, 2), (1, 4)]
CASES = [(a, s) for a in ARCHS for s in SHAPES]
IDS = [f"{a}-{s[0]}x{s[1]}" for a, s in CASES]

# the reference's shard_map TP loss on (2, 2) and (1, 4) Auto meshes
REF_SCRIPT = textwrap.dedent('''
    import dataclasses, sys
    import numpy as np, jax
    from repro.configs import SMOKE_SHAPES, get_config, make_batch
    from repro.models.lm import init_params, loss_fn
    out = {}
    for shape in ((2, 2), (1, 4)):
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        for arch in sys.argv[2:]:
            cfg = dataclasses.replace(get_config(arch, reduced=True), tp_block="shard_map")
            b = make_batch(cfg, dataclasses.replace(SMOKE_SHAPES["train_4k"], batch=4))["batch"]
            params = init_params(cfg, jax.random.PRNGKey(0))
            loss, _ = jax.jit(lambda p, bb: loss_fn(cfg, p, bb, mesh=mesh))(params, b)
            out[f"{arch}/{shape[0]}x{shape[1]}"] = np.asarray(loss)
    np.savez(sys.argv[1], **out)
''')


def _jax_weights(arch):
    """Reduced ``arch``'s seed-0 JAX weights by the port's parameter names."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import lm as jlm
    from repro_torch.models import convert, lm
    tree = jax.tree.map(np.asarray, jlm.init_params(jget_config(arch, reduced=True),
                                                    jax.random.PRNGKey(0)))
    model = convert.load_jax_params(lm.LM(jobs.tp_config(arch), device="cpu"), tree)
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def ws4(tmp_path_factory):
    """One spawn of 4 ranks: every (arch, mesh) case, then the replicated
    model's gradients spread over the ranks; the reference's subprocess
    runs meanwhile."""
    out = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, out, *ARCHS], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    weights = {a: _jax_weights(a) for a in ARCHS}
    cases = [((a, s), a, s, weights[a]) for a, s in CASES]
    plain = [(a, jobs.tp_gradients, (a, None, weights[a]), {}) for a in ARCHS]
    results = jobs.run_world(4, jobs.in_order, [(jobs.tp_cases, (cases,)),
                                                (jobs.spread, (plain,))])
    _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-4000:]
    return [r[0] for r in results], jobs.merged(r[1] for r in results), dict(np.load(out))


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_tp_equals_the_replicated_model(ws4, arch, shape):
    """Every rank reports the same loss; the loss within 1e-4 and every
    gradient (the step's sums over data and, for the sublayers'
    parameters, over model) within 1e-3 of the replicated model's."""
    results, plain, _ = ws4
    losses = [r[(arch, shape)][0] for r in results]
    assert len(set(losses)) == 1, losses
    loss, grads = results[0][(arch, shape)]
    want_loss, want = plain[arch]
    assert abs(loss - want_loss) < 1e-4, (loss, want_loss)
    assert set(grads) == set(want)
    for n, g in want.items():
        diff = float((grads[n] - g).abs().max())
        assert diff < 1e-3, (n, diff)
        assert float(g.abs().max()) == 0 or float(grads[n].abs().max()) > 0, n


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_tp_loss_matches_the_reference_shard_map_loss(ws4, arch, shape):
    results, _, ref = ws4
    want = float(ref[f"{arch}/{shape[0]}x{shape[1]}"])
    assert abs(results[0][(arch, shape)][0] - want) < 1e-4, (results[0][(arch, shape)][0], want)


# ------------------------------------------------------- routing and the rule
def test_tp_routes_follow_the_reference_conditions():
    """``repro/models/lm.py:269-284`` and ``:326-334``: attention needs
    shard_map, tp > 1 and heads % tp == 0, its MLP also d_ff % tp == 0
    (else the replicated MLP); rglru needs rnn and d_ff to divide."""
    from repro_torch.models.lm import tp_routes
    g = jobs.tp_config("granite-3-2b")                       # 8 heads, d_ff 256
    assert tp_routes(g, "dense", 2) == (True, True)
    assert tp_routes(g, "dense", 1) == (False, False)
    assert tp_routes(jobs.tp_config("granite-3-2b", "gspmd"), "dense", 2) == (False, False)
    assert tp_routes(dataclasses.replace(g, n_heads=6), "dense", 4) == (False, False)
    assert tp_routes(dataclasses.replace(g, d_ff=250), "dense", 4) == (True, False)
    assert tp_routes(g, "moe", 2) == (True, False)
    assert tp_routes(g, "ssd", 2) == (False, False)
    r = jobs.tp_config("recurrentgemma-9b")                  # rnn 128, d_ff 256
    assert tp_routes(r, "rglru", 4) == (True, True)
    assert tp_routes(dataclasses.replace(r, d_ff=250), "rglru", 4) == (False, False)
    assert tp_routes(dataclasses.replace(r, rnn_width=126), "rglru", 4) == (False, False)


def test_partial_over_model_names_the_sliced_parameters():
    """The gradient rule: the sublayers' parameters (norms included) and
    the routed experts are summed over model; the embedding, final norm,
    head, MoE router, its norm and shared experts are not."""
    from repro_torch.models import lm
    g = lm.LM(jobs.tp_config("granite-3-2b"), device="meta")
    names = lm.partial_over_model(g, 2)
    assert names == {n for n, _ in g.named_parameters() if n.startswith("blocks.")}
    assert lm.partial_over_model(g, 1) == set()
    assert lm.partial_over_model(lm.LM(jobs.tp_config("granite-3-2b", "gspmd"),
                                       device="meta"), 2) == set()
    fallback = lm.LM(dataclasses.replace(jobs.tp_config("granite-3-2b"), d_ff=250),
                     device="meta")
    names = lm.partial_over_model(fallback, 4)
    assert names and not any(".mlp." in n or ".ln2." in n for n in names)
    d = lm.LM(jobs.tp_config("deepseek-moe-16b"), device="meta")
    names = lm.partial_over_model(d, 4)
    for i in range(d.cfg.n_layers):
        for w in ("w_gate", "w_up", "w_down"):
            assert f"blocks.{i}.moe.{w}" in names
        assert f"blocks.{i}.attn.wq" in names and f"blocks.{i}.ln1.scale" in names
        for n in ("moe.w_router", "ln2.scale", "shared.w_up"):
            assert f"blocks.{i}.{n}" not in names
    assert lm.partial_over_model(lm.LM(jobs.tp_config("deepseek-moe-16b", "gspmd"),
                                       device="meta"), 4) == {
        f"blocks.{i}.moe.{w}" for i in range(2) for w in ("w_gate", "w_up", "w_down")}


# ------------------------------------------------------------- one rank
@pytest.fixture
def one_rank():
    """A gloo group of one rank: the sublayers' all-reduces move nothing."""
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=0, world_size=1)
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


def _layers(kind):
    """(cfg, block type, the block, x) of a small fp32 block with random
    weights."""
    from repro_torch.models import lm
    cfgs = {
        "gqa": dataclasses.replace(jobs.tp_config("granite-3-2b"), n_layers=1),
        "gqa-qknorm": dataclasses.replace(jobs.tp_config("granite-3-2b"), n_layers=1,
                                          qk_norm=True),
        "local-mqa": dataclasses.replace(jobs.tp_config("recurrentgemma-9b"), n_layers=3,
                                         local_window=8),
        "gelu-mlp": dataclasses.replace(jobs.tp_config("granite-3-2b"), n_layers=1,
                                        mlp_gated=False),
    }
    cfg = cfgs["local-mqa" if kind == "rglru" else kind]
    model = lm.init_params(cfg, seed=1, device="cpu")
    blk = model.blocks[0 if kind == "rglru" else -1]
    with torch.no_grad():
        for n, p in blk.named_parameters():            # norms off their ones
            if n.endswith("scale"):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(3)))
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(2))
    return cfg, blk, x


@pytest.mark.parametrize("kind", ["gqa", "gqa-qknorm", "local-mqa", "gelu-mlp", "rglru"])
def test_sublayers_at_one_rank_equal_the_plain_layers(one_rank, kind):
    """At one rank each sublayer is its plain layer: ``x + attn(ln1(x))``
    (window and qk-norm included), ``x + mlp(ln2(x))`` and
    ``x + rec(ln1(x))``: forward bitwise (the same ops on whole slices),
    and the gradients of x and every parameter within 1e-6."""
    from repro_torch.layers import tp_block
    cfg, blk, x = _layers(kind)
    window = cfg.local_window if blk.btype == "local_attn" else None

    def tp(x):
        if kind == "rglru":
            return tp_block.tp_rglru_sublayer(blk.ln1, blk.rec, x, group=one_rank)
        if kind == "gelu-mlp":
            return tp_block.tp_mlp_sublayer(blk.ln2, blk.mlp, x, group=one_rank)
        return tp_block.tp_attn_sublayer(blk.ln1, blk.attn, x, cfg=cfg, group=one_rank,
                                         window=window)

    def plain(x):
        if kind == "rglru":
            return x + blk.rec(blk.ln1(x))[0]
        if kind == "gelu-mlp":
            return x + blk.mlp(blk.ln2(x))
        return x + blk.attn(blk.ln1(x), window=window)[0]

    got = {}
    for name, fn in (("tp", tp), ("plain", plain)):
        xi = x.clone().requires_grad_()
        blk.zero_grad()
        out = fn(xi)
        (out * torch.linspace(-1, 1, out.numel()).view_as(out)).sum().backward()
        got[name] = (out.detach(), xi.grad,
                     {n: p.grad.clone() for n, p in blk.named_parameters() if p.grad is not None})
    assert torch.equal(got["tp"][0], got["plain"][0])
    torch.testing.assert_close(got["tp"][1], got["plain"][1], rtol=0, atol=1e-6)
    assert set(got["tp"][2]) == set(got["plain"][2])
    for n, g in got["plain"][2].items():
        torch.testing.assert_close(got["tp"][2][n], g, rtol=0, atol=1e-6, msg=n)


def test_tp_attention_off_position_zero_uses_the_plain_paths(one_rank):
    """At a nonzero ``pos_offset`` the sublayer attends through the dense
    and chunked paths, as the attention layer does: equal to the layer."""
    from repro_torch.layers import tp_block
    cfg, blk, x = _layers("gqa")
    for c in (cfg, dataclasses.replace(cfg, attn_impl="chunked", attn_chunk=8)):
        got = tp_block.tp_attn_sublayer(blk.ln1, blk.attn, x, cfg=c, group=one_rank,
                                        pos_offset=5)
        want = x + blk.attn(blk.ln1(x), pos_offset=5, impl=c.attn_impl, chunk=c.attn_chunk)[0]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_sublayers_refuse_what_does_not_divide():
    from repro_torch.layers import tp_block
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=3)
    try:
        cfg, blk, x = _layers("gqa")
        with pytest.raises(ValueError, match="heads do not divide over 3"):
            tp_block.tp_attn_sublayer(blk.ln1, blk.attn, x, cfg=cfg, group=dist.group.WORLD)
        with pytest.raises(ValueError, match="d_ff columns do not divide over 3"):
            tp_block.tp_mlp_sublayer(blk.ln2, blk.mlp, x, group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
