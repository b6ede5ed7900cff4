"""The PyTorch port's training path against the JAX package's.

``repro_torch.models.lm.loss_fn`` and its gradients are held against
``jax.value_and_grad(repro.models.lm.loss_fn)`` on the reduced qwen3,
mamba2, recurrentgemma, deepseek-moe and qwen3-moe configs (the MoE
balance loss included) from the JAX ``init_params`` tree
(carried across by ``load_jax_params``) and the same ``synth_batch``
batch; the port's ``train_loop`` against the JAX ``train_loop`` from the
same parameters and data.  On the CPU the port's ops run the kernels'
plain versions, and autograd runs through them; the autograd Functions
that carry the kernels on the card are tested here with the plain
version standing in for the kernel.  All in fp32: tolerances are stated
at each assertion.
"""
import functools
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import synth_batch  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan as trglru  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
MOE_ARCHS = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]
ARCHS = ["qwen3-0.6b", "mamba2-780m", "recurrentgemma-9b"] + MOE_ARCHS


def _converted(arch, seed=0):
    """(JAX tree, the port's model loaded from it) for the reduced config."""
    tree = jax.tree.map(np.asarray, jlm.init_params(jget_config(arch, reduced=True),
                                                    jax.random.PRNGKey(seed)))
    return tree, convert.load_jax_params(lm.LM(get_config(arch, reduced=True), device="cpu"),
                                         tree)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_loss_and_grads(model, batch, remat=None):
    model.zero_grad(set_to_none=True)
    total, metrics = lm.loss_fn(model, _t(batch), remat=remat)
    total.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return total.detach(), metrics, grads


# ------------------------------------------------------------ loss and grads
# the RG-LRU gate parameters: their gradients sum terms of both signs over
# every position and channel of a recurrence the reference evaluates with
# an associative scan and the port step by step; measured up to 3.3e-4 of
# the leaf's largest magnitude (every other leaf: at most 1.1e-5)
GATES = ("lam", "w_r", "b_r", "w_i", "b_i")


def grad_tol(path: str) -> float:
    """Largest |Δ| of a gradient leaf, relative to its largest magnitude."""
    return 1e-3 if path.split(".")[-1] in GATES else 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    """Loss and the MoE balance loss (zero without a ``moe`` block) within
    1e-5 relative; every gradient leaf within ``grad_tol`` of the JAX
    leaf's largest magnitude (fp32 sums in other orders through 2-5
    layers and a 512-way softmax)."""
    jcfg = jget_config(arch, reduced=True)
    tree, model = _converted(arch)
    batch = synth_batch(get_config(arch, reduced=True), 2, 24, step=1)
    total, metrics, grads = _port_loss_and_grads(model, batch)
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b), has_aux=True))(
            tree, {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(total) == pytest.approx(float(jtotal), rel=1e-5)
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-5)
    assert float(metrics["aux"]) == pytest.approx(float(jmetrics["aux"]), rel=1e-5, abs=0)
    assert (float(metrics["aux"]) > 0) == (arch in MOE_ARCHS)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == 2 * 23
    mine = convert.to_jax_tree(model, grads)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat] == \
        [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(mine)[0]]
    for (path, want), got in zip(flat, jax.tree_util.tree_leaves(mine)):
        want, key = np.asarray(want), jax.tree_util.keystr(path)
        assert np.abs(want).max() > 0, key
        tol = grad_tol(key.replace("']['", ".").strip("[']"))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=key)


def test_loss_fn_counts_only_unmasked_positions():
    _, model = _converted("qwen3-0.6b")
    batch = synth_batch(get_config("qwen3-0.6b", reduced=True), 2, 12, step=0)
    _, full = lm.loss_fn(model, _t(batch))
    batch["loss_mask"][:, 6:] = 0.0
    with torch.no_grad():
        logits, _ = model(_t(batch))
        lp = torch.log_softmax(logits[:, :6], dim=-1)
        want = -lp.gather(-1, torch.from_numpy(batch["targets"][:, :6]).long()[..., None]).mean()
        total, half = lm.loss_fn(model, _t(batch))
    assert float(half["tokens"]) == 12 and float(full["tokens"]) == 22
    assert float(total) == pytest.approx(float(want), rel=1e-6)
    with pytest.raises(ValueError):
        lm.loss_fn(model, _t(batch), remat="some")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_the_same_loss_and_gradients(arch):
    """``remat`` none, full (each block checkpointed) and dots (matmul
    outputs kept) change memory, not the numbers: equal loss and
    gradients (within 1e-6 of each leaf's scale: a recomputed forward
    runs the same ops)."""
    _, model = _converted(arch)
    batch = synth_batch(get_config(arch, reduced=True), 2, 16, step=2)
    ref = _port_loss_and_grads(model, batch, remat="none")
    for remat in ("full", "dots"):
        total, _, grads = _port_loss_and_grads(model, batch, remat=remat)
        assert float(total) == float(ref[0])
        for name, g in ref[2].items():
            torch.testing.assert_close(grads[name], g, rtol=0,
                                       atol=1e-6 * float(g.abs().max()), msg=name)


# ---------------------------------------------------------- the Functions
def _grads(fn, leaves, views, cotangent_seed=1, skip_last_output=False):
    xs = [t.detach().clone().requires_grad_() for t in leaves]
    out = fn(*views(xs))
    out = out if isinstance(out, tuple) else (out,)
    if skip_last_output:
        out = out[:-1]
    gen = torch.Generator().manual_seed(cotangent_seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=gen)).sum() for o in out)
    return torch.autograd.grad(loss, xs)


def _function_cases():
    rng = np.random.default_rng(0)

    def n(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def same(xs):
        return xs

    def heads(xs):
        return [t.transpose(1, 2) for t in xs]

    def ssd_views(xs, H=3, P=8, N=5):
        p, d, a = xs
        return (p[..., :H * P].reshape(*p.shape[:2], H, P), d, a, p[..., H * P:H * P + N],
                p[..., H * P + N:])

    flash = functools.partial(tflash.flash_attention_plain, window=5)
    ssd = functools.partial(tssd.ssd_scan_plain, chunk=4)
    return {
        "rmsnorm": (trms.rmsnorm_plain, [n(7, 3, 16), n(16)], same),
        "flash_attention": (flash, [n(2, 11, 4, 16), n(2, 11, 2, 16), n(2, 11, 2, 16)], heads),
        "ssd_scan": (ssd, [n(2, 10, 3 * 8 + 10), torch.nn.functional.softplus(n(2, 10, 3)),
                           -torch.linspace(1.0, 3.0, 3)], ssd_views),
        "rglru_scan": (trglru.rglru_scan_plain,
                       [-torch.nn.functional.softplus(n(2, 9, 6)), n(2, 9, 6), n(2, 6)], same),
    }


@pytest.mark.parametrize("kernel", ["rmsnorm", "flash_attention", "ssd_scan", "rglru_scan"])
def test_kernel_function_backward_matches_autograd_of_the_plain_version(kernel):
    """``ops.KernelFunction`` with the plain version standing in for the
    kernel: its backward (the plain version recomputed on the saved
    inputs, strided views included) gives every input exactly the
    gradient autograd gives through the plain version — with cotangents
    on every output, and with the scans' second output (final state,
    h_T) unused, whose gradient is then left out."""
    plain, leaves, views = _function_cases()[kernel]
    fn = functools.partial(ops.KernelFunction.apply, plain, plain)
    for skip in ((False, True) if kernel in ("ssd_scan", "rglru_scan") else (False,)):
        got = _grads(fn, leaves, views, skip_last_output=skip)
        want = _grads(plain, leaves, views, skip_last_output=skip)
        for a, b in zip(got, want):
            assert a is not None and a.shape == b.shape and a.dtype == b.dtype
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    # an input that needs no gradient gets none
    xs = [t.detach().clone() for t in leaves]
    xs[0].requires_grad_()
    out = fn(*views(xs))
    (out[0] if isinstance(out, tuple) else out).sum().backward()
    assert xs[0].grad is not None and all(t.grad is None for t in xs[1:])


def _through_functions(monkeypatch):
    """Route the model's ops through ``ops.KernelFunction`` on the CPU, the
    plain version standing in for each kernel: the card's autograd path."""
    def wrap(plain):
        return lambda *a, **kw: ops.KernelFunction.apply(functools.partial(plain, **kw),
                                                         functools.partial(plain, **kw), *a)
    monkeypatch.setattr(ops, "rmsnorm", wrap(trms.rmsnorm_plain))
    monkeypatch.setattr(ops, "flash_attention", wrap(tflash.flash_attention_plain))
    monkeypatch.setattr(ops, "ssd_scan", wrap(tssd.ssd_scan_plain))
    monkeypatch.setattr(ops, "rglru_scan", wrap(trglru.rglru_scan_plain))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_gradients_through_the_functions_match(arch, monkeypatch):
    """The whole model with every kernel op inside its autograd Function
    (plain version standing in), under remat none and full: the loss
    exactly and the gradients within 1e-5 of each leaf's scale of the
    direct autograd (the Functions' backwards add the same terms in
    another order; measured up to 6.5e-6, in ``A_log``, a sum over every
    position)."""
    _, model = _converted(arch)
    batch = synth_batch(get_config(arch, reduced=True), 2, 16, step=3)
    ref = _port_loss_and_grads(model, batch, remat="none")
    _through_functions(monkeypatch)
    for remat in ("none", "full"):
        total, _, grads = _port_loss_and_grads(model, batch, remat=remat)
        assert float(total) == float(ref[0])
        for name, g in ref[2].items():
            assert grads[name] is not None, name
            torch.testing.assert_close(grads[name], g, rtol=0,
                                       atol=1e-5 * float(g.abs().max()), msg=name)


def test_knn_and_kmeans_refuse_inputs_that_require_grad():
    """Neither has a gradient (as their Pallas calls have none under
    jax.grad): the ops refuse such inputs on the CPU as on the card, and
    the CUDA wrappers refuse them before anything else."""
    from repro_torch.kernels import kmeans_assign as tkm
    from repro_torch.kernels import knn_topk as tknn
    x = torch.randn((20, 4), requires_grad=True)
    labels = torch.zeros(20, dtype=torch.int32)
    for call in (lambda: ops.knn_topk(x, x.detach(), labels, k=3),
                 lambda: ops.kmeans_assign(x.detach(), x[:3]),
                 lambda: tknn.knn_topk_cuda(x, x.detach(), labels, 3),
                 lambda: tkm.kmeans_assign_cuda(x.detach(), x[:3])):
        with pytest.raises(RuntimeError, match="no gradient"):
            call()
    with torch.no_grad():
        assert ops.knn_topk(x, x, labels, k=3)[0].shape == (20, 3)
        assert ops.kmeans_assign(x, x[:3])[1].sum() == 20


# --------------------------------------------------------------- train_loop
# the reference's own mesh (make_local_mesh) takes jax's default Explicit
# axes, on which its embedding gather raises under the installed jax; the
# same 1 x 1 mesh with Auto axes runs it as written
def _jax_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.mark.parametrize("kw", [{}, {"microbatches": 2}, {"grad_compress": "int8"}],
                         ids=["plain", "microbatches2", "int8"])
def test_train_loop_matches_jax(kw):
    """Five steps of the port's ``train_loop`` and the JAX one, from the
    JAX ``init_params`` of seed 0 and the same prefetched batches
    (cosine schedule, warmup 2, AdamW with clipping): losses within 1e-4
    relative (fp32; measured ~1e-6)."""
    cfg, jcfg = get_config("qwen3-0.6b", reduced=True), jget_config("qwen3-0.6b", reduced=True)
    _, model = _converted("qwen3-0.6b", seed=0)
    common = dict(steps=5, batch=4, seq=16, lr=1e-3, warmup=2, workers=2, seed=0, log_every=0)
    mine = train.train_loop(cfg, device="cpu", model=model, **common, **kw)
    want = jtrain.train_loop(jcfg, mesh=_jax_mesh(), **common, **kw)
    assert mine["steps_done"] == 5 and mine["restored_from"] is None
    assert len(mine["step_seconds"]) == 5 and mine["tokens_per_s"] > 0
    np.testing.assert_allclose(mine["losses"], want["losses"], rtol=1e-4)
    assert mine["losses"][-1] != mine["losses"][0]


@pytest.mark.parametrize("kw", [{}, {"microbatches": 2}], ids=["plain", "microbatches2"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_loop_matches_jax(arch, kw):
    """The reduced MoE models: four steps of the port's ``train_loop`` and
    the JAX one from the same parameters and batches, losses within 1e-4
    relative (fp32); the port's per-step balance loss is finite and
    nonzero.  Microbatches route each half batch with its own capacity,
    as the reference does."""
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch, reduced=True)
    _, model = _converted(arch, seed=0)
    common = dict(steps=4, batch=4, seq=16, lr=1e-3, warmup=2, workers=2, seed=0, log_every=0)
    mine = train.train_loop(cfg, device="cpu", model=model, **common, **kw)
    want = jtrain.train_loop(jcfg, mesh=_jax_mesh(), **common, **kw)
    np.testing.assert_allclose(mine["losses"], want["losses"], rtol=1e-4)
    assert len(mine["aux"]) == 4 and all(math.isfinite(a) and a > 0 for a in mine["aux"])


def test_train_loop_resumes_from_its_checkpoint(tmp_path):
    """Six steps straight == three, a checkpoint (saved by the runtime's
    checkpoint_save task), and three more from a fresh model restored from
    it: the same losses, to fp32 rounding (identical ops on identical
    values)."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    common = dict(batch=2, seq=16, workers=2, seed=3, log_every=0, device="cpu")
    full = train.train_loop(cfg, steps=6, model=lm.init_params(cfg, seed=3, device="cpu"),
                            **common)
    first = train.train_loop(cfg, steps=6, ckpt_dir=str(tmp_path), ckpt_every=3,
                             model=lm.init_params(cfg, seed=3, device="cpu"), **common)
    # drop the final checkpoint: resume from step 3
    import shutil
    shutil.rmtree(tmp_path / "step_00000006")
    second = train.train_loop(cfg, steps=6, ckpt_dir=str(tmp_path), restore=True,
                              model=lm.init_params(cfg, seed=99, device="cpu"), **common)
    assert second["restored_from"] == 3 and second["steps_done"] == 3
    np.testing.assert_allclose(second["losses"], full["losses"][3:], rtol=1e-6)
    np.testing.assert_allclose(first["losses"], full["losses"], rtol=1e-6)


def test_train_loop_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_config("qwen3-0.6b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train_loop(cfg, steps=1, batch=2, seq=8)
    with pytest.raises(ValueError):
        train.train_loop(cfg, steps=1, batch=2, seq=8, device="cpu",
                         model=lm.LM(cfg, device="meta"))


def test_train_loop_raises_on_a_nan_loss():
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = lm.init_params(cfg, seed=0, device="cpu")
    with torch.no_grad():
        model.embed.fill_(float("nan"))
    with pytest.raises(FloatingPointError):
        train.train_loop(cfg, steps=2, batch=2, seq=8, workers=2, device="cpu", model=model,
                         log_every=0)


def test_train_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                           "mamba2-780m", "--reduced", "--device", "cpu", "--steps", "3",
                           "--batch", "2", "--seq", "16", "--workers", "2"],
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "step     2 loss" in proc.stdout and "loss:" in proc.stdout.splitlines()[-1]
