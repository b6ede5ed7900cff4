"""The port's train step over a device mesh, against its world-size-1 step
and against the JAX package's step on a mesh.

Each world size is one spawn of gloo ranks on the CPU
(``tests/_torch_dist_jobs.py``) that runs every case of that size; the
tests read its results.  Setup: reduced configs (fp32), seed-0 weights,
the SMOKE ``train_4k`` batch with an uneven loss mask (the first data
shard's rows partly zeroed), microbatches 2, AdamW at lr 1e-3 with
clipping.  A mesh step equals the one-device step on the whole batch
with its rows in the mesh's microbatch order (microbatch i is the i-th
slice of every data shard, as the reference splits it): loss, aux and
grad-norm within 1e-5 relative (fp32 sums in another order), every
parameter after the step within 1e-4 (measured up to 1.6e-5).  The
reference's ``make_train_step`` runs on a (2, 1) mesh with Auto axes in
a subprocess with two forced host devices, from the same JAX weights and
batch; there AdamW's eps is 1e-3 (see ``REF_EPS``).  Refusals and the
DTensor guard run in-process under a fake process group.
"""
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
DENSE = ["qwen3-0.6b", "mamba2-780m", "recurrentgemma-9b"]
MOE = "deepseek-moe-16b"
WS2 = [(a, (2, 1)) for a in DENSE + [MOE]]
WS4 = [(a, s) for a in DENSE for s in ((4, 1), (2, 2), (1, 4))] + [(MOE, (4, 1))]
REFERENCE = ["qwen3-0.6b", MOE]
# AdamW's first step moves each element by lr · g / (|g| + eps): at eps
# 1e-8 an element whose gradient is at rounding-noise level moves by up
# to lr either way, whatever the step computed.  Against XLA's sums
# that showed as one element of 16,384 (qwen3 wq, 1.6e-4) and one of
# 65,536 (deepseek embed, 3.0e-4) past 1e-4, with loss, aux and
# grad-norm equal.  At eps 1e-3 the update is Lipschitz in g
# (|Δp| <= lr · |Δg| / eps), so the parameters hold the gradients the
# two steps computed.
REF_EPS = 1e-3

# the JAX package's step on a (2, 1) mesh with Auto axes, microbatches 2
REF_SCRIPT = textwrap.dedent('''
    import dataclasses, sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import SMOKE_SHAPES, get_config, make_batch
    from repro.distributed.steps import make_train_step
    from repro.models.lm import init_params
    from repro.optim.adamw import adamw
    mesh = jax.make_mesh((2, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch in sys.argv[3:]:
        cfg = get_config(arch, reduced=True)
        b = make_batch(cfg, dataclasses.replace(SMOKE_SHAPES["train_4k"], batch=4))["batch"]
        mask = np.array(b["loss_mask"])
        mask[0, :20] = 0.0
        mask[1, 10:] = 0.0
        b["loss_mask"] = jnp.asarray(mask)
        opt = adamw(1e-3, eps=float(sys.argv[2]))
        fn, in_sh, out_sh, _ = make_train_step(cfg, mesh, opt, microbatches=2, sample_batch=b)
        params = init_params(cfg, jax.random.PRNGKey(0))
        new, _, m = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(
            params, opt.init(params), b)
        for k in ("loss", "aux", "grad_norm"):
            out[f"{arch}/{k}"] = np.asarray(m[k])
        for i, leaf in enumerate(jax.tree.leaves(new)):
            out[f"{arch}/leaf{i}"] = np.asarray(leaf)
    np.savez(sys.argv[1], **out)
''')


def _jax_weights(arch):
    """(the JAX tree of reduced ``arch``'s seed-0 weights, the same weights
    by the port's parameter names)."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import lm as jlm
    from repro_torch.configs import get_config
    from repro_torch.models import convert, lm
    tree = jax.tree.map(np.asarray, jlm.init_params(jget_config(arch, reduced=True),
                                                    jax.random.PRNGKey(0)))
    model = convert.load_jax_params(lm.LM(get_config(arch, reduced=True), device="cpu"), tree)
    return tree, {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def ws2(tmp_path_factory):
    """One spawn of 2 ranks: (a) and (c) on (2, 1), and the port's side of
    (b); the reference's subprocess runs meanwhile."""
    out = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2 "
                         "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, out, str(REF_EPS), *REFERENCE],
                           env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    trees = {a: _jax_weights(a) for a in REFERENCE}
    cases = [(("a", a), a, s, {}) for a, s in WS2]
    cases.append((("c",), "qwen3-0.6b", (2, 1),
                  {"grad_compress": "int8", "microbatches": 1, "batch": 4}))
    cases += [(("b", a), a, (2, 1), {"batch": 4, "weights": trees[a][1], "eps": REF_EPS})
              for a in REFERENCE]
    # world size 1: the same steps on one device, the rows in the mesh's
    # microbatch order
    plain = [(("a", a), jobs.one_step, (a,), {"order": (2, 2)}) for a, _ in WS2]
    plain += [(("c", codec), jobs.one_step, ("qwen3-0.6b",),
               {"batch": 4, "microbatches": 1, "grad_compress": codec})
              for codec in ("int8", None)]
    results = jobs.run_world(2, jobs.in_order, [(jobs.train_cases, (cases,)),
                                                (jobs.spread, (plain,))])
    _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-4000:]
    return ([r[0] for r in results], jobs.merged(r[1] for r in results), dict(np.load(out)),
            trees)


@pytest.fixture(scope="module")
def ws4():
    data = sorted({(a, s[0]) for a, s in WS4})
    plain = [((a, d), jobs.one_step, (a,), {"order": (d, 2)}) for a, d in data]
    results = jobs.run_world(4, jobs.in_order, [
        (jobs.train_cases, ([(("a", a, s), a, s, {}) for a, s in WS4],)),
        (jobs.spread, (plain,))])
    return [r[0] for r in results], jobs.merged(r[1] for r in results)


def _close(got, want, what):
    """Metrics within 1e-5 relative, parameters within 1e-4."""
    (gm, gp), (wm, wp) = got, want
    for k in ("loss", "aux", "grad_norm"):
        assert gm[k] == pytest.approx(wm[k], rel=1e-5, abs=1e-7), (what, k, gm[k], wm[k])
    assert set(gp) == set(wp)
    for n in wp:
        torch.testing.assert_close(gp[n], wp[n], rtol=0, atol=1e-4, msg=f"{what}: {n}")


def _every_rank_agrees(results, key):
    first = results[0][key][0]
    for r, res in enumerate(results):
        assert res[key][0] == first, (key, r, res[key][0], first)


@pytest.mark.parametrize("arch,shape", WS2, ids=[f"{a}-{s[0]}x{s[1]}" for a, s in WS2])
def test_step_on_two_ranks_equals_world_size_1(ws2, arch, shape):
    results, plain = ws2[0], ws2[1]
    _every_rank_agrees(results, ("a", arch))
    _close(results[0][("a", arch)], plain[("a", arch)], (arch, shape))
    if arch == MOE:          # the balance loss reached the step
        assert results[0][("a", arch)][0]["aux"] > 0


@pytest.mark.parametrize("arch,shape", WS4, ids=[f"{a}-{s[0]}x{s[1]}" for a, s in WS4])
def test_step_on_four_ranks_equals_world_size_1(ws4, arch, shape):
    results, plain = ws4
    _every_rank_agrees(results, ("a", arch, shape))
    _close(results[0][("a", arch, shape)], plain[(arch, shape[0])], (arch, shape))


def test_int8_compressed_step_on_two_ranks_equals_world_size_1(ws2):
    """The compression round trip runs on the gradients summed over the
    data ranks: the same step as one device's (the port of the
    reference's ``test_grad_compress_in_train_step``)."""
    results = ws2[0]
    _every_rank_agrees(results, ("c",))
    want, plain = ws2[1][("c", "int8")], ws2[1][("c", None)]
    _close(results[0][("c",)], want, "int8")
    # the codec changed the update, not the loss it was computed from
    assert want[0]["loss"] == plain[0]["loss"]
    assert any(not torch.equal(want[1][n], plain[1][n]) for n in plain[1])


@pytest.mark.parametrize("arch", REFERENCE)
def test_step_on_two_ranks_matches_the_reference_mesh_step(ws2, arch):
    """The port's (2, 1) gloo step against the JAX package's (2, 1) step
    (GSPMD on two forced host devices) from the same weights and batch,
    AdamW's eps at ``REF_EPS``: loss, aux and grad-norm within 1e-5
    relative, parameters within 1e-4."""
    import jax

    from repro_torch.configs import get_config
    from repro_torch.models import convert
    results, _, ref, trees = ws2
    tree = trees[arch][0]
    leaves, treedef = jax.tree.flatten(tree)
    new_tree = jax.tree.unflatten(treedef, [ref[f"{arch}/leaf{i}"] for i in range(len(leaves))])
    want_params = {n: torch.from_numpy(np.asarray(v)) for n, v in
                   convert.port_names(get_config(arch, reduced=True), new_tree).items()}
    want_metrics = {k: float(ref[f"{arch}/{k}"]) for k in ("loss", "aux", "grad_norm")}
    _close(results[0][("b", arch)], (want_metrics, want_params), (arch, "reference"))


# --------------------------------------------------- refusals, no fallback
@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_refusals_name_the_roadmap_items(fake_world):
    """What the reference computes with layers the port has not ported
    raises — an MoE block over ``model > 1`` (its ``moe_apply_sharded``)
    and ``tp_block="shard_map"`` where its TP sublayers would run — and
    is never computed another way."""
    import dataclasses

    from repro_torch.distributed import steps
    from repro_torch.models import lm
    from repro_torch.optim.adamw import adamw
    opt = adamw(1e-3)
    for shape in ((2, 2), (1, 4)):
        mesh = jobs.mesh_of(shape)
        moe = jobs.model_of(MOE)
        batch = jobs.train_batch(moe.cfg, 8)
        with pytest.raises(NotImplementedError, match="A11.4"):
            steps.make_train_step(opt, mesh=mesh)(moe, steps.shard_state(moe, opt, mesh), batch)
        with pytest.raises(NotImplementedError, match="A11.4"):
            steps.make_prefill_step(cache_len=40, mesh=mesh)(moe, {"tokens": batch["tokens"]})
        cfg = dataclasses.replace(jobs.get_config("qwen3-0.6b", reduced=True),
                                  tp_block="shard_map")
        dense = lm.init_params(cfg, seed=0, device="cpu")
        with pytest.raises(NotImplementedError, match="A11.3"):
            steps.make_train_step(opt, mesh=mesh)(dense, steps.shard_state(dense, opt, mesh),
                                                  jobs.train_batch(cfg, 8))


def test_a_dtensor_never_reaches_a_kernel(fake_world):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels import ops
    mesh = jobs.mesh_of((4, 1))

    def dt(*shape):
        return distribute_tensor(torch.randn(*shape), mesh, [Replicate(), Replicate()],
                                 src_data_rank=None)

    calls = [lambda: ops.rmsnorm(dt(4, 8), torch.ones(8)),
             lambda: ops.flash_attention(dt(1, 2, 4, 16), torch.randn(1, 2, 4, 16),
                                         torch.randn(1, 2, 4, 16)),
             lambda: ops.rglru_scan(dt(1, 4, 8), torch.randn(1, 4, 8)),
             lambda: ops.ssd_scan(dt(1, 4, 2, 8), torch.rand(1, 4, 2), -torch.rand(2),
                                  torch.randn(1, 4, 4), torch.randn(1, 4, 4)),
             lambda: ops.knn_topk(dt(3, 4), torch.randn(5, 4), torch.arange(5), k=2),
             lambda: ops.kmeans_assign(dt(6, 4), torch.randn(2, 4))]
    for call in calls:
        with pytest.raises(TypeError, match="DTensor"):
            call()


def test_make_local_mesh_takes_no_fallback():
    from repro_torch.launch.mesh import make_local_mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_local_mesh()                      # the default device is the card
    with pytest.raises(RuntimeError, match="process group"):
        make_local_mesh(device="cpu")
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=0,
                                world_size=1)
        try:
            with pytest.raises(ValueError, match="world of 2"):
                make_local_mesh(data=2, device="cpu")
            mesh = make_local_mesh(device="cpu")
            assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        finally:
            dist.destroy_process_group()
