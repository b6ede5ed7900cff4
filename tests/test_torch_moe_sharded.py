"""The port's expert-parallel MoE (``layers/moe.py::moe_apply_sharded``)
against ``moe_apply_local`` and against the JAX package's
``moe_apply_sharded``.

On four gloo ranks (one spawn, ``tests/_torch_dist_jobs.py``), seeded
NumPy experts and tokens go through ``moe_apply_sharded``:

* on a (1, 4) mesh (two experts per rank) it equals ``moe_apply_local``
  on the whole batch — output within 2e-5, aux within 1e-5, as the
  reference's ``test_moe_sharded_matches_local_on_4_devices`` holds its
  own — with capacity drops too, and equals the reference's
  ``moe_apply_sharded`` on four forced host devices (a subprocess) at
  capacity factors 8 and 1.25; its gradients, the experts' summed over
  ``model`` as the step sums them, equal ``moe_apply_local``'s within
  1e-5 of each leaf's scale;
* on a (2, 2) mesh each data half equals ``moe_apply_local`` on that
  half (the capacity from the half's tokens, no prefix counts) and the
  aux is the halves' mean;
* every forward repeats bit for bit.

In-process: the dispatch of one slice of experts against the
reference's ``_dispatch_compute`` with the same expert offset, and the
refusal of an expert count that does not divide.
"""
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_dist_jobs as jobs  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.layers import moe  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
D, F, E, TOP_K = 16, 32, 8, 2
CAPACITY = {"cf8": 8.0, "cf1.25": 1.25}

REF_SCRIPT = textwrap.dedent('''
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.layers import moe
    z = np.load(sys.argv[1])
    mesh = jax.make_mesh((1, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    p = {k: jnp.asarray(z[k]) for k in ("w_router", "w_gate", "w_up", "w_down")}
    x = jnp.asarray(z["x"])
    out = {}
    for name, cf in (("cf8", 8.0), ("cf1.25", 1.25)):
        o, aux = jax.jit(lambda p, x: moe.moe_apply_sharded(
            p, x, mesh=mesh, top_k=int(z["top_k"]), data_axes=("data",),
            capacity_factor=cf))(p, x)
        out[name] = np.asarray(o)
        out[name + "/aux"] = np.asarray(aux)
    np.savez(sys.argv[2], **out)
''')


def _inputs():
    """fp32 experts with ``init_moe``'s scales, and tokens that share one
    row in part, so that at capacity factor 1.25 some experts overflow."""
    rng = np.random.default_rng(0)
    p = {"w_router": rng.standard_normal((D, E)) / math.sqrt(D),
         "w_gate": rng.standard_normal((E, D, F)) / math.sqrt(D),
         "w_up": rng.standard_normal((E, D, F)) / math.sqrt(D),
         "w_down": rng.standard_normal((E, F, D)) / math.sqrt(F)}
    x = rng.standard_normal((4, 8, D)) + 1.5 * rng.standard_normal(D)
    return ({k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()},
            torch.from_numpy(x.astype(np.float32)))


@pytest.fixture(scope="module")
def ws4(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    p, x = _inputs()
    np.savez(d / "in.npz", x=x.numpy(), top_k=TOP_K, **{k: v.numpy() for k, v in p.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(d / "in.npz"),
                            str(d / "out.npz")], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    cot = torch.from_numpy(np.random.default_rng(1).standard_normal(tuple(x.shape))
                           .astype(np.float32))
    calls = [(("ep", name), jobs.moe_sharded, (p, x, (1, 4), cf, TOP_K),
              {"cotangent": cot, "repeats": 2}) for name, cf in CAPACITY.items()]
    calls += [(("dp", name), jobs.moe_sharded, (p, x, (2, 2), cf, TOP_K), {"repeats": 2})
              for name, cf in CAPACITY.items()]
    results = jobs.run_world(4, jobs.call_all, calls)
    _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-4000:]
    return results, dict(np.load(d / "out.npz")), p, x, cot


def _local(p, x, cf, cot=None):
    """``moe_apply_local`` of x: (out, aux), and with ``cot`` the
    gradients of ``<out, cot> + aux`` (x's under "x")."""
    p = {n: t.clone().requires_grad_(cot is not None) for n, t in p.items()}
    x = x.clone().requires_grad_(cot is not None)
    out, aux = moe.moe_apply_local(p, x, top_k=TOP_K, capacity_factor=cf)
    grads = None
    if cot is not None:
        ((out * cot).sum() + aux).backward()
        grads = {**{n: t.grad for n, t in p.items()}, "x": x.grad}
    return out.detach(), float(aux.detach()), grads


@pytest.mark.parametrize("name", list(CAPACITY))
def test_expert_parallel_equals_the_local_layer(ws4, name):
    """(1, 4): every rank's output within 2e-5 of ``moe_apply_local``'s,
    the aux within 1e-5; at capacity factor 1.25 the layer drops
    assignments, the same ones on both sides."""
    results, _, p, x, _ = ws4
    want, want_aux, _ = _local(p, x, CAPACITY[name])
    C = moe.moe_capacity(x.shape[0] * x.shape[1], TOP_K, E, CAPACITY[name])
    dropped, _ = moe.dropped_assignments(p, x, top_k=TOP_K, capacity_factor=CAPACITY[name])
    assert (int(dropped) > 0) == (name == "cf1.25"), (name, int(dropped), C)
    for r in results:
        got = r[("ep", name)]
        torch.testing.assert_close(got["outs"][0], want, rtol=0, atol=2e-5)
        assert abs(got["aux"] - want_aux) < 1e-5


@pytest.mark.parametrize("name", list(CAPACITY))
def test_expert_parallel_matches_the_reference(ws4, name):
    """(1, 4) against the JAX package's ``moe_apply_sharded`` on four
    forced host devices: output within 2e-5, aux within 1e-5."""
    results, ref, _, _, _ = ws4
    got = results[0][("ep", name)]
    np.testing.assert_allclose(got["outs"][0].numpy(), ref[name], rtol=0, atol=2e-5)
    assert abs(got["aux"] - float(ref[name + "/aux"])) < 1e-5


@pytest.mark.parametrize("name", list(CAPACITY))
def test_expert_parallel_gradients_equal_the_local_layer(ws4, name):
    """The gradients of ``<out, cot> + aux`` on (1, 4), the experts'
    summed over model: x, router and experts within 1e-5 of each leaf's
    largest magnitude, on every rank."""
    results, _, p, x, cot = ws4
    _, _, want = _local(p, x, CAPACITY[name], cot)
    for r in results:
        got = {**r[("ep", name)]["grads"], "x": r[("ep", name)]["x_grad"]}
        for n, g in want.items():
            scale = float(g.abs().max())
            assert scale > 0, n
            torch.testing.assert_close(got[n], g, rtol=0, atol=1e-5 * scale, msg=n)


@pytest.mark.parametrize("name", list(CAPACITY))
def test_each_data_shard_routes_its_own_tokens(ws4, name):
    """(2, 2): each data half's output is ``moe_apply_local`` on that half
    (its capacity from the half's tokens, no lower-rank counts), within
    2e-5; the aux is the halves' mean, within 1e-5."""
    results, _, p, x, _ = ws4
    halves = [_local(p, h, CAPACITY[name]) for h in x.chunk(2, dim=0)]
    mean_aux = (halves[0][1] + halves[1][1]) / 2
    for r in results:
        got = r[("dp", name)]
        torch.testing.assert_close(got["outs"][0], halves[got["data"]][0], rtol=0, atol=2e-5)
        assert abs(got["aux"] - mean_aux) < 1e-5
    assert sorted(r[("dp", name)]["data"] for r in results) == [0, 0, 1, 1]


def test_expert_parallel_forward_repeats_bit_for_bit(ws4):
    results = ws4[0]
    for r in results:
        for key, got in r.items():
            assert torch.equal(got["outs"][0], got["outs"][1]), key


# ------------------------------------------------------------ in-process
def test_slice_dispatch_matches_the_reference_local_slice():
    """One slice of experts at each offset: the port's dispatch with
    ``expert_offset`` against the reference's ``_dispatch_compute`` with
    the same offset (1e-5 of the output's scale), capacity drops
    included; the other slices' assignments contribute nothing."""
    import jax.numpy as jnp

    from repro.layers import moe as jmoe
    p, x = _inputs()
    xf = x.reshape(-1, D)
    topw, topi, _ = moe._route(xf, p["w_router"], TOP_K)
    C = moe.moe_capacity(xf.shape[0], TOP_K, E, 1.25)
    total = torch.zeros_like(xf)
    for off in range(0, E, 2):
        sl = slice(off, off + 2)
        got = moe._dispatch_compute(xf, topw, topi, p["w_gate"][sl], p["w_up"][sl],
                                    p["w_down"][sl], C, expert_offset=off)
        want = jmoe._dispatch_compute(
            jnp.asarray(xf.numpy()), jnp.asarray(topw.numpy()),
            jnp.asarray(topi.numpy().astype(np.int32)), jnp.asarray(p["w_gate"][sl].numpy()),
            jnp.asarray(p["w_up"][sl].numpy()), jnp.asarray(p["w_down"][sl].numpy()), off, E, C)
        scale = float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * scale)
        mine = ((topi >= off) & (topi < off + 2)).any(dim=1)
        assert not got[~mine].any()
        total = total + got
    whole = moe._dispatch_compute(xf, topw, topi, p["w_gate"], p["w_up"], p["w_down"], C)
    torch.testing.assert_close(total, whole, rtol=0, atol=1e-5)


def test_the_whole_slice_keeps_the_one_device_plan():
    """A local slice of every expert is the one-device plan, bit for bit."""
    _, topi, _ = moe._route(_inputs()[1].reshape(-1, D), _inputs()[0]["w_router"], TOP_K)
    a, b = moe._plan(topi, 5), moe._plan(topi, 5, local=(0, E))
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_experts_that_do_not_divide_are_refused():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=3)
    try:
        p, x = _inputs()
        with pytest.raises(ValueError, match="8 experts not divisible by EP=3"):
            moe.moe_apply_sharded(p, x, top_k=TOP_K, model_group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
