"""The PyTorch port's MoE layer against the JAX package's.

The same seeded NumPy parameters and inputs go to ``repro.layers.moe``
and to ``repro_torch.layers.moe`` on the CPU: the router (ids exactly,
weights and the balance loss), the capacity, the dispatch — which
assignments the capacity drops, bit for bit, against a NumPy oracle of
the reference's stable sort — the layer's output and its gradients
under ``jax.grad``.  fp32 results agree to the order of fp32 sums
(within ~1e-5 of the output's scale); bf16 results within two bf16
rounding steps of it.  Tolerances are stated at each assertion.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.layers import moe as jmoe  # noqa: E402
from repro_torch.layers import moe  # noqa: E402

BF16_STEP = 2.0 ** -7   # one bf16 rounding step, relative
DTYPES = {"fp32": (np.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def _params(seed, D, F, E, zero_router=False):
    """NumPy fp32 leaves with ``init_moe``'s shapes and scales."""
    rng = np.random.default_rng(seed)
    p = {"w_router": rng.standard_normal((D, E)) / math.sqrt(D),
         "w_gate": rng.standard_normal((E, D, F)) / math.sqrt(D),
         "w_up": rng.standard_normal((E, D, F)) / math.sqrt(D),
         "w_down": rng.standard_normal((E, F, D)) / math.sqrt(F)}
    if zero_router:
        p["w_router"] = np.zeros((D, E))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _pair(p, dtype):
    """(JAX leaves, port leaves) of the NumPy leaves: the experts in
    ``dtype``, the router in fp32 (as ``init_moe`` keeps it); bf16 values
    rounded to nearest even on both sides."""
    jdt, tdt = DTYPES[dtype]
    jp = {k: jnp.asarray(v, jnp.float32 if k == "w_router" else jdt) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "w_router" else tdt)
          for k, v in p.items()}
    return jp, tp


def _x(seed, shape, dtype, shared=0.0):
    """Normal inputs; ``shared`` mixes in one common row, so that the
    tokens prefer the same experts and overflow their capacity."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + shared * rng.standard_normal(shape[-1])
    x = x.astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _oracle_valid(ids, n_experts, capacity):
    """The reference's dispatch in NumPy: which flat assignments (token
    order, then choice order) its capacity keeps."""
    flat = np.asarray(ids).reshape(-1)
    order = np.argsort(flat, kind="stable")
    s = flat[order]
    pos = np.arange(flat.size) - np.searchsorted(s, s, side="left")
    valid = np.empty(flat.size, bool)
    valid[order] = (s < n_experts) & (pos < capacity)
    return valid


def _port_valid(topi, capacity):
    plan = moe._plan(topi, capacity)
    valid = torch.empty_like(plan.valid)
    valid[plan.order] = plan.valid
    return valid.numpy()


# -------------------------------------------------------------- the router
@pytest.mark.parametrize("zero_router", [False, True], ids=["random", "zero-router"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_route_matches_jax(dtype, zero_router):
    """Ids exactly; weights and the balance loss within 1e-6 relative (fp32
    routing on both sides, products summed in other orders).  A zero
    router makes every probability 1/E: the lower index must win each
    tie, as ``jax.lax.top_k`` keeps it."""
    D, E, k = 16, 8, 3
    jp, tp = _pair(_params(0, D, 8, E, zero_router), dtype)
    jx, tx = _x(1, (40, D), dtype)
    jw, ji, jaux = jmoe._route(jx, jp["w_router"], k)
    tw, ti, taux = moe._route(tx, tp["w_router"], k)
    probs = np.sort(_np(torch.softmax(tx.float() @ tp["w_router"], -1)), axis=-1)[:, ::-1]
    if zero_router:
        assert np.array_equal(ti.numpy(), np.tile(np.arange(k), (40, 1)))
    else:   # no near-tie at the k-th place could flip between the two stacks
        assert (probs[:, k - 1] - probs[:, k]).min() > 1e-5
    assert ti.dtype == torch.int64 and tw.dtype == torch.float32 and taux.shape == ()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(_np(tw), _np(jw), rtol=1e-6, atol=1e-7)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


def test_moe_capacity_matches_jax():
    for n in (1, 8, 100, 4096, 4344):
        for k in (1, 2, 6, 8):
            for E in (4, 8, 64, 128):
                for cf in (1.0, 1.25, 2.0, 8.0, E / k):
                    for mc in (1, 4):
                        assert moe.moe_capacity(n, k, E, cf, mc) == \
                            jmoe.moe_capacity(n, k, E, cf, mc), (n, k, E, cf, mc)
    # deepseek-moe-16b: a decode step of 8 tokens, the 8 x 512 prefill
    assert moe.moe_capacity(8, 6, 64, 1.25) == 4
    assert moe.moe_capacity(4096, 6, 64, 1.25) == 480


# ------------------------------------------------------------- the dispatch
def test_moe_dispatch_matches_dense_reference():
    """As tests/test_models.py holds the JAX layer: with no drops (cf 8)
    the capacity dispatch equals the dense every-expert oracle (fp32,
    1e-5), with the same balance loss."""
    _, p = _pair(_params(0, 16, 32, 8), "fp32")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 12, 16))
                         .astype(np.float32))
    out_d, aux_d = moe.moe_apply_local(p, x, top_k=2, capacity_factor=8.0)
    out_r, aux_r = moe.moe_reference(p, x, top_k=2)
    np.testing.assert_allclose(_np(out_d), _np(out_r), atol=1e-5)
    assert float(aux_d) == float(aux_r)


def test_moe_capacity_drops_are_bounded():
    """With cf 1.0 some assignments drop; the output stays finite and
    within the no-drop output's scale (as tests/test_models.py)."""
    _, p = _pair(_params(0, 16, 32, 4), "fp32")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 64, 16))
                         .astype(np.float32))
    tight, _ = moe.moe_apply_local(p, x, top_k=2, capacity_factor=1.0)
    loose, _ = moe.moe_apply_local(p, x, top_k=2, capacity_factor=8.0)
    dropped, total = moe.dropped_assignments(p, x, top_k=2, capacity_factor=1.0)
    assert 0 < int(dropped) < total == 128
    assert int(moe.dropped_assignments(p, x, top_k=2, capacity_factor=8.0)[0]) == 0
    assert bool(torch.isfinite(tight).all())
    assert float(tight.norm()) <= float(loose.norm()) * 1.5 + 1e-3


# (B, S, D, F, E, k, cf, shared): no drops; drops; deepseek's decode step
# (8 tokens, 64 experts, top-6, C = 4) with tokens that share a direction
CASES = {"cf8": (2, 12, 16, 32, 8, 2, 8.0, 0.0),
         "cf1": (1, 64, 16, 32, 4, 2, 1.0, 0.0),
         "decode": (8, 1, 32, 16, 64, 6, 1.25, 2.0)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_local_matches_jax(case, dtype):
    """The same assignments kept and dropped as the reference (bit for
    bit, against the NumPy oracle of its stable sort and against the
    reference's own ids), and the same output: fp32 within 1e-5 of the
    output's scale; bf16 within two bf16 steps of it (the experts' bf16
    products round apart where their fp32 sums differ)."""
    B, S, D, F, E, k, cf, shared = CASES[case]
    jp, tp = _pair(_params(2, D, F, E), dtype)
    jx, tx = _x(3, (B, S, D), dtype, shared)
    jout, jaux = jmoe.moe_apply_local(jp, jx, top_k=k, capacity_factor=cf)
    tout, taux = moe.moe_apply_local(tp, tx, top_k=k, capacity_factor=cf)
    C = moe.moe_capacity(B * S, k, E, cf)
    _, ji, _ = jmoe._route(jx.reshape(B * S, D), jp["w_router"], k)
    _, ti, _ = moe._route(tx.reshape(B * S, D), tp["w_router"], k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    want = _oracle_valid(ji, E, C)
    np.testing.assert_array_equal(_port_valid(ti, C), want)
    assert (want.all()) == (case == "cf8"), "the case must drop exactly when meant to"
    dropped, total = moe.dropped_assignments(tp, tx, top_k=k, capacity_factor=cf)
    assert (int(dropped), total) == (int((~want).sum()), B * S * k)
    assert tout.dtype == tx.dtype and tout.shape == (B, S, D)
    scale = float(np.abs(_np(jout)).max())
    tol = 1e-5 if dtype == "fp32" else 2 * BF16_STEP
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=tol, atol=tol * scale)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    # a token whose assignments all drop gets nothing from the experts
    gone = ~want.reshape(B * S, k).any(axis=1)
    assert not _np(tout).reshape(B * S, D)[gone].any()


def test_combine_adds_in_ascending_expert_order():
    """Each token's contributions are added in ascending expert id, from
    the first (the order of the reference's scatter-add): in bf16 the
    output is bit-identical to that sum taken by hand from the layer's
    own expert outputs, and repeats bit for bit."""
    B, S, D, F, E, k = 2, 20, 16, 8, 8, 4
    _, p = _pair(_params(4, D, F, E), "bf16")
    _, x = _x(5, (B, S, D), "bf16")
    out, _ = moe.moe_apply_local(p, x, top_k=k, capacity_factor=8.0)
    again, _ = moe.moe_apply_local(p, x, top_k=k, capacity_factor=8.0)
    assert torch.equal(out, again)
    xf = x.reshape(B * S, D)
    w, ids, _ = moe._route(xf, p["w_router"], k)
    w = w.to(torch.bfloat16)
    want = torch.zeros_like(xf)
    for n in range(B * S):
        for j in torch.argsort(ids[n]).tolist():          # ascending expert id
            e = int(ids[n, j])
            h = torch.nn.functional.silu(xf[n:n + 1] @ p["w_gate"][e]) * \
                (xf[n:n + 1] @ p["w_up"][e])
            want[n] = want[n] + w[n, j] * (h @ p["w_down"][e])[0]
    assert torch.equal(out.reshape(B * S, D), want)


# ------------------------------------------------------------ the gradients
@pytest.mark.parametrize("case", ["cf8", "cf1"])
def test_moe_gradients_match_jax(case):
    """Gradients of ``sum(out²) + 0.01·aux`` with respect to x and the four
    leaves against ``jax.grad`` (fp32): each within 1e-5 of its leaf's
    largest magnitude; the router's gradient reaches it through the
    weights and the balance loss, dropped assignments give none."""
    B, S, D, F, E, k, cf, _ = CASES[case]
    p = _params(6, D, F, E)
    x = np.random.default_rng(7).standard_normal((B, S, D)).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_apply_local(p, x, top_k=k, capacity_factor=cf)
        return jnp.sum(out ** 2) + 0.01 * aux

    jg = jax.grad(jloss, argnums=(0, 1))({n: jnp.asarray(v) for n, v in p.items()},
                                        jnp.asarray(x))
    tp = {n: torch.from_numpy(v).requires_grad_() for n, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_apply_local(tp, tx, top_k=k, capacity_factor=cf)
    ((out ** 2).sum() + 0.01 * aux).backward()
    got = {**{n: t.grad for n, t in tp.items()}, "x": tx.grad}
    want = {**jg[0], "x": jg[1]}
    for name, g in want.items():
        g = np.asarray(g)
        assert np.abs(g).max() > 0, name
        np.testing.assert_allclose(_np(got[name]), g, rtol=0, atol=1e-5 * np.abs(g).max(),
                                   err_msg=name)


def test_moe_grads_flow_to_router_and_experts():
    """As tests/test_models.py: the router and the experts get gradients."""
    _, p = _pair(_params(0, 16, 32, 8), "fp32")
    p = {n: t.requires_grad_() for n, t in p.items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 12, 16))
                         .astype(np.float32))
    out, aux = moe.moe_apply_local(p, x, top_k=2, capacity_factor=8.0)
    ((out ** 2).sum() + 0.01 * aux).backward()
    assert float(p["w_router"].grad.abs().sum()) > 0
    assert float(p["w_gate"].grad.abs().sum()) > 0


# ---------------------------------------------------------------- the module
def test_moe_module_keeps_its_router_in_fp32_and_the_jax_scales():
    """In a bf16 layer the router stays fp32; ``init_weights`` draws
    ``init_moe``'s scales; ``forward`` is ``moe_apply_local``."""
    layer = moe.MoE(64, 32, 8, dtype=torch.bfloat16, device="cpu")
    assert layer.w_router.dtype == torch.float32
    assert {n: (tuple(p.shape), p.dtype) for n, p in layer.named_parameters()} == {
        "w_router": ((64, 8), torch.float32), "w_gate": ((8, 64, 32), torch.bfloat16),
        "w_up": ((8, 64, 32), torch.bfloat16), "w_down": ((8, 32, 64), torch.bfloat16)}
    layer.init_weights(torch.Generator().manual_seed(0))
    for name, want in (("w_router", 64 ** -0.5), ("w_gate", 64 ** -0.5),
                       ("w_up", 64 ** -0.5), ("w_down", 32 ** -0.5)):
        assert abs(float(getattr(layer, name).detach().float().std()) / want - 1) < 0.05, name
    x = torch.randn((2, 5, 64), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    with torch.no_grad():
        got = layer(x, top_k=2, capacity_factor=1.0)
        want = moe.moe_apply_local(layer.params(), x, top_k=2, capacity_factor=1.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
