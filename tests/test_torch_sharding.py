"""The port's sharding rules and placements
(``repro_torch/distributed/sharding.py``, ``models/lm.py::param_axes``)
against the JAX package's (``repro/distributed/sharding.py``).

Host-side, no spawn: the reference runs on ``jax.sharding.AbstractMesh``
and ``jax.eval_shape``, the port on a :class:`MeshShape` and meta tensors,
so nothing is allocated for the full configs.  The default rule table and
the reference test's ``spec_for`` cases are equal; ``param_pspecs`` of
every config, full and reduced, equals the reference's over meshes
(1, 1), (2, 1), (4, 2), (2, 4), (8, 1) and (1, 8), its scan groups'
leading ``"layers"`` dim dropped (the port keeps one block per layer);
``batch_pspecs`` and ``cache_pspecs`` are equal on the same meshes.
Under a fake process group of world size 8, each parameter placed as a
DTensor (on the meta device) has the reference spec's shard shape.
"""
import functools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import dataclasses  # noqa: E402

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config, shapes  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402

MESHES = [(1, 1), (2, 1), (4, 2), (2, 4), (8, 1), (1, 8)]
CONFIGS = [(a, r) for a in ARCH_IDS for r in (False, True)]
CONFIG_IDS = [f"{a}-{'reduced' if r else 'full'}" for a, r in CONFIGS]


def _meshes(shape):
    names = ("data", "model")
    return sharding.MeshShape(shape, names), AbstractMesh(shape, names)


def _norm(spec) -> tuple:
    """A spec's entries, a one-name tuple written as the name (JAX's own
    normal form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _unstack(cfg, tree):
    """The reference's spec tree under the port's names, each scan leaf's
    leading layers entry dropped."""
    return convert.port_names(cfg, tree, take=lambda spec, s: JP(*tuple(spec)[1:]))


@functools.lru_cache(maxsize=None)
def _reference_shapes(arch, reduced):
    jcfg = jget_config(arch, reduced)
    return jax.eval_shape(lambda: jlm.init_params(jcfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _reference_pspecs(arch, reduced, shape):
    """The reference's parameter specs of a config on a mesh, under the
    port's names."""
    jcfg = jget_config(arch, reduced)
    mesh = _meshes(shape)[1]
    shapes_tree = _reference_shapes(arch, reduced)
    return _unstack(get_config(arch, reduced), jsharding.param_pspecs(
        jlm.param_axes(jcfg), shapes_tree, jsharding.default_rules(mesh), mesh))


@functools.lru_cache(maxsize=None)
def _meta_params(arch, reduced):
    return dict(lm.LM(get_config(arch, reduced), device="meta").named_parameters())


def test_default_rules_equal_the_reference():
    for shape in MESHES:
        mine, theirs = _meshes(shape)
        assert sharding.default_rules(mine).table == jsharding.default_rules(theirs).table
    rules = sharding.default_rules(_meshes((2, 4))[0])
    assert rules.override(embed=None).lookup("embed") is None
    assert rules.lookup("embed") == "data" and rules.lookup(None) is None


def test_spec_for_divisibility_and_axis_reuse():
    """The cases of the reference's test: divisible dims shard, others
    replicate (MQA's single KV head), and no mesh axis is used twice."""
    mine, theirs = _meshes((2, 4))
    cases = [((16, 8), ("embed", "heads"), ("data", "model")),
             ((16, 6), ("embed", "heads"), ("data", None)),
             ((3, 8), ("embed", "heads"), (None, "model")),
             ((8, 8), ("heads", "mlp"), ("model", None)),
             ((128, 1, 64), ("embed", "kv_heads", "head_dim"), ("data", None, None))]
    for shape, logical, want in cases:
        got = sharding.spec_for(shape, logical, sharding.default_rules(mine), mine)
        ref = jsharding.spec_for(shape, logical, jsharding.default_rules(theirs), theirs)
        assert isinstance(got, sharding.P)
        assert _norm(got) == _norm(ref) == want, (shape, logical)


@pytest.mark.parametrize("arch,reduced", CONFIGS, ids=CONFIG_IDS)
def test_param_pspecs_equal_the_reference(arch, reduced):
    cfg = get_config(arch, reduced)
    params = _meta_params(arch, reduced)
    axes = lm.param_axes(cfg)
    assert set(axes) == set(params)
    for shape in MESHES:
        mine = _meshes(shape)[0]
        got = sharding.param_pspecs(axes, params, sharding.default_rules(mine), mine)
        want = _reference_pspecs(arch, reduced, shape)
        assert set(got) == set(want)
        for n in want:
            assert _norm(got[n]) == _norm(want[n]), (shape, n, got[n], want[n])


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_pspecs_equal_the_reference(arch, reduced):
    cfg, jcfg = get_config(arch, reduced), jget_config(arch, reduced)
    for name in ("train_4k", "decode_32k"):
        # a batch of 8 divides over every data axis of MESHES
        spec = dataclasses.replace(shapes.SMOKE_SHAPES[name], batch=8)
        jspec = dataclasses.replace(jshapes.SMOKE_SHAPES[name], batch=8)
        mine_in, theirs_in = shapes.input_specs(cfg, spec), jshapes.input_specs(jcfg, jspec)
        for shape in MESHES:
            mine, theirs = _meshes(shape)
            rules, jrules = sharding.default_rules(mine), jsharding.default_rules(theirs)
            got = sharding.batch_pspecs(mine_in["batch"], rules, mine)
            want = jsharding.batch_pspecs(theirs_in["batch"], jrules, theirs)
            assert {k: _norm(v) for k, v in got.items()} == \
                {k: _norm(v) for k, v in want.items()}, (name, shape)
            if "caches" not in theirs_in:
                continue
            got = sharding.cache_pspecs(mine_in["caches"], rules, mine)
            got = {f"blocks.{i}.{k}": v for i, c in enumerate(got) for k, v in c.items()}
            want = convert.port_names(cfg, jsharding.cache_pspecs(theirs_in["caches"], jrules,
                                                                  theirs),
                                      take=lambda s, _: JP(*tuple(s)[1:]))
            assert set(got) == set(want)
            for k in want:
                assert _norm(got[k]) == _norm(want[k]), (name, shape, k, got[k], want[k])


def test_to_placements_and_refusals():
    from torch.distributed.tensor import Replicate, Shard
    mesh = sharding.MeshShape((2, 4), ("data", "model"))
    P = sharding.P
    assert sharding.to_placements(P("data", None), mesh) == [Shard(0), Replicate()]
    assert sharding.to_placements(P(None, "model"), mesh) == [Replicate(), Shard(1)]
    assert sharding.to_placements(P("model", "data"), mesh) == [Shard(1), Shard(0)]
    assert sharding.to_placements(P(), mesh) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="pod"):
        sharding.to_placements(P(("pod", "data"), None), mesh)
    tree = sharding.to_shardings({"a": P("data"), "b": [P(None, "model")]}, mesh)
    assert tree["a"].placements == (Shard(0), Replicate())
    assert tree["b"][0].placements == (Replicate(), Shard(1))


@pytest.fixture(scope="module")
def fake_world_of_8():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,reduced", CONFIGS, ids=CONFIG_IDS)
def test_dtensor_local_shapes_are_the_reference_shards(fake_world_of_8, arch, reduced):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    cfg = get_config(arch, reduced)
    params = _meta_params(arch, reduced)
    for shape in [s for s in MESHES if s[0] * s[1] == 8]:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        theirs = _meshes(shape)[1]
        specs = sharding.param_pspecs(lm.param_axes(cfg), params,
                                      sharding.default_rules(mesh), mesh)
        want = _reference_pspecs(arch, reduced, shape)
        seen = {}            # the layers repeat: each (shape, spec) placed once
        for n, p in params.items():
            key = (tuple(p.shape), p.dtype, specs[n], _norm(want[n]))
            if key not in seen:
                local = distribute_tensor(p.detach(), mesh,
                                          sharding.to_placements(specs[n], mesh),
                                          src_data_rank=None).to_local()
                assert local.device.type == "meta" and local.dtype == p.dtype
                want_shape = NamedSharding(theirs, want[n]).shard_shape(tuple(p.shape))
                assert tuple(local.shape) == tuple(want_shape), (shape, n)
                seen[key] = True
