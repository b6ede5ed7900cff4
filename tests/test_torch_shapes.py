"""The port's shape sets, input specs and smoke batches
(``repro_torch/configs/shapes.py``) against the JAX package's
(``repro/configs/shapes.py``): the same sets and applicability rule; the
meta-tensor specs of every arch, full and reduced, at every shape have
the reference's ``ShapeDtypeStruct`` shapes and dtypes (decode caches
mapped from its stacked scan layout to the port's per-layer list); and
``make_batch`` gives the reference's bytes for every arch (reduced) at
every SMOKE shape, decode caches and ``pos`` included — also with bf16
inputs, where JAX rounds float64 draws to float32 and then to bf16.
Host-side only: nothing is allocated for the full configs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro_torch.configs import get_config, shapes  # noqa: E402
from repro_torch.models import convert  # noqa: E402


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else np.dtype(dt).name


def _as_port_layers(cfg, jcaches):
    """The reference's cache tree under the port's per-layer names."""
    return convert.port_names(cfg, jcaches, take=lambda leaf, s: leaf)


def _port_layers(caches):
    return {f"blocks.{i}.{k}": v for i, c in enumerate(caches) for k, v in c.items()}


def _bytes(x) -> tuple:
    if isinstance(x, torch.Tensor):
        t = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return t.numpy().tobytes(), _dtype_name(x.dtype), tuple(x.shape)
    a = np.asarray(x)
    a = a.view(np.int16) if a.dtype.name == "bfloat16" else a
    return a.tobytes(), np.asarray(x).dtype.name, a.shape


def test_shape_sets_equal_the_reference():
    for mine, theirs in ((shapes.SHAPES, jshapes.SHAPES),
                         (shapes.SMOKE_SHAPES, jshapes.SMOKE_SHAPES)):
        assert list(mine) == list(theirs)
        for name in mine:
            assert dataclasses.astuple(mine[name]) == dataclasses.astuple(theirs[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_applicable_equals_the_reference(arch):
    for reduced in (False, True):
        cfg, jcfg = get_config(arch, reduced), jget_config(arch, reduced)
        for name in shapes.SHAPES:
            assert shapes.shape_applicable(cfg, name) == jshapes.shape_applicable(jcfg, name)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_have_the_reference_shapes_and_dtypes(arch, reduced):
    cfg, jcfg = get_config(arch, reduced), jget_config(arch, reduced)
    for table, jtable in ((shapes.SHAPES, jshapes.SHAPES),
                          (shapes.SMOKE_SHAPES, jshapes.SMOKE_SHAPES)):
        for name in table:
            mine, theirs = shapes.input_specs(cfg, table[name]), jshapes.input_specs(
                jcfg, jtable[name])
            assert set(mine) == set(theirs)
            assert set(mine["batch"]) == set(theirs["batch"])
            pairs = [(mine["batch"][k], theirs["batch"][k]) for k in theirs["batch"]]
            if "caches" in theirs:
                want = _as_port_layers(cfg, theirs["caches"])
                got = _port_layers(mine["caches"])
                assert set(got) == set(want)
                # the reference's scan caches carry a leading layers dim
                pairs += [(got[k], want[k]) for k in want]
                pairs.append((mine["pos"], theirs["pos"]))
            for m, t in pairs:
                assert m.device.type == "meta"
                shape = tuple(t.shape)
                if len(shape) == m.dim() + 1:      # a stacked scan leaf
                    shape = shape[1:]
                assert (tuple(m.shape), _dtype_name(m.dtype)) == (shape, t.dtype.name), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_batch_is_the_reference_bytes(arch):
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch, reduced=True)
    for name in shapes.SMOKE_SHAPES:
        for seed in (0, 3):
            mine = shapes.make_batch(cfg, shapes.SMOKE_SHAPES[name], seed=seed, device="cpu")
            theirs = jshapes.make_batch(jcfg, jshapes.SMOKE_SHAPES[name], seed=seed)
            assert set(mine) == set(theirs) and set(mine["batch"]) == set(theirs["batch"])
            for k in theirs["batch"]:
                assert _bytes(mine["batch"][k]) == _bytes(theirs["batch"][k]), (name, k)
            if "caches" in theirs:
                want = convert.port_names(cfg, theirs["caches"])
                got = _port_layers(mine["caches"])
                assert set(got) == set(want)
                for k in want:
                    assert _bytes(got[k]) == _bytes(want[k]), (name, k)
                assert mine["pos"].dtype == torch.int32
                assert int(mine["pos"]) == int(theirs["pos"]) == min(4, shapes.SMOKE_SHAPES[
                    name].seq - 1)


@pytest.mark.parametrize("arch", ["musicgen-medium", "internvl2-26b"])
def test_make_batch_rounds_bf16_inputs_as_jax_does(arch):
    cfg = dataclasses.replace(get_config(arch, reduced=True), compute_dtype=torch.bfloat16)
    jcfg = dataclasses.replace(jget_config(arch, reduced=True), compute_dtype=jnp.bfloat16)
    floats = 0
    for name in shapes.SMOKE_SHAPES:
        mine = shapes.make_batch(cfg, shapes.SMOKE_SHAPES[name], seed=1, device="cpu")["batch"]
        theirs = jshapes.make_batch(jcfg, jshapes.SMOKE_SHAPES[name], seed=1)["batch"]
        floats += sum(mine[k].dtype == torch.bfloat16 for k in theirs)
        for k in theirs:
            assert _bytes(mine[k]) == _bytes(theirs[k]), (name, k)
    assert floats >= 2          # the train and prefill inputs at least


def test_make_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        shapes.make_batch(get_config("qwen3-0.6b", reduced=True), shapes.SMOKE_SHAPES["train_4k"])
