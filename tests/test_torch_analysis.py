"""The port's H100 ledger (``distributed/analysis.py``,
``launch/dryrun.py``) against the JAX package's formulas, and the meta
branch of the kernel ops that the dry run stands on.

``active_params`` and ``model_flops`` equal the reference's for all ten
configs, full and reduced, at every shape.  The dry run runs every
applicable (arch × shape) cell on the CPU, with no card and without
loading JAX (the reduced sweep here, in a subprocess; one full-size cell
in-process), on (1, 1), (2, 2) and (1, 4) meshes; its per-device shard
bytes are the DTensor local shards under a fake process group, and its
collective bytes follow the placements.  A meta tensor reaches a kernel
op's plain version — the model kernels through the card's autograd
Function — and never a kernel.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable  # noqa: E402
from repro_torch.distributed import analysis  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
CONFIGS = [(a, r) for a in ARCH_IDS for r in (False, True)]
IDS = [f"{a}-{'reduced' if r else 'full'}" for a, r in CONFIGS]


@pytest.mark.parametrize("arch,reduced", CONFIGS, ids=IDS)
def test_active_params_and_model_flops_equal_the_reference(arch, reduced):
    pytest.importorskip("jax")
    from repro.configs import get_config as jget_config
    from repro.distributed import analysis as janalysis
    cfg, jcfg = get_config(arch, reduced), jget_config(arch, reduced)
    assert analysis.active_params(cfg) == janalysis.active_params(jcfg)
    for shape in SHAPES.values():
        assert analysis.model_flops(cfg, shape.kind, shape.batch, shape.seq) == \
            janalysis.model_flops(jcfg, shape.kind, shape.batch, shape.seq)


def _sweep(*args):
    """The dry run's CLI in a fresh interpreter: its cells (JSON lines)
    and whether it loaded JAX."""
    code = ("import runpy, sys; sys.argv = ['dryrun', *sys.argv[1:]]\n"
            "try:\n    runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')\n"
            "finally:\n    print('JAX_LOADED', 'jax' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code, *args], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "JAX_LOADED False", lines[-1]
    return [json.loads(line) for line in lines if line.startswith("{")]


@pytest.mark.parametrize("mesh", ["1x1", "2x2", "1x4"])
def test_the_dry_run_covers_every_applicable_cell(mesh):
    """Every (arch × shape) cell of the reduced sweep: applicable cells
    OK with finite positive FLOPs, bytes and per-device bytes, the others
    skipped as ``shape_applicable`` says; no JAX loaded."""
    cells = _sweep("--reduced", "--json", "--mesh", mesh, "--set", "tp_block=shard_map")
    assert [(c["arch"], c["shape"]) for c in cells] == [(a, s) for a in ARCH_IDS
                                                        for s in SHAPES]
    for c in cells:
        ok = shape_applicable(get_config(c["arch"], True), c["shape"])
        assert c["status"] == ("OK" if ok else "SKIP"), c
        if ok:
            r = c["roofline"]
            assert r["step_flops"] > 0 and r["step_bytes"] > 0 and c["per_device_bytes"] > 0
            assert r["chips"] == 4 if mesh != "1x1" else r["chips"] == 1
            assert (c["collectives"]["total"] > 0) == (mesh != "1x1"), c
            assert c["fits_80gb"]


def test_a_full_size_cell_fits_with_its_microbatches():
    """qwen3-0.6b × train_4k at full size on one card: the parameters,
    fp32 moments and the gathered compute copy, the microbatch count
    that fits 80 GB, the FLOPs above the model's 6·N·D (the plain path
    counts causal attention dense, and remat runs each block twice)."""
    from repro_torch.launch import dryrun
    cell = dryrun.run_cell("qwen3-0.6b", "train_4k")
    cfg = get_config("qwen3-0.6b")
    n = analysis.active_params(cfg)
    mem = cell["memory_bytes"]
    assert mem["params_full"] == mem["params_shard"] == 2 * n          # bf16
    assert mem["moments_shard"] == 8 * n                                # two fp32 moments
    assert cell["fits_80gb"] and cell["per_device_bytes"] <= 80e9
    mb = cell["microbatches"]
    assert mb > 1 and SHAPES["train_4k"].batch % mb == 0
    assert mem["grad_sums_fp32"] == 4 * n
    r = cell["roofline"]
    assert r["model_flops"] == analysis.model_flops(cfg, "train", 256, 4096)
    assert r["step_flops"] > r["model_flops"] and 0 < r["useful_ratio"] < 1
    assert r["bottleneck"] in ("compute", "memory") and r["collective_s"] == 0


def test_shard_bytes_are_the_dtensor_local_shards():
    """The dry run's per-device parameter bytes on (2, 4): each leaf's
    DTensor local shard under a fake process group of 8."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    cfg = get_config("deepseek-moe-16b", reduced=True)
    named = dict(lm.LM(cfg, device="meta").named_parameters())
    shape = sharding.MeshShape((2, 4), ("data", "model"))
    specs = sharding.param_pspecs(lm.param_axes(cfg), named, sharding.default_rules(shape),
                                  shape)
    want = dryrun._local_bytes(named, specs, {"data": 2, "model": 4})
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        got = sum(distribute_tensor(p.detach(), mesh, sharding.to_placements(specs[n], mesh),
                                    src_data_rank=None).to_local().nbytes
                  for n, p in named.items())
    finally:
        dist.destroy_process_group()
    assert got == want and got < sum(p.nbytes for p in named.values())


def test_collective_bytes_follow_the_placements():
    """On one rank nothing moves; over (1, 4) with TP the parameters are
    gathered, the sliced gradients summed over model and each TP
    sublayer's activations all-reduced; prefill moves no gradient."""
    from repro_torch.distributed.sharding import MeshShape
    cfg = dataclasses.replace(get_config("granite-3-2b", reduced=True), tp_block="shard_map")
    one = analysis.collective_bytes(cfg, MeshShape((1, 1), ("data", "model")), "train", 8, 32)
    assert one["total"] == 0
    tp = analysis.collective_bytes(cfg, MeshShape((1, 4), ("data", "model")), "train", 8, 32)
    assert tp["param_gather"] > 0 and tp["grad_model"] > 0 and tp["grad_data"] == 0
    act = 8 * 32 * cfg.d_model * 4
    assert tp["tp_sublayers"] == pytest.approx(2 * cfg.n_layers * 2 * 2 * act * 3 / 4)
    dp = analysis.collective_bytes(cfg, MeshShape((4, 1), ("data", "model")), "train", 8, 32)
    assert dp["grad_data"] > 0 and dp["grad_model"] == 0 and dp["tp_sublayers"] == 0
    pre = analysis.collective_bytes(cfg, MeshShape((1, 4), ("data", "model")), "prefill", 8, 32)
    assert pre["grad_data"] == pre["grad_model"] == pre["tp_sublayers"] == 0
    moe = analysis.collective_bytes(get_config("deepseek-moe-16b", reduced=True),
                                    MeshShape((1, 4), ("data", "model")), "decode", 8, 32)
    assert moe["ep_outputs"] > 0


def test_the_roofline_takes_the_h100_peaks():
    from repro_torch.launch import mesh
    r = analysis.Roofline("a", "s", "1x2", 2, step_flops=989e12, step_bytes=3.35e12 / 2,
                          collective_bytes=450e9 / 4, model_flops_total=989e12).finalize()
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 0.5, 0.25)
    assert r.bottleneck == "compute" and r.useful_ratio == 0.5
    assert (mesh.PEAK_BF16_FLOPS, mesh.HBM_BYTES_PER_S, mesh.NVLINK_BYTES_PER_S) == \
        (989e12, 3.35e12, 450e9)


# ------------------------------------------------------------ the meta branch
def test_a_meta_tensor_never_reaches_a_kernel(monkeypatch):
    """Every kernel op on meta tensors: the plain version's shapes, the
    CUDA wrapper never called; the model kernels pass the dry run's hook
    once each, and their backward runs the plain version; mixed meta and
    CPU tensors raise."""
    from repro_torch.kernels import flash_attention, kmeans_assign, knn_topk, ops, rglru_scan
    from repro_torch.kernels import rmsnorm, ssd_scan
    for mod, fn in ((knn_topk, "knn_topk_cuda"), (kmeans_assign, "kmeans_assign_cuda"),
                    (rmsnorm, "rmsnorm_cuda"), (flash_attention, "flash_attention_cuda"),
                    (rglru_scan, "rglru_scan_cuda"), (ssd_scan, "ssd_scan_cuda")):
        def refuse(*a, _n=fn, **k):
            raise AssertionError(f"{_n} reached with meta tensors")
        monkeypatch.setattr(mod, fn, refuse)
    seen = []

    def hook(fn, inputs):
        seen.append(getattr(fn, "func", fn).__name__)
        return fn(*inputs)

    monkeypatch.setattr(ops, "meta_hook", hook)

    def meta(*shape, grad=False):
        return torch.empty(shape, device="meta", requires_grad=grad)

    x = meta(4, 8, grad=True)
    y = ops.rmsnorm(x, meta(8))
    assert y.device.type == "meta" and y.shape == (4, 8)
    y.sum().backward()
    assert x.grad is not None and x.grad.shape == (4, 8)
    assert ops.flash_attention(meta(1, 4, 6, 16), meta(1, 2, 6, 16), meta(1, 2, 6, 16),
                               window=3).shape == (1, 4, 6, 16)
    out, h = ops.rglru_scan(meta(2, 5, 8), meta(2, 5, 8))
    assert out.shape == (2, 5, 8) and h.shape == (2, 8) and h.dtype == torch.float32
    out, state = ops.ssd_scan(meta(1, 8, 2, 4), meta(1, 8, 2), meta(2), meta(1, 8, 3),
                              meta(1, 8, 3), chunk=4)
    assert out.shape == (1, 8, 2, 4) and state.shape == (1, 2, 4, 3)
    assert seen == ["rmsnorm_plain", "flash_attention_plain", "rglru_scan_plain",
                    "ssd_scan_plain"]
    d, lab = ops.knn_topk(meta(3, 4), meta(5, 4), torch.empty(5, dtype=torch.int32,
                                                               device="meta"), k=2)
    assert d.shape == (3, 2) and lab.shape == (3, 2)
    sums, counts, _ = ops.kmeans_assign(meta(6, 4), meta(2, 4))
    assert sums.shape == (2, 4) and counts.shape == (2,)
    with pytest.raises(ValueError, match="all on meta"):
        ops.rmsnorm(meta(4, 8), torch.ones(8))
