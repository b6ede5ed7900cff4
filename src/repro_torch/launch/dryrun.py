"""Memory and FLOP ledger of every (arch × shape) cell on NVIDIA H100
cards: the port of ``repro/launch/dryrun.py``, with no TPU number.

The reference lowers and compiles each cell's jitted step for 256 / 512
TPU v5e chips and reads XLA's cost and memory analyses.  The port has no
compiler to ask, so each cell runs rank 0's step of the plain path on
the ``meta`` device (shapes and dtypes, no storage; the kernel ops take
their plain versions there, ``kernels/ops.py``) under a fake process
group of ``data · model`` ranks, whose collectives move nothing
(``torch.testing._internal.distributed.fake_pg``), on a ``(data, model)``
mesh given on the command line (default ``1x1``):

* train: ``steps.mesh_gradients`` — the forward and backward of its rows,
  through the TP sublayers and the expert-parallel MoE where the mesh
  and the config route there; prefill and decode: the model's forward
  with the rows of this rank, as ``make_prefill_step`` /
  ``make_decode_step`` compute it;
* FLOPs by ``torch.utils.flop_counter.FlopCounterMode``, bytes as every
  non-view op reading its tensor inputs and writing its outputs once, and
  the peak of the step's live tensors (activations, gradients and
  temporaries, each tensor counted from the op that makes it until it is
  freed);
* per-device bytes: the parameters' and (train) the fp32 AdamW moments'
  shards, as ``param_pspecs`` places them; the compute copy of the whole
  parameters, which the port's steps gather onto every rank; the batch's
  and the caches' rows of this rank; the step's peak; with microbatches,
  the fp32 gradient sums;
* ``model_flops``, the collective bytes and the ``Roofline``
  (``distributed/analysis.py``), and whether the cell fits one H100's
  80 GB.

Training's microbatch count is an argument (``--microbatches``); by
default it is the smallest power of two that divides the local batch and
fits the card, the peak of the live tensors scaled by the microbatch's
share of the rows (activations are linear in the rows).  The reference's
``MICROBATCHES`` table and bf16 moments were sized for 16 GB TPU chips
and are not carried over.  Cells that ``shape_applicable`` refuses are
skipped, as in the reference.  It imports no JAX and needs no card:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh 1x4
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import weakref
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs import (ARCH_IDS, SHAPES, SMOKE_SHAPES, cache_specs, get_config, input_specs,
                       shape_applicable)
from ..distributed import steps
from ..distributed.analysis import Roofline, collective_bytes, model_flops, shard_count
from ..distributed.sharding import MeshShape, default_rules, param_pspecs
from ..kernels import ops
from ..models.lm import LM, param_axes
from .mesh import HBM_BYTES


class StepLedger(TorchDispatchMode):
    """Bytes every non-view op reads and writes, and the peak of the live
    tensors the ops make (a tensor is live from the op that makes it
    until it is freed; views share their base's bytes).  A kernel's meta
    stand-in (``kernels/ops.py``'s ``meta_hook``) counts as the kernel:
    its inputs read and outputs written once, none of the plain
    version's temporaries."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._in_kernel = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def _count(self, ins, outs) -> None:
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self.live += _nbytes(t)
            weakref.finalize(t, self._free, _nbytes(t))
        self.peak = max(self.peak, self.live)

    def kernel(self, fn, inputs):
        self._in_kernel += 1
        try:
            out = fn(*inputs)
        finally:
            self._in_kernel -= 1
        self._count([t for t in inputs if isinstance(t, torch.Tensor)],
                    [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or self._in_kernel:
            return out
        self._count([t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)],
                    [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)])
        return out


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks (this process rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local_bytes(named: Dict[str, torch.Tensor], specs, sizes: Dict[str, int],
                 itemsize: Optional[int] = None) -> float:
    """Bytes of this rank's shards of ``named`` placed by ``specs``: each
    sharded dim divided by its mesh axes (the specs shard only dims that
    divide)."""
    return sum(p.numel() * (itemsize or p.element_size()) / shard_count(specs[n], sizes)
               for n, p in named.items())


def _step(model: LM, shape, inputs, mesh):
    """Rank 0's step of ``shape`` on ``mesh`` (meta tensors)."""
    if shape.kind == "train":
        steps.mesh_gradients(model, inputs["batch"], mesh)
        return
    with torch.no_grad():
        if shape.kind == "prefill":
            steps.make_prefill_step(cache_len=shape.seq, mesh=mesh)(model, inputs["batch"])
        else:
            steps.make_decode_step(mesh=mesh)(model, inputs["batch"], inputs["caches"],
                                              shape.seq - 1)


def run_cell(arch: str, shape_name: str, mesh_shape: Tuple[int, int] = (1, 1), *,
             microbatches: Optional[int] = None, cfg_overrides: Optional[dict] = None,
             reduced: bool = False) -> dict:
    """The ledger of one cell (see the module docstring); ``reduced``: the
    arch's reduced config at the SMOKE shapes (a quick sweep)."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg = get_config(arch, reduced=reduced)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = (SMOKE_SHAPES if reduced else SHAPES)[shape_name]
    data, tp = mesh_shape
    cell = {"arch": arch, "shape": shape_name, "mesh": f"{data}x{tp}",
            "cfg_overrides": dict(cfg_overrides or {})}
    if not shape_applicable(cfg, shape_name):
        cell.update(status="SKIP", reason="long_500k requires sub-quadratic attention; "
                                          "full-attention arch skipped per assignment")
        return cell
    t0 = time.perf_counter()
    chips = data * tp
    abstract = MeshShape((data, tp), ("data", "model"))
    sizes = {"data": data, "model": tp}
    rows = shape.batch // data if shape.batch % data == 0 else shape.batch
    inputs = input_specs(cfg, shape)
    if shape.kind == "decode":            # the decode step holds this rank's rows' caches
        inputs["caches"] = cache_specs(cfg, rows, shape.seq)
    model = LM(cfg, device="meta")
    named = dict(model.named_parameters())
    specs = param_pspecs(param_axes(cfg), named, default_rules(abstract), abstract)
    full = sum(_nbytes(p) for p in named.values())
    mem = {"params_shard": _local_bytes(named, specs, sizes), "params_full": full,
           "batch": sum(_nbytes(v) for v in inputs["batch"].values()) * rows / shape.batch}
    if shape.kind == "train":
        mem["moments_shard"] = 2 * _local_bytes(named, specs, sizes, itemsize=4)
    if shape.kind == "decode":
        mem["caches"] = sum(_nbytes(t) for c in inputs["caches"] for t in c.values())
    ledger = StepLedger()
    with fake_world(chips):
        mesh = init_device_mesh("cpu", (data, tp), mesh_dim_names=("data", "model"))
        ops.meta_hook = ledger.kernel
        try:
            with FlopCounterMode(display=False) as flops, ledger:
                _step(model, shape, inputs, mesh)
        finally:
            ops.meta_hook = None
    mem["step_peak"] = ledger.peak
    fixed = sum(mem.values()) - mem["step_peak"]
    mb = 1
    if shape.kind == "train":
        # the step's peak holds the gradients and the activations of its
        # rows; a microbatch holds its share of the activations, and the
        # fp32 gradient sums besides
        acts = max(ledger.peak - full, 0)
        sums = sum(p.numel() * 4 for p in named.values())

        def need(m):
            return fixed + full + acts / m + (sums if m > 1 else 0)

        mb = microbatches
        if mb is None:
            mb = 1
            while need(mb) > HBM_BYTES and rows % (2 * mb) == 0:
                mb *= 2
        mem["step_peak"] = full + acts / mb
        if mb > 1:
            mem["grad_sums_fp32"] = sums
        cell["microbatches"] = mb
    per_device = sum(mem.values())
    coll = collective_bytes(cfg, abstract, shape.kind, shape.batch, shape.seq,
                            microbatches=mb)
    mf = model_flops(cfg, shape.kind, shape.batch, shape.seq)
    rl = Roofline(arch=arch, shape=shape_name, mesh=cell["mesh"], chips=chips,
                  step_flops=float(flops.get_total_flops()), step_bytes=float(ledger.bytes),
                  collective_bytes=coll["total"], model_flops_total=mf).finalize()
    cell.update(status="OK", seconds=time.perf_counter() - t0, chips=chips,
                memory_bytes=mem, per_device_bytes=per_device,
                fits_80gb=per_device <= HBM_BYTES, collectives=coll, roofline=rl.as_dict())
    return cell


def _parse_mesh(text: str) -> Tuple[int, int]:
    data, _, model = text.partition("x")
    return int(data), int(model)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="H100 memory and FLOP ledger of every "
                                             "(arch × shape) cell, on meta tensors")
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="1x1", help="data x model, e.g. 1x4")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--set", dest="cfg_set", default=None,
                    help="comma list of LMConfig overrides, e.g. tp_block=shard_map")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs at the SMOKE shapes (a quick sweep)")
    ap.add_argument("--json", action="store_true", help="one JSON line per cell")
    args = ap.parse_args(argv)
    overrides = None
    if args.cfg_set:
        overrides = {}
        for kv in args.cfg_set.split(","):
            k, _, v = kv.partition("=")
            overrides[k] = int(v) if v.isdigit() else v
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    mesh = _parse_mesh(args.mesh)
    counts = {"OK": 0, "SKIP": 0}
    for arch in archs:
        for shape in shapes:
            cell = run_cell(arch, shape, mesh, microbatches=args.microbatches,
                            cfg_overrides=overrides, reduced=args.reduced)
            counts[cell["status"]] += 1
            if args.json:
                print(json.dumps(cell), flush=True)
                continue
            extra = ""
            if cell["status"] == "OK":
                r = cell["roofline"]
                extra = (f" per-device {cell['per_device_bytes'] / 1e9:.2f} GB"
                         f" fits={cell['fits_80gb']}"
                         + (f" mb={cell['microbatches']}" if "microbatches" in cell else "")
                         + f" compute={r['compute_s'] * 1e3:.1f}ms"
                         f" memory={r['memory_s'] * 1e3:.1f}ms"
                         f" coll={r['collective_s'] * 1e3:.1f}ms bound={r['bottleneck']}"
                         f" useful={r['useful_ratio']:.2f}")
            print(f"[{cell['status']}] {arch} × {shape} × {cell['mesh']}{extra}", flush=True)
    print(f"\ndry run: {counts['OK']} OK, {counts['SKIP']} SKIP")
    return 0


if __name__ == "__main__":
    sys.exit(main())
