"""FLOP, byte and collective ledger of one step on NVIDIA H100 cards: the
port of ``repro/distributed/analysis.py``, with the H100's peaks in
place of the TPU v5e's.

Three least times per (arch × shape × mesh), each on the published peak
of the NVIDIA H100 SXM at 700 W (``launch/mesh.py``):

    compute    = step FLOPs per rank / 989e12     (bf16 tensor cores)
    memory     = step bytes per rank / 3.35e12    (HBM3)
    collective = collective bytes per rank / 450e9 (NVLink 4, one direction)

The step's FLOPs and bytes are counted over its aten ops on meta tensors
(``launch/dryrun.py``): FLOPs by ``torch.utils.flop_counter``, bytes as
every op reading its tensor inputs once and writing its outputs once
(no fusion: what XLA's unfused ``bytes accessed`` counts).  The
collective bytes are worked out from the placements of the port's own
step (:func:`collective_bytes`).  The collective term is a projection
for a node of several H100s joined by NVLink: one card has no link, and
the port's multi-rank runs share one card (gloo) or run on the CPU.

``model_flops`` and ``active_params`` are the reference's formulas;
``active_params`` counts the parameters of a model on the meta device in
place of ``jax.eval_shape``.  The reference's ``parse_collectives``
reads XLA's post-SPMD HLO text, which a PyTorch step does not have; the
port's collectives are explicit calls whose sizes follow from the
placements, so it has no counterpart.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict

import torch

from ..launch.mesh import HBM_BYTES_PER_S, NVLINK_BYTES_PER_S, PEAK_BF16_FLOPS
from ..models.lm import LM, LMConfig, param_axes, partial_over_model, tp_routes
from .sharding import default_rules, param_pspecs

_EXPERTS = ("w_gate", "w_up", "w_down")


def model_flops(cfg: LMConfig, kind: str, batch: int, seq: int) -> float:
    """MODEL_FLOPS = 6·N·D for training, 2·N·D for an inference forward,
    with *active* parameters for MoE; D = tokens processed (decode: one
    new token per sequence; the cache reads are memory traffic, not model
    FLOPs)."""
    tokens = batch if kind == "decode" else batch * seq
    mult = 6.0 if kind == "train" else 2.0
    return mult * active_params(cfg) * tokens


def active_params(cfg: LMConfig) -> float:
    """Parameter count with the routed experts scaled by top_k / n_experts
    (the shared experts count fully)."""
    total = 0.0
    for name, p in LM(cfg, device="meta").named_parameters():
        n = float(p.numel())
        parts = name.split(".")
        if "moe" in parts and parts[-1] in _EXPERTS:
            n *= cfg.top_k / max(cfg.n_experts, 1)
        total += n
    return total


def shard_count(spec, sizes: Dict[str, int]) -> int:
    """Ranks a tensor placed by ``spec`` is split over."""
    k = 1
    for entry in spec:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                k *= sizes[axis]
    return k


def collective_bytes(cfg: LMConfig, mesh, kind: str, batch: int, seq: int, *,
                     microbatches: int = 1, rules=None) -> Dict[str, float]:
    """Bytes one rank receives over ``mesh`` (a ``MeshShape`` or
    ``DeviceMesh`` with axes ``data`` and ``model``) in one step of the
    port's steps (``distributed/steps.py``), by collective, with ring
    algorithms (an all-gather of S bytes over n ranks brings S·(n−1)/n to
    each, an all-reduce 2·S·(n−1)/n):

    * ``param_gather``: every parameter gathered whole from its shards
      (``param_pspecs``), every step;
    * ``grad_data``: every gradient summed over ``data`` (fp32 with
      microbatches, else the parameter's dtype);
    * ``grad_model``: the gradients a model rank holds in part
      (``partial_over_model``) summed over ``model``;
    * ``tp_sublayers``: one ``B_l·S·D`` all-reduce per TP sublayer
      forward (twice under remat "full", which runs it again) and one in
      its backward (the input's cotangent);
    * ``ep_outputs``: the expert-parallel MoE's output all-reduce per
      layer forward (and again under remat) and, in training, its
      backward sums of the tokens' and weights' cotangents.

    The loss's and the gradient norm's scalar all-reduces are left out."""
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    dp, tp = sizes.get("data", 1), sizes.get("model", 1)
    rules = rules or default_rules(mesh)
    model = LM(cfg, device="meta")
    named = dict(model.named_parameters())
    specs = param_pspecs(param_axes(cfg), named, rules, mesh)

    def nbytes(p, dtype=None):
        return p.numel() * (dtype.itemsize if dtype is not None else p.element_size())

    def ring(s, n, reduce):
        return (2.0 if reduce else 1.0) * s * (n - 1) / n

    out = {"param_gather": sum(ring(nbytes(p), shard_count(specs[n], sizes), False)
                               for n, p in named.items())}
    train = kind == "train"
    grad_dt = torch.float32 if train and microbatches > 1 else None
    partial = partial_over_model(model, tp)
    out["grad_data"] = sum(ring(nbytes(p, grad_dt), dp, True) for p in named.values()) \
        if train else 0.0
    out["grad_model"] = sum(ring(nbytes(named[n], grad_dt), tp, True) for n in partial) \
        if train else 0.0
    rows = batch // dp if batch % dp == 0 else batch
    tokens = rows * (1 if kind == "decode" else seq)
    act = tokens * cfg.d_model * cfg.compute_dtype.itemsize
    again = 2 if train and cfg.remat == "full" else 1
    n_tp = sum(sum(tp_routes(cfg, t, tp)) for t in cfg.layer_types) if train else 0
    out["tp_sublayers"] = n_tp * (again + 1) * ring(act, tp, True)
    n_moe = cfg.layer_types.count("moe") if tp > 1 else 0
    routed = tokens * cfg.top_k * 4                        # the fp32 router weights
    out["ep_outputs"] = n_moe * (again * ring(act, tp, True)
                                 + (ring(act + routed, tp, True) if train else 0.0))
    out["total"] = sum(out.values())
    return out


@dataclass
class Roofline:
    """One cell's least times on H100s.  ``step_flops`` and ``step_bytes``
    are one rank's (every rank of the mesh does the same work);
    ``collective_bytes`` what one rank receives."""
    arch: str
    shape: str
    mesh: str
    chips: int
    step_flops: float
    step_bytes: float
    collective_bytes: float
    model_flops_total: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0

    def finalize(self) -> "Roofline":
        self.compute_s = self.step_flops / PEAK_BF16_FLOPS
        self.memory_s = self.step_bytes / HBM_BYTES_PER_S
        self.collective_s = self.collective_bytes / NVLINK_BYTES_PER_S
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        done = self.step_flops * self.chips
        self.useful_ratio = self.model_flops_total / done if done else 0.0
        return self

    def as_dict(self) -> dict:
        d = asdict(self)
        d["model_flops"] = d.pop("model_flops_total")
        return d
