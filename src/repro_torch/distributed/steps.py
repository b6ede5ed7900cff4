"""Train / prefill / decode steps, on one device or over a device mesh: the
port of ``repro/distributed/steps.py``.

Without a mesh, ``make_train_step`` is the world-size-1 step:

1. the value and gradient of :func:`repro_torch.models.lm.loss_fn`
   (``loss.backward()``);
2. with ``microbatches > 1``: the batch split into that many contiguous
   slices along its first axis, the gradients summed in fp32 buffers and
   divided by the count — the optimizer then gets fp32 gradients, as the
   reference's ``gsum`` path does, where the single-batch path gives it
   gradients in each parameter's dtype;
3. optionally a compression round trip (``grad_compress``: ``int8`` or
   ``topk``, fresh error feedback every step, as the reference calls it);
4. the optimizer's update, in place, which returns the gradient norm.

Over a ``(data, model)`` mesh (:func:`repro_torch.launch.mesh.make_local_mesh`)
the steps compute the reference's GSPMD function with data parallelism
and FSDP storage:

* the parameters and the AdamW moments are stored as DTensors placed by
  :func:`~repro_torch.distributed.sharding.param_pspecs` (the moments
  inherit the parameter specs; the count is a host scalar on every rank):
  a :class:`ShardedState` from :func:`shard_state`;
* each step gathers the full parameters into the model's own (plain)
  parameters for compute — the hand-written kernels take plain CUDA
  tensors through ctypes, and ``kernels/ops.py`` raises on a DTensor;
* each rank computes on its rows of the batch (dim 0 over ``data`` in
  contiguous blocks, as :func:`batch_pspecs` places it); microbatch i is
  the i-th contiguous slice of every data shard; the loss divides by the
  global mask sum;
* with ``model = 1`` the MoE blocks route over the data group (global
  capacity, global token order, global balance loss, ``layers/moe.py``),
  so the step equals the one-device step on the whole batch, its rows in
  that microbatch order;
* with ``model > 1`` the model routes as the reference's does over that
  axis (``models/lm.py``): every MoE block runs the expert-parallel
  ``moe_apply_sharded`` (each data shard routes its own tokens with its
  own capacity and balance loss), and with ``tp_block="shard_map"`` the
  training forward runs the Megatron TP sublayers
  (``layers/tp_block.py``).  Otherwise compute is replicated across
  ``model``, which is the reference's GSPMD function;
* the gradients are summed over ``data``, and those that a model rank
  holds only in part (:func:`repro_torch.models.lm.partial_over_model`:
  the TP sublayers' and the routed experts' parameters) also over
  ``model`` — every other parameter's gradient is already whole on each
  model rank; then the compression round trip runs on them, then each
  rank updates its local shards, with the gradient norm (and so the
  clipping) reduced over all ranks.

The prefill and decode steps take the global batch too and compute this
rank's rows with the model's full parameters; their caches hold this
rank's rows (``cache_pspecs`` places caches over ``data``), and their
logits are this rank's rows (:func:`gather_rows` gathers them).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..models.convert import jax_layout
from ..models.lm import LM, loss_fn, param_axes, partial_over_model
from ..optim.adamw import AdamWState, Optimizer
from ..optim.compress import compressed_gradients
from .sharding import (P, ShardingRules, batch_pspecs, default_rules, param_pspecs,
                       to_placements, to_shardings)


def _grads(model: LM, batch: Dict[str, torch.Tensor], data_group=None, model_group=None):
    """(metrics of ``loss_fn``, {name: gradient}) of one forward and
    backward; parameters that get no gradient get zeros, as JAX's
    ``value_and_grad`` gives them."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    total, metrics = loss_fn(model, batch, data_group=data_group, model_group=model_group)
    total.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    for p in params.values():
        p.grad = None
    return metrics, grads


def _accumulated(model: LM, batch: Dict[str, torch.Tensor], microbatches: int,
                 data_group=None, model_group=None):
    """(metrics, gradients) of ``batch``: :func:`_grads`, or with
    ``microbatches > 1`` its contiguous slices' gradients summed in fp32
    buffers (not yet divided by the count) and their loss and aux
    averaged."""
    if microbatches == 1:
        return _grads(model, batch, data_group, model_group)
    B = next(iter(batch.values())).shape[0]
    mb = B // microbatches
    if mb * microbatches != B:
        raise ValueError(f"batch {B} not divisible by {microbatches} microbatches")
    gsum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in model.named_parameters()}
    lsum = asum = 0.0
    for i in range(microbatches):
        m, g = _grads(model, {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}, data_group,
                      model_group)
        for n, gi in g.items():
            gsum[n] += gi.to(torch.float32)
        lsum = lsum + m["loss"].detach()
        asum = asum + m["aux"].detach()
    return {"loss": lsum / microbatches, "aux": asum / microbatches}, gsum


class ShardedState(NamedTuple):
    """The training state over a mesh: ``params`` and ``opt``'s moments are
    DTensors by parameter name; ``opt.count`` is a host scalar."""
    params: Dict[str, Any]
    opt: AdamWState


def shard_state(model: LM, optimizer: Optimizer, mesh,
                rules: Optional[ShardingRules] = None) -> ShardedState:
    """``model``'s parameters (the same on every rank) placed on ``mesh`` by
    the sharding rules, each rank keeping its shards, and a fresh
    optimizer state whose moments inherit the placements."""
    from torch.distributed.tensor import distribute_tensor
    rules = rules or default_rules(mesh)
    named = dict(model.named_parameters())
    specs = param_pspecs(param_axes(model.cfg), named, rules, mesh)
    params = {n: distribute_tensor(p.detach().clone(), mesh, to_placements(specs[n], mesh),
                                   src_data_rank=None)
              for n, p in named.items()}
    return ShardedState(params, optimizer.init(params))


def _local(dt) -> torch.Tensor:
    with torch.no_grad():
        return dt.to_local()


def full_tensor(dt) -> torch.Tensor:
    """The full tensor of the DTensor ``dt``: its local shard gathered over
    each mesh dim that shards it.  ``DTensor.full_tensor`` computes the
    same, but also gathers over mesh dims of one rank, and its dispatch
    costs ~0.1 ms a leaf on the card (32 ms a step for qwen3-0.6b's 311)."""
    t = _local(dt)
    mesh = dt.device_mesh
    for i, pl in enumerate(dt.placements):
        if pl.is_shard() and mesh.size(i) > 1:
            parts = [torch.empty_like(t) for _ in range(mesh.size(i))]
            dist.all_gather(parts, t.contiguous(), group=mesh.get_group(i))
            t = torch.cat(parts, dim=pl.dim)
    return t


@torch.no_grad()
def gather_params(model: LM, state: ShardedState) -> None:
    """Copy the full parameters of ``state`` into ``model``'s own."""
    for n, p in model.named_parameters():
        p.copy_(full_tensor(state.params[n]))


def _shard_of(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's shard of ``full`` (the same on every rank), placed as
    the DTensor ``like``: its chunk along each dim a mesh dim shards (the
    specs shard only dims that divide, so the chunks are even)."""
    coord = like.device_mesh.get_coordinate()
    for i, pl in enumerate(like.placements):
        if pl.is_shard():
            full = full.chunk(like.device_mesh.size(i), dim=pl.dim)[coord[i]]
    return full


def _owns(dt) -> bool:
    """Whether this rank counts ``dt``'s local shard in a global sum: it is
    the first of the ranks that hold a copy of it (coordinate 0 on every
    mesh dim that replicates it)."""
    coord = dt.device_mesh.get_coordinate()
    return all(c == 0 for c, pl in zip(coord, dt.placements) if pl.is_replicate())


def _model_group(mesh):
    """The mesh's ``model`` group where that axis has more than one rank,
    else ``None`` (compute replicated, as without a mesh)."""
    return mesh.get_group("model") if mesh.size(mesh.mesh_dim_names.index("model")) > 1 else None


def _rows(batch: Dict[str, torch.Tensor], mesh, rules: ShardingRules):
    """(this rank's rows of ``batch``, the data group where the rows are
    split over it, else ``None``): dim 0 over ``data`` as
    :func:`batch_pspecs` places it (a batch that does not divide stays
    whole on every rank)."""
    specs = batch_pspecs(batch, rules, mesh)
    group = None
    out = {}
    for k, x in batch.items():
        spec = specs[k]
        if len(spec) and spec[0] is not None:
            axis = spec[0]
            n, i = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)
            x = x.chunk(n, dim=0)[i]
            group = mesh.get_group(axis)
        out[k] = x
    return out, group


def gather_rows(t: torch.Tensor, mesh, n_rows: int) -> torch.Tensor:
    """The global batch of ``n_rows`` rows of a per-rank result ``t``
    (logits, chosen tokens): every data rank's rows concatenated in rank
    order, or ``t`` itself where it holds them all (a batch that does not
    divide over ``data``, or a data axis of one)."""
    if t.shape[0] == n_rows:
        return t
    group = mesh.get_group("data")
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def make_train_step(optimizer: Optimizer, *, mesh=None, rules: Optional[ShardingRules] = None,
                    microbatches: int = 1, grad_compress: Optional[str] = None) -> Callable:
    """``train_step(model, state, batch) -> metrics``: one optimizer step on
    ``batch`` (tensors on the model's device), updating the parameters
    and the optimizer state in place.  ``metrics`` holds ``loss``,
    ``aux`` (the ``moe`` blocks' balance loss, weighed into the gradients
    by ``loss_fn``; zero without one) and ``grad_norm`` (0-d tensors;
    ``tokens`` too on the single-batch path).  The reference's ``cfg``
    argument is not taken: the model carries its config.

    Without ``mesh``, ``state`` is the optimizer's :class:`AdamWState` and
    the model's parameters are the ones updated.  With ``mesh``,
    ``state`` is the :class:`ShardedState` of :func:`shard_state`, whose
    shards are updated; ``batch`` is the global batch (the same on every
    rank) and ``model`` the compute copy that each step fills with the
    gathered parameters (:func:`gather_params` refreshes it after the
    last step)."""
    if mesh is None:
        def train_step(model: LM, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
            metrics, grads = _accumulated(model, batch, microbatches)
            if microbatches > 1:
                grads = {n: g / microbatches for n, g in grads.items()}
            if grad_compress and grad_compress != "none":
                grads, _ = compressed_gradients(grads, None, codec=grad_compress)
            gnorm = optimizer.update(grads, opt_state, dict(model.named_parameters()))
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["grad_norm"] = gnorm
            return metrics

        return train_step

    rules = rules or default_rules(mesh)

    def sharded_step(model: LM, state: ShardedState, batch: Dict[str, torch.Tensor]):
        gather_params(model, state)
        metrics, grads = mesh_gradients(model, batch, mesh, rules, microbatches)
        if microbatches > 1:
            grads = {n: g / microbatches for n, g in grads.items()}
        if grad_compress and grad_compress != "none":
            grads, _ = compressed_gradients(grads, None, codec=grad_compress)
        owned = {n: _owns(dt) for n, dt in state.params.items()}

        def sumsq(local_grads: Dict[str, torch.Tensor]) -> torch.Tensor:
            # each shard counted once over the mesh, then summed over it
            s = sum(torch.sum(torch.square(g.to(torch.float32)))
                    for n, g in local_grads.items() if owned[n])
            s = torch.as_tensor(s, dtype=torch.float32, device=model.device)
            dist.all_reduce(s)
            return s

        params = {n: _local(dt) for n, dt in state.params.items()}
        opt = AdamWState(state.opt.count, {n: _local(t) for n, t in state.opt.mu.items()},
                         {n: _local(t) for n, t in state.opt.nu.items()})
        gnorm = optimizer.update({n: _shard_of(g, state.params[n]) for n, g in grads.items()},
                                 opt, params, sumsq=sumsq)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        return metrics

    return sharded_step


def mesh_gradients(model: LM, batch: Dict[str, torch.Tensor], mesh,
                   rules: Optional[ShardingRules] = None, microbatches: int = 1):
    """(metrics, {name: gradient}) of ``model``'s parameters (the whole
    parameters, the same on every rank) on the global ``batch`` over
    ``mesh``: this rank's rows, every gradient summed over ``data``, and
    those a model rank holds only in part
    (:func:`~repro_torch.models.lm.partial_over_model`) also over
    ``model``, so that each rank holds the whole batch's gradients (with
    ``microbatches > 1`` the fp32 sums over the microbatches, not yet
    divided by their count).  The train step's gradients."""
    rules = rules or default_rules(mesh)
    local, group = _rows(batch, mesh, rules)
    if group is None and mesh.size(mesh.mesh_dim_names.index("data")) > 1:
        raise ValueError(f"batch {next(iter(batch.values())).shape[0]} does not divide "
                         f"over the data axis of {mesh}")
    group = group if group is not None else mesh.get_group("data")
    model_group = _model_group(mesh)
    metrics, grads = _accumulated(model, local, microbatches, group, model_group)
    partial = partial_over_model(model, dist.get_world_size(model_group)) if model_group else ()
    for n, g in grads.items():
        dist.all_reduce(g, group=group)              # summed over the data ranks
        if n in partial:
            dist.all_reduce(g, group=model_group)    # and over the model ranks
    return metrics, grads


def make_prefill_step(*, cache_len: int, mesh=None, rules: Optional[ShardingRules] = None
                      ) -> Callable:
    """``prefill(model, batch) -> (last-position logits (B, 1, V) fp32,
    caches)``.  With ``mesh``, ``batch`` is the global batch and the
    logits and caches are this rank's rows."""
    rules = rules or (default_rules(mesh) if mesh is not None else None)

    @torch.no_grad()
    def prefill(model: LM, batch: Dict[str, torch.Tensor]):
        group = model_group = None
        if mesh is not None:
            batch, group = _rows(batch, mesh, rules)
            model_group = _model_group(mesh)
        return model(batch, make_cache_len=cache_len, last_only=True, remat="none",
                     data_group=group, model_group=model_group)

    return prefill


def make_decode_step(*, mesh=None, rules: Optional[ShardingRules] = None) -> Callable:
    """``decode(model, batch, caches, pos) -> (logits (B, 1, V) fp32,
    caches)``: one token per row at position ``pos``, the attention caches
    written in place.  With ``mesh``, ``batch`` is the global batch, and
    ``caches`` and the logits are this rank's rows."""
    rules = rules or (default_rules(mesh) if mesh is not None else None)

    @torch.no_grad()
    def decode(model: LM, batch: Dict[str, torch.Tensor], caches, pos: int):
        group = model_group = None
        if mesh is not None:
            batch, group = _rows(batch, mesh, rules)
            model_group = _model_group(mesh)
        return model(batch, caches=caches, pos_offset=pos, remat="none", data_group=group,
                     model_group=model_group)

    return decode


def checkpoint_shardings(model: LM, mesh, rules: Optional[ShardingRules] = None) -> Dict[str, Any]:
    """The :class:`~repro_torch.distributed.sharding.Sharding` of every
    leaf of a checkpoint of a :class:`ShardedState` in the reference's
    layout (``{"params", "opt"}``, scan leaves stacked on a leading layers
    dim, which stays whole): the ``shardings`` that restore one onto
    ``mesh``."""
    rules = rules or default_rules(mesh)
    specs = param_pspecs(param_axes(model.cfg), dict(model.named_parameters()), rules, mesh)
    tree = jax_layout(model.cfg, specs, stack=lambda s: P(None, *s[0]))
    shardings = to_shardings(tree, mesh)
    return {"params": shardings, "opt": AdamWState(None, shardings, shardings)}

