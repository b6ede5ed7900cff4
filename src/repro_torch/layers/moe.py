"""Routed Mixture-of-Experts with capacity-based dispatch: the port of
``repro/layers/moe.py``'s ``moe_apply_local``, on one device or over a
data-parallel group (the expert-parallel ``moe_apply_sharded``, experts
over the ``model`` axis, waits for ROADMAP item A11.4).

The reference computes MoE outside any Pallas kernel, as gathers and
batched einsums, so the port is plain PyTorch (``torch.sort``, indexing,
``torch.bmm``) with the reference's semantics, kept exactly:

* routing in fp32 (``x @ w_router``, softmax), the top-k by a stable
  descending sort, so that ties keep the lower expert index as
  ``jax.lax.top_k`` does (``torch.topk`` promises no order among ties);
* dispatch by a stable sort of the flat expert ids; an assignment's slot
  is its position in its expert's segment, so an expert's capacity
  ``C = max(min_capacity, ceil(N·k·cf / E))`` keeps its first ``C``
  assignments in token order (not by weight) and drops the rest, which
  pass through the residual only;
* the expert FFNs as ``torch.bmm`` over the packed ``(E, C, D)`` buffer,
  in the compute dtype, and the weighted contributions combined per
  token in ascending expert order — the order of the reference's
  ``out.at[s_tok].add(contrib)`` — by a gather and a fixed sequence of
  adds: no atomics, so the result is bitwise repeatable on a card;
* the Switch-style balance loss ``E · Σ_e mean(probs)_e · mean(onehot(top-1))_e``.

Over a data-parallel ``group`` (each rank holds contiguous rows of the
batch, rank-major) the layer computes what one device computes on the
whole batch, as the reference's GSPMD step does on a ``model = 1`` mesh:
the capacity comes from the global token count; an assignment's slot is
its position among its expert's assignments in global token order — its
local position plus the assignments of the lower ranks to that expert,
the exclusive prefix of one ``all_gather`` of each rank's per-expert
counts, so ties still go by token order; the balance loss takes the
router statistics of the whole batch, summed by a differentiable
all-reduce, so that its gradient reaches every rank's router.  Each rank
computes its own tokens' outputs.  Without a group, or with a group of
one, no collective is launched and the code is the one-device path.

Weights keep the JAX layouts: ``w_router`` (d_model, E), kept in fp32
in a bf16 model as the reference keeps it, ``w_gate`` / ``w_up``
(E, d_model, F), ``w_down`` (E, F, d_model).
"""
from __future__ import annotations

import math
import warnings
from typing import Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mlp import init_normal_

PARAM_NAMES = ("w_router", "w_gate", "w_up", "w_down")


def moe_axes():
    """Logical axes of :class:`MoE`'s parameters (for placement)."""
    return {
        "w_router": ("embed", "expert_router"),
        "w_gate": ("expert", "embed", "expert_mlp"),
        "w_up": ("expert", "embed", "expert_mlp"),
        "w_down": ("expert", "expert_mlp", "embed"),
    }


def _spread(group) -> Optional[object]:
    """``group`` where it spans more than one rank, else ``None``."""
    return group if group is not None and dist.get_world_size(group) > 1 else None


def _summed(t: torch.Tensor, group, grad: bool = False) -> torch.Tensor:
    """``t`` summed over ``group``; with ``grad``, differentiably (the
    gradient of each rank's share is the sum of every rank's gradient)."""
    if grad:
        import torch.distributed.nn.functional as dist_fn
        with warnings.catch_warnings():       # deprecated, but still the autograd one
            warnings.simplefilter("ignore", FutureWarning)
            return dist_fn.all_reduce(t, group=group)
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def _route(xf: torch.Tensor, w_router: torch.Tensor, top_k: int, renormalize: bool = True,
           group=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf (N, D) -> (weights (N, k) fp32, expert ids (N, k) int64, aux loss
    0-d fp32): the reference's ``_route``, with the balance loss's router
    statistics over every rank of ``group``'s tokens."""
    probs = torch.softmax(xf.to(torch.float32) @ w_router, dim=-1)
    # a stable descending sort keeps the lower index first among equal
    # probabilities, as jax.lax.top_k does
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :top_k], topi[:, :top_k]
    if renormalize:
        topw = topw / torch.clamp(topw.sum(dim=-1, keepdim=True), min=1e-9)
    n_experts = w_router.shape[1]
    group = _spread(group)
    if group is None:
        me = probs.mean(dim=0)
        ce = F.one_hot(topi[:, 0], n_experts).to(torch.float32).mean(dim=0)
    else:
        n = _summed(torch.tensor(float(xf.shape[0]), device=xf.device), group)
        me = _summed(probs.sum(dim=0), group, grad=True) / n
        ce = _summed(F.one_hot(topi[:, 0], n_experts).to(torch.float32).sum(dim=0), group) / n
    return topw, topi, n_experts * (me * ce).sum()


class Plan(NamedTuple):
    """Where each of the N·k token-expert assignments goes, in dispatch
    order (a stable sort of the expert ids)."""
    order: torch.Tensor     # (N·k,) flat assignment index, in dispatch order
    expert: torch.Tensor    # (N·k,) expert id
    token: torch.Tensor     # (N·k,) token of the assignment
    slot: torch.Tensor      # (N·k,) position in its expert's segment here
    valid: torch.Tensor     # (N·k,) kept: within the capacity


def _plan(topi: torch.Tensor, capacity: int, before: Optional[torch.Tensor] = None) -> Plan:
    """The reference's dispatch plan for ids ``topi`` (N, k): which
    assignments its capacity keeps, and where they go.  ``before`` (E,)
    counts each expert's assignments of tokens that precede these (the
    lower ranks' of a data-parallel group): they come first in the
    expert's segment."""
    N, k = topi.shape
    flat_e = topi.reshape(N * k)
    order = torch.sort(flat_e, stable=True).indices
    s_e = flat_e[order]
    first = torch.searchsorted(s_e, s_e, side="left")
    pos = torch.arange(N * k, device=topi.device) - first
    kept = pos < capacity if before is None else before[s_e] + pos < capacity
    return Plan(order, s_e, torch.div(order, k, rounding_mode="floor"), pos, kept)


def _dispatch_compute(xf, topw, topi, w_gate, w_up, w_down, capacity: int,
                      before: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sort-based capacity dispatch to the experts ``w_*`` (E, D, F) /
    (E, F, D): their (N, D) contribution for ``xf`` (N, D), ``topw``
    (N, k) in xf's dtype and ``topi`` (N, k); ``before`` as :func:`_plan`'s."""
    N, D = xf.shape
    k = topi.shape[1]
    E = w_gate.shape[0]
    p = _plan(topi, capacity, before)
    # pack into (E + 1, C, D); dropped assignments land, as zeros, in the
    # overflow row, which is discarded
    be = torch.where(p.valid, p.expert, E)
    bp = torch.where(p.valid, p.slot, 0)
    rows = torch.where(p.valid[:, None], xf[p.token], 0.0)
    buf = xf.new_zeros((E + 1, capacity, D)).index_put((be, bp), rows)[:E]
    dt = xf.dtype
    h = F.silu(torch.bmm(buf, w_gate.to(dt))) * torch.bmm(buf, w_up.to(dt))
    y = torch.bmm(h, w_down.to(dt))
    y_rows = y[p.expert, bp]                                  # garbage where dropped
    s_w = topw.reshape(N * k)[p.order]
    contrib = torch.where(p.valid, s_w, 0.0)[:, None].to(dt) * y_rows
    # each token's k contributions in dispatch order, i.e. ascending expert
    # id: the positions of its assignments in that order, sorted
    where = torch.empty_like(p.order)
    where[p.order] = torch.arange(N * k, device=xf.device)
    mine = contrib[torch.sort(where.view(N, k), dim=1).values]     # (N, k, D)
    out = mine[:, 0]
    for i in range(1, k):
        out = out + mine[:, i]
    return out


def moe_capacity(n_tokens: int, top_k: int, n_experts: int, capacity_factor: float,
                 min_capacity: int = 4) -> int:
    return max(min_capacity, int(math.ceil(n_tokens * top_k * capacity_factor / n_experts)))


def _lower_ranks_counts(topi: torch.Tensor, n_experts: int, group
                        ) -> Tuple[torch.Tensor, int]:
    """(each expert's assignments on the lower ranks of ``group``, (E,);
    the group's token count), from one ``all_gather`` of every rank's
    per-expert counts."""
    counts = torch.bincount(topi.reshape(-1), minlength=n_experts)
    every = [torch.empty_like(counts) for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, counts, group=group)
    rank = dist.get_rank(group)
    before = torch.stack(every[:rank]).sum(dim=0) if rank else torch.zeros_like(counts)
    return before, int(sum(int(c.sum()) for c in every)) // topi.shape[1]


def moe_apply_local(params: Mapping[str, torch.Tensor], x: torch.Tensor, *, top_k: int,
                    capacity_factor: float = 1.25, min_capacity: int = 4,
                    renormalize: bool = True, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed MoE: x (B, S, D) -> (out (B, S, D), aux loss).  The capacity
    comes from this call's token count B·S, or with a data-parallel
    ``group`` (x holds this rank's rows, rank-major) from the group's,
    with slots in global token order and the balance loss of the whole
    batch (see the module docstring)."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    E = params["w_gate"].shape[0]
    group = _spread(group)
    topw, topi, aux = _route(xf, params["w_router"], top_k, renormalize, group=group)
    before, n_tokens = (None, B * S) if group is None else _lower_ranks_counts(topi, E, group)
    C = moe_capacity(n_tokens, top_k, E, capacity_factor, min_capacity)
    out = _dispatch_compute(xf, topw.to(xf.dtype), topi, params["w_gate"], params["w_up"],
                            params["w_down"], C, before)
    return out.reshape(B, S, D), aux


def dropped_assignments(params: Mapping[str, torch.Tensor], x: torch.Tensor, *, top_k: int,
                        capacity_factor: float = 1.25, min_capacity: int = 4,
                        renormalize: bool = True) -> Tuple[torch.Tensor, int]:
    """(assignments that :func:`moe_apply_local` drops for ``x`` (B, S, D),
    a 0-d int64 tensor on x's device; assignments B·S·k): for readings."""
    B, S, D = x.shape
    _, topi, _ = _route(x.reshape(B * S, D), params["w_router"], top_k, renormalize)
    E = params["w_gate"].shape[0]
    C = moe_capacity(B * S, top_k, E, capacity_factor, min_capacity)
    return (~_plan(topi, C).valid).sum(), B * S * top_k


def moe_reference(params: Mapping[str, torch.Tensor], x: torch.Tensor, *, top_k: int,
                  renormalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact dense oracle: every expert computed for every token, masked by
    the router's top-k choice.  O(E) cost — tests only."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    topw, topi, aux = _route(xf, params["w_router"], top_k, renormalize)
    out = torch.zeros_like(xf)
    for e in range(params["w_gate"].shape[0]):
        w_e = torch.where(topi == e, topw, 0.0).sum(dim=1)
        h = F.silu(xf @ params["w_gate"][e]) * (xf @ params["w_up"][e])
        out = out + w_e[:, None].to(xf.dtype) * (h @ params["w_down"][e])
    return out.reshape(B, S, D), aux


class MoE(nn.Module):
    """The routed experts' parameters; ``forward`` is
    :func:`moe_apply_local` on them."""

    def __init__(self, d_model: int, d_ff_expert: int, n_experts: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()

        def w(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.w_router = w(d_model, n_experts, dt=torch.float32)   # fp32, as the reference
        self.w_gate = w(n_experts, d_model, d_ff_expert)
        self.w_up = w(n_experts, d_model, d_ff_expert)
        self.w_down = w(n_experts, d_ff_expert, d_model)

    def init_weights(self, generator: torch.Generator) -> None:
        """The shapes and scales of ``repro.layers.moe.init_moe``."""
        d_model, d_ff = self.w_gate.shape[1:]
        for p in (self.w_router, self.w_gate, self.w_up):
            init_normal_(p, 1.0 / math.sqrt(d_model), generator)
        init_normal_(self.w_down, 1.0 / math.sqrt(d_ff), generator)

    def params(self) -> dict:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def forward(self, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
                renormalize: bool = True, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_apply_local(self.params(), x, top_k=top_k, capacity_factor=capacity_factor,
                               renormalize=renormalize, group=group)
