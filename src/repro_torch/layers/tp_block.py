"""Tensor-parallel transformer sublayers: the port of
``repro/layers/tp_block.py``.

Each sublayer computes ``x + sublayer(norm(x))`` on one rank's slice of
the weights, then sums the ranks' partial outputs with one all-reduce
over the mesh's ``model`` group — Megatron's layout, as the reference
pins it with ``shard_map``:

* ``wq``, ``w_up``, ``w_gate``, ``w_x`` and the RG-LRU's per-channel
  vectors (``conv_w`` / ``conv_b``, ``lam``, ``w_r``, ``b_r``, ``w_i``,
  ``b_i``) are split by columns, ``wo``, ``w_down`` and ``w_out`` by
  rows;
* K/V shard with their q-head groups where ``K % tp == 0 and K >= tp``;
  otherwise every rank computes all K heads (MQA, or fewer K heads than
  ranks) and each local q head gathers its kv group
  ``(rank·H_l + j) // G``;
* one all-reduce per sublayer (the out-projection's), nothing else.

The slices are cut from the model's whole parameters: the port's steps
gather every parameter onto each rank before compute
(``distributed/steps.py``), so here the split is of compute, not of
storage.  A rank's gradient of a sliced weight is therefore nonzero on
its slice only, and the norm scale inside a sublayer (and replicated
K/V, and the q/k norms) gets a partial gradient on each rank: the step
sums those over ``model`` (:func:`repro_torch.models.lm.partial_over_model`
names them).

The all-reduces are Megatron's conjugate pair, as autograd Functions of
the port: :func:`copy_to_group` (*f*, at the sublayer's input: identity
forward, the sum of x's cotangent over the group backward) and
:func:`sum_over_group` (*g*, at the out-projection: the sum forward,
identity backward).  ``torch.distributed.nn.functional.all_reduce``
would be wrong for *g*: its backward all-reduces again, which counts the
replicated downstream gradient ``tp`` times.

Compute uses the port's ops, so on a CUDA card the sublayers launch the
hand-written kernels — *the port's choice*: the norms run ``rmsnorm``,
attention from position 0 runs ``flash_attention`` with the rank's
``H_l`` heads (as ``layers/attention.py`` calls it) and the RG-LRU runs
``rglru_scan`` on its ``R/tp``-wide slice (as ``layers/rglru.py`` calls
it).  The reference's TP attention is jnp ``_dense_attn`` /
``_chunked_attn`` (``repro/layers/tp_block.py:95-100``); the port uses
those plain paths only at a nonzero ``pos_offset``, as its attention
layer does.

Training path only (no KV cache): prefill and decode stay on the
replicated layers, as in the reference.  The sublayers take the module
of the plain layer (``RMSNorm``, ``Attention``, ``MLP``, ``RGLRU``) and a
process group over the mesh's ``model`` axis
(``mesh.get_group("model")``); the rank is the caller's rank in it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels import ops
from .attention import Attention, _chunked_attn, _dense_attn
from .mlp import MLP
from .norms import RMSNorm
from .rglru import RGLRU, causal_conv, rglru_gates
from .rope import apply_rope, rope_angles


class _SumOver(torch.autograd.Function):
    """Megatron's *g*: the sum over ``group`` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    """Megatron's *f*: identity forward, the sum of the cotangent over
    ``group`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' partial ``x`` summed over ``group``; its gradient passes
    through unchanged (each rank's partial gets the whole cotangent)."""
    return _SumOver.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (the same on every rank of ``group``) entering rank-local
    compute: its gradient is summed over the group."""
    return _CopyTo.apply(x, group)


def rank_slice(group, n: int, what: str) -> Tuple[slice, int]:
    """(this rank's slice of ``n`` items split evenly over ``group``, the
    group's size); ``n`` must divide."""
    tp, rank = dist.get_world_size(group), dist.get_rank(group)
    if n % tp:
        raise ValueError(f"{n} {what} do not divide over {tp} model ranks")
    per = n // tp
    return slice(rank * per, (rank + 1) * per), tp


def tp_attn_sublayer(ln: RMSNorm, attn: Attention, x: torch.Tensor, *, cfg, group,
                     window: Optional[int] = None, pos_offset: int = 0) -> torch.Tensor:
    """``x + Wo·Attn(ln(x))`` over the ranks of ``group``: x (B, S, D) is
    the same on every rank; this rank computes its ``H/tp`` q heads."""
    H, K, hd = attn.n_heads, attn.n_kv_heads, attn.head_dim
    heads, tp = rank_slice(group, H, "heads")
    H_l = H // tp
    shard_kv = K % tp == 0 and K >= tp
    q_cols = slice(heads.start * hd, heads.stop * hd)
    K_l = K // tp if shard_kv else K
    rank = heads.start // H_l
    kv_cols = slice(rank * K_l * hd, (rank + 1) * K_l * hd) if shard_kv else slice(None)
    B, S, _ = x.shape
    h = ln(copy_to_group(x, group))
    q = (h @ attn.wq[:, q_cols]).reshape(B, S, H_l, hd)
    k = (h @ attn.wk[:, kv_cols]).reshape(B, S, K_l, hd)
    v = (h @ attn.wv[:, kv_cols]).reshape(B, S, K_l, hd)
    if attn.q_norm is not None:
        q = attn.q_norm(q)
        k = attn.k_norm(k)
    positions = pos_offset + torch.arange(S, dtype=torch.int32, device=x.device)
    cos, sin = rope_angles(positions, hd, attn.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if not shard_kv:
        # replicated K/V: the local q heads are a contiguous global slice;
        # each gathers its kv group (global head // G)
        gidx = torch.arange(heads.start, heads.stop, device=x.device) // (H // K)
        k, v, K_l = k[:, :, gidx], v[:, :, gidx], H_l
    if pos_offset == 0:
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                causal=True, window=window).transpose(1, 2)
    else:
        qg = q.reshape(B, S, K_l, H_l // K_l, hd)
        if S > 2048 or cfg.attn_impl == "chunked":
            sd = torch.bfloat16 if cfg.attn_scores_bf16 else torch.float32
            o = _chunked_attn(qg, k, v, positions, positions, window, chunk=cfg.attn_chunk,
                              scores_dtype=sd)
        else:
            o = _dense_attn(qg, k, v, positions, positions, window)
    o = o.to(x.dtype).reshape(B, S, H_l * hd)
    return x + sum_over_group(o @ attn.wo[q_cols], group)


def tp_mlp_sublayer(ln: RMSNorm, mlp: MLP, x: torch.Tensor, *, group) -> torch.Tensor:
    """``x + W_down·act(W_up·ln(x))`` over the ranks of ``group``, d_ff
    split evenly."""
    cols, _ = rank_slice(group, mlp.w_up.shape[1], "d_ff columns")
    h = ln(copy_to_group(x, group))
    if mlp.w_gate is not None:
        a = F.silu(h @ mlp.w_gate[:, cols]) * (h @ mlp.w_up[:, cols])
    else:
        a = F.gelu(h @ mlp.w_up[:, cols], approximate="tanh")   # jax.nn.gelu's default
    return x + sum_over_group(a @ mlp.w_down[cols], group)


def tp_rglru_sublayer(ln: RMSNorm, rec: RGLRU, x: torch.Tensor, *, group) -> torch.Tensor:
    """``x + RG-LRU-block(ln(x))`` over the ranks of ``group``: the rnn
    width R split evenly; every recurrence and gate op is elementwise over
    R, so the only communication is the out-projection's sum."""
    c, _ = rank_slice(group, rec.w_x.shape[1], "rnn channels")
    h = ln(copy_to_group(x, group))
    u = h @ rec.w_x[:, c]
    gate = F.gelu(h @ rec.w_gate[:, c], approximate="tanh")
    u = causal_conv(u, rec.conv_w[:, c], rec.conv_b[c])
    log_a, b = rglru_gates(u, rec.lam[c], rec.w_r[c], rec.b_r[c], rec.w_i[c], rec.b_i[c])
    y, _ = ops.rglru_scan(log_a, b)
    return x + sum_over_group((y.to(u.dtype) * gate) @ rec.w_out[c], group)
