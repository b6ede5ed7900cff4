"""Decoder-only LM: the port of ``repro/models/lm.py``.

A model is a cycle of block types (``block_pattern``) over ``n_layers``:
``dense`` (GQA attention + MLP), ``local_attn`` (sliding-window GQA +
MLP), ``moe`` (GQA attention + routed experts, plus optional shared
experts), ``ssd`` (a Mamba-2 SSD block, attention-free) and ``rglru``
(RG-LRU temporal mixing + MLP, RecurrentGemma's recurrent block).  Each
``moe`` block adds its balance loss to the forward's ``aux``, which
:func:`loss_fn` weighs into the total.

Where the JAX model stacks the layers of each pattern period and runs
them with ``lax.scan`` (plus an unrolled tail), the port keeps one
:class:`Block` per layer in layer order in an ``nn.ModuleList`` and loops
over it in Python; caches are a list in the same order.  Parameters
keep the JAX layouts — ``(in, out)`` for every ``x @ W`` weight,
``(vocab, d_model)`` for ``embed``, ``(d_model, vocab)`` for ``lm_head``
— and the module names mirror the JAX tree's keys, so
:func:`repro_torch.models.convert.load_jax_params` copies leaves without
transposing.  The norms, the cache-free attention and the recurrent
prefill scans run the port's hand-written kernels on a CUDA card (see
``layers/norms.py``, ``layers/attention.py``, ``layers/ssd.py`` and
``layers/rglru.py``); the experts are plain PyTorch, as the reference's
are jnp (``layers/moe.py``).

:func:`param_axes` gives each parameter's logical axes, keyed by the
port's parameter names, for the sharding rules of
:mod:`repro_torch.distributed.sharding`.  A forward or :func:`loss_fn`
given a ``data_group`` (a data-parallel process group whose ranks hold
contiguous rows of one batch) computes the one-device function of the
whole batch: the MoE blocks route over the group (``layers/moe.py``) and
the loss divides by the group's mask sum.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..algorithms.common import resolve_device
from ..layers.attention import Attention, attention_axes, init_kv_cache
from ..layers.mlp import MLP, init_normal_, mlp_axes
from ..layers.moe import MoE, moe_axes
from ..layers.norms import RMSNorm, rmsnorm_axes
from ..layers.rglru import RGLRU, init_rglru_cache, rglru_axes
from ..layers.ssd import SSD, init_ssd_cache, ssd_axes
from .convert import port_names

ATTENTION_BLOCKS = ("dense", "local_attn", "moe")
BLOCK_TYPES = ATTENTION_BLOCKS + ("ssd", "rglru")
REMAT = ("none", "full", "dots")
# the matmuls whose outputs ``remat="dots"`` keeps (jax's checkpoint_dots)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots():
    return create_selective_checkpoint_contexts(_dots_policy)


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    block_pattern: Tuple[str, ...] = ("dense",)
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_renormalize: bool = True
    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # RG-LRU
    rnn_width: int = 0
    local_window: int = 2048
    # input modality: "tokens" | "embeds" (audio stub) | "prefix_embeds" (VLM stub)
    input_mode: str = "tokens"
    prefix_len: int = 0
    mlp_gated: bool = True
    # numerics / compilation
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    cache_dtype: Any = torch.bfloat16
    remat: str = "none"            # none | full | dots
    attn_impl: str = "auto"
    attn_chunk: int = 1024
    scan_layers: bool = True
    unroll_scans: bool = False
    # distribution hints (repro_torch.distributed; the expert-parallel MoE
    # and the shard_map TP blocks they steer are ROADMAP items A11.4, A11.3)
    moe_ff_shard_axis: Optional[str] = "data"
    tp_block: str = "gspmd"          # "gspmd" | "shard_map"
    attn_scores_bf16: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def layer_types(self) -> Tuple[str, ...]:
        m = len(self.block_pattern)
        return tuple(self.block_pattern[i % m] for i in range(self.n_layers))

    @property
    def n_super(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def n_tail(self) -> int:
        return self.n_layers % len(self.block_pattern)

    @property
    def is_recurrent_only(self) -> bool:
        return all(t in ("ssd", "rglru") for t in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        return all(t in ("ssd", "rglru", "local_attn") for t in self.block_pattern)


class Block(nn.Module):
    """One layer, with the JAX block's key names.  ``dense`` /
    ``local_attn``: ``x + attn(ln1(x))``, then ``+ mlp(ln2(x))``
    (``local_attn`` adds the sliding window and a ring cache of at most
    ``local_window`` slots).  ``moe``: ``x + attn(ln1(x))``, then
    ``+ moe(ln2(x))`` ``+ shared(ln2(x))`` where ``n_shared_experts > 0``
    (one MLP of ``n_shared_experts · d_ff_expert``).  ``ssd``:
    ``x + ssd(ln1(x))``.  ``rglru``: ``x + rec(ln1(x))``, then
    ``+ mlp(ln2(x))``.  The routed experts read ``cfg``'s capacity factor
    at each call."""

    def __init__(self, cfg: LMConfig, btype: str, device=None):
        super().__init__()
        self.cfg, self.btype = cfg, btype
        dt = cfg.param_dtype
        self.ln1 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        if btype in ATTENTION_BLOCKS:
            self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                  qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
                                  dtype=dt, device=device)
        elif btype == "ssd":
            self.ssd = SSD(cfg.d_model, expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                           d_state=cfg.ssm_state, conv_width=cfg.conv_width, dtype=dt,
                           device=device)
        else:
            self.rec = RGLRU(cfg.d_model, cfg.rnn_width or cfg.d_model,
                             conv_width=cfg.conv_width, dtype=dt, device=device)
        if btype == "moe":
            self.ln2 = RMSNorm(cfg.d_model, dtype=dt, device=device)
            self.moe = MoE(cfg.d_model, cfg.d_ff_expert, cfg.n_experts, dtype=dt,
                           device=device)
            if cfg.n_shared_experts:
                self.shared = MLP(cfg.d_model, cfg.n_shared_experts * cfg.d_ff_expert,
                                  dtype=dt, device=device)
        elif btype != "ssd":
            self.ln2 = RMSNorm(cfg.d_model, dtype=dt, device=device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated, dtype=dt,
                           device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        """Each sub-layer's JAX shapes and scales (the norms keep their ones)."""
        for name in ("attn", "ssd", "rec", "mlp", "moe", "shared"):
            if hasattr(self, name):
                getattr(self, name).init_weights(generator)

    def init_cache(self, batch: int, cache_len: int, device) -> dict:
        """An empty decode cache of this layer's type (the JAX shapes)."""
        return _init_block_cache(self.cfg, self.btype, batch, cache_len, device)

    def forward(self, x, *, cache, pos_offset, make_cache_len, data_group=None):
        """(x, new cache, the balance loss of a ``moe`` block or ``None``)."""
        cfg = self.cfg
        if self.btype == "ssd":
            y, new_cache = self.ssd(self.ln1(x), chunk=cfg.ssm_chunk, cache=cache,
                                    make_cache=make_cache_len is not None)
            return x + y, new_cache, None
        if self.btype == "rglru":
            y, new_cache = self.rec(self.ln1(x), cache=cache,
                                    make_cache=make_cache_len is not None)
        else:
            window = cfg.local_window if self.btype == "local_attn" else None
            mcl = make_cache_len
            if window is not None and mcl is not None:
                mcl = min(mcl, window)
            y, new_cache = self.attn(
                self.ln1(x), window=window, pos_offset=pos_offset, cache=cache,
                make_cache_len=mcl, cache_dtype=cfg.cache_dtype, impl=cfg.attn_impl,
                chunk=cfg.attn_chunk,
                scores_dtype=torch.bfloat16 if cfg.attn_scores_bf16 else torch.float32)
        x = x + y
        if self.btype != "moe":
            return x + self.mlp(self.ln2(x)), new_cache, None
        h = self.ln2(x)
        y, aux = self.moe(h, top_k=cfg.top_k, capacity_factor=cfg.moe_capacity_factor,
                          renormalize=cfg.moe_renormalize, group=data_group)
        if cfg.n_shared_experts:
            y = y + self.shared(h)
        return x + y, new_cache, aux


def _init_block_cache(cfg: LMConfig, btype: str, batch: int, cache_len: int, device) -> dict:
    if btype == "ssd":
        return init_ssd_cache(batch, cfg.d_model, expand=cfg.ssm_expand,
                              headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
                              conv_width=cfg.conv_width, dtype=cfg.compute_dtype, device=device)
    if btype == "rglru":
        return init_rglru_cache(batch, cfg.rnn_width or cfg.d_model, conv_width=cfg.conv_width,
                                dtype=cfg.compute_dtype, device=device)
    if btype == "local_attn":
        cache_len = min(cache_len, cfg.local_window)
    return init_kv_cache(batch, cache_len, cfg.n_kv_heads, cfg.hd, cfg.cache_dtype, device)


def init_caches(cfg: LMConfig, batch: int, cache_len: int, device) -> List[dict]:
    """Empty decode caches of ``cfg``, one per layer in layer order, on
    ``device`` (``"meta"`` for shapes alone): what :meth:`LM.init_caches`
    gives, without a model."""
    return [_init_block_cache(cfg, t, batch, cache_len, device) for t in cfg.layer_types]


def _block_axes(cfg: LMConfig, btype: str) -> Dict:
    if btype in ("dense", "local_attn"):
        return {"ln1": rmsnorm_axes(), "attn": attention_axes(cfg.qk_norm),
                "ln2": rmsnorm_axes(), "mlp": mlp_axes(cfg.mlp_gated)}
    if btype == "moe":
        ax = {"ln1": rmsnorm_axes(), "attn": attention_axes(cfg.qk_norm),
              "ln2": rmsnorm_axes(), "moe": moe_axes()}
        if cfg.n_shared_experts:
            ax["shared"] = mlp_axes()
        return ax
    if btype == "ssd":
        return {"ln1": rmsnorm_axes(), "ssd": ssd_axes()}
    if btype == "rglru":
        return {"ln1": rmsnorm_axes(), "rec": rglru_axes(),
                "ln2": rmsnorm_axes(), "mlp": mlp_axes(cfg.mlp_gated)}
    raise ValueError(btype)


def _super_axes(cfg: LMConfig) -> Dict:
    return {f"b{i}": _block_axes(cfg, t) for i, t in enumerate(cfg.block_pattern)}


def param_axes(cfg: LMConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Each parameter's logical axis names (a tuple, one per dim), keyed
    by the port's parameter names (``LM.named_parameters()``).  The
    reference's tree, mapped by :func:`~repro_torch.models.convert.port_names`;
    where its scan groups carry a leading ``"layers"`` axis, each of the
    port's blocks is one layer, so that entry drops."""
    ax: Dict[str, Any] = {}
    if cfg.input_mode in ("tokens", "prefix_embeds"):
        ax["embed"] = ("vocab", "embed")
    if cfg.n_super > 0:
        ax["scan"] = _super_axes(cfg)
    tail_types = cfg.layer_types[cfg.n_super * len(cfg.block_pattern):]
    if tail_types:
        ax["tail"] = [_block_axes(cfg, t) for t in tail_types]
    ax["final_norm"] = rmsnorm_axes()
    if not cfg.tie_embeddings:
        ax["lm_head"] = ("embed", "vocab")
    return port_names(cfg, ax, take=lambda axes, s: axes)


class LM(nn.Module):
    """The model's parameters and forward pass.  Parameters are allocated
    uninitialised on ``device`` (``None``: CUDA, raising without a card):
    fill them with :func:`init_params` or
    :func:`repro_torch.models.convert.load_jax_params`."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        for t in set(cfg.block_pattern):
            if t not in BLOCK_TYPES:
                raise ValueError(f"unknown block type {t}")
        device = resolve_device(device)
        self.cfg = cfg
        dt = cfg.param_dtype
        self.embed = (nn.Parameter(torch.empty((cfg.vocab_size, cfg.d_model), dtype=dt,
                                               device=device))
                      if cfg.input_mode in ("tokens", "prefix_embeds") else None)
        self.blocks = nn.ModuleList(Block(cfg, t, device) for t in cfg.layer_types)
        self.final_norm = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Parameter(torch.empty((cfg.d_model, cfg.vocab_size), dtype=dt,
                                                 device=device)))

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    def init_caches(self, batch: int, cache_len: int) -> List[dict]:
        """Empty decode caches, one per layer in layer order: KV caches
        (``dense`` and ``moe``; ring caches of ``local_window`` slots for
        ``local_attn``), SSD and RG-LRU states with their conv histories."""
        return init_caches(self.cfg, batch, cache_len, self.device)

    def embed_inputs(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        if cfg.input_mode == "tokens":
            x = self.embed[batch["tokens"].long()]
        elif cfg.input_mode == "embeds":
            x = batch["embeds"]
        elif cfg.input_mode == "prefix_embeds":
            parts = []
            if "prefix_embeds" in batch:
                parts.append(batch["prefix_embeds"].to(cfg.compute_dtype))
            if "tokens" in batch:
                parts.append(self.embed[batch["tokens"].long()])
            x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        else:
            raise ValueError(cfg.input_mode)
        return x.to(cfg.compute_dtype)

    def forward(self, batch: Dict[str, torch.Tensor], caches: Optional[List[dict]] = None,
                pos_offset: int = 0, make_cache_len: Optional[int] = None,
                last_only: bool = False, remat: Optional[str] = None,
                return_aux: bool = False, data_group=None) -> Tuple:
        """Returns (logits fp32 (B, S, V), new caches or None), and with
        ``return_aux=True`` also the summed balance loss of the ``moe``
        blocks (0-d fp32; zero without one), as the reference's triple.
        With ``caches`` (decode) each attention layer's new K/V is written
        into its cache in place; the recurrent layers return new states.
        ``last_only=True`` computes logits for the final position only
        (prefill: no (B, S, V) tensor).

        ``remat`` (``None``: ``cfg.remat``) is the reference's
        rematerialisation of its scan body, here per block, in a
        cache-free forward under grad mode: ``"full"`` checkpoints each
        block (its forward, kernels included, runs again in the
        backward), ``"dots"`` keeps the matmul outputs and recomputes the
        rest (``checkpoint_dots``), ``"none"`` keeps everything.  It
        changes memory, not the numbers.  Serving passes ``"none"``, as
        the reference's prefill and decode steps do.

        ``data_group``: ``batch`` holds this rank's rows of a batch split
        over the group, and the MoE blocks route over the whole batch
        (see the module docstring)."""
        remat = self.cfg.remat if remat is None else remat
        if remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
        if caches is not None or make_cache_len is not None or not torch.is_grad_enabled():
            remat = "none"
        x = self.embed_inputs(batch)
        new_caches = []
        aux_total = None
        for i, blk in enumerate(self.blocks):
            cache = caches[i] if caches is not None else None
            if remat == "none":
                x, nc, aux = blk(x, cache=cache, pos_offset=pos_offset,
                                 make_cache_len=make_cache_len, data_group=data_group)
            else:
                x, nc, aux = checkpoint(
                    blk, x, cache=None, pos_offset=pos_offset, make_cache_len=None,
                    data_group=data_group, use_reentrant=False,
                    **({"context_fn": _save_dots} if remat == "dots" else {}))
            new_caches.append(nc)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        if last_only:
            x = x[:, -1:]
        x = self.final_norm(x)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        logits = (x @ head.to(x.dtype)).to(torch.float32)
        new_caches = new_caches if any(c is not None for c in new_caches) else None
        if not return_aux:
            return logits, new_caches
        if aux_total is None:
            aux_total = torch.zeros((), dtype=torch.float32, device=logits.device)
        return logits, new_caches, aux_total


@torch.no_grad()
def init_params(cfg: LMConfig, seed: int = 0, device=None) -> LM:
    """A model with random weights of the shapes and scales of
    ``repro.models.lm.init_params``: normal · 0.02 embeddings and head,
    normal / √fan-in projections, unit norm scales, the recurrent layers'
    constants and conv scales (see their ``init_weights``), on ``device``
    (``None``: CUDA, raising without a card).  The numbers come from a
    ``torch.Generator`` on that device seeded with ``seed``; they cannot
    match ``jax.random`` (load those with ``convert``)."""
    model = LM(cfg, device=device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    if model.embed is not None:
        init_normal_(model.embed, 0.02, gen)
    for blk in model.blocks:
        blk.init_weights(gen)
    if model.lm_head is not None:
        init_normal_(model.lm_head, 0.02, gen)
    return model


def loss_fn(model: LM, batch: Dict[str, torch.Tensor], *, aux_weight: float = 0.01,
            remat: Optional[str] = None, data_group=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked next-token cross entropy, as ``repro.models.lm.loss_fn``:
    ``batch`` carries ``targets`` (B, S) and ``loss_mask`` (B, S) aligned
    with the model's output positions.  Returns ``(total, {"loss", "aux",
    "tokens"})`` with ``total = loss + aux_weight · aux``; ``aux`` is the
    summed balance loss of the ``moe`` blocks (a 0-d zero without one).

    With a ``data_group`` of R ranks, ``batch`` is this rank's rows: the
    denominator is the group's mask sum (all-reduced before dividing), the
    metrics are the whole batch's, and ``total`` is this rank's share —
    its rows' cross entropy over that denominator plus ``aux_weight ·
    aux / R`` — so that the gradients summed over the group are the
    whole batch's."""
    logits, _, aux = model(batch, remat=remat, return_aux=True, data_group=data_group)
    mask = batch["loss_mask"].to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["targets"].long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    if data_group is None:
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = nll.sum() / denom
        return loss + aux_weight * aux, {"loss": loss, "aux": aux, "tokens": mask.sum()}
    tokens = mask.sum()
    dist.all_reduce(tokens, group=data_group)
    share = nll.sum() / torch.clamp(tokens, min=1.0)
    loss = share.detach().clone()
    dist.all_reduce(loss, group=data_group)
    total = share + aux_weight * aux / dist.get_world_size(data_group)
    return total, {"loss": loss, "aux": aux, "tokens": tokens}
