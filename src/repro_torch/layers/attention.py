"""Grouped-query attention with RoPE, optional qk-norm, sliding window and
KV caches (full or ring-buffer): the port of ``repro/layers/attention.py``.

Cache layout, as in the JAX layer: ``{"k": (B, Sc, K, hd), "v": ...,
"pos_map": (Sc,) int32}``; ``pos_map[slot]`` holds the absolute position
stored in that slot (``INVALID_POS`` when empty).  A full cache uses
``slot == position``, a ring cache (sliding window, ``Sc == window``)
``slot == position % Sc``.

Compute paths:

* cache-free attention from position 0 (training-style forward and
  prefill, ``cache is None and pos_offset == 0``) goes to the
  hand-written flash kernel through
  :func:`repro_torch.kernels.ops.flash_attention` — *the port's choice*:
  the JAX layer picks only between its dense and chunked jnp paths
  (``repro/layers/attention.py:216``).  The kernel's masks count from
  index 0 in q and k, which is exactly this case (``kv_pos == positions
  == arange(S)``).
* everything else — decode over a cache, ring caches, any ``pos_offset``
  — attends through ``pos_map`` with the plain PyTorch ports of
  ``_dense_attn`` and ``_chunked_attn`` (chosen as in JAX: chunked for
  more than 2048 keys or ``impl="chunked"``).

Weights keep the JAX layout ``(in, out)`` and the layer computes ``x @ w``.
Unlike the JAX layer, a decode step writes its new K/V into the given
cache tensors in place (and returns the same dict): the cache is not
copied on every step.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels import ops
from .mlp import init_normal_
from .norms import RMSNorm
from .rope import apply_rope, rope_angles

NEG_INF = -1e30
INVALID_POS = 1 << 30


def attention_axes(qk_norm: bool = False):
    """Logical axes of :class:`Attention`'s parameters (for placement)."""
    ax = {
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv_heads"),
        "wv": ("embed", "kv_heads"),
        "wo": ("heads", "embed"),
    }
    if qk_norm:
        ax["q_norm"] = {"scale": ("head_dim",)}
        ax["k_norm"] = {"scale": ("head_dim",)}
    return ax


def _mask(q_pos, kv_pos, window: Optional[int]):
    """(Sq, Skv) boolean validity: causal + optional sliding window.
    Invalid cache slots carry ``INVALID_POS`` and fail the causal test."""
    m = kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= (q_pos[:, None] - kv_pos[None, :]) < window
    return m


def _dense_attn(q, k, v, q_pos, kv_pos, window):
    """q: (B,Sq,K,G,hd); k,v: (B,Skv,K,hd) -> (B,Sq,K,G,hd) fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32), k.to(torch.float32)) * scale
    s = s.masked_fill(~_mask(q_pos, kv_pos, window), NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32))


def _chunked_attn(q, k, v, q_pos, kv_pos, window, chunk: int = 1024,
                  scores_dtype=torch.float32):
    """Streaming (online-softmax) attention over KV chunks; the running max
    and denominator stay fp32, ``scores_dtype`` stores scores and
    probabilities (bf16 halves their traffic, as in the JAX layer)."""
    B, Sq, K, G, hd = q.shape
    Skv = k.shape[1]
    chunk = min(chunk, Skv)
    scale = 1.0 / math.sqrt(hd)
    sd = scores_dtype
    qf = q.to(sd)
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    lse = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, Sq, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, Skv, chunk):
        # the ragged last chunk is padded with INVALID_POS keys, as in JAX
        k_i, v_i, pos_i = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk], kv_pos[c0:c0 + chunk]
        pad = chunk - k_i.shape[1]
        if pad:
            k_i = torch.nn.functional.pad(k_i, (0, 0, 0, 0, 0, pad))
            v_i = torch.nn.functional.pad(v_i, (0, 0, 0, 0, 0, pad))
            pos_i = torch.nn.functional.pad(pos_i, (0, pad), value=INVALID_POS)
        s = (torch.einsum("bqkgh,bskh->bkgqs", qf, k_i.to(sd)) * scale).to(sd)
        s = s.masked_fill(~_mask(q_pos, pos_i, window), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1).to(torch.float32))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s.to(torch.float32) - m_new[..., None]).to(sd)
        lse = lse * alpha + p.to(torch.float32).sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p, v_i.to(sd)).to(torch.float32)
        m = m_new
    o = acc / torch.clamp(lse, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4)  # (B,Sq,K,G,hd)


def init_kv_cache(batch: int, cache_len: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    return {
        "k": torch.zeros((batch, cache_len, n_kv_heads, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, n_kv_heads, head_dim), dtype=dtype, device=device),
        "pos_map": torch.full((cache_len,), INVALID_POS, dtype=torch.int32, device=device),
    }


def _build_cache(k, v, positions, cache_len: int, dtype) -> dict:
    """A cache from freshly computed prefill K/V (a gather of the
    slot-owning positions, no scatter)."""
    B, S, K, hd = k.shape
    if cache_len >= S:
        cache = init_kv_cache(B, cache_len, K, hd, dtype, k.device)
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        cache["pos_map"][:S] = positions
        return cache
    # ring: slot s holds the latest position p < S with p % cache_len == s
    slots = torch.arange(cache_len, device=k.device)
    owner = (S - 1) - ((S - 1 - slots) % cache_len)  # index into current block
    return {"k": k[:, owner].to(dtype), "v": v[:, owner].to(dtype),
            "pos_map": positions[owner].to(torch.int32)}


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int, head_dim: int, *,
                 qk_norm: bool = False, rope_theta: float = 10_000.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.n_heads, self.n_kv_heads, self.head_dim = n_heads, n_kv_heads, head_dim
        self.rope_theta = rope_theta

        def w(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))

        self.wq = w(d_model, n_heads * head_dim)
        self.wk = w(d_model, n_kv_heads * head_dim)
        self.wv = w(d_model, n_kv_heads * head_dim)
        self.wo = w(n_heads * head_dim, d_model)
        if qk_norm:
            self.q_norm = RMSNorm(head_dim, dtype=dtype, device=device)
            self.k_norm = RMSNorm(head_dim, dtype=dtype, device=device)
        else:
            self.q_norm = self.k_norm = None

    def init_weights(self, generator: torch.Generator) -> None:
        """The shapes and scales of ``repro.layers.attention.init_attention``."""
        s = 1.0 / math.sqrt(self.wq.shape[0])
        for w in (self.wq, self.wk, self.wv):
            init_normal_(w, s, generator)
        init_normal_(self.wo, 1.0 / math.sqrt(self.wo.shape[0]), generator)

    def forward(self, x: torch.Tensor, *, window: Optional[int] = None, pos_offset: int = 0,
                cache: Optional[dict] = None, make_cache_len: Optional[int] = None,
                cache_dtype=torch.bfloat16, impl: str = "auto", chunk: int = 1024,
                scores_dtype=torch.float32) -> Tuple[torch.Tensor, Optional[dict]]:
        """Returns (output, new_cache).

        * training: ``cache=None, make_cache_len=None`` — block-local attention.
        * prefill:  ``make_cache_len=Sc`` — same attention, plus a cache built
          from the computed K/V (ring-truncated if ``Sc < S``).
        * decode:   ``cache=...`` — new K/V written at
          ``slot = position % Sc`` (in place); attention over the whole cache.
        """
        B, S, _ = x.shape
        H, K, hd = self.n_heads, self.n_kv_heads, self.head_dim
        q = (x @ self.wq).reshape(B, S, H, hd)
        k = (x @ self.wk).reshape(B, S, K, hd)
        v = (x @ self.wv).reshape(B, S, K, hd)
        if self.q_norm is not None:
            q = self.q_norm(q)
            k = self.k_norm(k)
        positions = pos_offset + torch.arange(S, dtype=torch.int32, device=x.device)
        cos, sin = rope_angles(positions, hd, self.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        new_cache = None
        if cache is not None:
            Sc = cache["k"].shape[1]
            slots = (positions % Sc).long()
            cache["k"][:, slots] = k.to(cache["k"].dtype)
            cache["v"][:, slots] = v.to(cache["v"].dtype)
            cache["pos_map"][slots] = positions
            new_cache = cache
            k_all, v_all, kv_pos = cache["k"], cache["v"], cache["pos_map"]
        else:
            k_all, v_all, kv_pos = k, v, positions
            if make_cache_len is not None:
                new_cache = _build_cache(k, v, positions, make_cache_len, cache_dtype)

        if cache is None and pos_offset == 0:
            # (B, S, H, hd) as (B, H, S, hd) views: the kernel takes strides
            o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                    causal=True, window=window).transpose(1, 2)
        else:
            qg = q.reshape(B, S, K, H // K, hd)
            if impl == "chunked" or (impl == "auto" and k_all.shape[1] > 2048):
                o = _chunked_attn(qg, k_all, v_all, positions, kv_pos, window,
                                  chunk=chunk, scores_dtype=scores_dtype)
            else:
                o = _dense_attn(qg, k_all, v_all, positions, kv_pos, window)
        o = o.to(x.dtype).reshape(B, S, H * hd)
        return o @ self.wo, new_cache
