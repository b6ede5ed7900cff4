"""AdamW with dtype-configurable moments, a cosine learning-rate schedule
and global-norm clipping: the port of ``repro/optim/adamw.py``.

The reference is functional (optax-style, returning new trees); the
port keeps its formula, defaults and fp32 arithmetic, and updates the
parameters and the moments in place, which saves a copy of each:

    g ← g · min(1, max_norm / ‖g‖)           (cast back to g's dtype)
    m ← b1·m + (1 − b1)·g,   v ← b2·v + (1 − b2)·g²
    delta = (m / (1 − b1ᵗ)) / (√(v / (1 − b2ᵗ)) + eps) + wd·p
    p ← (p − lr(t)·delta)                    (rounded once to p's dtype)

with t the count after the increment.  Weight decay applies to every
parameter, norm scales and embeddings included, as in the reference.
``torch.optim.AdamW`` decays before the Adam step and rounds bf16
parameters twice, so it does not compute the same thing.

Parameters, gradients and moments are dicts keyed by parameter name
(``dict(model.named_parameters())``); the count is a 0-d int32 tensor
on the host, and the schedule is evaluated there in fp32, as the
reference evaluates it in fp32 on its device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch

Tensors = Mapping[str, torch.Tensor]


class AdamWState(NamedTuple):
    count: torch.Tensor              # 0-d int32, host
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclass(frozen=True)
class Optimizer:
    init: Callable      # (params) -> AdamWState
    update: Callable    # (grads, state, params) -> grad norm; params and state in place


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Callable[[Union[int, torch.Tensor]], torch.Tensor]:
    """Linear warmup to ``base_lr``, then a cosine decay to
    ``min_ratio · base_lr`` at ``total_steps``; a 0-d fp32 tensor."""
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(1.0, warmup_steps)
        prog = torch.clamp((step - warmup_steps) / max(1.0, total_steps - warmup_steps),
                           0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads scaled to a global norm of at most ``max_norm``, each in its
    own dtype; the norm before scaling, 0-d fp32)."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: (g.to(torch.float32) * scale).to(g.dtype) for n, g in grads.items()}, norm


def adamw(lr: Union[Callable, float], b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, moment_dtype: torch.dtype = torch.float32,
          max_grad_norm: Optional[float] = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: _f32(lr))

    def init(params: Tensors) -> AdamWState:
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32),
            mu={n: torch.zeros_like(p, dtype=moment_dtype) for n, p in params.items()},
            nu={n: torch.zeros_like(p, dtype=moment_dtype) for n, p in params.items()},
        )

    @torch.no_grad()
    def update(grads: Tensors, state: AdamWState, params: Tensors) -> torch.Tensor:
        """One step: updates ``params`` and ``state`` in place; returns the
        gradients' global norm before clipping (0 without clipping)."""
        gnorm = torch.zeros((), dtype=torch.float32)
        if max_grad_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        state.count.add_(1)
        t = state.count.to(torch.float32)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        step_lr = lr_fn(state.count)
        for name, p in params.items():
            gf = grads[name].to(torch.float32)
            mu = b1 * state.mu[name].to(torch.float32) + (1 - b1) * gf
            nu = b2 * state.nu[name].to(torch.float32) + (1 - b2) * gf * gf
            mhat = mu / bc1
            vhat = nu / bc2
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - step_lr * delta)
            state.mu[name].copy_(mu)
            state.nu[name].copy_(nu)
        return gnorm

    return Optimizer(init=init, update=update)
