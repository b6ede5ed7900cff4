"""The training step: the port of ``repro/distributed/steps.py``'s
``make_train_step``, at world size 1.

The reference builds a pjit step with sharding trees and a
sharding-aware microbatch split; here one device holds the model, so the
step keeps the reference's path without them (the mesh, the sharding
rules and the prefill / decode steps wait for the multi-device layer,
ROADMAP item A11):

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
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models.lm import LM, loss_fn
from ..optim.adamw import AdamWState, Optimizer
from ..optim.compress import compressed_gradients


def _grads(model: LM, batch: Dict[str, torch.Tensor]):
    """(metrics of ``loss_fn``, {name: gradient}) of one forward and
    backward; parameters that get no gradient get zeros, as JAX's
    ``value_and_grad`` gives them."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    total, metrics = loss_fn(model, batch)
    total.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    for p in params.values():
        p.grad = None
    return metrics, grads


def make_train_step(optimizer: Optimizer, *, microbatches: int = 1,
                    grad_compress: Optional[str] = None) -> Callable:
    """``train_step(model, opt_state, batch) -> metrics``: one optimizer
    step on ``batch`` (tensors on the model's device), updating the
    model's parameters and ``opt_state`` in place.  ``metrics`` holds
    ``loss``, ``aux`` (the ``moe`` blocks' balance loss, weighed into the
    gradients by ``loss_fn``; zero without one) and ``grad_norm`` (0-d
    tensors; ``tokens`` too on the single-batch path).  The reference's
    ``cfg`` and ``mesh`` arguments are not taken: the model carries its
    config."""

    def train_step(model: LM, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        if microbatches == 1:
            metrics, grads = _grads(model, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            mb = B // microbatches
            if mb * microbatches != B:
                raise ValueError(f"batch {B} not divisible by {microbatches} microbatches")
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for n, p in model.named_parameters()}
            lsum = asum = 0.0
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                m, g = _grads(model, part)
                for n, gi in g.items():
                    gsum[n] += gi.to(torch.float32)
                lsum = lsum + m["loss"].detach()
                asum = asum + m["aux"].detach()
            grads = {n: g / microbatches for n, g in gsum.items()}
            metrics = {"loss": lsum / microbatches, "aux": asum / microbatches}
        if grad_compress and grad_compress != "none":
            grads, _ = compressed_gradients(grads, None, codec=grad_compress)
        gnorm = optimizer.update(grads, opt_state, dict(model.named_parameters()))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        return metrics

    return train_step
