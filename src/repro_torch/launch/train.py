"""Training driver: the port of ``repro/launch/train.py``.

The paper's technique is the orchestration layer: data prefetch and
checkpoint saves run as tasks on the port's runtime (``data_prefetch``,
``checkpoint_save``), so host I/O overlaps the training step on the card,
as the paper hides I/O behind long compute tasks.  The step itself is
:func:`repro_torch.distributed.steps.make_train_step`: the model's norms,
cache-free attention and recurrent scans run the hand-written kernels on
the card, differentiated through their plain versions
(``kernels/ops.py``).  With ``mesh`` (a ``(data, model)`` DeviceMesh of
:func:`repro_torch.launch.mesh.make_local_mesh`, one process per rank,
each calling ``train_loop``), the parameters and the optimizer moments
are sharded over it, every rank draws the same global batch and the step
takes its rows (``distributed/steps.py``).

Fault tolerance: checkpoint saves are retried tasks; ``--restore``
resumes from the newest checkpoint, onto whatever mesh this launch has
(elastic resharding: a sharded save gathers full leaves and the first
rank writes them, and a restore places each leaf on this launch's mesh).
Batches are deterministic in (seed, step), so a restored run replays the
exact data stream.  Checkpoints are in the reference's format, do not
depend on the mesh, and restore in either package.

What differs from the JAX driver: the model starts from
``init_params(cfg, seed)`` drawn by a torch generator (pass ``model`` to
start from other weights, e.g. the JAX tree through
``convert.load_jax_params``); the parameters and the optimizer state are
updated in place; the result also carries ``step_seconds``, each step's
wall time ending in a device sync, and ``aux``, each step's MoE balance
loss (the step's metric; zeros without a ``moe`` block), which the log
line shows for a model with one.

Usage (on the card; ``--device cpu`` runs the kernels' plain versions):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 10 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --reduced \\
        --device cpu --steps 20 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-moe-16b --reduced \\
        --device cpu --steps 5 --batch 4 --seq 32
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..algorithms.common import resolve_device
from ..checkpoint.manager import CheckpointManager
from ..configs import ARCH_IDS, get_config
from ..core import api
from ..data.pipeline import DataPipeline
from ..distributed.steps import (ShardedState, checkpoint_shardings, full_tensor,
                                 gather_params, make_train_step, shard_state)
from ..models.convert import flat_jax_params, jax_layout, load_jax_params, port_names, to_jax_tree
from ..models.lm import LM, LMConfig, init_params
from ..optim.adamw import AdamWState, adamw, cosine_schedule


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def state_tree(model: LM, opt_state) -> Dict[str, Any]:
    """``{"params", "opt"}`` as the reference checkpoints them: the JAX
    trees of the parameters and the moments, host copies.  Of a
    :class:`ShardedState`, its full tensors, gathered on every rank (a
    collective over the mesh)."""
    if isinstance(opt_state, ShardedState):
        def full(named):
            return to_jax_tree(model, {n: full_tensor(t) for n, t in named.items()})
        opt = opt_state.opt
        return {"params": full(opt_state.params),
                "opt": AdamWState(opt.count.numpy().copy(), full(opt.mu), full(opt.nu))}
    return {"params": to_jax_tree(model),
            "opt": AdamWState(opt_state.count.numpy().copy(), to_jax_tree(model, opt_state.mu),
                              to_jax_tree(model, opt_state.nu))}


@torch.no_grad()
def load_state(model: LM, opt_state: AdamWState, state: Dict[str, Any]) -> None:
    """Copy a restored :func:`state_tree` into the model and the optimizer
    state, in place."""
    load_jax_params(model, state["params"])
    opt = state["opt"]
    for tree, dst in ((opt.mu, opt_state.mu), (opt.nu, opt_state.nu)):
        for name, t in flat_jax_params(model, tree).items():
            dst[name].copy_(t)
    opt_state.count.copy_(opt.count)


@torch.no_grad()
def load_sharded_state(model: LM, state: ShardedState, restored: Dict[str, Any]) -> None:
    """Copy a checkpoint restored with :func:`checkpoint_shardings` (its
    leaves DTensors on ``state``'s mesh) into ``state``'s shards, in
    place."""
    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    opt = restored["opt"]
    for tree, dst in ((restored["params"], state.params), (opt.mu, state.opt.mu),
                      (opt.nu, state.opt.nu)):
        for name, t in port_names(model.cfg, tree, take=lambda leaf, s: local(leaf)[s]).items():
            local(dst[name]).copy_(local(t))
    state.opt.count.copy_(opt.count)


def _restore_target(model: LM) -> Dict[str, Any]:
    """A tree of :func:`state_tree`'s structure whose leaves are
    placeholders: a restore's target (it reads the names alone)."""
    tree = jax_layout(model.cfg, {n: 0 for n, _ in model.named_parameters()},
                      stack=lambda _: 0)
    return {"params": tree, "opt": AdamWState(0, tree, tree)}


def train_loop(
    cfg: LMConfig,
    *,
    steps: int = 20,
    batch: int = 8,
    seq: int = 64,
    lr: float = 3e-4,
    warmup: int = 10,
    microbatches: int = 1,
    workers: int = 4,
    seed: int = 0,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    restore: bool = False,
    grad_compress: Optional[str] = None,
    log_every: int = 1,
    manage_runtime: bool = True,
    device=None,
    model: Optional[LM] = None,
    mesh=None,
) -> Dict[str, Any]:
    """Returns {"losses": [...], "steps_done", "restored_from",
    "tokens_per_s", "runtime_stats", "step_seconds", "aux": [...]}.
    ``device=None`` means CUDA (raises without a card); ``model`` (on that
    device) is trained in place, else ``init_params(cfg, seed)``.  With
    ``mesh`` (on the same device type) every rank of it calls this with
    the same arguments; the parameters are stored sharded, and ``model``
    holds the full trained parameters at the end."""
    dev = resolve_device(device)
    if model is not None and model.device.type != dev.type:
        raise ValueError(f"the model is on {model.device}, training on {dev}")
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type}, training on {dev}")
    if manage_runtime:
        api.runtime_start(n_workers=workers, policy="fifo", max_retries=2)
    try:
        opt = adamw(cosine_schedule(lr, warmup, steps), weight_decay=0.01)
        pipeline = DataPipeline(cfg, batch, seq, seed=seed, prefetch_depth=2)
        model = model if model is not None else init_params(cfg, seed, device=dev)
        if mesh is None:
            opt_state = opt.init(dict(model.named_parameters()))
        else:
            opt_state = shard_state(model, opt, mesh)
        writes = mesh is None or dist.get_rank() == 0

        def save(step: int, blocking: bool) -> None:
            tree = state_tree(model, opt_state)        # every rank: a gather over the mesh
            if writes:
                manager.save(tree, step, blocking=blocking)

        manager = None
        start_step = 0
        restored_from = None
        if ckpt_dir:
            manager = CheckpointManager(ckpt_dir, keep=3, use_runtime=True)
            if restore and manager.latest_step() is not None:
                if mesh is None:
                    state, start_step = manager.restore(_restore_target(model))
                    load_state(model, opt_state, state)
                else:
                    state, start_step = manager.restore(
                        _restore_target(model), shardings=checkpoint_shardings(model, mesh))
                    load_sharded_state(model, opt_state, state)
                restored_from = start_step
        sample = pipeline.get(start_step)
        train_step = make_train_step(opt, mesh=mesh, microbatches=microbatches,
                                     grad_compress=grad_compress)

        losses: List[float] = []
        auxes: List[float] = []
        step_seconds: List[float] = []
        has_moe = "moe" in cfg.block_pattern
        _sync(dev)
        t0 = time.perf_counter()
        batch_np = sample
        for step in range(start_step, steps):
            t_step = time.perf_counter()
            dev_batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
            metrics = train_step(model, opt_state, dev_batch)
            if step + 1 < steps:
                batch_np = pipeline.get(step + 1)  # prefetched task result
            loss = float(metrics["loss"])
            _sync(dev)
            step_seconds.append(time.perf_counter() - t_step)
            losses.append(loss)
            auxes.append(float(metrics["aux"]))
            if math.isnan(loss):
                raise FloatingPointError(f"loss NaN at step {step}")
            if log_every and (step % log_every == 0 or step == steps - 1):
                aux = f"aux {auxes[-1]:.4f} " if has_moe else ""
                print(f"step {step:5d} loss {loss:.4f} {aux}"
                      f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
            if manager and ckpt_every and (step + 1) % ckpt_every == 0:
                save(step + 1, blocking=False)
        wall = time.perf_counter() - t0
        if manager:
            manager.wait()
            save(steps, blocking=True)
        if mesh is not None:
            gather_params(model, opt_state)
            dist.barrier()                   # every rank sees the checkpoints written
        api.barrier()
        tokens = (steps - start_step) * batch * seq
        return {"losses": losses, "steps_done": steps - start_step,
                "restored_from": restored_from,
                "tokens_per_s": tokens / max(wall, 1e-9),
                "runtime_stats": api.current_runtime().stats(),
                "step_seconds": step_seconds, "aux": auxes}
    finally:
        if manage_runtime:
            api.runtime_stop()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--grad-compress", default=None, choices=[None, "int8", "topk"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the hand-written kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args()
    cfg = get_config(args.arch, reduced=args.reduced)
    out = train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                     lr=args.lr, microbatches=args.microbatches,
                     workers=args.workers, seed=args.seed,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     restore=args.restore, grad_compress=args.grad_compress,
                     device=args.device)
    print(json.dumps({k: v for k, v in out.items() if k not in ("losses", "aux")}, indent=1,
                     default=str))
    print(f"loss: {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()
