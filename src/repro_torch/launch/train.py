"""Training driver: the port of ``repro/launch/train.py``.

The paper's technique is the orchestration layer: data prefetch and
checkpoint saves run as tasks on the port's runtime (``data_prefetch``,
``checkpoint_save``), so host I/O overlaps the training step on the card,
as the paper hides I/O behind long compute tasks.  The step itself is
:func:`repro_torch.distributed.steps.make_train_step` on one device: the
model's norms, cache-free attention and recurrent scans run the
hand-written kernels on the card, differentiated through their plain
versions (``kernels/ops.py``).

Fault tolerance: checkpoint saves are retried tasks; ``--restore``
resumes from the newest checkpoint.  Batches are deterministic in (seed,
step), so a restored run replays the exact data stream.  Checkpoints are
in the reference's format and restore in either package.

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

from ..algorithms.common import resolve_device
from ..checkpoint.manager import CheckpointManager
from ..configs import ARCH_IDS, get_config
from ..core import api
from ..data.pipeline import DataPipeline
from ..distributed.steps import make_train_step
from ..models.convert import flat_jax_params, load_jax_params, to_jax_tree
from ..models.lm import LM, LMConfig, init_params
from ..optim.adamw import AdamWState, adamw, cosine_schedule


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def state_tree(model: LM, opt_state: AdamWState) -> Dict[str, Any]:
    """``{"params", "opt"}`` as the reference checkpoints them: the JAX
    trees of the parameters and the moments, host copies."""
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
) -> Dict[str, Any]:
    """Returns {"losses": [...], "steps_done", "restored_from",
    "tokens_per_s", "runtime_stats", "step_seconds", "aux": [...]}.
    ``device=None`` means CUDA (raises without a card); ``model`` (on that
    device) is trained in place, else ``init_params(cfg, seed)``."""
    dev = resolve_device(device)
    if model is not None and model.device.type != dev.type:
        raise ValueError(f"the model is on {model.device}, training on {dev}")
    if manage_runtime:
        api.runtime_start(n_workers=workers, policy="fifo", max_retries=2)
    try:
        opt = adamw(cosine_schedule(lr, warmup, steps), weight_decay=0.01)
        pipeline = DataPipeline(cfg, batch, seq, seed=seed, prefetch_depth=2)
        model = model if model is not None else init_params(cfg, seed, device=dev)
        opt_state = opt.init(dict(model.named_parameters()))

        manager = None
        start_step = 0
        restored_from = None
        if ckpt_dir:
            manager = CheckpointManager(ckpt_dir, keep=3, use_runtime=True)
            if restore and manager.latest_step() is not None:
                state, start_step = manager.restore(state_tree(model, opt_state))
                load_state(model, opt_state, state)
                restored_from = start_step
        sample = pipeline.get(start_step)
        train_step = make_train_step(opt, microbatches=microbatches,
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
                manager.save(state_tree(model, opt_state), step + 1, blocking=False)
        wall = time.perf_counter() - t0
        if manager:
            manager.wait()
            manager.save(state_tree(model, opt_state), steps)
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
