"""Batched serving driver: prefill, then greedy decode with KV caches or
recurrent states — the port of ``repro/launch/serve.py``.  It serves
every block type of :mod:`repro_torch.models.lm`: the dense-attention
families, the MoE families (deepseek-moe-16b, qwen3-moe-235b-a22b:
attention with KV caches, routed experts whose capacity comes from each
step's own token count, as in the reference), mamba2 (SSD blocks: the
prefill builds each layer's final state and conv history, decode steps
them) and recurrentgemma (RG-LRU blocks and local attention with ring
caches).

Request pre-processing (prompt synthesis, the tokenizer's stand-in) and
response post-processing run as tasks on the port's runtime; prefill and
the decode steps run on the device — the paper's split between
orchestration (the runtime) and compute (here the H100).  Prefill and
decode are the step makers of :mod:`repro_torch.distributed.steps`.  With
``mesh`` (a ``(data, model)`` DeviceMesh, one process per rank, each
calling ``serve_batch``) the prompts are sharded over the data ranks,
each rank prefills and decodes its rows with the full parameters, and
the chosen tokens are gathered after every step (the next step's input
is the global batch); compute is replicated over ``model``.

What differs from the JAX driver:

* the step timers end in ``torch.cuda.synchronize()`` on CUDA, so
  ``prefill_s`` and ``decode_s`` include the device's work (the JAX
  prefill timer stops before its device finishes);
* the decode loop keeps the chosen tokens on the device and reads them
  back once, after the last step;
* for ``input_mode == "embeds"`` the decode inputs are NumPy normals from
  ``default_rng([seed, step])`` (the JAX driver draws ``jax.random``
  numbers, which torch cannot reproduce).

Serving keeps only the chosen tokens from step to step.  Checks that need
the logits each token was chosen from get them from :func:`replay_logits`,
which runs the same steps again, fed the served tokens.

Usage (on the card; ``--device cpu`` runs the kernels' plain versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --requests 8 --prompt-len 512 --gen-len 32
    (also ``--arch mamba2-780m``, ``--arch recurrentgemma-9b`` and
    ``--arch deepseek-moe-16b``; ``qwen3-moe-235b-a22b`` does not fit one
    card: ``--reduced`` runs its reduced config)
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..algorithms.common import resolve_device
from ..configs import ARCH_IDS, get_config
from ..core import api
from ..distributed.steps import gather_rows, make_decode_step, make_prefill_step
from ..models.lm import LM, LMConfig, init_params


def make_prompts(cfg: LMConfig, n: int, prompt_len: int, seed: int) -> Dict:
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        return {"embeds": rng.standard_normal(
            (n, prompt_len, cfg.d_model)).astype(np.float32)}
    if cfg.input_mode == "prefix_embeds":
        p = min(cfg.prefix_len, prompt_len // 2)
        return {
            "prefix_embeds": rng.standard_normal((n, p, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size,
                                   (n, prompt_len - p)).astype(np.int32),
        }
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   (n, prompt_len)).astype(np.int32)}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _step_input(cfg: LMConfig, tok: torch.Tensor, step: int, seed: int) -> Dict:
    """The input of decode step ``step``: the tokens ``tok`` (batch,) chosen
    before it, or for ``input_mode == "embeds"`` fresh normals."""
    if cfg.input_mode == "embeds":
        x = np.random.default_rng([seed, step]).standard_normal((tok.shape[0], 1, cfg.d_model))
        return {"embeds": torch.from_numpy(x.astype(np.float32)).to(tok.device)}
    return {"tokens": tok[:, None]}


@torch.no_grad()
def serve_batch(cfg: LMConfig, *, batch: int = 4, prompt_len: int = 32, gen_len: int = 16,
                seed: int = 0, device=None, params: Optional[LM] = None,
                manage_runtime: bool = True, mesh=None) -> Dict[str, Any]:
    """Serve ``batch`` synthetic prompts of ``prompt_len`` and greedily
    generate ``gen_len`` tokens each.  ``device=None`` means CUDA (raises
    without a card); ``params`` is the model to serve (default: random
    weights from ``init_params(cfg, seed)`` on the device).  ``mesh``: a
    DeviceMesh on the same device type, over which the prompts are
    sharded.  Returns ``tokens`` (batch, gen_len) int32 (every rank: all
    of them), ``prefill_s``, ``decode_s`` and ``decode_tokens_per_s``."""
    dev = resolve_device(device)
    if params is not None and params.device.type != dev.type:
        raise ValueError(f"params are on {params.device}, serving on {dev}")
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type}, serving on {dev}")
    if manage_runtime:
        api.runtime_start(n_workers=2)
    try:
        cache_len = prompt_len + gen_len
        prompt_task = api.task(make_prompts, name="make_prompts")
        prompts_f = prompt_task(cfg, batch, prompt_len, seed)

        model = params if params is not None else init_params(cfg, seed, device=dev)
        prompts = api.wait_on(prompts_f)
        prefill = make_prefill_step(cache_len=cache_len, mesh=mesh)
        decode = make_decode_step(mesh=mesh)

        def choose(logits: torch.Tensor) -> torch.Tensor:
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            return tok if mesh is None else gather_rows(tok, mesh, batch)

        _sync(dev)
        t0 = time.perf_counter()
        dev_prompts = {k: torch.from_numpy(v).to(dev) for k, v in prompts.items()}
        logits, caches = prefill(model, dev_prompts)
        next_tok = choose(logits)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        generated: List[torch.Tensor] = [next_tok]
        t1 = time.perf_counter()
        pos = prompt_len
        for i in range(gen_len - 1):
            logits, caches = decode(model, _step_input(cfg, next_tok, i, seed), caches, pos)
            next_tok = choose(logits)
            generated.append(next_tok)
            pos += 1
        host_tokens = [t.cpu().numpy() for t in generated]   # waits for the last step
        _sync(dev)
        t_decode = time.perf_counter() - t1

        post_task = api.task(lambda toks: np.stack(toks, axis=1), name="postprocess")
        out_tokens = api.wait_on(post_task(host_tokens))
        return {
            "tokens": out_tokens,
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "decode_tokens_per_s": batch * (gen_len - 1) / max(t_decode, 1e-9),
        }
    finally:
        if manage_runtime:
            api.runtime_stop()


@torch.no_grad()
def replay_logits(model: LM, prompts: Dict, tokens: np.ndarray, *, seed: int = 0
                  ) -> torch.Tensor:
    """The fp32 logits ``(batch, gen_len, vocab)`` each of ``tokens`` was
    chosen from: :func:`serve_batch`'s prefill and decode steps run again on
    ``model``, over ``prompts`` (as :func:`make_prompts` gives them), each
    step fed the served token before it.  For checks: it holds
    batch x gen_len x vocab fp32 values on the model's device, which
    serving itself never keeps."""
    dev = model.device
    batch, gen_len = tokens.shape
    prompt_len = sum(v.shape[1] for v in prompts.values())
    toks = torch.from_numpy(tokens).to(dev)
    logits, caches = model({k: torch.from_numpy(v).to(dev) for k, v in prompts.items()},
                           make_cache_len=prompt_len + gen_len, last_only=True, remat="none")
    out = [logits[:, -1]]
    for i in range(gen_len - 1):
        logits, caches = model(_step_input(model.cfg, toks[:, i], i, seed), caches=caches,
                               pos_offset=prompt_len + i, remat="none")
        out.append(logits[:, -1])
    return torch.stack(out, dim=1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    args = ap.parse_args()
    cfg = get_config(args.arch, reduced=args.reduced)
    out = serve_batch(cfg, batch=args.requests, prompt_len=args.prompt_len,
                      gen_len=args.gen_len, device=args.device)
    print(json.dumps({k: (list(v.shape) if hasattr(v, "shape") else v)
                      for k, v in out.items()}, indent=1, default=str))


if __name__ == "__main__":
    main()
