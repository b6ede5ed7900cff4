"""End-to-end training on the PyTorch port — the twin of
``examples/train_lm.py``: task-runtime data prefetch, the train step on
the card, checkpoints saved as runtime tasks, cosine schedule, AdamW.

Presets:
  --preset tiny   (default)  ~3M-param qwen3-style model, 30 steps
  --preset 100m              ~100M params, a few hundred steps
``--arch <id>`` trains that architecture's reduced config instead (for
example ``--arch deepseek-moe-16b``: the log then shows the MoE balance
loss).

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--preset tiny] [--device cpu]
(the default device is the CUDA card; checkpoints go to ``--ckpt-dir``,
by default a temporary directory removed at the end)
"""
import argparse
import tempfile

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.train import train_loop
from repro_torch.models.lm import LM, LMConfig

PRESETS = {
    # ~3M params: a fast sanity run
    "tiny": dict(
        cfg=LMConfig(name="tiny-lm", n_layers=4, d_model=128, n_heads=8,
                     n_kv_heads=4, d_ff=512, vocab_size=2048, qk_norm=True),
        steps=30, batch=8, seq=64, lr=1e-3,
    ),
    # ~100M params
    "100m": dict(
        cfg=LMConfig(name="lm-100m", n_layers=12, d_model=512, n_heads=8,
                     n_kv_heads=4, d_ff=2048, vocab_size=32768, qk_norm=True),
        steps=300, batch=8, seq=256, lr=6e-4,
    ),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--arch", default=None, choices=ARCH_IDS,
                    help="train this architecture's reduced config instead of the preset")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    p = PRESETS[args.preset]
    cfg = get_config(args.arch, reduced=True) if args.arch else p["cfg"]
    n_params = sum(t.numel() for t in LM(cfg, device="meta").parameters())
    print(f"model: {cfg.name}  params≈{n_params/1e6:.1f}M  on {args.device}")
    with tempfile.TemporaryDirectory() as tmp:
        out = train_loop(
            cfg, steps=args.steps or p["steps"], batch=args.batch or p["batch"],
            seq=args.seq or p["seq"], lr=p["lr"], workers=4,
            ckpt_dir=args.ckpt_dir or tmp, ckpt_every=50, log_every=10,
            device=args.device)
    print(f"\nloss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f} "
          f"({out['tokens_per_s']:.0f} tokens/s)")
    print("runtime stats:", {k: v for k, v in out["runtime_stats"].items()
                             if k in ("tasks_done", "retries", "utilization")})
    assert all(torch.isfinite(torch.tensor(out["losses"])))


if __name__ == "__main__":
    main()
