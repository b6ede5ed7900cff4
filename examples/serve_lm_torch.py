"""Batched serving on the PyTorch port — the twin of
``examples/serve_lm.py``: prefill, then greedy decode over KV caches or
recurrent states, with request pre- and post-processing as runtime
tasks, on the card (the norms, the prefill's attention and the
recurrent scans in the hand-written kernels).

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--arch deepseek-moe-16b]
      [--device cpu]
      (always the --reduced config, so that it runs on the CPU in seconds;
      the default device is the CUDA card)
"""
import argparse

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.serve import serve_batch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    cfg = get_config(args.arch, reduced=True)
    out = serve_batch(cfg, batch=args.requests, prompt_len=args.prompt_len,
                      gen_len=args.gen_len, device=args.device)
    print(f"arch={args.arch} (reduced) on {args.device}")
    print(f"generated token matrix {out['tokens'].shape}:")
    print(out["tokens"])
    print(f"prefill {out['prefill_s']*1e3:.0f} ms, "
          f"decode {out['decode_tokens_per_s']:.1f} tokens/s")


if __name__ == "__main__":
    main()
