"""qwen3-0.6b — dense GQA with per-head qk-norm. [hf:Qwen/Qwen3-8B; hf]"""
import torch

from ..models.lm import LMConfig

FULL = LMConfig(
    name="qwen3-0.6b",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab_size=151936, qk_norm=True,
    rope_theta=1_000_000.0,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat="full",
)

REDUCED = LMConfig(
    name="qwen3-0.6b-reduced",
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=4,
    d_ff=256, vocab_size=512, qk_norm=True,
)
