"""qwen3-moe-235b-a22b — 128 routed experts, top-8, expert d_ff=1536,
GQA kv=4, qk-norm. [hf:Qwen/Qwen3-30B-A3B; hf]"""
import torch

from ..models.lm import LMConfig

FULL = LMConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=0, d_ff_expert=1536, vocab_size=151936, qk_norm=True,
    rope_theta=1_000_000.0,
    block_pattern=("moe",), n_experts=128, top_k=8,
    moe_capacity_factor=1.25,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat="full",
)

REDUCED = LMConfig(
    name="qwen3-moe-235b-reduced",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=0, d_ff_expert=64, vocab_size=512, qk_norm=True,
    block_pattern=("moe",), n_experts=8, top_k=2,
    moe_capacity_factor=2.0,
)
