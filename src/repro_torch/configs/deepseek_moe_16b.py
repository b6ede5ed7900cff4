"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed experts,
top-6, expert d_ff=1408, MHA (kv=16). [arXiv:2401.06066; hf]"""
import torch

from ..models.lm import LMConfig

FULL = LMConfig(
    name="deepseek-moe-16b",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=0, d_ff_expert=1408, vocab_size=102400,
    block_pattern=("moe",), n_experts=64, top_k=6, n_shared_experts=2,
    moe_capacity_factor=1.25,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat="full",
)

REDUCED = LMConfig(
    name="deepseek-moe-16b-reduced",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=0, d_ff_expert=64, vocab_size=512,
    block_pattern=("moe",), n_experts=8, top_k=3, n_shared_experts=2,
    moe_capacity_factor=2.0,
)
