"""internlm2-1.8b — dense GQA. [arXiv:2403.17297; hf]"""
import torch

from ..models.lm import LMConfig

FULL = LMConfig(
    name="internlm2-1.8b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92544,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat="full",
)

REDUCED = LMConfig(
    name="internlm2-1.8b-reduced",
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=4,
    d_ff=256, vocab_size=512,
)
