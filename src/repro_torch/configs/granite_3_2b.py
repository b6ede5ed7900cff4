"""granite-3-2b — dense GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]"""
import torch

from ..models.lm import LMConfig

FULL = LMConfig(
    name="granite-3-2b",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=49155,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat="full",
)

REDUCED = LMConfig(
    name="granite-3-2b-reduced",
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab_size=515,
)
