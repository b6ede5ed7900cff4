"""granite-20b — dense llama-arch code model, MQA (GQA kv=1).
[arXiv:2405.04324; hf]"""
import torch

from ..models.lm import LMConfig

FULL = LMConfig(
    name="granite-20b",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    mlp_gated=False,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat="full",
)

REDUCED = LMConfig(
    name="granite-20b-reduced",
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=1,
    d_ff=256, vocab_size=512,
)
