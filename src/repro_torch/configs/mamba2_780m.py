"""mamba2-780m — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
import torch

from ..models.lm import LMConfig

FULL = LMConfig(
    name="mamba2-780m",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    block_pattern=("ssd",), ssm_state=128, ssm_headdim=64, ssm_expand=2,
    ssm_chunk=256,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat="full",
)

REDUCED = LMConfig(
    name="mamba2-780m-reduced",
    n_layers=3, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=512,
    block_pattern=("ssd",), ssm_state=16, ssm_headdim=16, ssm_expand=2,
    ssm_chunk=8,
)
