"""internvl2-26b — VLM: InternViT frontend (STUB per assignment —
``input_specs`` provides precomputed patch embeddings) + InternLM2-20B-style
decoder backbone. [arXiv:2404.16821; hf]"""
import torch

from ..models.lm import LMConfig

PATCH_PREFIX = 1024  # ViT patch tokens provided as embeddings

FULL = LMConfig(
    name="internvl2-26b",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92553,
    input_mode="prefix_embeds", prefix_len=PATCH_PREFIX,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat="full",
)

REDUCED = LMConfig(
    name="internvl2-26b-reduced",
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab_size=512,
    input_mode="prefix_embeds", prefix_len=8,
)
