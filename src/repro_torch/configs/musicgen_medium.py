"""musicgen-medium — decoder-only transformer over EnCodec tokens; MHA
(kv=24).  The EnCodec frontend is a STUB per assignment — ``input_specs``
provides precomputed frame embeddings; the head predicts codebook tokens
(vocab 2048). [arXiv:2306.05284; hf]"""
import torch

from ..models.lm import LMConfig

FULL = LMConfig(
    name="musicgen-medium",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    mlp_gated=False,
    input_mode="embeds",
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat="full",
)

REDUCED = LMConfig(
    name="musicgen-medium-reduced",
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=8,
    d_ff=256, vocab_size=128,
    input_mode="embeds",
)
