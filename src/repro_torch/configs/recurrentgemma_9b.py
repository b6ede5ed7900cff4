"""recurrentgemma-9b — Griffin hybrid: RG-LRU temporal mixing + local
attention in a 1:2 pattern (2 recurrent blocks per local-attention block),
MQA (kv=1), window 2048. [arXiv:2402.19427; unverified]

38 layers = 12 × (rglru, rglru, local_attn) + 2 tail rglru layers.
Sub-quadratic: runs the ``long_500k`` shape (O(window) attention memory,
O(1) recurrent state).
"""
import torch

from ..models.lm import LMConfig

FULL = LMConfig(
    name="recurrentgemma-9b",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"),
    rnn_width=4096, local_window=2048,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat="full",
)

REDUCED = LMConfig(
    name="recurrentgemma-9b-reduced",
    n_layers=5, d_model=128, n_heads=4, n_kv_heads=1,
    d_ff=256, vocab_size=512,
    block_pattern=("rglru", "rglru", "local_attn"),
    rnn_width=128, local_window=16,
)
