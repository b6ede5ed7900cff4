"""The port's model layers (``repro/layers``): RMSNorm, RoPE, the MLPs,
grouped-query attention with KV caches, the recurrent layers (Mamba-2
SSD, RG-LRU), the routed MoE (``moe``, local and expert-parallel) and
the Megatron tensor-parallel sublayers (``tp_block``), each with its
parameters' logical axes for placement."""
