"""The port's model layers (``repro/layers``): RMSNorm, RoPE, the MLPs,
grouped-query attention with KV caches, the recurrent layers (Mamba-2
SSD, RG-LRU) and the routed MoE (``moe``), each with its parameters'
logical axes for placement.  ``tp_block`` (the shard_map TP sublayers)
is ROADMAP item A11.3."""
