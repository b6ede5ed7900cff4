"""The port's model layers (``repro/layers``): RMSNorm, RoPE, the MLPs,
grouped-query attention with KV caches, the recurrent layers (Mamba-2
SSD, RG-LRU) and the routed MoE (``moe``).  ``tp_block`` belongs to the
multi-device layer."""
