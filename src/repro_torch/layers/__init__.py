"""The port's model layers (``repro/layers``): RMSNorm, RoPE, the MLPs and
grouped-query attention with KV caches.  The recurrent and MoE layers
come with later slices."""
