"""The port's optimizer (``repro/optim``): AdamW, its schedule and clipping,
and gradient compression with error feedback."""
from .adamw import AdamWState, adamw, clip_by_global_norm, cosine_schedule  # noqa: F401
from .compress import compressed_gradients  # noqa: F401
