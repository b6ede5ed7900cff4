"""The port's training step (``repro/distributed``), at world size 1: the
mesh and sharding wait for the multi-device layer (ROADMAP item A11)."""
from .steps import make_train_step  # noqa: F401
