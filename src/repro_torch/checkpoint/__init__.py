"""The port's checkpoints (``repro/checkpoint``), in the reference's on-disk
format."""
from .manager import CheckpointManager, restore_checkpoint, save_checkpoint  # noqa: F401
