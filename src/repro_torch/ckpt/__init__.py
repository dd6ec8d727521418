"""Checkpoints (port of ``src/repro/ckpt``; ``elastic.py`` has no port)."""
from repro_torch.ckpt.checkpoint import (
    CheckpointManager, latest_step, restore, save,
)

__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
