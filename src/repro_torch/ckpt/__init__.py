"""Checkpoints (port of ``src/repro/ckpt``: ``checkpoint.py`` and
``elastic.py``)."""
from repro_torch.ckpt.checkpoint import (
    CheckpointManager, latest_step, restore, save,
)

__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
