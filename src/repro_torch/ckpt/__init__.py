"""Checkpointing and fault tolerance (the port of ``repro.ckpt``)."""
from .checkpoint import (CheckpointManager, save_checkpoint, load_checkpoint,
                         latest_step)

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "latest_step"]
