"""Fault-tolerant checkpointing (save/restore/restart discovery), in the
reference's on-disk format."""

from repro_torch.checkpoint.manager import CheckpointManager, restore_latest

__all__ = ["CheckpointManager", "restore_latest"]
