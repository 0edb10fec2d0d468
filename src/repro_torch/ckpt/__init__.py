"""Checkpoints of the training state (:class:`CheckpointManager`), restored
onto a mesh of another size with :func:`restore_to_sharding`."""

from .manager import CheckpointManager, restore_to_sharding

__all__ = ["CheckpointManager", "restore_to_sharding"]
