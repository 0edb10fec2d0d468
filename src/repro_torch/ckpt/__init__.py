"""Checkpoints of the training state (:class:`CheckpointManager`)."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
