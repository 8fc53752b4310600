"""Atomic, versioned checkpoints of tensor trees (``manager``)."""
from repro_torch.checkpoint.manager import CheckpointManager, config_digest

__all__ = ["CheckpointManager", "config_digest"]
