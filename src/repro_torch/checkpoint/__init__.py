"""Versioned checkpoints of training state in the port's VersionStore."""

from .emergency import PreemptionGuard
from .versioned import VersionedCheckpointManager, restore_to_template

__all__ = ["VersionedCheckpointManager", "PreemptionGuard", "restore_to_template"]
