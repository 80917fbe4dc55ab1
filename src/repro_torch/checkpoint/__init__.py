"""repro_torch.checkpoint — the single-host checkpoint manager (flat layout,
v3 manifests, warm saves), in PyTorch."""

from .manager import CheckpointConfig, CheckpointManager, IncompleteCheckpointError

__all__ = ["CheckpointConfig", "CheckpointManager", "IncompleteCheckpointError"]
