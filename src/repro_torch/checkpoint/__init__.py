"""repro_torch.checkpoint — async, atomic, elastic checkpointing."""

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
