from .ckpt import CheckpointManager

__all__ = ["CheckpointManager"]
