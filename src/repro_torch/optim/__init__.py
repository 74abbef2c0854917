"""Optimizers (twin of the JAX package's ``optim``): AdamW and the LR
schedules. ``compress.py`` (bf16 gradients on the wire) is ROADMAP
queue 1 item 9c."""
from . import adamw, schedules
from .adamw import AdamWState, clip_by_global_norm, global_norm

__all__ = ["adamw", "schedules", "AdamWState", "clip_by_global_norm",
           "global_norm"]
