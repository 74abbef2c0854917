"""Optimizers (twin of the JAX package's ``optim``): AdamW, the LR
schedules and ``compress`` (the int8 all-reduce with error feedback)."""
from . import adamw, compress, schedules
from .adamw import AdamWState, clip_by_global_norm, global_norm

__all__ = ["adamw", "compress", "schedules", "AdamWState",
           "clip_by_global_norm", "global_norm"]
