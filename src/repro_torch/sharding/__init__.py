from .activation import constrain, BATCH_AXES, SEQ_AXES
from . import rules

__all__ = ["constrain", "BATCH_AXES", "SEQ_AXES", "rules"]
