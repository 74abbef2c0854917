from . import pipeline, synth, tabular
from .pipeline import TokenBatcher, batch_to

__all__ = ["pipeline", "synth", "tabular", "TokenBatcher", "batch_to"]
