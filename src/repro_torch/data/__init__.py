from . import pipeline, synth
from .pipeline import TokenBatcher, batch_to

__all__ = ["pipeline", "synth", "TokenBatcher", "batch_to"]
