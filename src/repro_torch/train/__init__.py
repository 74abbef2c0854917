from .steps import decode_step, prefill_step

__all__ = ["decode_step", "prefill_step"]
