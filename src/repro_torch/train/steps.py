"""Serving steps (twin of the JAX package's ``train/steps.py``).

``prefill_step`` builds the KV cache from a full prompt in one forward;
``decode_step`` advances one token against it. ``train_step`` and the
loss come with the training slice (ROADMAP queue 1 item 5).
"""
from __future__ import annotations

from typing import Any

import torch

from ..models import lm, registry
from ..models.config import ArchConfig


def prefill_step(cfg: ArchConfig, params: Any, batch: dict, *,
                 max_len: int) -> tuple[torch.Tensor, Any]:
    """Build the cache from a full prompt. Returns (last logits, cache)."""
    tokens = batch["tokens"]
    b, _ = tokens.shape
    cache = registry.init_cache(cfg, b, max_len, tokens.device)
    out = lm.forward(cfg, params, tokens, cache=cache,
                     vision_embeds=batch.get("vision_embeds"),
                     mrope_positions=batch.get("mrope_positions"))
    return out.logits[:, -1], out.cache


def decode_step(cfg: ArchConfig, params: Any, token: torch.Tensor,
                cache: Any) -> tuple[torch.Tensor, Any]:
    """One token against the cache (updated in place). token: (B, 1).
    Returns (logits, cache)."""
    out = lm.forward(cfg, params, token, cache=cache)
    return out.logits[:, 0], out.cache
