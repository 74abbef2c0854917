"""LR schedules (twin of the JAX package's ``optim/schedules.py``).

Pure functions of the step counter, computed in fp32 on a 0-d tensor on
the counter's device, as the reference computes in ``jnp.float32``: a
Python float would differ in the last bits and, for a counter on the card,
cost a host sync.
"""
from __future__ import annotations

import math

import torch


def _as_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    step = _as_f32(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(_as_f32(step), peak_lr)
