"""Family dispatch (twin of the JAX package's ``models/registry.py``): one
interface over ``lm.py`` and ``encdec.py``.

``lm.py`` holds the decoder-only families: dense (the windowed configs'
ring caches included), MoE (granite-moe-1b-a400m, qwen2-moe-a2.7b, through
``moe.py``), vlm (qwen2-vl-7b: M-RoPE and the vision splice), ssm and
hybrid (jamba-v0.1-52b: Mamba-2, attention and MoE layers in groups).
``encdec.py`` holds the audio family (whisper-medium), whose serving cache
holds the encoder output of ``cfg.encdec.cross_len`` frames here.
"""
from __future__ import annotations

from typing import Any

import torch

from . import encdec, lm
from .config import ArchConfig


def param_defs(cfg: ArchConfig) -> Any:
    if cfg.family == "audio":
        return encdec.param_defs(cfg)
    return lm.param_defs(cfg)


def init(cfg: ArchConfig, generator: torch.Generator,
         device: torch.device | str) -> Any:
    if cfg.family == "audio":
        return encdec.init(cfg, generator, device)
    return lm.init(cfg, generator, device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device | str) -> Any:
    if cfg.family == "audio":
        return encdec.init_cache(cfg, batch, max_len,
                                 enc_len=cfg.encdec.cross_len, device=device)
    return lm.init_cache(cfg, batch, max_len, device)
