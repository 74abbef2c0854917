"""Family dispatch (twin of the JAX package's ``models/registry.py``).

Only ``lm.py`` is ported, for the dense family (the windowed configs'
ring caches included), the MoE family (granite-moe-1b-a400m,
qwen2-moe-a2.7b, through ``moe.py``), the vlm family (qwen2-vl-7b:
M-RoPE and the vision splice), the ssm family and the hybrid family
(jamba-v0.1-52b: Mamba-2, attention and MoE layers in groups); it raises
for the enc-dec (audio) family, which comes with ``encdec.py`` (ROADMAP
queue 1 item 8).
"""
from __future__ import annotations

from typing import Any

import torch

from . import lm
from .config import ArchConfig


def param_defs(cfg: ArchConfig) -> Any:
    return lm.param_defs(cfg)


def init(cfg: ArchConfig, generator: torch.Generator,
         device: torch.device | str) -> Any:
    return lm.init(cfg, generator, device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device | str) -> Any:
    return lm.init_cache(cfg, batch, max_len, device)
