"""Family dispatch (twin of the JAX package's ``models/registry.py``).

Only ``lm.py`` is ported, for the dense family (the windowed configs'
ring caches included), the MoE family (granite-moe-1b-a400m,
qwen2-moe-a2.7b, through ``moe.py``) and the ssm family; it raises for
the others, and the enc-dec (audio) family comes with them (ROADMAP queue
1 item 8).
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
