"""Architecture registry: ``--arch <id>`` resolves here.

Each module defines ``CONFIG: ArchConfig`` with the exact published
configuration; ``reduced(cfg)`` builds the same-family small config used by
CPU smoke tests.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ArchConfig, EncDecCfg, MoECfg, SSMCfg

from . import (command_r_plus_104b, gemma3_4b, granite_moe_1b_a400m,
               helix100m, internlm2_1_8b, jamba_v0_1_52b, mamba2_130m,
               qwen2_moe_a2_7b, qwen2_vl_7b, whisper_medium, yi_9b)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (internlm2_1_8b, yi_9b, command_r_plus_104b, gemma3_4b,
              jamba_v0_1_52b, qwen2_vl_7b, mamba2_130m,
              granite_moe_1b_a400m, qwen2_moe_a2_7b, whisper_medium,
              helix100m)
}

ASSIGNED = [n for n in ARCHS if n != "helix100m"]


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Same-family tiny config for CPU smoke tests: few layers, narrow
    width, tiny vocab, few experts — preserves every structural feature
    (GQA ratio, window pattern, MoE period, hybrid grouping, enc-dec)."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        num_layers=max(2, min(4, cfg.num_layers)),
        d_model=128,
        num_heads=4,
        num_kv_heads=max(1, 4 * cfg.num_kv_heads // cfg.num_heads),
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32 if cfg.head_dim else 0,
    )
    if cfg.window is not None:
        kw["window"] = 8
        kw["global_every"] = 2   # [local, global] × 2 — exercises both paths
        kw["num_layers"] = 4
    if cfg.mrope_sections is not None:
        kw["mrope_sections"] = (4, 6, 6)  # sums to head_dim//2 = 16
    if cfg.attn_every:
        kw["attn_every"] = 4
        kw["num_layers"] = 8
    if cfg.moe is not None:
        kw["moe"] = MoECfg(
            num_experts=min(8, cfg.moe.num_experts),
            top_k=min(2, cfg.moe.top_k),
            expert_d_ff=64,
            num_shared=min(1, cfg.moe.num_shared),
            shared_d_ff=128 if cfg.moe.num_shared else 0,
            every_k_layers=cfg.moe.every_k_layers,
            # no token drops in smoke tests → decode == full forward exactly
            capacity_factor=float(min(8, cfg.moe.num_experts)))
    if cfg.ssm is not None:
        kw["ssm"] = SSMCfg(d_state=16, head_dim=16, expand=2, d_conv=4,
                           chunk=8)
    if cfg.encdec is not None:
        kw["encdec"] = EncDecCfg(enc_layers=2, dec_layers=2, cross_len=16)
    return dataclasses.replace(cfg, **kw)
