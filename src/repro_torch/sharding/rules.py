"""Logical-axis → mesh-axis rule sets (MaxText-style), per execution mode
(twin of the JAX package's ``sharding/rules.py``, copied: plain dicts).

``models/params.py`` ``param_specs`` applies these with divisibility
fallback. Swapping ``embed: ("data",)`` (FSDP) for ``embed: ()`` (pure
replication) or moving MLP sharding changes the collective schedule
without touching model code.
"""
from __future__ import annotations

# Default: 2D-sharded params — FSDP over `data`, TP over `model`.
TRAIN_2D = {
    "vocab": ("model",),
    "embed": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": ("model",),
    "ssm_inner": ("model",),
}

# Pure tensor-parallel params (replicated over data) — small models where
# per-step all-gather of FSDP shards dominates.
TRAIN_TP_ONLY = dict(TRAIN_2D, embed=())

# Serving: params TP-sharded; no FSDP (no optimizer state at serve time).
SERVE = dict(TRAIN_2D, embed=())

# Pure FSDP / ZeRO-3: NO tensor parallelism — batch spreads over every mesh
# axis (see BATCH_AXES_BY_RULESET), params and optimizer stay 2D-sharded for
# storage and are all-gathered (bf16) around each use. Trades the fp32 TP
# activation all-reduce for bf16 weight gathers — wins when
# 3·params·2B < 2·B·S·D·4B per device (small models / big batches).
TRAIN_FSDP = {
    "vocab": ("model",),
    "embed": ("data", "model"),   # ZeRO-3 over all 256 chips: a 104B AdamW
    "heads": (),                  # state is 3.3 GB/device instead of 53 GB
    "kv_heads": (),
    "mlp": (),
    "experts": (),
    "expert_mlp": (),
    "ssm_inner": (),
}

RULESETS = {
    "train_2d": TRAIN_2D,
    "train_tp_only": TRAIN_TP_ONLY,
    "train_fsdp": TRAIN_FSDP,
    "serve": SERVE,
}

# Logical-batch physical axes per ruleset (default: data parallel only).
BATCH_AXES_BY_RULESET = {
    "train_fsdp": ("pod", "data", "model"),
}

