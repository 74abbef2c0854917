"""Architecture configuration dataclasses for the model zoo.

One frozen dataclass describes every assigned architecture; family-specific
blocks (MoE, SSM, enc-dec) are optional sub-configs. ``src/repro/configs/``
holds one instance per assigned arch id.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared: int = 0
    shared_d_ff: int = 0
    every_k_layers: int = 1       # MoE FFN every k-th layer (1 = all layers)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128              # SSD chunk length
    a_init_range: tuple = (1.0, 16.0)


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    enc_layers: int
    dec_layers: int
    cross_len: int = 1500         # encoder output length seen by decoder


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 → d_model // num_heads
    use_bias: bool = False
    rope_theta: float = 10_000.0
    # Sliding-window pattern: (local_count, global_every) e.g. gemma3 = (5, 6)
    # means layers use window except every 6th layer which is global.
    window: int | None = None     # local window size (None = all global)
    global_every: int = 0         # 0 = no global layers when window set
    # M-RoPE (qwen2-vl): rotary dims split into (t, h, w) sections.
    mrope_sections: Optional[tuple] = None
    # hybrid (jamba): attention every k-th layer, SSM elsewhere.
    attn_every: int = 0
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    encdec: Optional[EncDecCfg] = None
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # --- execution hints (overridable per run) ------------------------------
    remat: str = "block"          # none | block | full | dots
    scan_layers: bool = True
    attn_impl: str = "chunked"    # reference | chunked | flash (Pallas, TPU)
    grad_accum: int = 1           # microbatches per train step
    # vocab-sharded-friendly implementations (§Perf levers): "onehot" turns
    # the embedding gather / xent gold-gather into fused one-hot matmuls so
    # GSPMD never reshards the (vocab, d) table (XLA's sharded-gather
    # fallback replicates it).
    embed_impl: str = "onehot"    # gather | onehot
    xent_impl: str = "onehot"     # gather | onehot
    moe_impl: str = "einsum"      # einsum | shard_map (expert-TP, explicit)
    # Ring KV cache for sliding-window layers (§Perf lever): local layers
    # allocate only `window` slots (ring-written, absolute positions stored
    # alongside so masking is order-independent); global layers keep the
    # full-length cache. gemma3 long_500k: 36.5 GB → ~5.5 GB.
    window_cache: bool = False
    # Preferred launch-level sharding ruleset for training (None → the
    # launcher default "train_2d"). command-r-plus validated "train_fsdp"
    # in §Perf cell B: pure ZeRO-3, batch over all 256 chips, no TP ARs.
    train_ruleset: str | None = None
    # Fully unroll the layer/accum scans. Used by the roofline dry-run:
    # XLA's cost_analysis counts while-loop bodies ONCE, so scanned models
    # under-report FLOPs/bytes by ~layers×accum. Unrolling restores exact
    # counts (slower compile; never used for real runs).
    unroll: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def param_count(self) -> int:
        """Approximate parameter count (used for 6·N·D model-FLOPs)."""
        hd = self.resolved_head_dim
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        enc_dec = self.encdec
        n_layers = self.num_layers if enc_dec is None else (
            enc_dec.enc_layers + enc_dec.dec_layers)
        for i in range(n_layers):
            is_ssm = self._layer_is_ssm(i)
            if is_ssm:
                d_in = self.ssm.expand * d
                nheads = d_in // self.ssm.head_dim
                ns = self.ssm.d_state
                total += d * (2 * d_in + 2 * ns + nheads)       # in_proj
                total += (d_in + 2 * ns) * (self.ssm.d_conv + 1)  # conv
                total += d_in * d                                # out_proj
                total += d_in + 3 * nheads                       # norm/dt/a/D
            else:
                q = d * self.num_heads * hd
                kv = 2 * d * self.num_kv_heads * hd
                o = self.num_heads * hd * d
                total += q + kv + o
            if self.moe is not None and (i % max(self.moe.every_k_layers, 1)
                                         == (self.moe.every_k_layers - 1)):
                total += self.moe.num_experts * 3 * d * self.moe.expert_d_ff
                total += d * self.moe.num_experts  # router
                if self.moe.num_shared:
                    total += 3 * d * self.moe.shared_d_ff
            elif not is_ssm or self.family == "hybrid":
                total += 3 * d * self.d_ff if self.d_ff else 0
            total += 2 * d  # norms
            if enc_dec is not None and i >= enc_dec.enc_layers:
                total += 2 * d * self.num_heads * hd + 2 * d  # cross-attn
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        dead = (self.moe.num_experts - self.moe.top_k) * 3 * self.d_model \
            * self.moe.expert_d_ff
        n_moe_layers = sum(
            1 for i in range(self.num_layers)
            if i % max(self.moe.every_k_layers, 1) == (self.moe.every_k_layers - 1))
        return int(full - dead * n_moe_layers)

    def _layer_is_ssm(self, i: int) -> bool:
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and self.attn_every:
            return (i % self.attn_every) != (self.attn_every - 1)
        return False

    def layer_is_attn(self, i: int) -> bool:
        return not self._layer_is_ssm(i)

    def layer_window(self, i: int) -> int | None:
        """Per-layer sliding window (None = global attention)."""
        if self.window is None:
            return None
        if self.global_every and (i % self.global_every == self.global_every - 1):
            return None
        return self.window

    def layer_is_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        k = max(self.moe.every_k_layers, 1)
        return i % k == (k - 1)
