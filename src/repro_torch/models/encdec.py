"""Whisper-style encoder-decoder backbone, the audio family (twin of the JAX
package's ``models/encdec.py``).

As in the reference, the audio frontend (mel → conv downsampling) is a
stub: the encoder takes precomputed frame embeddings (B, S_enc, d_model)
and maps them through ``frame_proj``. The transformer backbone is real: a
non-causal self-attention encoder stack, and a causal decoder stack with a
self-attention KV cache and cross-attention over the encoder output
(``layers.cross_attn_block``, which projects K and V from the encoder
output in every layer of every call, as the reference does).

The reference scans the stacked ``enc`` and ``dec`` trees; here a Python
loop walks them (``lm._unstack``), as ``lm._attn_stack`` does. The decoder
writes its KV cache in place layer by layer, as ``lm.py`` does (the
reference returns an updated copy and its serve loop donates the old one),
and returns a new cache dict holding the same K/V tensors, ``enc_out`` and
``pos + s``. ``pos`` is a host int, as in every cache of the port.

With ``attn_impl="flash"`` the encoder's self-attention (non-causal over
every frame) and the decoder's prefill go through the FlashAttention
wrapper. At whisper's 1,500 frames the reference's wrapper finds no tile
of 8 to 512 rows that divides the length and computes the plain
``attention_ref`` instead (``kernels/flash_attention/ops.py``
``_pick_block``); the port's wrapper has no off-tile fallback and launches
the kernel, which masks the ragged last tile itself. Both compute the same
function.

The residual streams and the logits go through ``constrain`` where the
reference constrains them: a no-op returning its input on a mesh of one
device and with none.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..sharding.activation import batch_axes, cache_leaf, constrain, on_mesh
from . import layers
from .config import ArchConfig
from .lm import _maybe_remat, _stack, _unstack, embed_lookup
from .params import P, init_params


class EncDecOut(NamedTuple):
    logits: torch.Tensor
    cache: Any
    aux_loss: torch.Tensor


def _enc_layer_defs(cfg: ArchConfig) -> dict:
    return {"ln1": layers.rmsnorm_defs(cfg.d_model),
            "attn": layers.attention_defs(cfg),
            "ln2": layers.rmsnorm_defs(cfg.d_model),
            "mlp": layers.mlp_defs(cfg.d_model, cfg.d_ff)}


def _dec_layer_defs(cfg: ArchConfig) -> dict:
    return {"ln1": layers.rmsnorm_defs(cfg.d_model),
            "attn": layers.attention_defs(cfg),
            "lnx": layers.rmsnorm_defs(cfg.d_model),
            "xattn": layers.attention_defs(cfg),
            "ln2": layers.rmsnorm_defs(cfg.d_model),
            "mlp": layers.mlp_defs(cfg.d_model, cfg.d_ff)}


def param_defs(cfg: ArchConfig) -> dict:
    ed = cfg.encdec
    return {
        "frame_proj": P((cfg.d_model, cfg.d_model), ("embed", None)),  # stub frontend adapter
        "embed": P((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
        "enc": _stack(_enc_layer_defs(cfg), ed.enc_layers),
        "dec": _stack(_dec_layer_defs(cfg), ed.dec_layers),
        "enc_norm": layers.rmsnorm_defs(cfg.d_model),
        "final_norm": layers.rmsnorm_defs(cfg.d_model),
        "lm_head": P((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
    }


def init(cfg: ArchConfig, generator: torch.Generator,
         device: torch.device | str) -> dict:
    return init_params(param_defs(cfg), generator, device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, enc_len: int,
               device: torch.device | str) -> dict:
    """The decoder's self-attention K/V (dec_layers, B, max_len, KV, D) and
    the encoder output (B, enc_len, d_model), bf16 zeros (prefill replaces
    ``enc_out``), and ``pos`` 0, the next write offset."""
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (cfg.encdec.dec_layers, batch, max_len, kvh, hd)

    def zeros(name, *shape):
        # on a mesh of several devices, laid out as the reference's
        # prefill lays its cache out; a plain tensor otherwise
        return cache_leaf(name, shape, 0, torch.bfloat16, device, batch)

    return {"k": zeros("k", *shape), "v": zeros("v", *shape),
            "enc_out": zeros("enc_out", batch, enc_len, cfg.d_model),
            "pos": 0}


def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames: (B, S_enc, d_model) stub embeddings → encoder states: the
    bf16 frames through ``frame_proj``, a non-causal self-attention stack
    under RoPE at positions 0..S_enc − 1, then ``enc_norm``."""
    b, s, _ = frames.shape
    h = frames.to(torch.bfloat16) @ params["frame_proj"]
    h = constrain(h, batch_axes(), None, None)
    positions = on_mesh(torch.arange(s, dtype=torch.int32,
                                     device=frames.device).expand(b, s),
                        batch_axes(), None)

    def body(h, p):
        x = layers.rmsnorm(h, p["ln1"], cfg.norm_eps)
        out, _ = layers.attn_block(cfg, p["attn"], x, positions, window=None,
                                   causal=False)
        h = h + out
        h = h + layers.mlp_block(
            p["mlp"], layers.rmsnorm(h, p["ln2"], cfg.norm_eps))
        return constrain(h, batch_axes(), None, None)

    if torch.is_grad_enabled():
        body = _maybe_remat(body, cfg)
    for p in _unstack(params["enc"], cfg.encdec.enc_layers):
        h = body(h, p)
    return layers.rmsnorm(h, params["enc_norm"], cfg.norm_eps)


def decode(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
           enc_out: torch.Tensor, cache: dict | None = None) -> EncDecOut:
    """Teacher-forced decode (``cache=None``) or incremental decode: each
    layer runs self-attention (writing K/V at ``cache['pos']`` in place),
    then ``lnx`` and cross-attention over ``enc_out``, then the MLP.
    Returns the logits (B, S, vocab) and, with a cache, the new cache."""
    b, s = tokens.shape
    h = embed_lookup(cfg, params["embed"], tokens)
    has_cache = cache is not None
    base = cache["pos"] if has_cache else 0
    positions = on_mesh(torch.arange(base, base + s, dtype=torch.int32,
                                     device=tokens.device).expand(b, s),
                        batch_axes(), None)
    h = constrain(h, batch_axes(), None, None)

    def body(h, p, kv_cache):
        x = layers.rmsnorm(h, p["ln1"], cfg.norm_eps)
        out, _ = layers.attn_block(cfg, p["attn"], x, positions, window=None,
                                   kv_cache=kv_cache,
                                   cache_pos=base if has_cache else None)
        h = h + out
        x = layers.rmsnorm(h, p["lnx"], cfg.norm_eps)
        h = h + layers.cross_attn_block(cfg, p["xattn"], x, enc_out)
        h = h + layers.mlp_block(
            p["mlp"], layers.rmsnorm(h, p["ln2"], cfg.norm_eps))
        return constrain(h, batch_axes(), None, None)

    if torch.is_grad_enabled() and not has_cache:
        body = _maybe_remat(body, cfg)
    n = cfg.encdec.dec_layers
    for i, p in enumerate(_unstack(params["dec"], n)):
        h = body(h, p, (cache["k"][i], cache["v"][i]) if has_cache else None)
    new_cache = None
    if has_cache:
        new_cache = {"k": cache["k"], "v": cache["v"], "enc_out": enc_out,
                     "pos": base + s}
    h = layers.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", h, params["lm_head"].to(h.dtype))
    logits = constrain(logits, batch_axes(), None,
                       None if "model" in batch_axes() else "model")
    return EncDecOut(logits=logits, cache=new_cache,
                     aux_loss=torch.zeros((), dtype=torch.float32,
                                          device=h.device))


def forward(cfg: ArchConfig, params: dict, frames: torch.Tensor,
            tokens: torch.Tensor) -> EncDecOut:
    """Training forward: encode the frames, teacher-force the tokens."""
    return decode(cfg, params, tokens, encode(cfg, params, frames))
