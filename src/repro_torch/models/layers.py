"""Transformer building blocks: RMSNorm, RoPE and M-RoPE, GQA attention
with a KV cache or a ring KV cache, gated MLP (twin of the JAX package's
``models/layers.py``).

Plain functions on tensors over the reference's dict parameter tree.
``rmsnorm`` always goes through the RMSNorm kernel's wrapper, which is
differentiable (``RMSNormFn``: the forward kernel, and a backward kernel
where the reference has autodiff of its jnp rmsnorm) wherever grad mode
is on and an input requires grad, and a direct launch otherwise;
``gqa_attention`` with ``impl="flash"`` and ``S_q > 1`` goes through the
FlashAttention wrapper, which is forward only: training runs the plain
``"chunked"`` attention, as the reference does. On CPU tensors both
wrappers take their plain versions. ``ring_update`` and
``attn_block_ring`` serve the windowed family's local layers (gemma3);
``cross_attn_block`` is the audio family's cross-attention over the
encoder output (whisper), always through the plain ``"reference"``
attention, as in the reference.

Every product with no batch dimension (the q/k/v/o projections and the
MLP) goes through ``project``, one ``mm`` on 2-D views, so that
``remat="dots"`` can tell it by its op from the batched products
(attention's logits and PV, the experts, the SSD scan), which run as
``bmm`` (``models/lm.py`` ``_dots_policy``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as flash_ops
from ..kernels.flash_attention.ops import GLOBAL_WINDOW
from ..kernels.rmsnorm import ops as rmsnorm_ops
from ..sharding import activation
from ..sharding.activation import (batch_axes, constrain, distributed, full,
                                   model_axis, shards, splittable,
                                   write_slice)
from .params import P

__all__ = ["GLOBAL_WINDOW", "project", "rmsnorm_defs", "rmsnorm",
           "rope_freqs", "apply_rope", "attention_defs", "gqa_attention",
           "attn_block", "ring_update", "attn_block_ring", "cross_attn_block",
           "mlp_defs", "mlp_block"]


# --------------------------------------------------------------------------- product
def project(x: torch.Tensor, w: torch.Tensor, n_in: int = 1) -> torch.Tensor:
    """``x`` (..., *w.shape[:n_in]) contracted with ``w`` over those
    ``n_in`` dims: (..., *w.shape[n_in:]), as one ``mm`` of 2-D views
    ("bsd,dhk->bshk" with ``n_in`` 1, "bshk,hkd->bsd" with 2). As an
    einsum it would run as a ``bmm`` with a batch of 1, the op of the
    batched products."""
    k = math.prod(w.shape[:n_in])
    if distributed(w):
        # on a mesh of several devices, shards that the views below (or
        # their backwards) would split unevenly are gathered (8 KV heads on
        # a 16-way model axis)
        rows, cols = x.shape[0], w.shape[n_in]
        x2 = splittable(x.reshape(-1, k), rows, w.shape[0])
        w2 = splittable(w.reshape(k, -1), w.shape[0], cols)
        out = splittable(torch.mm(x2, w2), rows, cols)
    else:
        out = torch.mm(x.reshape(-1, k), w.reshape(k, -1))
    return out.reshape(*x.shape[:x.dim() - n_in], *w.shape[n_in:])


def _to_residual(x: torch.Tensor) -> torch.Tensor:
    """A block's output laid out as the residual stream it is added to
    (batch over the batch axes, the rest whole): on a mesh of several
    devices, the partial sums of a product contracted over a sharded dim
    are reduced here, where DTensor would otherwise carry them into the
    next block; ``x`` itself with no mesh and on a mesh of one device."""
    if not distributed(x):
        return x
    return constrain(x, batch_axes(), None, None)


# --------------------------------------------------------------------------- norm
def rmsnorm_defs(d: int) -> P:
    return P((d,), ("embed",), init="ones", dtype=torch.float32)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    return rmsnorm_ops.rmsnorm(x, w, eps)


# --------------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple | None = None) -> torch.Tensor:
    """Rotary embedding, computed in fp32 and cast back to ``x.dtype``.

    x: (B, S, H, D). positions: (B, S) integer positions, or (3, B, S) for
    M-RoPE (Qwen2-VL), where the three streams are the temporal, height
    and width ids and ``mrope_sections`` gives the number of frequency
    pairs each stream takes, in order (summing to D/2).
    """
    d = x.shape[-1]
    # rope_freqs on the tensor's device (float64 as numpy computes it), so
    # the decode loop makes no host-to-device copy per layer
    exps = torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d
    freqs = (1.0 / theta ** exps).float()                     # (d/2,)
    if mrope_sections is None:
        ang = positions.float()[..., None] * freqs            # (B, S, d/2)
    else:
        if positions.dim() != 3 or sum(mrope_sections) != d // 2:
            raise ValueError(
                f"M-RoPE wants (3, B, S) positions and sections summing to "
                f"{d // 2}; got {tuple(positions.shape)}, {mrope_sections}")
        parts, start = [], 0
        for i, n in enumerate(mrope_sections):
            parts.append(positions[i].float()[..., None] * freqs[start:start + n])
            start += n
        ang = torch.cat(parts, dim=-1)                        # (B, S, d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- attention
def attention_defs(cfg) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    defs = {
        "wq": P((d, h, hd), ("embed", "heads", None)),
        "wk": P((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": P((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": P((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.use_bias:
        defs["bq"] = P((h, hd), ("heads", None), init="zeros")
        defs["bk"] = P((kv, hd), ("kv_heads", None), init="zeros")
        defs["bv"] = P((kv, hd), ("kv_heads", None), init="zeros")
    return defs


def _sdpa_reference(q, k, v, mask) -> torch.Tensor:
    """Grouped-query scaled-dot-product attention, fp32 softmax.

    q: (B, S_q, KV, G, D) — G = q heads per kv head.
    k, v: (B, S_k, KV, D). mask: broadcastable to (B, KV, G, S_q, S_k).
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def _sdpa_chunked(qg, k, v, q_pos, k_pos, *, causal, window, valid_len,
                  chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention looped over KV chunks (the reference's XLA
    flash-style path, in plain torch). qg: (B, Sq, KV, G, D); k/v: (B, Sk,
    KV, D)."""
    b, sq, kvh, g, d = qg.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    pad = (-sk) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-(1 << 30))
    nc = (sk + pad) // chunk
    scale = d ** -0.5
    qf = qg.float()
    # laid out as the queries on a mesh of several devices, else plain
    ax = (batch_axes(), None, None, model_axis())
    m = full((b, kvh, g, sq), -1e30, *ax, dtype=torch.float32,
             device=qg.device)
    l = full((b, kvh, g, sq), 0, *ax, dtype=torch.float32, device=qg.device)
    acc = full((b, kvh, g, sq, d), 0, *ax, dtype=torch.float32,
               device=qg.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        k_i, v_i, kp_i = k[:, sl], v[:, sl], k_pos[:, sl]
        # on a mesh of several devices, on the local shards: the product
        # would fold the batch and the queries' sequence, both sharded
        logits = activation.einsum("bqkgd,bskd->bkgqs", qf,
                                   k_i.float()) * scale
        rel = q_pos[:, None, None, :, None] - kp_i[:, None, None, None, :]
        mask = kp_i[:, None, None, None, :] >= 0
        if causal:
            mask = mask & (rel >= 0)
        if window is not None:
            mask = mask & (rel < window)
        if valid_len is not None:
            mask = mask & (kp_i[:, None, None, None, :]
                           < valid_len[:, None, None, None, None])
        logits = torch.where(mask, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + activation.einsum(
            "bkgqs,bskd->bkgqd", p, v_i.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.movedim(-2, 1).reshape(b, sq, kvh, g, d).to(qg.dtype)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor,
                  *, causal: bool, window: int | None,
                  valid_len: torch.Tensor | None = None,
                  impl: str = "reference") -> torch.Tensor:
    """GQA attention with positional masking.

    q: (B, S_q, H, D); k/v: (B, S_k, KV, D); q_pos: (B, S_q); k_pos: (B, S_k)
    valid_len: optional (B,) number of live cache slots (decode).
    Returns (B, S_q, H, D).

    As in the reference, the flash path masks only by the query offset
    ``q_pos[:, 0]``, causality and the window: it ignores ``k_pos`` and
    ``valid_len`` (prefill into a longer cache is right because causality
    hides the empty slots).
    """
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    if impl == "flash" and sq > 1:
        return flash_ops.flash_attention(
            q, k, v, q_offset=q_pos[:, 0].to(torch.int32).contiguous(),
            causal=causal,
            window=window if window is not None else GLOBAL_WINDOW)
    if distributed(q):
        # on a mesh of several devices: the heads whole (the products fold
        # batch and heads into one dim, which DTensor cannot keep sharded
        # over both); the queries' sequence over the model axis where
        # S_q > 1, else the keys' and values' (a decode step's cache)
        bd = batch_axes()
        qs = model_axis() if sq > 1 else None
        ks = None if sq > 1 else model_axis()
        q = constrain(q, bd, qs, None, None)
        q_pos = constrain(q_pos, bd, qs)
        k = constrain(k, bd, ks, None, None)
        v = constrain(v, bd, ks, None, None)
        if g > 1 and qs is not None:
            # each query head gets its own copy of its KV head: the
            # products would fold (G, S_q) into one dim, sharded unevenly
            k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
            kvh, g = h, 1
    qg = q.reshape(b, sq, kvh, g, d)
    if impl == "chunked" and sq > 1:
        out = _sdpa_chunked(qg, k, v, q_pos, k_pos, causal=causal,
                            window=window, valid_len=valid_len)
    else:
        rel = q_pos[:, None, None, :, None] - k_pos[:, None, None, None, :]
        mask = torch.ones((b, 1, 1, sq, k.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (rel >= 0)
        if window is not None:
            mask = mask & (rel < window)
        if valid_len is not None:
            mask = mask & (torch.arange(k.shape[1], device=q.device)
                           < valid_len[:, None, None, None, None])
        out = _sdpa_reference(qg, k, v, mask)
    out = out.reshape(b, sq, h, d)
    if distributed(out):
        # the heads back over the model axis for the output projection,
        # whose rows a sequence shard would cut unevenly
        return constrain(out, batch_axes(), None, model_axis(), None)
    return out


def attn_block(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
               *, window: int | None, causal: bool = True,
               kv_cache: tuple | None = None, cache_pos: int | None = None,
               mrope_positions=None) -> tuple[torch.Tensor, tuple | None]:
    """Self-attention block (no residual/norm — caller owns those).

    kv_cache: optional (k_cache, v_cache), each (B, S_max, KV, D);
    cache_pos: int — write offset (decode step / prefill fill).
    mrope_positions: optional (3, B, S) M-RoPE ids: the rotary embedding
    takes them, with ``cfg.mrope_sections``; the mask keeps ``positions``.
    Returns (out, cache). The reference returns an updated copy of the
    cache (and its serve loop donates the old one); here the new K/V are
    written in place into ``kv_cache``'s tensors, which are returned.
    """
    b, s, _ = x.shape
    q = project(x, p["wq"])
    k = project(x, p["wk"])
    v = project(x, p["wv"])
    if cfg.use_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if mrope_positions is not None:
        rope_pos, sections = mrope_positions, cfg.mrope_sections
    else:
        rope_pos, sections = positions, None
    q = apply_rope(q, rope_pos, cfg.rope_theta, sections)
    k = apply_rope(k, rope_pos, cfg.rope_theta, sections)
    if positions.dim() == 3:
        positions = positions[0]

    if kv_cache is not None:
        kc, vc = kv_cache
        if shards(kc, 1) > 1:
            # a cache whose sequence a mesh of several devices shards
            write_slice(kc, k.to(kc.dtype), 1, cache_pos)
            write_slice(vc, v.to(vc.dtype), 1, cache_pos)
        else:
            kc[:, cache_pos:cache_pos + s] = k.to(kc.dtype)
            vc[:, cache_pos:cache_pos + s] = v.to(vc.dtype)
        k_full, v_full = kc, vc
        k_pos = torch.arange(kc.shape[1], dtype=torch.int32,
                             device=x.device).expand(b, -1)
        valid = torch.full((b,), cache_pos + s, dtype=torch.int32,
                           device=x.device)
        new_cache = (kc, vc)
    else:
        k_full, v_full = k, v
        k_pos = positions
        valid = None
        new_cache = None

    out = gqa_attention(q, k_full, v_full, positions, k_pos,
                        causal=causal, window=window, valid_len=valid,
                        impl=cfg.attn_impl)
    return _to_residual(project(out, p["wo"], 2)), new_cache


def ring_update(kc: torch.Tensor, vc: torch.Tensor, kpc: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor, cache_pos: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ring-buffer cache write with absolute-position tracking.

    kc/vc: (B, W, KV, hd); kpc: (B, W) int32 absolute positions (−big when
    empty); k/v: (B, S, KV, hd) new entries for positions
    [cache_pos, cache_pos+S). Slot = pos % W; for S > W only the last W
    survive. Written in place into ``kc``, ``vc`` and ``kpc``, which are
    returned (the reference returns updated copies).

    The slot's newest position takes the remainder with the dividend's
    sign (``torch.fmod``, as the reference's ``lax.rem``): when S < W, the
    slots past the last position get a position after it and the K/V of
    the last one. Causality hides them until decode overwrites them; a
    floored remainder would leave them empty, and the cache would differ
    from the reference's.
    """
    w = kpc.shape[1]
    s = k.shape[1]
    if s == 1:
        slot = cache_pos % w          # cache_pos >= 0: the same as rem
        kc[:, slot:slot + 1] = k.to(kc.dtype)
        vc[:, slot:slot + 1] = v.to(vc.dtype)
        kpc.narrow(1, slot, 1).fill_(cache_pos)
        return kc, vc, kpc
    last = cache_pos + s - 1
    j = torch.arange(w, dtype=torch.int32, device=kpc.device)
    p = last - torch.fmod(last - j, w)        # newest pos <= last in slot j
    take = p >= cache_pos                     # slot overwritten by this call
    rel = torch.clamp(p - cache_pos, 0, s - 1).long()
    sel = take[None, :, None, None]
    kc.copy_(torch.where(sel, k.index_select(1, rel).to(kc.dtype), kc))
    vc.copy_(torch.where(sel, v.index_select(1, rel).to(vc.dtype), vc))
    kpc.copy_(torch.where(take[None, :], p[None, :], kpc))
    return kc, vc, kpc


def attn_block_ring(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                    ring: tuple, cache_pos: int, window: int
                    ) -> tuple[torch.Tensor, tuple]:
    """Sliding-window attention against a ring cache (window_cache mode).

    Decode (S == 1): write-then-attend over the W ring slots, masking by
    the *stored absolute positions* (ring order is irrelevant to a position
    mask). Prefill (S > 1, cache_pos == 0, as in the reference): attend
    within the sequence through ``cfg.attn_impl``, then ring-write the
    tail. The ring is written in place and returned.
    """
    s = x.shape[1]
    kc, vc, kpc = ring
    q = project(x, p["wq"])
    k = project(x, p["wk"])
    v = project(x, p["wv"])
    if cfg.use_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if s == 1:
        ring_update(kc, vc, kpc, k, v, cache_pos)
        out = gqa_attention(q, kc, vc, positions, kpc, causal=True,
                            window=window, impl="reference")
    else:
        if cache_pos != 0:
            # attending within the sequence would miss the ring's older keys
            raise ValueError(f"attn_block_ring: a prefill (S = {s}) must "
                             f"start at position 0, not {cache_pos}")
        out = gqa_attention(q, k, v, positions, positions, causal=True,
                            window=window, impl=cfg.attn_impl)
        ring_update(kc, vc, kpc, k, v, cache_pos)
    return _to_residual(project(out, p["wo"], 2)), (kc, vc, kpc)


def cross_attn_block(cfg, p: dict, x: torch.Tensor, enc: torch.Tensor
                     ) -> torch.Tensor:
    """Encoder-decoder cross-attention: queries from ``x`` (B, S, d), keys
    and values projected from ``enc`` (B, S_enc, d) on every call (no
    cache: ``enc`` is static). Every position is 0 and nothing is masked
    (``causal=False``, no window), through the plain ``"reference"``
    attention whatever ``cfg.attn_impl`` says. As in the reference, the
    ``bq``/``bk``/``bv`` biases of a ``use_bias`` config are not added
    here."""
    b, s, _ = x.shape
    q = project(x, p["wq"])
    k = project(enc, p["wk"])
    v = project(enc, p["wv"])
    # over the batch axes on a mesh of several devices, plain otherwise
    bd = batch_axes()
    q_pos = full((b, s), 0, bd, None, dtype=torch.int32, device=x.device)
    k_pos = full((b, enc.shape[1]), 0, bd, None, dtype=torch.int32,
                 device=x.device)
    out = gqa_attention(q, k, v, q_pos, k_pos, causal=False, window=None,
                        impl="reference")
    return _to_residual(project(out, p["wo"], 2))


# --------------------------------------------------------------------------- mlp
def mlp_defs(d: int, d_ff: int) -> dict:
    return {
        "w_gate": P((d, d_ff), ("embed", "mlp")),
        "w_up": P((d, d_ff), ("embed", "mlp")),
        "w_down": P((d_ff, d), ("mlp", "embed")),
    }


def mlp_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(project(x, p["w_gate"])) * project(x, p["w_up"])
    return _to_residual(project(h, p["w_down"]))
