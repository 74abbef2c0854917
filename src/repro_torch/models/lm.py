"""Decoder-only LM: the dense, MoE, vlm, ssm and hybrid families (twin of
the JAX package's ``models/lm.py``), the dense family's windowed configs
(gemma3) included.

The reference scans stacked ``blocks`` with ``jax.lax.scan``; here a Python
loop walks the layer index over the same stacked tensors. The caches are
stacked tensors written in place layer by layer (the reference's serve loop
donates its cache instead): for the dense family one (layers, B, S_max, KV,
D) tensor per K and V, for the ssm family the conv state (layers, B, K-1,
C) and the SSM state (layers, B, H, P, N). A windowed config with
``window_cache`` keeps the reference's ring caches instead: groups of
``global_every - 1`` local layers with ``min(window, max_len)`` ring slots
and their absolute positions, one global layer with a full-length cache,
and a tail of ``num_layers % global_every`` local layers
(``_windowed_stack``; without a cache such a config runs the uniform
stack with per-layer windows, as the reference does). The ssm stack runs
its blocks with ``use_kernel=True``, so prefill goes through the SSD chunk
kernel (the reference's stack leaves it off). The MoE family's layers
run ``models/moe.py`` ``moe_block`` in place of the MLP, and ``forward``
returns the sum of their load-balancing losses as ``aux_loss``, as the
reference's scan carries it.

The vlm family (qwen2-vl) is the dense stack with two more inputs:
``vision_embeds`` replace the first embeddings of the sequence, and
``mrope_positions`` (3, B, S) drive the rotary embedding through
``cfg.mrope_sections`` (M-RoPE). As in the reference, only the
homogeneous attention stack sees them, and a decode step, which passes
neither, continues from the cache's plain positions. The hybrid family
(jamba) stacks its parameters by group: ``groups`` is a list of
``attn_every`` layer trees (Mamba-2 layers, then one attention layer), each
stacked over the groups; its cache holds one full-length K/V per group and
the SSM states (groups, attn_every - 1, ...). ``_hybrid_stack`` runs the
SSM layers through the SSD chunk kernel as the ssm stack does, and the MoE
FFN where ``cfg.layer_is_moe`` says, counted within the group.

For training, each layer of the dense, MoE and ssm stacks, and each
group of the hybrid stack, runs under ``torch.utils.checkpoint`` where
the reference wraps its scan body in ``jax.checkpoint`` (``_maybe_remat``,
``cfg.remat``: ``"block"`` saves the body's inputs, ``"dots"`` also the
outputs of its products with no batch dimension, through selective
activation checkpointing), and only where grad mode is on and there is
no cache, so serving is unchanged. The ssm and hybrid families train
through the SSD chunk kernel and its backward kernel, the MoE and hybrid
families through ``moe_block``'s gather-only backward. A recompute routes
as the forward did: it runs the same arithmetic on the same inputs, so
its top-k picks are the forward's (the CPU tests and the card hold them
alike), and the aux loss rides in the checkpointed function's outputs.

The residual stream and the logits go through ``constrain`` where the
reference constrains them (after the embedding, after each layer or
group, the logits over the batch axes): under a mesh of one device, and
with none, each call returns its input itself.

The audio family is an encoder-decoder and lives in ``encdec.py``
(``registry`` dispatches to it); ``lm.py`` refuses its configs.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from ..sharding.activation import (batch_axes, cache_leaf, carried,
                                   constrain, distributed, model_axis,
                                   on_mesh)
from . import layers, moe as moe_lib, ssd as ssd_lib
from .config import ArchConfig
from .params import P, init_params, tree_map


class LMOut(NamedTuple):
    logits: torch.Tensor
    cache: Any
    aux_loss: torch.Tensor


def _require_decoder_only(cfg: ArchConfig) -> None:
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name}: the audio family is an encoder-decoder; use "
            "models.encdec (models.registry dispatches to it)")


# ---------------------------------------------------------------------------
# parameter definitions
# ---------------------------------------------------------------------------
def _is_moe(cfg: ArchConfig) -> bool:
    """Whether every layer of the homogeneous stack runs the MoE FFN (the
    hybrid family picks it per layer of a group, ``_group_defs``)."""
    return cfg.moe is not None and cfg.moe.every_k_layers == 1


def _ffn_defs(cfg: ArchConfig, is_moe: bool) -> dict:
    if is_moe:
        return {"ln2": layers.rmsnorm_defs(cfg.d_model),
                "moe": moe_lib.moe_defs(cfg.d_model, cfg.moe)}
    if cfg.d_ff:
        return {"ln2": layers.rmsnorm_defs(cfg.d_model),
                "mlp": layers.mlp_defs(cfg.d_model, cfg.d_ff)}
    return {}


def _attn_layer_defs(cfg: ArchConfig, is_moe: bool) -> dict:
    return {"ln1": layers.rmsnorm_defs(cfg.d_model),
            "attn": layers.attention_defs(cfg),
            **_ffn_defs(cfg, is_moe)}


def _ssm_layer_defs(cfg: ArchConfig, with_ffn: bool, is_moe: bool) -> dict:
    d = {"ln1": layers.rmsnorm_defs(cfg.d_model),
         "ssm": ssd_lib.ssm_defs(cfg.d_model, cfg.ssm)}
    if with_ffn:
        d.update(_ffn_defs(cfg, is_moe))
    return d


def _stack(defs: Any, n: int) -> Any:
    """Prepend a 'layers' dim to every P leaf."""
    return tree_map(lambda p: P((n,) + p.shape, ("layers",) + p.axes, p.init,
                                p.scale, p.dtype), defs)


def _n_groups(cfg: ArchConfig) -> int:
    return cfg.num_layers // cfg.attn_every


def _group_defs(cfg: ArchConfig) -> list[dict]:
    """A jamba group of ``attn_every`` layers: SSM layers, attention last,
    each with an FFN that is MoE where ``cfg.layer_is_moe(i)`` (``i``
    counted within the group)."""
    last = cfg.attn_every - 1
    return [_attn_layer_defs(cfg, cfg.layer_is_moe(i)) if i == last
            else _ssm_layer_defs(cfg, True, cfg.layer_is_moe(i))
            for i in range(cfg.attn_every)]


def param_defs(cfg: ArchConfig) -> dict:
    _require_decoder_only(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    defs: dict = {
        "embed": P((v, d), ("vocab", "embed")),
        "final_norm": layers.rmsnorm_defs(d),
    }
    if cfg.family == "hybrid":
        defs["groups"] = _stack(_group_defs(cfg), _n_groups(cfg))
    elif cfg.family == "ssm":
        defs["blocks"] = _stack(_ssm_layer_defs(cfg, bool(cfg.d_ff), False),
                                cfg.num_layers)
    else:
        defs["blocks"] = _stack(_attn_layer_defs(cfg, _is_moe(cfg)),
                                cfg.num_layers)
    if not cfg.tie_embeddings:
        defs["lm_head"] = P((d, v), ("embed", "vocab"))
    return defs


def init(cfg: ArchConfig, generator: torch.Generator,
         device: torch.device | str) -> dict:
    return init_params(param_defs(cfg), generator, device)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def _windowed(cfg: ArchConfig) -> bool:
    """Whether ``cfg`` keeps ring caches for its local layers."""
    return bool(cfg.window_cache and cfg.window is not None
                and cfg.global_every)


def _window_groups(cfg: ArchConfig) -> tuple[int, int, int]:
    """(n_full_groups, group_size, n_tail_local) for window_cache mode."""
    g = cfg.global_every
    n_groups = cfg.num_layers // g
    tail = cfg.num_layers - n_groups * g
    return n_groups, g, tail


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device | str) -> dict:
    """Dense KV cache, the ring caches of a windowed config with
    ``window_cache``, the ssm family's conv and SSM states, or the hybrid
    family's K/V per group and SSM states per group and SSM layer: the
    reference's leaves, shapes, dtypes and fill values. ``pos`` (the next
    write offset) is a host int."""
    _require_decoder_only(cfg)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def leaf(name, shape, dtype=torch.bfloat16, fill=0):
        # on a mesh of several devices, laid out as the reference's
        # prefill lays its cache out; a plain tensor otherwise
        return cache_leaf(name, shape, fill, dtype, device, batch)

    if cfg.family == "hybrid":
        ng, n_ssm = _n_groups(cfg), cfg.attn_every - 1
        conv, h = ssd_lib.init_ssm_state(cfg, cfg.ssm, batch, "meta")
        shape = (ng, batch, max_len, kvh, hd)
        return {
            "k": leaf("k", shape),
            "v": leaf("v", shape),
            "conv": leaf("conv", (ng, n_ssm) + conv.shape, conv.dtype),
            "h": leaf("h", (ng, n_ssm) + h.shape, h.dtype),
            "pos": 0,
        }
    if cfg.family == "ssm":
        conv, h = ssd_lib.init_ssm_state(cfg, cfg.ssm, batch, "meta")
        return {
            "conv": leaf("conv", (cfg.num_layers,) + conv.shape, conv.dtype),
            "h": leaf("h", (cfg.num_layers,) + h.shape, h.dtype),
            "pos": 0,
        }
    if _windowed(cfg):
        ng, g, tail = _window_groups(cfg)
        w = min(cfg.window, max_len)
        neg = -(1 << 30)
        return {
            # local layers: ring buffers of `w` slots + absolute positions
            "kl": leaf("kl", (ng, g - 1, batch, w, kvh, hd)),
            "vl": leaf("vl", (ng, g - 1, batch, w, kvh, hd)),
            "kpl": leaf("kpl", (ng, g - 1, batch, w), torch.int32, neg),
            # global layers: full-length caches
            "kg": leaf("kg", (ng, 1, batch, max_len, kvh, hd)),
            "vg": leaf("vg", (ng, 1, batch, max_len, kvh, hd)),
            # tail local layers (num_layers % global_every)
            "kt": leaf("kt", (tail, batch, w, kvh, hd)),
            "vt": leaf("vt", (tail, batch, w, kvh, hd)),
            "kpt": leaf("kpt", (tail, batch, w), torch.int32, neg),
            "pos": 0,
        }
    shape = (cfg.num_layers, batch, max_len, kvh, hd)
    return {"k": leaf("k", shape), "v": leaf("v", shape), "pos": 0}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def embed_lookup(cfg: ArchConfig, table: torch.Tensor, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """Embedding lookup. The reference's ``embed_impl="onehot"`` is a bf16
    one-hot matmul, which reproduces the table row exactly; an index lookup
    gives the same bits for either setting. A DTensor table on a mesh of
    several devices takes the one-hot product, each device over its shard
    of the vocab: DTensor's index and embedding backwards fail on a table
    sharded over the vocab."""
    if distributed(table):
        vocab = on_mesh(torch.arange(table.shape[0], device=table.device),
                        model_axis())
        hit = (tokens[..., None] == vocab).to(torch.bfloat16)
        return torch.einsum("bsv,vd->bsd", hit, table.to(torch.bfloat16))
    return table.to(torch.bfloat16)[tokens.long()]


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """The twin of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
    for ``create_selective_checkpoint_contexts``: save the output of every
    product with no batch dimension, recompute everything else. Those
    products are the ones that run as ``mm`` (``layers.project``, and
    ``x @ W`` with a 2-D ``W``: the MLP, the Mamba-2 projections, the MoE
    router and shared gate). A ``torch.einsum`` of such a product would run
    as a ``bmm`` with a batch of 1, the op of the batched products
    (attention's logits and PV, the experts, the plain SSD scan), which
    the reference recomputes: so ``bmm`` is never saved."""
    if op in _SAVED_BY_DOTS:
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    return torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ArchConfig):
    """``fn`` under the activation checkpointing ``cfg.remat`` names:
    ``"none"`` keeps it as it is; ``"block"`` (and ``"full"``, which the
    reference treats alike) recomputes it in the backward, saving only its
    inputs (``jax.checkpoint``'s default); ``"dots"`` also saves the
    outputs of its products with no batch dimension (``_dots_policy``)
    and recomputes the rest. The recompute runs under the mesh and batch
    axes of the forward (``carried``). A torch without selective
    checkpointing cannot run ``"dots"``, and raises."""
    if cfg.remat == "none":
        return fn
    kwargs = {}
    if cfg.remat == "dots":
        make = getattr(torch.utils.checkpoint,
                       "create_selective_checkpoint_contexts", None)
        if make is None:
            raise NotImplementedError(
                f"remat='dots' needs torch.utils.checkpoint's selective "
                f"checkpointing, which torch {torch.__version__} lacks")
        kwargs["context_fn"] = functools.partial(make, _dots_policy)
    return lambda *args: torch.utils.checkpoint.checkpoint(
        carried(fn), *args, use_reentrant=False, **kwargs)


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            positions: torch.Tensor | None = None,
            vision_embeds: torch.Tensor | None = None,
            mrope_positions: torch.Tensor | None = None,
            cache: dict | None = None) -> LMOut:
    """Token forward. tokens: (B, S) integer.

    With ``cache``: writes K/V (or the SSM states) at ``cache['pos']`` (in
    place) and returns the cache with ``pos`` advanced — S == 1 is the
    decode step, S > 1 prefill. ``vision_embeds`` (B, npatch, D) replace
    the first ``npatch`` token embeddings; ``mrope_positions`` (3, B, S)
    are the rotary ids of the homogeneous attention stack (vlm).
    """
    _require_decoder_only(cfg)
    b, s = tokens.shape
    h = embed_lookup(cfg, params["embed"], tokens)
    if vision_embeds is not None:
        npatch = vision_embeds.shape[1]
        h = torch.cat([vision_embeds.to(h.dtype), h[:, npatch:]], dim=1)
    base = cache["pos"] if cache is not None else 0
    if positions is None:
        positions = torch.arange(base, base + s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    positions = on_mesh(positions, batch_axes(), None)
    h = constrain(h, batch_axes(), None, None)

    if cfg.family == "hybrid":
        h, new_cache, aux = _hybrid_stack(cfg, params, h, positions, cache)
    elif cfg.family == "ssm":
        h, new_cache, aux = _ssm_stack(cfg, params, h, positions, cache)
    elif cache is not None and _windowed(cfg):
        h, new_cache, aux = _windowed_stack(cfg, params, h, positions, cache)
    else:
        h, new_cache, aux = _attn_stack(cfg, params, h, positions, cache,
                                        mrope_positions)

    h = layers.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = torch.einsum("bsd,dv->bsv", h, head.to(h.dtype))
    logits = constrain(logits, batch_axes(), None,
                       None if "model" in batch_axes() else "model")
    if new_cache is not None:
        new_cache["pos"] = base + s
    return LMOut(logits=logits, cache=new_cache, aux_loss=aux)


def _unstack(tree: Any, n: int) -> list:
    """The stacked ``blocks`` tree as ``n`` per-layer trees of views, one
    ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where indexing each layer would add a zero-filled gradient of the whole
    stacked leaf per layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _ffn(cfg: ArchConfig, p: dict, h: torch.Tensor, aux: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The FFN the layer's parameters hold (the MoE block or the MLP, as
    its defs chose) added to the residual stream, and ``aux`` plus the MoE
    block's load-balancing loss. The MoE block's form follows
    ``cfg.moe_impl``, as in the reference: ``"shard_map"`` expert tensor
    parallelism, ``"a2a"`` expert parallelism, anything else the block on
    whole tensors (each form is ``moe_block`` with no mesh)."""
    if "moe" in p:
        x = layers.rmsnorm(h, p["ln2"], cfg.norm_eps)
        moe_fn = {"shard_map": moe_lib.moe_block_sharded,
                  "a2a": moe_lib.moe_block_a2a}.get(cfg.moe_impl,
                                                    moe_lib.moe_block)
        out, a = moe_fn(cfg.moe, p["moe"], x)
        return h + out, aux + a
    if "mlp" in p:
        x = layers.rmsnorm(h, p["ln2"], cfg.norm_eps)
        h = h + layers.mlp_block(p["mlp"], x)
    return h, aux


def _no_aux(h: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=h.device)


# --- homogeneous attention stack (dense, moe, vlm) -------------------------------
def _attn_stack(cfg, params, h, positions, cache, mrope_positions):
    blocks = params["blocks"]
    has_cache = cache is not None

    def body(h, aux, p, window, kv_cache):
        x = layers.rmsnorm(h, p["ln1"], cfg.norm_eps)
        attn_out, _ = layers.attn_block(
            cfg, p["attn"], x, positions, window=window, kv_cache=kv_cache,
            cache_pos=cache["pos"] if has_cache else None,
            mrope_positions=mrope_positions)
        h, aux = _ffn(cfg, p, h + attn_out, aux)
        return constrain(h, batch_axes(), None, None), aux

    if torch.is_grad_enabled() and not has_cache:
        body = _maybe_remat(body, cfg)
    aux = _no_aux(h)
    for i, p in enumerate(_unstack(blocks, cfg.num_layers)):
        window = cfg.layer_window(i)
        h, aux = body(h, aux, p,
                      window if window is not None else layers.GLOBAL_WINDOW,
                      (cache["k"][i], cache["v"][i]) if has_cache else None)
    new_cache = None
    if has_cache:
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"]}
    return h, new_cache, aux


# --- windowed group stack (gemma3 window_cache mode) ---------------------------
def _windowed_stack(cfg, params, h, positions, cache):
    """Groups of [(global_every − 1) × local-ring, 1 × global] layers, plus
    a tail of local layers: ring caches for locals, a full cache for
    globals, each written in place. Serving only: the cache is always
    there, so nothing is checkpointed."""
    ng, g, tail = _window_groups(cfg)
    base = cache["pos"]
    w = cfg.window

    def local(p, h, aux, ring):
        x = layers.rmsnorm(h, p["ln1"], cfg.norm_eps)
        out, _ = layers.attn_block_ring(cfg, p["attn"], x, positions, ring,
                                        base, w)
        return _ffn(cfg, p, h + out, aux)

    blocks = _unstack(params["blocks"], cfg.num_layers)
    aux = _no_aux(h)
    for gi in range(ng):
        for i in range(g - 1):
            h, aux = local(blocks[gi * g + i], h, aux, (cache["kl"][gi, i],
                                                        cache["vl"][gi, i],
                                                        cache["kpl"][gi, i]))
        p = blocks[gi * g + g - 1]
        x = layers.rmsnorm(h, p["ln1"], cfg.norm_eps)
        out, _ = layers.attn_block(
            cfg, p["attn"], x, positions, window=None,
            kv_cache=(cache["kg"][gi, 0], cache["vg"][gi, 0]), cache_pos=base)
        h, aux = _ffn(cfg, p, h + out, aux)
        h = constrain(h, batch_axes(), None, None)
    for i in range(tail):
        h, aux = local(blocks[ng * g + i], h, aux,
                       (cache["kt"][i], cache["vt"][i], cache["kpt"][i]))
    h = constrain(h, batch_axes(), None, None)
    return h, dict(cache), aux


# --- ssm stack (mamba2) ---------------------------------------------------------
def _ssm_stack(cfg, params, h, positions, cache):
    blocks = params["blocks"]
    has_cache = cache is not None

    def body(h, aux, p, state):
        x = layers.rmsnorm(h, p["ln1"], cfg.norm_eps)
        out, new_state = ssd_lib.ssm_block(cfg, cfg.ssm, p["ssm"], x, state,
                                           use_kernel=True)
        h, aux = _ffn(cfg, p, h + out, aux)
        return constrain(h, batch_axes(), None, None), aux, new_state

    if torch.is_grad_enabled() and not has_cache:
        body = _maybe_remat(body, cfg)
    aux = _no_aux(h)
    for i, p in enumerate(_unstack(blocks, cfg.num_layers)):
        state = (cache["conv"][i], cache["h"][i]) if has_cache else None
        h, aux, (conv, hst) = body(h, aux, p, state)
        if has_cache:
            cache["conv"][i].copy_(conv)
            cache["h"][i].copy_(hst)
    new_cache = None
    if has_cache:
        new_cache = {"conv": cache["conv"], "h": cache["h"], "pos": cache["pos"]}
    return h, new_cache, aux


# --- hybrid group stack (jamba) -------------------------------------------------
def _hybrid_stack(cfg, params, h, positions, cache):
    """Groups of ``attn_every`` layers: Mamba-2 layers through the SSD
    chunk kernel (``use_kernel=True``, as ``_ssm_stack``), then one
    attention layer over the group's full-length cache, each followed by
    its FFN (``_ffn``: MoE where the group's defs put it, adding its aux
    loss). With a cache (serving) the attention layer writes its K/V in
    place and the SSM states are copied into the cache after the group
    has run. Without one, where grad mode is on, each group runs under
    ``_maybe_remat``, as the reference wraps its whole group body: the
    backward recomputes a group from its input, and a recompute writes
    no cache."""
    has_cache = cache is not None
    ng, n_ssm = _n_groups(cfg), cfg.attn_every - 1
    sublayers = [_unstack(tree, ng) for tree in params["groups"]]

    def group(h, aux, gp, g):
        states = []
        for i, p in enumerate(gp):
            x = layers.rmsnorm(h, p["ln1"], cfg.norm_eps)
            if i < n_ssm:
                state = ((cache["conv"][g, i], cache["h"][g, i]) if has_cache
                         else None)
                out, new_state = ssd_lib.ssm_block(
                    cfg, cfg.ssm, p["ssm"], x, state, use_kernel=True)
                states.append(new_state)
            else:
                out, _ = layers.attn_block(
                    cfg, p["attn"], x, positions, window=None,
                    kv_cache=(cache["k"][g], cache["v"][g]) if has_cache
                    else None,
                    cache_pos=cache["pos"] if has_cache else None)
            h, aux = _ffn(cfg, p, h + out, aux)
        return constrain(h, batch_axes(), None, None), aux, states

    def body(h, aux, gp, g):
        return group(h, aux, gp, g)[:2]

    if torch.is_grad_enabled() and not has_cache:
        body = _maybe_remat(body, cfg)
    aux = _no_aux(h)
    for g in range(ng):
        gp = [sublayers[i][g] for i in range(cfg.attn_every)]
        if not has_cache:
            h, aux = body(h, aux, gp, g)
            continue
        h, aux, states = group(h, aux, gp, g)
        for i, (conv, hst) in enumerate(states):
            cache["conv"][g, i].copy_(conv)
            cache["h"][g, i].copy_(hst)
    return h, dict(cache) if has_cache else None, aux
