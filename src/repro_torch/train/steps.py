"""Train / prefill / decode steps (twin of the JAX package's
``train/steps.py``).

``train_step`` is one optimizer step: gradient accumulation over
``cfg.grad_accum`` microbatches with fp32 accumulators, global-norm
clipping, the 1-indexed warmup-cosine schedule and AdamW (fp32 moments).
Gradients come from ``torch.autograd``; the RMSNorm kernel contributes
its own backward kernel (``kernels/rmsnorm/ops.py`` ``RMSNormFn``), and
every stack checkpoints each layer (the hybrid stack each group, whisper
each encoder and decoder layer) as ``cfg.remat`` says: ``"none"``,
``"block"`` or ``"dots"``, which also keeps the outputs of the products
with no batch dimension (``models/lm.py`` ``_maybe_remat``).
Every family trains (the vlm batch adds ``vision_embeds`` and
``mrope_positions``, the audio batch ``frames``, each split into
microbatches as the reference splits them); the ssm and hybrid families'
SSD chunk kernel is an ``autograd.Function`` whose backward is a kernel
too (``kernels/ssd/ops.py`` ``SSDChunkFn``), and the MoE and hybrid
families' ``moe_block`` has a backward with no accumulating scatter
(``models/moe.py``); their loss adds ``0.01 · aux_loss``, the sum of the
MoE layers' load-balancing losses, as the reference's does. Attention
trains through the plain paths: the FlashAttention kernel has no backward
yet (queue 2), so ``attn_impl="flash"`` is refused.

``prefill_step`` builds the KV cache from a full prompt in one forward
(for the audio family, after encoding the frames, whose output the cache
keeps); ``decode_step`` advances one token against it.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..core.tree import tree_flatten, tree_map, tree_unflatten
from ..models import encdec, lm, registry
from ..models.config import ArchConfig
from ..optim import adamw, schedules
from ..sharding.activation import (batch_axes, constrain, distributed,
                                   laid_out_as, model_axis, on_mesh,
                                   splittable)


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     device: torch.device | str) -> TrainState:
    """Params from ``registry.init`` (``generator`` lives on ``device``)
    and zero AdamW moments."""
    params = registry.init(cfg, generator, device)
    return TrainState(params=params, opt=adamw.init(params))


def _require_trainable(cfg: ArchConfig) -> None:
    if cfg.attn_impl == "flash":
        raise NotImplementedError(
            "the FlashAttention kernel has no backward yet (ROADMAP queue 2): "
            "train with attn_impl='chunked' or 'reference'")


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def _batch_layout(key: str, x: torch.Tensor) -> torch.Tensor:
    """A batch leaf laid out over the batch axes (dim 1 of
    ``mrope_positions``, dim 0 of the rest): ``x`` itself with no mesh
    and on a mesh of one device."""
    lead = (None,) if key == "mrope_positions" else ()
    return constrain(x, *lead, batch_axes(),
                     *[None] * (x.ndim - 1 - len(lead)))


def _gold(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The logit of each target: a gather over the vocab. A DTensor on a
    mesh of several devices takes it as the reference's one-hot product
    does, a masked sum over the vocab, each device over its own shard of
    the vocab: DTensor's gather there would make the whole (rows, vocab)
    gradient on every device."""
    if distributed(logits):
        vocab = on_mesh(torch.arange(logits.shape[-1], device=logits.device),
                        model_axis())
        hit = targets[..., None] == vocab
        return torch.where(hit, logits, 0).sum(-1)
    return logits.gather(-1, targets[..., None].long())[..., 0]


def _xent(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
          impl: str = "gather") -> torch.Tensor:
    if impl == "onehot":
        # The reference contracts the logits with a one-hot in the logits'
        # dtype; a product by exact ones and zeros picks the gold logit
        # exactly, so a gather gives the same bits, and the same gradient
        # (the one-hot scatter of the gold cotangent).
        m = logits.amax(-1, keepdim=True).detach()
        shifted = (logits - m).to(torch.float32)
        logz = torch.log(torch.exp(shifted).sum(-1)) + m[..., 0].to(torch.float32)
        gold = _gold(logits, targets)
        nll = (logz - gold.to(torch.float32)) * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, -1)
    gold = _gold(logits, targets)
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(cfg: ArchConfig, params: Any, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """batch keys: tokens (B, S) [+ loss_mask, frames, vision_embeds,
    mrope_positions]. Next-token LM loss (teacher-forced for enc-dec).
    Returns (loss + 0.01·aux, {"loss", "aux_loss"})."""
    _require_trainable(cfg)
    tokens = batch["tokens"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = on_mesh(torch.ones(tokens.shape, dtype=torch.float32,
                                  device=tokens.device), batch_axes(), None)
    if cfg.family == "audio":
        out = encdec.forward(cfg, params, batch["frames"], tokens)
    else:
        out = lm.forward(cfg, params, tokens,
                         vision_embeds=batch.get("vision_embeds"),
                         mrope_positions=batch.get("mrope_positions"))
    logits = out.logits[:, :-1]
    targets = tokens[:, 1:]
    loss = _xent(logits, targets, mask[:, 1:], impl=cfg.xent_impl)
    aux = 0.01 * out.aux_loss
    return loss + aux, {"loss": loss, "aux_loss": out.aux_loss}


def value_and_grad(cfg: ArchConfig, params: Any, batch: dict
                   ) -> tuple[dict, Any]:
    """(metrics, grads) of ``loss_fn`` at ``params``: the twin of
    ``jax.value_and_grad(..., has_aux=True)``. Grads are in each param's
    dtype; a leaf the loss does not reach gets zeros, as in JAX (the audio
    family's cross-attention biases: ``layers.cross_attn_block`` adds none).
    ``params`` are left as they are (the graph is built on detached
    aliases of them)."""
    flat, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        total, metrics = loss_fn(cfg, tree_unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else laid_out_as(g, p)
             for p, g in zip(leaves, grads)]
    return ({k: v.detach() for k, v in metrics.items()},
            tree_unflatten(treedef, grads))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
def train_step(cfg: ArchConfig, state: TrainState, batch: dict, *,
               peak_lr: float = 3e-4, warmup_steps: int = 100,
               total_steps: int = 10_000, clip_norm: float = 1.0
               ) -> tuple[TrainState, dict]:
    """One optimizer step. Returns the new state (``state`` is left as it
    is) and the metrics ``loss``, ``aux_loss``, ``grad_norm``, ``lr`` and
    ``step``, as 0-d fp32 tensors on the state's device."""
    _require_trainable(cfg)
    accum = max(cfg.grad_accum, 1)
    if accum == 1:
        metrics, grads = value_and_grad(cfg, state.params, batch)
        grads = tree_map(lambda g: g.to(torch.float32), grads)
    else:
        # on a mesh of several devices the batch is gathered for the split
        # (its shards do not divide ``accum``) and each microbatch laid
        # out over the batch axes again (a local cut); else as it is
        micro = {}
        for k, v in batch.items():
            if k == "mrope_positions":   # (3, B, S) -> (accum, 3, B/a, S)
                micro[k] = splittable(v, None, accum).reshape(
                    3, accum, -1, v.shape[-1]).movedim(1, 0)
            else:
                micro[k] = splittable(v, accum).reshape(
                    (accum, v.shape[0] // accum) + v.shape[1:])
        grads = tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.float32, memory_format=torch.contiguous_format),
            state.params)
        metrics = {k: torch.zeros((), dtype=torch.float32,
                                  device=batch["tokens"].device)
                   for k in ("loss", "aux_loss")}
        for i in range(accum):
            m_i, g_i = value_and_grad(cfg, state.params, {
                k: _batch_layout(k, v[i]) for k, v in micro.items()})
            grads = tree_map(lambda a, g: a + g.to(torch.float32), grads, g_i)
            metrics = {k: metrics[k] + m_i[k] / accum for k in metrics}
            del g_i
        grads = tree_map(lambda g: g / accum, grads)

    grads, gnorm = adamw.clip_by_global_norm(grads, clip_norm)
    # schedule is 1-indexed: step 0 would otherwise get lr == 0
    lr = schedules.warmup_cosine(
        state.opt.step + 1, peak_lr=peak_lr, warmup_steps=warmup_steps,
        total_steps=total_steps)
    new_params, new_opt = adamw.update(state.params, grads, state.opt, lr=lr)
    metrics = dict(metrics, grad_norm=gnorm, lr=lr,
                   step=new_opt.step.to(torch.float32))
    return TrainState(params=new_params, opt=new_opt), metrics


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------
def prefill_step(cfg: ArchConfig, params: Any, batch: dict, *,
                 max_len: int) -> tuple[torch.Tensor, Any]:
    """Build the cache from a full prompt (``batch``: tokens [+ frames,
    vision_embeds, mrope_positions]). Returns (last logits, cache)."""
    tokens = batch["tokens"]
    b, _ = tokens.shape
    if cfg.family == "audio":
        enc_out = encdec.encode(cfg, params, batch["frames"])
        cache = encdec.init_cache(cfg, b, max_len, enc_len=enc_out.shape[1],
                                  device=tokens.device)
        out = encdec.decode(cfg, params, tokens, enc_out, cache=cache)
    else:
        cache = registry.init_cache(cfg, b, max_len, tokens.device)
        out = lm.forward(cfg, params, tokens, cache=cache,
                         vision_embeds=batch.get("vision_embeds"),
                         mrope_positions=batch.get("mrope_positions"))
    return out.logits[:, -1], out.cache


def decode_step(cfg: ArchConfig, params: Any, token: torch.Tensor,
                cache: Any) -> tuple[torch.Tensor, Any]:
    """One token against the cache (updated in place). token: (B, 1).
    Returns (logits, cache)."""
    if cfg.family == "audio":
        out = encdec.decode(cfg, params, token, cache["enc_out"], cache=cache)
    else:
        out = lm.forward(cfg, params, token, cache=cache)
    return out.logits[:, 0], out.cache
