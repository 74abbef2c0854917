"""Mixture-of-Experts FFN (twin of the JAX package's ``models/moe.py``).

The reference's sort-based capacity dispatch, step for step:

  1. route with top-k over the fp32 router's softmax (ties to the lower
     expert index, as ``lax.top_k`` breaks them),
  2. flatten the (token, k) assignments and sort them stably by expert id,
  3. rank each assignment within its expert; an assignment whose rank
     reaches the capacity ``round(n·k/E·cf)`` (Python's ``round``, at least
     1) is dropped, so the capacity follows the tokens of the call: at
     batch 4 a decode step runs with capacity 1 per expert,
  4. run the experts' gated MLPs as batched matmuls over E (``torch.bmm``;
     plain matrix products, which the reference computes outside any
     Pallas kernel), and
  5. combine each token's kept outputs, times their gates.

Two steps are written without a scatter, so that nothing reduces in an
order the card picks (a float atomic) and the host never waits on the
card (``bincount`` on a CUDA tensor reads its maximum back):

  * each expert's first sorted row (the reference's ``cumsum(bincount)``
    shifted by one) comes from ``searchsorted`` over the sorted ids, and
    the (expert, slot) → token table from a gather of those rows, which
    fills the same slots the reference's ``.at[slot].set`` fills;
  * the combine (the reference's float ``.at[st].add``) is a fixed-order
    sum of each token's k rows: the reference's scatter visits a token's
    rows in sorted order, ascending expert id, adding each to the bf16
    output in turn, and so does the sum here.

Training adds the backward, and it too has no accumulating scatter. The
two row reads of the block are ``autograd.Function``s whose backward is a
gather through the other table (an index read's own backward is an
accumulating index write, which adds with float atomics on the card):

  * the dispatch ``xe[slot] = xt[token_for_slot[slot]]`` (``_Dispatch``):
    ``dxt[t]`` is the sum of its kept slots' cotangents, gathered through
    ``flat_slot`` and added in the combine's order (ascending expert id,
    rounding to the operand dtype after each add). That is the order of
    the reference's transpose, a scatter-add that visits the slots in
    ascending order, so given the same cotangent it gives its bits (the
    CPU tests hold them). An unfilled slot is never visited: ``xe`` is
    multiplied by ``filled``, so its cotangent is 0;
  * the combine's read ``y[t, j] = ye[flat_slot[t, j]]`` (``_SlotRead``):
    each filled slot holds one assignment, so ``dye[slot]`` is that
    assignment's cotangent, gathered through ``flat_for_slot``, and 0 for
    an unfilled slot (the reference adds its dropped rows' zero
    cotangents into the last slot, which leaves it as it is).

The rest of the block's backward is deterministic as it stands: the
sort's backward (a permutation: each element written once), the combine's
per-row ``gather`` (its backward adds each row into a zero row at
distinct indices: one add an element), the batched matmuls and the fp32
router's matmul, softmax and means (fixed-order reductions). So two
backward passes on the same inputs give the same bits on the card.

``moe_block_sharded``/``moe_block_a2a`` (the reference's ``shard_map``
and all-to-all forms) are ROADMAP queue 1 item 9c; without a mesh the
reference falls back to ``moe_block`` (on a mesh of one device its
``shard_map`` form computes the same function), and ``models/lm.py``
runs ``moe_block`` for every ``moe_impl``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import layers
from .config import MoECfg
from .params import P


def moe_defs(d: int, mcfg: MoECfg) -> dict:
    e, f = mcfg.num_experts, mcfg.expert_d_ff
    defs = {
        "router": P((d, e), ("embed", None), dtype=torch.float32),
        "w_gate": P((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_up": P((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_down": P((e, f, d), ("experts", "expert_mlp", "embed")),
    }
    if mcfg.num_shared:
        defs["shared"] = layers.mlp_defs(d, mcfg.shared_d_ff)
        defs["shared_gate"] = P((d, 1), ("embed", None), dtype=torch.float32)
    return defs


def capacity(mcfg: MoECfg, n: int) -> int:
    """Slots per expert for a call over ``n`` tokens, as the reference
    computes it: Python's ``round`` (half to even), at least 1."""
    return int(max(1, round(n * mcfg.top_k / mcfg.num_experts
                            * mcfg.capacity_factor)))


class Routing(NamedTuple):
    """The integers of one call's dispatch (the reference's names), with
    the gates and the load-balancing loss. ``flat_*`` are in (token, k)
    order, ``order``/``keep`` in sorted order, the slot tables (E·cap,)."""
    expert_idx: torch.Tensor      # (N, k) top-k experts, descending prob
    gate: torch.Tensor            # (N, k) fp32, renormalised
    order: torch.Tensor           # (N·k,) stable argsort of the flat ids
    keep: torch.Tensor            # (N·k,) rank within its expert < cap
    flat_slot: torch.Tensor       # (N·k,) e·cap + rank, or E·cap if dropped
    token_for_slot: torch.Tensor  # (E·cap,) int32
    flat_for_slot: torch.Tensor   # (E·cap,) the (token·k + j) a slot holds
    filled: torch.Tensor          # (E·cap,) bool
    cap: int
    aux: torch.Tensor             # () fp32 Switch loss


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest probabilities of each row,
    descending, as ``lax.top_k`` gives them: among equal values the lower
    index first. ``torch.topk`` promises no order among ties; a stable
    descending sort keeps the lower index first."""
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top[:, :k], idx[:, :k]


def route(mcfg: MoECfg, router: torch.Tensor, xt: torch.Tensor) -> Routing:
    """Top-k routing and the capacity dispatch of ``xt`` (N, D)."""
    n = xt.shape[0]
    e, k = mcfg.num_experts, mcfg.top_k
    probs = torch.softmax(xt.float() @ router, dim=-1)          # (N, E)
    gate, expert_idx = top_k(probs, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch-style load-balancing loss: density from the top-1 column
    experts = torch.arange(e, device=xt.device)
    density = (expert_idx[:, :1] == experts).float().mean(0)
    aux = e * torch.sum(density * probs.mean(0))

    cap = capacity(mcfg, n)
    flat_e = expert_idx.reshape(-1)                             # (N·k,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = torch.searchsorted(se, experts)                    # (E,)
    ends = torch.searchsorted(se, experts, right=True)
    rank = torch.arange(n * k, device=xt.device) - starts[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)          # OOB: dropped
    # the same slots in (token, k) order, through the inverse permutation
    flat_slot = slot[torch.argsort(order)]
    # slot r of expert j holds sorted row starts[j] + r, if the expert got
    # more than r assignments
    r = torch.arange(cap, device=xt.device)
    row = starts[:, None] + r                                   # (E, cap)
    filled = row < ends[:, None]
    flat_for_slot = torch.where(filled, order[row.clamp_max(n * k - 1)], 0)
    token_for_slot = torch.div(flat_for_slot, k, rounding_mode="floor")
    return Routing(expert_idx=expert_idx, gate=gate, order=order, keep=keep,
                   flat_slot=flat_slot,
                   token_for_slot=token_for_slot.to(torch.int32).reshape(-1),
                   flat_for_slot=flat_for_slot.reshape(-1),
                   filled=filled.reshape(-1), cap=cap, aux=aux)


def _in_expert_order(rt: Routing, y: torch.Tensor) -> torch.Tensor:
    """Each token's k rows of ``y`` (N, k, D) summed in ascending expert
    id, rounding to ``y``'s dtype after every add: the order in which the
    reference's scatter-adds visit them."""
    n, k = rt.expert_idx.shape
    by_expert = torch.argsort(rt.expert_idx, dim=-1)            # ids distinct
    y = torch.gather(y, 1, by_expert[..., None].expand(n, k, y.shape[-1]))
    out = y[:, 0]
    for i in range(1, k):
        out = out + y[:, i]
    return out


class _Dispatch(torch.autograd.Function):
    """``xt[token_for_slot]`` (N, D) → (E·cap, D), whose backward is the
    fixed-order sum of each token's kept slots (module docstring)."""

    @staticmethod
    def forward(ctx, xt, rt):
        ctx.rt = rt
        return xt.index_select(0, rt.token_for_slot)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dxe):
        rt = ctx.rt
        n, k = rt.expert_idx.shape
        n_slots = dxe.shape[0]
        kept = (rt.flat_slot < n_slots).reshape(n, k, 1)
        g = dxe.index_select(0, rt.flat_slot.clamp_max(n_slots - 1))
        g = torch.where(kept, g.reshape(n, k, -1), 0)
        return _in_expert_order(rt, g), None


class _SlotRead(torch.autograd.Function):
    """``ye[flat_slot]`` (E·cap, D) → (N·k, D), dropped assignments reading
    the last slot; its backward gathers each filled slot's one cotangent
    through ``flat_for_slot`` (module docstring)."""

    @staticmethod
    def forward(ctx, ye, rt):
        ctx.rt = rt
        return ye.index_select(0, rt.flat_slot.clamp_max(ye.shape[0] - 1))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        rt = ctx.rt
        dye = dy.index_select(0, rt.flat_for_slot)
        return torch.where(rt.filled[:, None], dye, 0), None


def combine(rt: Routing, ye: torch.Tensor) -> torch.Tensor:
    """Each token's kept expert outputs times their gates, summed: ``ye``
    (E·cap, D) → (N, D). The reference scatter-adds its bf16 rows into a
    zero bf16 output, visiting a token's rows in sorted order (ascending
    expert id) and rounding after every add; here a token's k rows are
    gathered into that order and added one at a time, which gives its
    bits (the CPU tests hold them), where one fp32 sum rounded once
    does not."""
    n, k = rt.expert_idx.shape
    d = ye.shape[-1]
    kept = (rt.flat_slot < ye.shape[0]).to(rt.gate.dtype).reshape(n, k)
    y = _SlotRead.apply(ye, rt).reshape(n, k, d)
    y = y * (rt.gate * kept)[..., None].to(y.dtype)              # 0 if dropped
    return _in_expert_order(rt, y)


def moe_block(mcfg: MoECfg, p: dict, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out (B, S, D), aux_loss scalar)."""
    b, s, d = x.shape
    e = mcfg.num_experts
    xt = x.reshape(b * s, d)
    rt = route(mcfg, p["router"], xt)

    xe = _Dispatch.apply(xt, rt).reshape(e, rt.cap, d)
    xe = xe * rt.filled.reshape(e, rt.cap, 1).to(xe.dtype)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).reshape(e * rt.cap, d)        # (E·cap, D)
    out = combine(rt, ye)

    if mcfg.num_shared:
        sg_w = torch.sigmoid(xt.float() @ p["shared_gate"])
        out = out + layers.mlp_block(p["shared"], xt) * sg_w.to(out.dtype)
    return out.reshape(b, s, d), rt.aux
