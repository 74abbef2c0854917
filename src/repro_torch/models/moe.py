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

``moe_block_sharded`` and ``moe_block_a2a`` are the reference's two
forms of the block on a mesh with a ``model`` axis, each its ``shard_map``
done by hand: every input is redistributed to the form's layout and the
block runs on the local shards (``_local_shards``), whose outputs are
laid out again as DTensors. Each device routes its own tokens, so the
capacity follows the shard's tokens, as in the reference, and
``searchsorted`` runs on local tensors.

  * ``moe_block_sharded`` (expert tensor parallelism): every device holds
    all experts with a 1/TP slice of d_ff, runs ``moe_block`` on its
    batch shard and sums the partial outputs over ``model``
    (``psum_axis``);
  * ``moe_block_a2a`` (expert parallelism): each model shard owns E/TP
    experts with their whole d_ff; a device sends its assignments to
    their experts' shards (the rows and their expert ids, an all-to-all
    each), a second capacity dispatch there fills each local expert, and
    an all-to-all brings the outputs back to be combined. As in the
    reference, every model shard holds the same batch shard, so each
    expert receives TP copies of its rows and computes them all. The
    reference's ``.at[st].add`` combine is ``combine``'s fixed-order sum
    here too, and every row move is a gather whose backward is a gather
    (``_Dispatch``, ``_SlotRead``).

Gradients through the collectives are the meshless block's. The sum over
``model`` (``_SumOver``) passes its cotangent through unchanged: the
summed output is one value replicated over ``model``, so each partial's
cotangent is the output's. The inputs that every model shard reads
whole (the tokens, the router, the shared gate) get their gradients as
``Partial`` sums over ``model``, every weight's as one over the batch
axes too, and the a2a form's routed output, which each model shard
computes in full from the same tokens, passes 1/TP of its cotangent back
(``_ScaleGrad``), as JAX divides an unmapped output's cotangent by the
axis size under ``check_rep=False``. With plain tensors on a mesh of one
device the forms run the same local body with collectives over the
one-rank group, which leave every bit as it is.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import layers
from .config import MoECfg
from .params import P
from ..sharding import activation


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


def _slots(ids: torch.Tensor, n_groups: int, per_group: int, cap: int
           ) -> tuple:
    """The sort-based capacity dispatch of ``ids`` (M,): group
    ``ids // per_group``, an id of ``n_groups·per_group`` belongs to no
    group (it sorts last and is dropped). Returns (order, keep, flat_slot,
    flat_for_slot, filled), ``Routing``'s fields for M assignments over
    ``n_groups`` groups of ``cap`` slots."""
    m = ids.shape[0]
    dev = ids.device
    order = torch.argsort(ids, stable=True)
    se = ids[order]
    # each group's first sorted row, and the end of the last group
    edges = torch.searchsorted(se, torch.arange(n_groups + 1, device=dev)
                               * per_group)                     # (G+1,)
    grp = se if per_group == 1 else torch.div(se, per_group,
                                              rounding_mode="floor")
    rank = torch.arange(m, device=dev) - edges[grp.clamp_max(n_groups - 1)]
    keep = (rank < cap) & (grp < n_groups)
    slot = torch.where(keep, grp * cap + rank, n_groups * cap)  # OOB: dropped
    # the same slots in the assignments' order, through the inverse
    # permutation
    flat_slot = slot[torch.argsort(order)]
    # slot r of group j holds sorted row edges[j] + r, if the group got
    # more than r assignments
    row = edges[:-1, None] + torch.arange(cap, device=dev)      # (G, cap)
    filled = row < edges[1:, None]
    flat_for_slot = torch.where(filled, order[row.clamp_max(m - 1)], 0)
    return (order, keep, flat_slot, flat_for_slot.reshape(-1),
            filled.reshape(-1))


def route(mcfg: MoECfg, router: torch.Tensor, xt: torch.Tensor,
          per_group: int = 1) -> Routing:
    """Top-k routing and the capacity dispatch of ``xt`` (N, D): into each
    expert's ``capacity`` slots, or, with ``per_group`` > 1, into each
    group of ``per_group`` consecutive experts' ``per_group·capacity``
    slots (``moe_block_a2a``'s send buffer: a group is a model shard's
    experts)."""
    n = xt.shape[0]
    e, k = mcfg.num_experts, mcfg.top_k
    probs = torch.softmax(xt.float() @ router, dim=-1)          # (N, E)
    gate, expert_idx = top_k(probs, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch-style load-balancing loss: density from the top-1 column
    experts = torch.arange(e, device=xt.device)
    density = (expert_idx[:, :1] == experts).float().mean(0)
    aux = e * torch.sum(density * probs.mean(0))

    cap = capacity(mcfg, n) * per_group
    order, keep, flat_slot, flat_for_slot, filled = _slots(
        expert_idx.reshape(-1), e // per_group, per_group, cap)
    token_for_slot = torch.div(flat_for_slot, k, rounding_mode="floor")
    return Routing(expert_idx=expert_idx, gate=gate, order=order, keep=keep,
                   flat_slot=flat_slot,
                   token_for_slot=token_for_slot.to(torch.int32),
                   flat_for_slot=flat_for_slot, filled=filled, cap=cap,
                   aux=aux)


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


def moe_block(mcfg: MoECfg, p: dict, x: torch.Tensor, psum_axis=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out (B, S, D), aux_loss scalar). ``psum_axis``, a
    group as ``torch.distributed._functional_collectives`` takes one (the
    reference's axis name), sums the output over it: the experts' d_ff is
    sharded over it, so each device's output is a partial sum."""
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
    if psum_axis is not None:
        out = _SumOver.apply(out, psum_axis)
    return out.reshape(b, s, d), rt.aux


# ---------------------------------------------------------------------------
# the forms on a mesh
# ---------------------------------------------------------------------------
def _wait(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(t)


class _SumOver(torch.autograd.Function):
    """The sum of each device's ``x`` over ``group``, replicated; its
    backward passes the (replicated) cotangent to every partial as it
    is."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol
        return _wait(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOver(torch.autograd.Function):
    """The mean of each device's ``x`` over each of ``mesh``'s dims
    ``dims`` in turn (the reference's ``pmean`` of each axis); the
    backward divides the cotangent by their sizes."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        from torch.distributed import _functional_collectives as funcol
        ctx.n = 1
        for dim in dims:
            x = _wait(funcol.all_reduce(x, "sum", (mesh, dim)))
            x = x / mesh.size(dim)
            ctx.n *= mesh.size(dim)
        return x

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _ScaleGrad(torch.autograd.Function):
    """``x`` itself, its cotangent times ``factor``."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """The reference's tiled ``all_to_all`` over dim 0 (split and concat
    axis 0): block i of the result is device i's block for this device.
    Its backward is the all-to-all back."""
    from torch.distributed import _functional_collectives as funcol
    if x.requires_grad:
        return _wait(funcol.all_to_all_single_autograd(x, None, None, group))
    return _wait(funcol.all_to_all_single(x, None, None, group))


def _model_mesh():
    """The active mesh if it has a ``model`` axis, else None."""
    mesh = activation.active_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return None
    return mesh


def _batch_dims(mesh, batch: int) -> tuple:
    """The reference's ``bd``: the axes of ``batch_axes()`` that the mesh
    has, other than ``model``, as long as their sizes' product still
    divides the batch."""
    sizes = activation.axis_sizes(mesh)
    bd, prod = [], 1
    for a in activation.batch_axes():
        if a in sizes and a != "model" and batch % (prod * sizes[a]) == 0:
            bd.append(a)
            prod *= sizes[a]
    return tuple(bd)


_TP_SPECS = {"router": (None, None),
             "w_gate": (None, None, "model"),     # expert-TP on d_ff
             "w_up": (None, None, "model"),
             "w_down": (None, "model", None)}
_EP_SPECS = {"router": (None, None),
             "w_gate": ("model", None, None),     # experts over model (EP)
             "w_up": ("model", None, None),
             "w_down": ("model", None, None)}
_SHARED_SPECS = {"shared": {"w_gate": (None, "model"),
                            "w_up": (None, "model"),
                            "w_down": ("model", None)},
                 "shared_gate": (None, None)}


def _local_shards(mcfg: MoECfg, p: dict, x: torch.Tensor, mesh, specs: dict,
                  local) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``shard_map(local, in_specs=(PS(bd, None, None),
    specs), out_specs=(PS(bd, None, None), PS()))``: ``local(p_l, x_l,
    (mesh, model dim))`` on this device's shards, its aux averaged over
    ``model`` and the batch axes. DTensors are redistributed to ``specs``
    and the batch layout, and their local tensors handed to ``local``,
    each input's gradient coming back as a ``Partial`` sum over the mesh
    dims that split the work of a whole input it reads (``model`` and the
    batch axes); the output comes back as a DTensor sharded on the batch
    axes. Plain tensors on a mesh of one device are their own shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    names = tuple(mesh.mesh_dim_names)
    bd = _batch_dims(mesh, x.shape[0])
    model = names.index("model")
    summed = {model, *(names.index(a) for a in bd)}
    specs = dict(specs, **_SHARED_SPECS) if mcfg.num_shared else specs
    if isinstance(x, DTensor):
        def shard(t, spec):
            pl = activation.placements(spec, t.ndim, names)
            grad = [Partial() if q.is_replicate() and i in summed else q
                    for i, q in enumerate(pl)]
            return t.redistribute(mesh, pl).to_local(grad_placements=grad)

        x_l = shard(x, (bd, None, None))
        p_l = {k: ({j: shard(p[k][j], v) for j, v in spec.items()}
                   if isinstance(spec, dict) else shard(p[k], spec))
               for k, spec in specs.items()}
    elif mesh.size() == 1:
        x_l, p_l = x, {k: p[k] for k in specs}
    else:
        raise NotImplementedError(
            f"the MoE block's sharded forms on a mesh of {mesh.size()} "
            f"devices take DTensors (build_step's in-shardings place them), "
            f"not plain tensors")
    out, aux = local(p_l, x_l, (mesh, model))
    aux = _MeanOver.apply(aux, mesh, [names.index(a) for a in ("model", *bd)])
    if not isinstance(x, DTensor):
        return out, aux
    out_pl = activation.placements((bd, None, None), out.ndim, names)
    return (DTensor.from_local(out, mesh, out_pl, run_check=False),
            DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                               run_check=False))


def moe_block_sharded(mcfg: MoECfg, p: dict, x: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-tensor-parallel MoE (the reference's ``moe_block_sharded``):
    routing, sort and dispatch run on each device's own tokens (its batch
    shard), each device holds all experts with a 1/TP slice of d_ff, and
    the partial outputs are summed over ``model``: one (N_local, D)
    all-reduce a layer, no dispatch traffic. ``moe_block`` with no active
    mesh or no ``model`` axis."""
    mesh = _model_mesh()
    if mesh is None:
        return moe_block(mcfg, p, x)

    def local(p_l, x_l, group):
        return moe_block(mcfg, p_l, x_l, psum_axis=group)

    return _local_shards(mcfg, p, x, mesh, _TP_SPECS, local)


def _rows(ids: torch.Tensor, n_groups: int, cap: int) -> Routing:
    """A ``Routing`` of single rows (one assignment each) into ``n_groups``
    groups of ``cap`` slots by ``ids``; an id of ``n_groups`` is no
    group's (the receiving shard's empty rows)."""
    order, keep, flat_slot, flat_for_slot, filled = _slots(ids, n_groups, 1,
                                                          cap)
    return Routing(expert_idx=ids[:, None], gate=None, order=order,
                   keep=keep, flat_slot=flat_slot,
                   token_for_slot=flat_for_slot, flat_for_slot=flat_for_slot,
                   filled=filled, cap=cap, aux=None)


def moe_block_a2a(mcfg: MoECfg, p: dict, x: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """True expert parallelism with all-to-all dispatch (the reference's
    ``moe_block_a2a``). Each model shard owns E/TP experts with their full
    d_ff; each device routes its tokens, sends every kept assignment to
    its expert's shard in one all-to-all (capacity ``capacity·E/TP`` a
    shard), dispatches what it receives to its own experts (capacity TP
    times that over E/TP), computes them and sends the outputs back in a
    second all-to-all. ``moe_block_sharded`` when E does not divide over
    ``model`` or with no mesh."""
    mesh = _model_mesh()
    if mesh is None or mcfg.num_experts % mesh.size(
            mesh.mesh_dim_names.index("model")):
        return moe_block_sharded(mcfg, p, x)

    def local(p_l, x_l, group):
        b, s, d = x_l.shape
        gmesh, gdim = group
        n_shards = gmesh.size(gdim)
        e_local = mcfg.num_experts // n_shards
        xt = x_l.reshape(b * s, d)
        # ---- dispatch to the (n_shards, cap) send buffer, by expert ----
        rt = route(mcfg, p_l["router"], xt, per_group=e_local)
        send = _Dispatch.apply(xt, rt) * rt.filled[:, None].to(xt.dtype)
        send_e = torch.where(rt.filled,
                             rt.expert_idx.reshape(-1)[rt.flat_for_slot], -1)
        # ---- exchange: every shard receives the rows for its experts ----
        recv = _all_to_all(send, group)
        recv_e = _all_to_all(send_e.to(torch.int32), group)
        first = gmesh.get_local_rank(gdim) * e_local
        ids = torch.where(recv_e >= 0, recv_e - first, e_local).long()
        # ---- second-level dispatch to the E_local experts ----
        cap2 = n_shards * rt.cap // e_local
        rt2 = _rows(ids, e_local, cap2)
        xe = _Dispatch.apply(recv, rt2) * rt2.filled[:, None].to(recv.dtype)
        xe = xe.reshape(e_local, cap2, d)
        h = F.silu(torch.bmm(xe, p_l["w_gate"])) * torch.bmm(xe, p_l["w_up"])
        ye = torch.bmm(h, p_l["w_down"]).reshape(e_local * cap2, d)
        # ---- undo the second dispatch, send back, combine ----
        kept2 = (rt2.flat_slot < e_local * cap2)[:, None].to(ye.dtype)
        back = _all_to_all(_SlotRead.apply(ye, rt2) * kept2, group)
        out = _ScaleGrad.apply(combine(rt, back), 1.0 / n_shards)
        if mcfg.num_shared:
            sgw = torch.sigmoid(xt.float() @ p_l["shared_gate"])
            partial = layers.mlp_block(p_l["shared"], xt) * sgw.to(out.dtype)
            out = out + _SumOver.apply(partial, group)
        return out.reshape(b, s, d), rt.aux

    return _local_shards(mcfg, p, x, mesh, _EP_SPECS, local)
