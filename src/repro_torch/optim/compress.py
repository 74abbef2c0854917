"""Gradient compression for cross-replica reduction (twin of the JAX
package's ``optim/compress.py``).

Two mechanisms, both beyond-paper distributed-optimization features:

* ``bf16`` — gradients are kept in bf16 so a reduce-scatter / all-reduce
  moves half the bytes (the default in the train step).
* ``int8 + error feedback`` — 1-byte quantized all-reduce with a persistent
  residual buffer so quantization error is re-injected next step
  (1-bit-Adam-style convergence behavior).

``compress_psum`` reduces over a ``torch.distributed`` process group, or
over one named dim of a ``DeviceMesh`` given as ``(mesh, dim name)``: the
twin of the reference's ``psum`` over an axis name inside ``shard_map``,
where each device quantizes its own block. A plain tensor is that block.
A DTensor leaf must be the unreduced gradient it stands for: ``Partial``
(sum) over the named dim of its own mesh, as autograd leaves a weight's
gradient of a loss over a batch sharded there. Its local tensor is the
device's block; the sum comes back ``Replicate`` over the dim and the
residual stays ``Partial`` there (each device's own error, whose sum is
what the group has not sent yet). Nothing is read back to the host.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from ..core.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


class EFState(NamedTuple):
    residual: Any            # same structure as grads, fp32


def _zeros(g: torch.Tensor) -> torch.Tensor:
    if isinstance(g, DTensor):       # zeros laid out as g, Partial kept
        return _dtensor(torch.zeros_like(g.to_local(), dtype=torch.float32),
                        g, g.placements)
    return torch.zeros_like(g, dtype=torch.float32)


def ef_init(grads_like: Any) -> EFState:
    return EFState(residual=tree_map(_zeros, grads_like))


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q, scale): ``x / scale`` rounded half to even and clipped to
    ±127 as int8, with scale = max|x| / 127 + 1e-12, a 0-d tensor in
    ``x``'s dtype, as the reference computes them."""
    scale = x.abs().amax() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _dtensor(local: torch.Tensor, like: DTensor, placements) -> DTensor:
    """``local`` as a DTensor of ``like``'s mesh and global shape."""
    local = local.contiguous()
    return DTensor.from_local(
        local, like.device_mesh, placements, shape=like.shape,
        stride=torch.empty(like.shape, device="meta").stride(),
        run_check=False)


def _block(g: torch.Tensor, group) -> tuple[torch.Tensor, Any, Any]:
    """(the device's block of ``g``, the process group to sum it over,
    the sum's placements or None for a plain tensor)."""
    if not isinstance(g, DTensor):
        if isinstance(group, tuple):
            mesh, name = group
            return g, mesh.get_group(name), None
        return g, group, None
    if not isinstance(group, tuple) or group[0] != g.device_mesh:
        raise ValueError("a DTensor gradient is reduced over (its own "
                         "DeviceMesh, a dim name), not a process group")
    mesh, name = group
    i = mesh.mesh_dim_names.index(name)
    p = g.placements[i]
    if not (p.is_partial() and p.reduce_op == "sum"):
        raise ValueError(
            f"a DTensor gradient must be Partial(sum) over {name!r}, the "
            f"unreduced sum of each device's block; its placements are "
            f"{g.placements}: reduce a plain local tensor instead")
    out = list(g.placements)
    out[i] = Replicate()
    return g.to_local(), mesh.get_group(name), tuple(out)


def compress_psum(grads: Any, ef: EFState, group) -> tuple[Any, EFState]:
    """int8 all-reduce (sum) with error feedback over ``group``: per leaf,
    g + r is quantized, the dequantized fp32 is summed over the group and
    cast back to g's dtype, and the new residual is (g + r) − sent."""
    from torch.distributed import _functional_collectives as funcol

    def one(g, r):
        local, pg, summed = _block(g, group)
        if isinstance(r, DTensor):
            if isinstance(g, DTensor) and r.placements != g.placements:
                raise ValueError(f"residual laid out as {r.placements}, "
                                 f"its gradient as {g.placements}")
            r = r.to_local()
        gf = local.to(torch.float32) + r
        q, scale = quantize_int8(gf)
        sent = dequantize_int8(q, scale)
        new_r = gf - sent
        # all-reduce the dequantized value (an int8 sum is not what the
        # collectives offer on every backend; the wire format is what
        # matters for the cost model, recorded as 1 byte/element in the
        # roofline). The functional all-reduce copies its input into a
        # contiguous buffer: a gradient may be strided, which nccl's
        # in-place all-reduce refuses.
        red = funcol.wait_tensor(funcol.all_reduce(sent, "sum", pg))
        red = red.to(g.dtype)
        if summed is None:
            return red, new_r
        return _dtensor(red, g, summed), _dtensor(new_r, g, g.placements)

    flat, treedef = tree_flatten(grads)
    out = [one(g, r) for g, r in zip(flat, tree_leaves(ef.residual))]
    return (tree_unflatten(treedef, [o[0] for o in out]),
            EFState(residual=tree_unflatten(treedef, [o[1] for o in out])))
