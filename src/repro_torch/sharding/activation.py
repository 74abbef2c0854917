"""Activation sharding constraints that degrade gracefully (twin of the
JAX package's ``sharding/activation.py``).

``constrain(x, ("pod", "data"), None, "model")`` keeps, of each entry,
only the mesh axes that the active mesh has, and binds them only when
their total size is above 1 and divides the dim (``resolve_entries``), so
the same model code runs on a one-card mesh, a 256-device pod or the
512-device two-pod mesh. ``use_mesh(mesh)`` makes a ``DeviceMesh`` the
active one for the calling thread, as the reference's ``with mesh:`` does.

With no active mesh, or when every entry resolves to ``None`` (always so
on a mesh of one device), ``constrain`` returns ``x`` itself: the model's
arithmetic and launches are those of a run without a mesh. A DTensor is
redistributed to the resolved placements. The steps trace on DTensors on
a mesh of several devices (``launch/dryrun.py`` traces them on fake
tensors); where DTensor cannot carry a sharding through an op the model
code calls, each a no-op with no mesh and on a mesh of one device:
``splittable`` before a view that would split a dim's shards unevenly
(and on its gradient), ``full`` and ``on_mesh`` for the tensors a step
makes (accumulators, positions), ``cache_leaf`` for a serving cache laid
out as ``cache_axes`` say, ``write_slice`` for a write into a cache whose
sequence is sharded, ``einsum`` for a product whose batch dims two mesh
axes shard, ``grad_laid_out`` for a value whose gradient must come back
in its own layout. A plain tensor under an entry that binds an axis
raises: the steps of every family run across devices on DTensors, laid
out by ``launch/shapes.py`` ``build_step``'s in-shardings.

Also here, as pure functions of axis names and sizes (no process group):
``axis_sizes`` of a mesh or a ``{name: size}`` mapping, and
``placements``, the DTensor ``Shard``/``Replicate`` per mesh dim of a
spec.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Mapping

import torch

BATCH_AXES = ("pod", "data")   # logical batch → physical axes (filtered)
SEQ_AXES = ("data",)           # sequence parallelism for long-context decode


class _State(threading.local):
    """Each thread's batch axes and active mesh. The defaults are class
    attributes, so a thread that never set one reads it with no
    ``AttributeError`` raised and caught (a ``getattr`` default costs
    that on every call of a step)."""
    batch_axes = BATCH_AXES
    mesh = None
    several = False      # the active mesh has several devices


_local = _State()


def batch_axes() -> tuple:
    """Physical axes the logical batch maps to (overridable per run —
    e.g. pure-FSDP spreads batch over (pod, data, model))."""
    return _local.batch_axes


@contextlib.contextmanager
def use_batch_axes(axes: tuple):
    prev = _local.batch_axes
    _local.batch_axes = tuple(axes)
    try:
        yield
    finally:
        _local.batch_axes = prev


def model_axis():
    """``model``, the axis a sharded step spreads heads, the queries'
    sequence or the vocab over, or None where the batch takes it."""
    return None if "model" in batch_axes() else "model"


def active_mesh():
    """The mesh of the innermost ``use_mesh`` of this thread, or None."""
    return _local.mesh


def _several() -> bool:
    """Whether the active mesh has several devices (False with none)."""
    return _local.several


@contextlib.contextmanager
def use_mesh(mesh):
    """``mesh`` (a ``DeviceMesh``) is the active mesh of this thread inside
    the block; the one before it is restored at the end."""
    prev, prev_several = active_mesh(), _several()
    _local.mesh = mesh
    # read by ``distributed`` on every call of a step: a mesh's size once
    _local.several = mesh is not None and mesh.size() > 1
    try:
        yield mesh
    finally:
        _local.mesh, _local.several = prev, prev_several


def carried(fn):
    """``fn`` run, from whichever thread calls it, under the active mesh
    and batch axes of this thread as they are now: a checkpointed block's
    recompute runs in the backward, which the autograd engine runs on a
    thread of its own for a CUDA device, with no mesh active there. ``fn``
    itself with no mesh and the default batch axes."""
    mesh, axes = active_mesh(), batch_axes()
    if mesh is None and axes == BATCH_AXES:
        return fn

    def run(*args, **kwargs):
        with use_mesh(mesh), use_batch_axes(axes):
            return fn(*args, **kwargs)
    return run


def axis_sizes(mesh: Any) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (its dim names and shape)
    or of a plain mapping, which is taken as it is."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError(f"a mesh without axis names: {mesh}")
    return dict(zip(names, (int(n) for n in mesh.shape)))


def resolve_entries(shape: tuple, axes: tuple, sizes: Mapping[str, int]
                    ) -> tuple:
    """The spec ``constrain`` applies: per dim, the entry's axes that
    ``sizes`` has (a name or a tuple of names, in the entry's order), kept
    only when their total size is above 1 and divides the dim; else
    None. The reference's loop, entry for entry."""
    entries = []
    for dim, a in zip(shape, axes):
        if a is None:
            entries.append(None)
            continue
        cand = a if isinstance(a, tuple) else (a,)
        cand = tuple(c for c in cand if c in sizes)
        total = 1
        for c in cand:
            total *= sizes[c]
        if cand and total > 1 and dim % total == 0:
            entries.append(cand if len(cand) > 1 else cand[0])
        else:
            entries.append(None)
    return tuple(entries)


def placements(spec: tuple, ndim: int, mesh_dim_names: tuple) -> tuple:
    """The DTensor placements of ``spec`` on a mesh with these dim names:
    ``Shard(d)`` on every mesh dim that entry ``d`` names, ``Replicate()``
    on the rest. A tuple entry shards its dim over its axes in the mesh's
    order, so it must list them in that order: any other order raises
    (it is never reordered). Raises on an axis the mesh lacks, an axis
    named twice, or more entries than ``ndim``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh_dim_names)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in names:
                raise KeyError(f"spec {spec} names axis {a!r}; the mesh has "
                               f"{names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {entry} lists its axes out of the mesh's order "
                f"{names}: DTensor shards a dim over mesh dims in their "
                f"order, so the entry would shard otherwise than it says")
        for i in idx:
            if not out[i].is_replicate():
                raise ValueError(f"spec {spec} names axis {names[i]!r} twice")
            out[i] = Shard(dim)
    return tuple(out)


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """``x`` with the sharding ``axes`` resolve to on the active mesh:
    ``x`` itself with no mesh, or when every entry resolves to None
    except for a DTensor on a mesh of several devices, which is made
    whole (replicated), as the reference's constraint to an empty spec
    does; else a DTensor redistributed to the resolved placements; a
    plain tensor under an entry that binds an axis raises: a sharded step
    runs on DTensors."""
    mesh = active_mesh()
    if mesh is None:
        return x
    entries = resolve_entries(tuple(x.shape), axes, axis_sizes(mesh))
    if all(e is None for e in entries) and not distributed(x):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise NotImplementedError(
            f"constrain{tuple(axes)} binds mesh axes {entries} but got a "
            f"plain tensor: on a mesh of several devices pass the step "
            f"DTensors (distribute its inputs by build_step's "
            f"in-shardings, or place them with models.params.place)")
    return x.redistribute(mesh, placements(entries, x.ndim,
                                           mesh.mesh_dim_names))


def distributed(x: torch.Tensor) -> bool:
    """Whether ``x`` is a DTensor inside ``use_mesh`` of a mesh of several
    devices (a sharded step); False for a plain tensor, on a mesh of one
    device and with no active mesh (checked first, from a flag that
    ``use_mesh`` sets: the cheap answer of every other run)."""
    if not _several():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def laid_out_as(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a gradient) with the placements of ``like`` (its parameter)
    on a mesh of several devices, as XLA lays a gradient out as its
    parameter: partial sums become a reduce-scatter into the parameter's
    shards, where DTensor might all-reduce the whole tensor later; ``x``
    itself otherwise."""
    if not distributed(x) or x.placements == like.placements:
        return x
    return x.redistribute(like.device_mesh, like.placements)


def shards(x: torch.Tensor, dim: int) -> int:
    """Into how many shards the mesh dims of a DTensor ``x`` cut its dim
    ``dim`` inside ``use_mesh`` (1 for a plain tensor or no active
    mesh of several devices)."""
    if not distributed(x):
        return 1
    dim %= x.ndim
    return math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                     if p.is_shard(dim))


def _gather_uneven(x: torch.Tensor, leads: tuple) -> torch.Tensor:
    """``x`` (a DTensor) with the mesh dims that shard dim ``d`` gathered
    where their total size does not divide ``leads[d]``."""
    from torch.distributed.tensor import Replicate
    gather = set()
    for d, lead in enumerate(leads):
        if lead is not None and lead % shards(x, d):
            gather.update(i for i, p in enumerate(x.placements)
                          if p.is_shard(d))
    if not gather:
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if i in gather else p for i, p in enumerate(x.placements)))


class _Splittable(torch.autograd.Function):
    """``_gather_uneven`` on the value and on its gradient."""

    @staticmethod
    def forward(ctx, x, leads):
        ctx.leads = leads
        return _gather_uneven(x, leads)

    @staticmethod
    def backward(ctx, g):
        return _gather_uneven(g, ctx.leads), None


def _mesh_placements(shape: tuple, axes: tuple):
    """(mesh, placements) that ``axes`` resolve to on the active mesh of
    several devices, or None with no mesh or a mesh of one device."""
    if not _several():
        return None
    mesh = active_mesh()
    entries = resolve_entries(tuple(shape), axes, axis_sizes(mesh))
    return mesh, placements(entries, len(shape), mesh.mesh_dim_names)


def full(shape: tuple, fill, *axes, dtype: torch.dtype,
         device: torch.device | str) -> torch.Tensor:
    """``torch.full(shape, fill)`` (``torch.zeros`` for a fill of 0) for a
    tensor that a step makes: with no mesh or on a mesh of one device the
    plain tensor, as before; on an active mesh of several devices a
    DTensor laid out as ``constrain`` lays out ``axes``, each device
    making only its own shard."""
    on = _mesh_placements(shape, axes)
    if on is None:
        if fill == 0:
            return torch.zeros(shape, dtype=dtype, device=device)
        return torch.full(shape, fill, dtype=dtype, device=device)
    from torch.distributed import tensor as dtensor
    return dtensor.full(shape, fill, dtype=dtype, device_mesh=on[0],
                        placements=on[1])


def on_mesh(t: torch.Tensor, *axes) -> torch.Tensor:
    """A plain tensor that a step makes (a constant, the same on every
    device: positions) laid out by ``axes`` on the active mesh of several
    devices, as a DTensor cut from it on each device with no collective;
    ``t`` itself with no mesh or on a mesh of one device."""
    on = _mesh_placements(t.shape, axes)
    if on is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh, target = on
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(mesh, target)


def cache_axes(name: str, ndim: int, long_ctx: bool) -> tuple:
    """The serving cache's layout, per leaf name (the reference's
    ``launch/shapes.py`` ``_cache_shardings``): K/V sequence over
    ``model``, or over (``data``, ``model``) for a long context of batch
    1; batch over (``pod``, ``data``); ring buffers and SSM states over
    the batch only, the conv state's channels over ``model``."""
    bd = ("pod", "data")
    seq = ("data", "model") if long_ctx else ("model",)
    if name in ("kg", "vg"):      # (G, 1, B, S, KV, hd) global layers
        return (None, None, bd, seq, None, None)
    if name in ("kl", "vl"):      # (G, g-1, B, W, KV, hd) ring buffers
        return (None, None, bd, None, None, None)
    if name == "kpl":
        return (None, None, bd, None)
    if name in ("kt", "vt"):      # (T, B, W, KV, hd)
        return (None, bd, None, None, None)
    if name == "kpt":
        return (None, bd, None)
    if name in ("k", "v"):
        if ndim == 5:             # (L, B, S, KV, hd)
            return (None, bd, seq, None, None)
        return (bd, seq, None, None)
    if name == "conv":            # (L[, n_ssm], B, K-1, C)
        return (None,) * (ndim - 3) + (bd, None, ("model",))
    if name == "h":               # (L[, n_ssm], B, H, P, N)
        return (None,) * (ndim - 4) + (bd, None, None, None)
    if name == "enc_out":         # (B, S_enc, D)
        return (bd, None, None)
    return (None,) * ndim


def cache_leaf(name: str, shape: tuple, fill, dtype: torch.dtype,
               device: torch.device | str, batch: int) -> torch.Tensor:
    """A serving cache's leaf ``name`` of ``fill`` (``full``): on an active
    mesh of several devices laid out as ``cache_axes`` say (a batch of 1
    is a long context), as the reference's prefill lays its cache out."""
    return full(shape, fill, *cache_axes(name, len(shape), batch == 1),
                dtype=dtype, device=device)


def write_slice(dst: torch.Tensor, src: torch.Tensor, dim: int,
                start: int) -> None:
    """``dst``'s positions [start, start + n) along ``dim`` (n =
    ``src.shape[dim]``) set to ``src``, in place, for a DTensor ``dst``
    sharded on ``dim`` (a cache whose sequence is sharded): each device
    writes the part of the range that falls in its own shard, with no
    collective, as XLA partitions a dynamic-update-slice. DTensor would
    gather the whole cache to write a slice of a sharded dim."""
    from torch.distributed.tensor import Replicate
    mesh = dst.device_mesh
    want = tuple(Replicate() if p.is_shard(dim) else p
                 for p in dst.placements)
    src = src.redistribute(mesh, want).to_local()
    local = dst.to_local()
    # this device's offset along ``dim``: the mesh dims cut it in order,
    # each into even chunks (``resolve_entries`` binds only divisors)
    off, n = 0, dst.shape[dim]
    for i, p in enumerate(dst.placements):
        if p.is_shard(dim):
            n //= mesh.size(i)
            off += mesh.get_coordinate()[i] * n
    lo, hi = max(start, off), min(start + src.shape[dim], off + n)
    if lo < hi:
        local.narrow(dim, lo - off, hi - lo).copy_(
            src.narrow(dim, lo - start, hi - lo))


class _GradLaidOut(torch.autograd.Function):
    """``x`` itself; its gradient redistributed to ``x``'s layout (the
    gradient of a partial sum is whole: ``Replicate`` there)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        ctx.mesh = x.device_mesh
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g.placements == ctx.placements:
            return g
        return g.redistribute(ctx.mesh, ctx.placements)


def grad_laid_out(x: torch.Tensor) -> torch.Tensor:
    """``x`` whose gradient comes back laid out as ``x`` is, on a mesh of
    several devices: before a product whose backward folds ``x``'s dims
    (``x @ w`` folds the batch and the sequence), where DTensor may hand
    back a gradient sharded on a dim ``x`` keeps whole (the sequence over
    ``model``), a fold of two sharded dims it cannot carry. ``x`` itself
    with no mesh, on a mesh of one device and for a plain tensor."""
    if not distributed(x):
        return x
    return _GradLaidOut.apply(x)


def splittable(x: torch.Tensor, *leads) -> torch.Tensor:
    """``x`` ready for each dim ``d`` with a ``leads[d]`` (None for a dim
    that is not split) to be split into (``leads[d]``, ...) by a view,
    and its gradient ready for the same: a DTensor sharded on ``d`` over
    mesh dims whose total size does not divide ``leads[d]`` has those
    mesh dims gathered (``Replicate()``), in the forward and in the
    backward, since DTensor cannot unflatten such a shard (XLA's
    partitioner reshards there on its own). Put it after a view whose
    backward splits and before a view that splits in the forward. ``x``
    itself with no mesh, on a mesh of one device and for a plain
    tensor."""
    if not distributed(x):
        return x
    return _Splittable.apply(x, tuple(leads))


def _local_einsum_placements(eq: str, operands: tuple):
    """How ``torch.einsum(eq, *operands)`` is computed on each device's
    local shards: (mesh, the output's placements, each operand's
    placements to take its local tensor in, and its gradient's), or None
    where it is not. Per mesh dim, either every operand is replicated; or
    one letter of ``eq`` is sharded there (evenly, as ``constrain`` binds
    only divisors) in some operands and the others are replicated: an
    operand holding the letter is cut to its shard of it (a replicated one
    with no collective), a letter of the output gives ``Shard``, a
    contracted one ``Partial``, and an operand without the letter a
    ``Partial`` gradient; or one operand is a ``Partial`` sum and the others are
    replicated (the product is linear in it): the output is ``Partial``,
    the gradient of that operand replicated and of the others
    ``Partial``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    if (any(not isinstance(t, DTensor) for t in operands)
            or len({t.device_mesh for t in operands}) != 1
            or any("." in a for a in ins)):
        return None
    mesh = operands[0].device_mesh
    out_pl, takes, grads = [], [[] for _ in operands], [[] for _ in operands]
    for i in range(mesh.ndim):
        here = [t.placements[i] for t in operands]
        if any(type(p) not in (Shard, Replicate) and not p.is_partial()
               for p in here):
            return None
        letters = {sub[p.dim] for p, sub in zip(here, ins) if type(p) is Shard}
        partial = [j for j, p in enumerate(here) if p.is_partial()]
        if partial:
            if (len(partial) > 1 or letters
                    or here[partial[0]] != Partial("sum")):
                return None
            out_pl.append(Partial())
            for j, (take, g) in enumerate(zip(takes, grads)):
                take.append(here[j])
                g.append(Replicate() if j == partial[0] else Partial())
            continue
        if len(letters) > 1:
            return None
        if not letters:
            out_pl.append(Replicate())
            for take, g in zip(takes, grads):
                take.append(Replicate())
                g.append(Replicate())
            continue
        (letter,) = letters
        for p, sub, take, g in zip(here, ins, takes, grads):
            if letter in sub:
                if (type(p) is Shard and p.dim != sub.index(letter)) \
                        or sub.count(letter) > 1:
                    return None
                take.append(Shard(sub.index(letter)))
                g.append(Shard(sub.index(letter)))
            else:
                take.append(p)
                g.append(Partial())
        out_pl.append(Shard(out.index(letter)) if letter in out
                      else Partial())
    return mesh, tuple(out_pl), takes, grads


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *operands)``; on DTensors inside ``use_mesh`` of
    a mesh of several devices, where each mesh dim shards one letter of
    ``eq`` in every operand that has it, computed on the local shards
    and laid out again (``_local_einsum_placements``). DTensor turns an
    einsum into a ``bmm`` whose batch dim folds the batch letters, and
    cannot give a sharding to a fold of two sharded dims (the batch over
    the data axes and the heads over ``model``: a strided shard). The
    same ``torch.einsum`` with no mesh, on a mesh of one device, and
    where the layouts do not allow it."""
    if not distributed(operands[0]):
        return torch.einsum(eq, *operands)
    plan = _local_einsum_placements(eq, operands)
    if plan is None:
        return torch.einsum(eq, *operands)
    from torch.distributed.tensor import DTensor
    mesh, out_pl, takes, grads = plan
    local = torch.einsum(eq, *(
        t.redistribute(mesh, take).to_local(grad_placements=g)
        for t, take, g in zip(operands, takes, grads)))
    return DTensor.from_local(local, mesh, out_pl, run_check=False)
