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
redistributed to the resolved placements. A plain tensor under an entry
that binds an axis raises: the sharded train step, whose activations are
DTensors, is ROADMAP queue 1 item 9c.

Also here, as pure functions of axis names and sizes (no process group):
``axis_sizes`` of a mesh or a ``{name: size}`` mapping, and
``placements``, the DTensor ``Shard``/``Replicate`` per mesh dim of a
spec.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Mapping

import torch

BATCH_AXES = ("pod", "data")   # logical batch → physical axes (filtered)
SEQ_AXES = ("data",)           # sequence parallelism for long-context decode

_local = threading.local()


def batch_axes() -> tuple:
    """Physical axes the logical batch maps to (overridable per run —
    e.g. pure-FSDP spreads batch over (pod, data, model))."""
    return getattr(_local, "batch_axes", BATCH_AXES)


@contextlib.contextmanager
def use_batch_axes(axes: tuple):
    prev = getattr(_local, "batch_axes", BATCH_AXES)
    _local.batch_axes = tuple(axes)
    try:
        yield
    finally:
        _local.batch_axes = prev


def active_mesh():
    """The mesh of the innermost ``use_mesh`` of this thread, or None."""
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """``mesh`` (a ``DeviceMesh``) is the active mesh of this thread inside
    the block; the one before it is restored at the end."""
    prev = active_mesh()
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


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
    ``x`` itself with no mesh or when every entry resolves to None, a
    DTensor redistributed to the resolved placements; a plain tensor
    under an entry that binds an axis raises (ROADMAP queue 1 item 9c)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    entries = resolve_entries(tuple(x.shape), axes, axis_sizes(mesh))
    if all(e is None for e in entries):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise NotImplementedError(
            f"constrain{tuple(axes)} binds mesh axes {entries} but got a "
            f"plain tensor: a sharded step runs on DTensors, which is "
            f"ROADMAP queue 1 item 9c")
    return x.redistribute(mesh, placements(entries, x.ndim,
                                           mesh.mesh_dim_names))
