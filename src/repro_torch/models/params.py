"""Declarative parameter trees (twin of the JAX package's ``models/params.py``).

A model is described once as a nested dict of :class:`P` leaves (shape,
logical axis names, init, dtype); :func:`init_params` materializes it on a
device from an explicit ``torch.Generator``. The tree layout is the
reference's leaf for leaf, so weights cross between the packages through
``convert.params_from_numpy``. ``param_specs``/``shardings_for`` come with
the distributed substrate.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class P:
    shape: tuple
    axes: tuple              # logical axis name (or None) per dim
    init: str = "normal"     # normal | zeros | ones
    scale: float | None = None   # stddev; default 0.02
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of nested dicts / lists / tuples, keeping
    the structure (dict keys in sorted order, as ``jax.tree_util`` walks)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def init_params(defs: Any, generator: torch.Generator,
                device: torch.device | str) -> Any:
    """Materialize a tree of P leaves into tensors on ``device``: normal·0.02
    drawn in fp32 then cast (or ``P.scale``), zeros or ones, in ``P.dtype``.
    ``generator`` must live on ``device``."""
    def make(p: P) -> torch.Tensor:
        assert isinstance(p, P), f"non-P leaf: {p}"
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=p.dtype, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=p.dtype, device=device)
        scale = p.scale if p.scale is not None else 0.02
        arr = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                          device=device)
        return (arr * scale).to(p.dtype)

    return tree_map(make, defs)
