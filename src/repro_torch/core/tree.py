"""Pytrees for the core: the port's stand-in for ``jax.tree_util``.

The store numbers a value's leaves (``leaf_{i}.npy``, the per-leaf
placement callable ``sharding_for_leaf(i, ...)``), so leaf ``i`` must be
the same leaf in both packages. The flatten order is therefore JAX's:

* ``dict`` — keys in sorted order (``jax.tree_util`` sorts them; an
  ``OrderedDict`` keeps its insertion order, as in JAX);
* ``None`` — an empty subtree (no leaves);
* ``tuple``, ``list`` and NamedTuples — children in order;
* a class registered with :func:`register_node` — its flatten function's
  children in order;
* anything else (``torch.Tensor``, ``np.ndarray``, scalars, strings…) is
  a leaf.

A :class:`TreeDef` is plain data (node kinds, dict keys, classes), so it
pickles: the store writes it next to the leaves as ``treedef.pkl``.
``torch.utils._pytree`` is not used: it is private, and it keeps dict
insertion order.

:func:`block_until_ready` is the twin of ``jax.block_until_ready``: it
waits for the device work that produces a tree's CUDA tensors.
"""
from __future__ import annotations

import collections
from typing import Any, Callable

import torch

# class -> (flatten(obj) -> (children, aux), unflatten(aux, children) -> obj)
_REGISTRY: dict[type, tuple[Callable, Callable]] = {}


def register_node(cls: type, flatten: Callable, unflatten: Callable) -> None:
    """Make instances of ``cls`` interior nodes (the signature of
    ``jax.tree_util.register_pytree_node``): ``flatten(obj)`` returns
    ``(children, aux)``, with ``children`` an iterable of subtrees, and
    ``unflatten(aux, children)`` rebuilds the object."""
    _REGISTRY[cls] = (flatten, unflatten)


class TreeDef:
    """The structure of a flattened tree. ``kind`` is ``"leaf"``,
    ``"none"``, ``"dict"``, ``"odict"``, ``"tuple"``, ``"list"``,
    ``"namedtuple"`` or ``"custom"``; ``meta`` holds the dict keys, the
    NamedTuple class, or ``(cls, aux)`` of a registered node."""

    __slots__ = ("kind", "meta", "children", "num_leaves")

    def __init__(self, kind: str, meta: Any = None,
                 children: tuple = ()) -> None:
        self.kind = kind
        self.meta = meta
        self.children = tuple(children)
        self.num_leaves = (1 if kind == "leaf" else
                           sum(c.num_leaves for c in self.children))

    def __getstate__(self):
        return (self.kind, self.meta, self.children)

    def __setstate__(self, state) -> None:
        self.__init__(*state)

    def __eq__(self, other) -> bool:
        return (isinstance(other, TreeDef) and self.kind == other.kind
                and self.meta == other.meta
                and self.children == other.children)

    def __hash__(self) -> int:
        return hash((self.kind, self.children))

    def __repr__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        return f"{self.kind}({self.meta!r}, {list(self.children)!r})"


_LEAF = TreeDef("leaf")
_NONE = TreeDef("none")


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _flatten(tree: Any, leaves: list) -> TreeDef:
    if tree is None:
        return _NONE
    node = _REGISTRY.get(type(tree))
    if node is not None:
        children, aux = node[0](tree)
        return TreeDef("custom", (type(tree), aux),
                       tuple(_flatten(c, leaves) for c in children))
    if isinstance(tree, dict):
        if isinstance(tree, collections.OrderedDict):
            keys, kind = list(tree), "odict"
        else:
            keys, kind = sorted(tree), "dict"
        return TreeDef(kind, tuple(keys),
                       tuple(_flatten(tree[k], leaves) for k in keys))
    if _is_namedtuple(tree):
        return TreeDef("namedtuple", type(tree),
                       tuple(_flatten(c, leaves) for c in tree))
    if isinstance(tree, (tuple, list)):
        return TreeDef("tuple" if isinstance(tree, tuple) else "list", None,
                       tuple(_flatten(c, leaves) for c in tree))
    leaves.append(tree)
    return _LEAF


def tree_flatten(tree: Any) -> tuple[list, TreeDef]:
    """``(leaves, treedef)``, leaves in ``jax.tree_util``'s order."""
    leaves: list = []
    treedef = _flatten(tree, leaves)
    return leaves, treedef


def _build(td: TreeDef, it) -> Any:
    kind = td.kind
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    children = [_build(c, it) for c in td.children]
    if kind == "dict":
        return dict(zip(td.meta, children))
    if kind == "odict":
        return collections.OrderedDict(zip(td.meta, children))
    if kind == "tuple":
        return tuple(children)
    if kind == "list":
        return children
    if kind == "namedtuple":
        return td.meta(*children)
    cls, aux = td.meta
    return _REGISTRY[cls][1](aux, tuple(children))


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    leaves = list(leaves)
    if len(leaves) != treedef.num_leaves:
        raise ValueError(f"treedef wants {treedef.num_leaves} leaves, "
                         f"got {len(leaves)}")
    return _build(treedef, iter(leaves))


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``, which must have ``tree``'s structure)."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for other in rest:
        o_leaves, o_def = tree_flatten(other)
        if o_def != treedef:
            raise ValueError(f"tree structures differ: {treedef!r} vs "
                             f"{o_def!r}")
        others.append(o_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def cuda_devices(tree: Any) -> set[torch.device]:
    """The CUDA devices that the tree's tensor leaves live on."""
    return {leaf.device for leaf in tree_leaves(tree)
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda}


def block_until_ready(tree: Any) -> Any:
    """Wait until the device work queued for the tree's CUDA tensors has
    run: the current stream of each device they live on is synchronised
    once (not once per leaf, and not the whole device). Returns ``tree``."""
    for dev in cuda_devices(tree):
        torch.cuda.current_stream(dev).synchronize()
    return tree
