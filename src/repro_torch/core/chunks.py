"""Chunk-partitioned values — incremental recomputation on data deltas.

Helix recomputes any node whose input signature changed, so appending one
data batch flips the source signature and recomputes entire subtrees: the
daily-retrain scenario gets zero reuse. Following "Spinning Fast Iterative
Data Flows" (PAPERS.md), this module makes materializations *partitioned*:
an append-mostly source declares per-chunk identities, chunk-level
signatures flow through operators that declared how they transform
per-chunk (``incremental=`` on :meth:`Workflow.node`), and the executor
recomputes only the chunks whose signatures it has never seen — splicing
them into cached per-chunk state.

Three operator capabilities are modeled (the classic incremental-dataflow
trio):

``"map"``
    Row-local: ``fn(concat(chunks)) == concat(fn(c) for c in chunks)``.
    Chunk ``j`` of the output depends only on chunk ``j`` of each chunked
    parent (non-chunked parents are broadcast whole). One-hot encoding and
    other per-row featurizers qualify; anything with global state (quantile
    bucketizers, standardizers) does not.
``"union"``
    Row-concatenation of its parents: the output's chunk list is the
    parents' chunk lists concatenated in parent order (``fn`` is never
    invoked on the incremental path — declaring ``union`` asserts the
    operator *is* concat).
``"assoc_reduce"``
    Associative aggregation: ``fn`` maps a chunk to a *partial* array and
    must satisfy ``fn(concat(chunks)) == fn(stack(partials))`` (sums,
    maxima, counts…). Cached partials combine with delta partials, so an
    append reduces only the new chunks. The node's output is the combined
    value — *not* chunked — so downstream consumers see a scalar world.

**Determinism contract.** Whenever a chunk plan exists for a node, the
executor computes it per-chunk *even on a cold store*. The result is then a
pure function of (chunk values, plan) — identical whether zero, some, or
all chunks came from cache — which is what makes the differential oracle's
bit-identity assertion (tests/test_incremental.py) hold exactly, including
for float reductions where a different summation order would drift ulps.

:class:`Chunked` is registered as a pytree node (``tree.register_node``)
so the store's host snapshot, byte estimates, and blocking helpers traverse
it transparently;
the store itself special-cases it *before* flattening to persist a
manifest + per-chunk entries (see store.py).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np
import torch

from .dag import DAG, Kind
from .tree import register_node, tree_map

#: Chunk-plan modes (``ChunkPlan.mode``); "source" marks a chunked root.
MODES = ("source", "map", "union", "assoc_reduce")


def _concat(*xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.cat(xs, dim=0)
    return np.concatenate([np.asarray(x) for x in xs], axis=0)


def _stack(*xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs, dim=0)
    return np.stack([np.asarray(x) for x in xs], axis=0)


def tree_concat(values: list) -> Any:
    """Concatenate a list of like-shaped pytrees leaf-wise along axis 0
    (arrays concat; a dict of columns concats per column). Tensor leaves
    go through ``torch.cat``, everything else through ``np.concatenate``."""
    if len(values) == 1:
        return values[0]
    return tree_map(_concat, *values)


def tree_stack(values: list) -> Any:
    """Stack a list of like-shaped pytrees leaf-wise along a new axis 0 —
    how assoc_reduce partials are fed back through ``fn`` to combine
    (``fn(concat(chunks)) == fn(stack(partials))``). Tensor leaves go
    through ``torch.stack``, everything else through ``np.stack``."""
    return tree_map(_stack, *values)


@dataclasses.dataclass
class Chunked:
    """A value carried as per-chunk pieces plus their chunk signatures.

    ``combine`` is ``"concat"`` (map/union/source chains: the logical
    value is the row-concatenation of ``chunks``) or ``"reduce"``
    (``chunks`` are assoc_reduce *partials* and ``final`` holds the
    combined output). :meth:`assemble` returns the logical value either
    way — opaque consumers always receive it assembled.
    """

    chunks: tuple
    chunk_sigs: tuple
    combine: str = "concat"
    final: Any = None

    def __post_init__(self) -> None:
        self.chunks = tuple(self.chunks)
        self.chunk_sigs = tuple(self.chunk_sigs)
        if len(self.chunks) != len(self.chunk_sigs):
            raise ValueError(
                f"{len(self.chunks)} chunks vs {len(self.chunk_sigs)} "
                "chunk signatures")
        if self.combine not in ("concat", "reduce"):
            raise ValueError(f"unknown combine {self.combine!r}")

    def __len__(self) -> int:
        return len(self.chunks)

    def assemble(self) -> Any:
        """The logical (un-partitioned) value this Chunked represents."""
        if self.combine == "reduce":
            return self.final
        return tree_concat(list(self.chunks))


def _flatten_chunked(c: Chunked):
    return (c.chunks, c.final), (c.chunk_sigs, c.combine)


def _unflatten_chunked(aux, children):
    chunks, final = children
    obj = object.__new__(Chunked)
    obj.chunks = tuple(chunks)
    obj.chunk_sigs = aux[0]
    obj.combine = aux[1]
    obj.final = final
    return obj


register_node(Chunked, _flatten_chunked, _unflatten_chunked)


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Per-node chunk-granular plan: how (and under which per-chunk
    signatures) the node's value partitions. Derived at planning time by
    :func:`compute_chunk_plans`; carried by the executor so the computed
    :class:`Chunked` always labels its pieces with plan signatures."""

    mode: str                       # one of MODES
    chunk_sigs: tuple               # per-chunk (or per-partial) signatures
    chunked_parents: tuple = ()     # parents that supply chunks

    @property
    def n_chunks(self) -> int:
        """Number of chunks (or reduce partials) this plan covers."""
        return len(self.chunk_sigs)


def _chunk_hash(*parts: str) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(str(p).encode())
        h.update(b"\x00")
    return h.hexdigest()


def compute_chunk_plans(dag: DAG, sigs: dict) -> dict:
    """Derive chunk-level signatures for every node they can flow to.

    Walks the DAG bottom-up, mirroring ``compute_signatures`` one level
    finer. A chunked *source* (``Node.chunk_ids`` set) seeds per-chunk
    signatures from its chunk identities — deliberately excluding the
    node ``version`` (which changes on every append; the chunk ids are
    what stay stable across appends). Downstream, a node joins the
    chunked world iff it declared an ``incremental`` capability, is
    deterministic, and its parents' plans are compatible:

    * ``map`` — at least one concat-mode chunked parent, all with equal
      chunk counts; chunk ``j``'s signature hashes the node identity,
      every chunked parent's chunk-``j`` signature and every non-chunked
      parent's *full* signature (so a change to broadcast state
      deprecates every chunk, exactly like the recursive full signature).
    * ``union`` — every parent chunked (concat mode); the chunk-signature
      list is the parents' lists concatenated.
    * ``assoc_reduce`` — exactly one concat-mode chunked parent; per-chunk
      *partial* signatures hash the node identity against the parent's
      chunk signatures. The plan's mode marks the output as not chunked
      (descendants fall back to whole-value signatures).

    Any node that fails these gates simply gets no plan — the executor
    then computes it whole from assembled parents, which is the paper's
    whole-subtree recompute fallback.
    """
    plans: dict = {}
    for name in dag.topological():
        node = dag.nodes[name]
        if not node.deterministic:
            continue
        if node.kind is Kind.SOURCE and node.chunk_ids:
            plans[name] = ChunkPlan(
                "source",
                tuple(_chunk_hash("chunk", name, node.kind.value, cid)
                      for cid in node.chunk_ids))
            continue
        inc = node.incremental
        if inc is None:
            continue
        cparents = tuple(p for p in node.parents
                         if p in plans and plans[p].mode != "assoc_reduce")
        if inc == "map":
            if not cparents:
                continue
            counts = {plans[p].n_chunks for p in cparents}
            if len(counts) != 1:
                continue
            others = tuple(sigs[p] for p in node.parents
                           if p not in cparents)
            csigs = tuple(
                _chunk_hash("chunk", name, node.kind.value, node.version,
                            *(plans[p].chunk_sigs[j] for p in cparents),
                            *others)
                for j in range(counts.pop()))
            plans[name] = ChunkPlan("map", csigs, cparents)
        elif inc == "union":
            if not node.parents or len(cparents) != len(node.parents):
                continue
            csigs = tuple(cs for p in node.parents
                          for cs in plans[p].chunk_sigs)
            plans[name] = ChunkPlan("union", csigs, cparents)
        elif inc == "assoc_reduce":
            if len(cparents) != 1:
                continue
            p0 = cparents[0]
            others = tuple(sigs[p] for p in node.parents if p != p0)
            csigs = tuple(
                _chunk_hash("partial", name, node.kind.value, node.version,
                            cs, *others)
                for cs in plans[p0].chunk_sigs)
            plans[name] = ChunkPlan("assoc_reduce", csigs, cparents)
        else:
            raise ValueError(
                f"{name}: unknown incremental capability {inc!r}; "
                f"expected one of {MODES[1:]} or None")
    return plans


def protected_chunk_sigs(chunk_plans: dict) -> frozenset:
    """Every chunk signature the upcoming execution may splice from.

    The §6.6 purge deletes *stale* manifests (same name, old full
    signature) before execution — but a delta's new manifest shares its
    prefix chunks with the manifest being purged. Passing this set as
    ``Store.delete(..., keep_chunks=...)`` keeps those still-valid
    sibling chunks on disk while the stale manifest itself goes."""
    return frozenset(cs for plan in chunk_plans.values()
                     for cs in plan.chunk_sigs)
