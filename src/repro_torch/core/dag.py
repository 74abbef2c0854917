"""Workflow DAG — the paper's central abstraction (§4.1, Def. 1).

Nodes correspond to *operator outputs*; edges to input→output relationships.
Each node carries the callable that produces its output from its parents'
outputs, plus the metadata the optimizer needs (version string for change
tracking, determinism flag, output flag).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Mapping, Sequence


class State(enum.Enum):
    """Execution state assignment (paper §5.1): compute / load / prune."""

    COMPUTE = "compute"
    LOAD = "load"
    PRUNE = "prune"


class Kind(enum.Enum):
    """Operator kinds mirroring the HML interfaces (paper §3.2.2)."""

    SOURCE = "source"          # data source (root; l_i == c_i in the paper)
    SCANNER = "scanner"        # parsing / flatMap
    EXTRACTOR = "extractor"    # feature extraction / transformation
    SYNTHESIZER = "synthesizer"  # join / example assembly
    LEARNER = "learner"        # learning + inference
    REDUCER = "reducer"        # PPR reduce
    SEGMENT = "segment"        # a training segment (N optimizer steps) — the
                               # unit of fault-tolerant reuse in Helix-JAX


@dataclasses.dataclass(frozen=True)
class Node:
    """A single operator output in the Workflow DAG."""

    name: str
    fn: Callable[..., Any]
    parents: tuple[str, ...] = ()
    kind: Kind = Kind.EXTRACTOR
    # ``version`` participates in the signature: editing an operator between
    # iterations means giving it a new version (the DSL hashes source/config).
    version: str = "0"
    # Nondeterministic operators (e.g. unseeded random featurization, as in
    # the paper's MNIST workflow) can never be reused across iterations.
    deterministic: bool = True
    # Mandatory output (HML ``is_output``): must not be pruned and is always
    # materialized by the executor.
    is_output: bool = False
    # Optional a-priori compute-cost estimate in seconds (e.g. derived from a
    # dry-run roofline) used when no measured statistics exist yet.
    cost_hint: float | None = None
    # Operator capability for incremental recomputation on data deltas
    # (chunks.py): "map" (row-local, applies per chunk), "union"
    # (row-concat of parents), "assoc_reduce" (chunk → partial, partials
    # combine associatively), or None (opaque: whole-subtree recompute on
    # any input change).
    incremental: str | None = None
    # Chunked sources only: one stable identity per data chunk (hash of
    # the chunk's descriptor). Appending a batch appends an id; the
    # prefix ids — and therefore the prefix chunk signatures — survive,
    # which is what makes the delta the only new work.
    chunk_ids: tuple[str, ...] | None = None


class DAG:
    """An immutable-ish DAG of :class:`Node` keyed by name."""

    def __init__(self, nodes: Sequence[Node]):
        self.nodes: dict[str, Node] = {}
        for n in nodes:
            if n.name in self.nodes:
                raise ValueError(f"duplicate node name: {n.name}")
            self.nodes[n.name] = n
        for n in nodes:
            for p in n.parents:
                if p not in self.nodes:
                    raise ValueError(f"{n.name}: unknown parent {p!r}")
        self._children: dict[str, list[str]] = {k: [] for k in self.nodes}
        for n in nodes:
            for p in n.parents:
                self._children[p].append(n.name)
        self._order = self._toposort()

    # -- structure ---------------------------------------------------------
    def children(self, name: str) -> list[str]:
        return self._children[name]

    def parents(self, name: str) -> tuple[str, ...]:
        return self.nodes[name].parents

    def topological(self) -> list[str]:
        return list(self._order)

    def ancestors(self, name: str) -> set[str]:
        out: set[str] = set()
        stack = list(self.nodes[name].parents)
        while stack:
            cur = stack.pop()
            if cur not in out:
                out.add(cur)
                stack.extend(self.nodes[cur].parents)
        return out

    def outputs(self) -> list[str]:
        return [n.name for n in self.nodes.values() if n.is_output]

    def subgraph(self, keep: set[str]) -> "DAG":
        return DAG([self.nodes[k] for k in self._order if k in keep])

    def _toposort(self) -> list[str]:
        indeg = {k: len(n.parents) for k, n in self.nodes.items()}
        # Deterministic order: seed with insertion order.
        ready = [k for k in self.nodes if indeg[k] == 0]
        order: list[str] = []
        while ready:
            cur = ready.pop(0)
            order.append(cur)
            for ch in self._children[cur]:
                indeg[ch] -= 1
                if indeg[ch] == 0:
                    ready.append(ch)
        if len(order) != len(self.nodes):
            raise ValueError("cycle detected in workflow DAG")
        return order

    # -- scheduler support (executor's ready-set engine) -------------------
    def exec_indegree(self, states: Mapping[str, State]) -> dict[str, int]:
        """Unfinished-dependency count per runnable node under a plan.

        COMPUTE nodes wait on every non-pruned parent (Constraint 2 says
        there are no pruned ones; if a broken plan violates that, the node
        runs anyway and fails with the sequential engine's KeyError instead
        of deadlocking the pool). LOAD nodes are pure store I/O with no
        dependencies, so they are ready — and prefetchable — the moment
        planning finishes. PRUNE nodes never run and are omitted.
        """
        indeg: dict[str, int] = {}
        for name, node in self.nodes.items():
            s = states[name]
            if s is State.PRUNE:
                continue
            indeg[name] = (sum(1 for p in node.parents
                               if states[p] is not State.PRUNE)
                           if s is State.COMPUTE else 0)
        return indeg

    def oos_order(self, states: Mapping[str, State]) -> list[str]:
        """The deterministic out-of-scope sequence of the sequential engine.

        Replays the topological sweep symbolically: a node goes out of scope
        (Def. 5 / Constraint 3) when its last COMPUTE-state child executes,
        or immediately after its own execution if it has none. The parallel
        scheduler processes materialization decisions strictly in this order
        so OMP decisions and budget accounting are identical for any worker
        count.
        """
        remaining = {
            name: sum(1 for ch in self._children[name]
                      if states[ch] is State.COMPUTE)
            for name in self.nodes
        }
        order: list[str] = []
        for name in self._order:
            s = states[name]
            if s is State.PRUNE:
                continue
            if s is State.COMPUTE:
                for p in self.nodes[name].parents:
                    remaining[p] -= 1
                    if remaining[p] == 0 and states[p] is not State.PRUNE:
                        order.append(p)
            if remaining[name] == 0:
                order.append(name)
        return order

    def __len__(self) -> int:
        return len(self.nodes)

    def __contains__(self, name: str) -> bool:
        return name in self.nodes


def validate_states(dag: DAG, states: Mapping[str, State]) -> None:
    """Check Constraint 2 (computed node's parents not pruned) and that
    mandatory outputs are not pruned. Raises ``ValueError`` on violation."""
    for name, node in dag.nodes.items():
        s = states[name]
        if s is State.COMPUTE:
            for p in node.parents:
                if states[p] is State.PRUNE:
                    raise ValueError(
                        f"Constraint 2 violated: {name} computed but parent "
                        f"{p} pruned")
        if node.is_output and s is State.PRUNE:
            raise ValueError(f"output node {name} pruned")
