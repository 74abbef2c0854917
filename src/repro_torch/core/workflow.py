"""The Helix-JAX workflow DSL (the HML analogue, paper §3).

HML's operator interfaces map one-to-one:

    HML                  Helix-JAX
    -------------------  -------------------------------
    data source          Workflow.source(...)
    Scanner              Workflow.scanner(...)
    Extractor            Workflow.extractor(...)
    Synthesizer          Workflow.synthesizer(...)
    Learner              Workflow.learner(...)
    Reducer              Workflow.reducer(...)
    A results_from B     inputs=[B]
    A uses (e1, e2)      uses=[e1, e2]   (extra edges, UDF deps — §5.4)
    A is_output          wf.output(A)
    training segment     Workflow.segment(...)  (Helix-JAX extension)

Versions: the ``version`` of a node is derived from its config blob via
``source_version`` — editing a hyperparameter automatically deprecates the
node and (through recursive signatures) its descendants, which is exactly the
paper's representational-equivalence change tracking.

**Operators must not mutate their inputs.** JAX values are immutable;
torch tensors are not. The executor's in-memory cache and the store's
memory tier hand the very same tensors to every consumer (a memory-tier
hit is zero-copy), so an operator that writes into an input in place —
as ``decode_step`` writes its KV cache — would corrupt the value that
its parent computed, and with it a stored entry that later iterations
load. Such an operator clones what it writes into first
(``torch.Tensor.clone``).
"""
from __future__ import annotations

from typing import Any, Callable, Iterable

from .dag import DAG, Kind, Node
from .signature import source_version


class Ref:
    """Handle to a declared node; usable as an input to later declarations."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"Ref({self.name})"


def _names(items: Iterable) -> tuple[str, ...]:
    out = []
    for it in items or ():
        out.append(it.name if isinstance(it, Ref) else str(it))
    return tuple(out)


class Workflow:
    def __init__(self, name: str):
        self.name = name
        self._nodes: list[Node] = []
        self._outputs: set[str] = set()

    # -- generic declaration -----------------------------------------------------
    def node(self, name: str, fn: Callable, inputs: Iterable = (),
             kind: Kind = Kind.EXTRACTOR, config: Any = None,
             uses: Iterable = (), deterministic: bool = True,
             cost_hint: float | None = None,
             incremental: str | None = None,
             chunk_ids: tuple[str, ...] | None = None) -> Ref:
        """Declare one operator output.

        ``incremental`` declares how the operator transforms per-chunk —
        ``"map"`` (row-local), ``"union"`` (row-concat of its parents) or
        ``"assoc_reduce"`` (chunk → partial, partials combine
        associatively) — enabling chunk-granular reuse on data deltas
        (see chunks.py for the exact contracts). ``None`` (default)
        keeps the operator opaque: any input change recomputes it whole.
        """
        if incremental not in (None, "map", "union", "assoc_reduce"):
            raise ValueError(
                f"{name}: incremental={incremental!r} is not one of "
                "'map', 'union', 'assoc_reduce', None")
        parents = _names(inputs) + _names(uses)
        self._nodes.append(Node(
            name=name, fn=fn, parents=parents, kind=kind,
            version=source_version(config),
            deterministic=deterministic, cost_hint=cost_hint,
            incremental=incremental,
            chunk_ids=tuple(chunk_ids) if chunk_ids else None))
        return Ref(name)

    # -- HML-style sugar -----------------------------------------------------------
    def source(self, name, fn, config=None, chunks=None, **kw) -> Ref:
        """Declare a data source. ``chunks`` (an iterable of per-chunk
        descriptors, e.g. ``[(seed, n_rows), ...]``) declares an
        append-mostly *chunked* source: ``fn`` must then return one value
        per descriptor (a list), ``config`` defaults to the descriptor
        tuple, and each chunk's identity is the hash of its descriptor —
        so appending a batch leaves the existing chunks' identities (and
        downstream chunk signatures) intact."""
        if chunks is not None:
            chunks = tuple(chunks)
            if config is None:
                config = chunks
            kw = dict(kw, chunk_ids=tuple(source_version(c)
                                          for c in chunks))
        return self.node(name, fn, (), Kind.SOURCE, config, **kw)

    def scanner(self, name, fn, inputs, config=None, **kw) -> Ref:
        return self.node(name, fn, inputs, Kind.SCANNER, config, **kw)

    def extractor(self, name, fn, inputs, config=None, **kw) -> Ref:
        return self.node(name, fn, inputs, Kind.EXTRACTOR, config, **kw)

    def synthesizer(self, name, fn, inputs, config=None, **kw) -> Ref:
        return self.node(name, fn, inputs, Kind.SYNTHESIZER, config, **kw)

    def learner(self, name, fn, inputs, config=None, **kw) -> Ref:
        return self.node(name, fn, inputs, Kind.LEARNER, config, **kw)

    def reducer(self, name, fn, inputs, config=None, **kw) -> Ref:
        return self.node(name, fn, inputs, Kind.REDUCER, config, **kw)

    def segment(self, name, fn, inputs, config=None, **kw) -> Ref:
        """A fault-tolerance unit: N optimizer steps as one reusable node."""
        return self.node(name, fn, inputs, Kind.SEGMENT, config, **kw)

    def output(self, ref: Ref) -> Ref:
        self._outputs.add(ref.name)
        return ref

    # -- compilation -----------------------------------------------------------------
    def build(self) -> DAG:
        nodes = []
        for n in self._nodes:
            if n.name in self._outputs:
                import dataclasses
                n = dataclasses.replace(n, is_output=True)
            nodes.append(n)
        return DAG(nodes)
