"""Change tracking via recursive signatures (paper §4.2, Defs. 2-3).

The paper's equivalence test: a node is equivalent across iterations iff its
own declaration is unchanged *and* all ancestors are equivalent. We realize
this with a content signature computed bottom-up:

    sig(n) = H(name, kind, version, [sig(p) for p in parents])

Two nodes with equal signatures are *representationally equivalent* in the
paper's sense (conservative: false positives on changes are possible — e.g.
``a+b`` vs ``b+a`` get different signatures — but false negatives are not,
which is what Theorem 1 requires for correctness).

Nondeterministic nodes get a fresh nonce mixed into their signature at every
compilation, so they are never equivalent to any prior run (paper's MNIST
workflow relies on this).
"""
from __future__ import annotations

import hashlib
import uuid

from .dag import DAG


def compute_signatures(dag: DAG, nonces: dict[str, str] | None = None
                       ) -> dict[str, str]:
    """Return ``{node name: hex signature}`` for every node in ``dag``.

    ``nonces`` optionally pins the nonce used for nondeterministic nodes
    (used by tests); by default a fresh uuid4 is drawn per compilation.
    """
    sigs: dict[str, str] = {}
    for name in dag.topological():
        node = dag.nodes[name]
        h = hashlib.sha256()
        h.update(node.name.encode())
        h.update(node.kind.value.encode())
        h.update(str(node.version).encode())
        if not node.deterministic:
            nonce = (nonces or {}).get(name, uuid.uuid4().hex)
            h.update(nonce.encode())
        for p in node.parents:
            h.update(sigs[p].encode())
        sigs[name] = h.hexdigest()
    return sigs


def compute_chunk_signatures(dag: DAG, sigs: dict[str, str]) -> dict:
    """Chunk-level refinement of :func:`compute_signatures`.

    Where the full signature answers "is this node's whole output
    equivalent to a prior run?", the chunk signature answers it *per data
    chunk*:

        chunk_sig(n, j) = H(name, kind, version,
                            [chunk_sig(p, j) for chunked parents],
                            [sig(p) for broadcast parents])

    seeded at chunked sources by H(name, kind, chunk_id_j) — the source
    ``version`` (which changes on every append) is deliberately left out,
    so the pre-append prefix keeps its chunk signatures and only the
    appended chunks are new work. Returns ``{node name:
    :class:`~repro_torch.core.chunks.ChunkPlan`}`` for every node chunk
    signatures can flow to; all derivation rules live in
    :func:`repro_torch.core.chunks.compute_chunk_plans`.
    """
    from .chunks import compute_chunk_plans
    return compute_chunk_plans(dag, sigs)


def source_version(obj) -> str:
    """Hash an arbitrary config/source blob into a version string.

    The DSL uses this to derive ``Node.version`` from operator configuration,
    so editing a hyperparameter automatically deprecates the node (and, via
    the recursive signature, all descendants) — exactly the paper's
    representational-equivalence check.
    """
    h = hashlib.sha256()
    h.update(repr(obj).encode())
    return h.hexdigest()[:16]
