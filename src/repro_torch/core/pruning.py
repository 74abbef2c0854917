"""Workflow DAG pruning (paper §5.4).

* ``slice_from_outputs`` — program slicing: keep only ancestors of outputs
  (plus explicit ``uses`` dependencies, which the DSL already encodes as
  edges). The raceExt example in the paper's Fig. 3 is pruned this way.
* ``zero_weight_extractors`` — data-driven pruning: given a trained linear
  model's weights and per-feature provenance (which extractor produced each
  feature column), report extractors whose every feature has |w| below
  tolerance; these can be dropped in the next iteration without changing
  predictions.
* ``stale_variants`` — the §6.6 purge's selection rule: which store
  signatures are *stale* materializations of this iteration's original
  nodes (same node name, different signature). Extracted from the session
  so the suppression rules — never the node's own current signature, only
  names actually original this iteration — are unit-testable without a
  store.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from .dag import DAG


def slice_from_outputs(dag: DAG) -> set[str]:
    keep: set[str] = set()
    stack = list(dag.outputs())
    while stack:
        cur = stack.pop()
        if cur in keep:
            continue
        keep.add(cur)
        stack.extend(dag.nodes[cur].parents)
    return keep


def stale_variants(by_name: Mapping[str, Sequence[str]],
                   original: set[str],
                   sigs: Mapping[str, str]) -> list[str]:
    """Store signatures the §6.6 purge should delete, in deterministic
    order: every stored signature under an *original* node's name except
    the node's own current signature. Names that are not original this
    iteration are untouched — their stored variants may belong to sibling
    sessions (sweep mode) or to this session's own still-equivalent past.
    The caller handles chunk protection (``Store.delete(keep_chunks=…)``):
    a stale chunked manifest's *prefix chunks* are typically shared with
    the delta manifest about to be computed."""
    out: list[str] = []
    for n in sorted(original):
        for old_sig in by_name.get(n, []):
            if old_sig != sigs[n]:
                out.append(old_sig)
    return out


def zero_weight_extractors(weights: np.ndarray,
                           provenance: Mapping[str, Sequence[int]],
                           tol: float = 1e-8) -> set[str]:
    """Extractors whose features all have |weight| < tol (prunable)."""
    w = np.asarray(weights).reshape(-1)
    prunable = set()
    for extractor, cols in provenance.items():
        cols = list(cols)
        if cols and np.all(np.abs(w[cols]) < tol):
            prunable.add(extractor)
    return prunable
