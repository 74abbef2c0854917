"""Tabular featurization operators (the census workflow's DPR layer).

A copy, in numpy, of the JAX package's ``data/tabular.py``: the same
inputs give the same bytes in both packages.

These mirror the HML extractors in the paper's Fig. 3: column extractors,
learned discretization (bucket boundaries from data — a *learned* DPR
function in the paper's taxonomy), one-hot encoding, interaction features,
and the example-assembly synthesizer that concatenates feature vectors and
records per-extractor provenance (used for data-driven pruning §5.4).

Incremental-capability notes (chunks.py): ``one_hot``, ``interact`` and
``fixed_bucketize`` are row-local — safe to declare ``incremental="map"``
on the nodes that wrap them. ``bucketize`` (quantile boundaries *learned
from the whole column*) and ``standardize`` (global mean/std) are NOT
maps: their output for row r depends on every other row, so the nodes
wrapping them must stay opaque (whole-recompute on any append).

The ``census_chunk_descriptors`` / ``load_census_chunks`` pair models an
append-mostly table for chunked sources: each descriptor is a stable
``(seed, n_rows)`` identity, a daily append appends one descriptor, and
the loader generates one column-dict per descriptor — so a chunked
``Workflow.source`` keeps its prefix chunk signatures across appends.
"""
from __future__ import annotations

import numpy as np


def column(rows: dict, name: str) -> np.ndarray:
    return np.asarray(rows[name])


def bucketize(values: np.ndarray, n_buckets: int) -> np.ndarray:
    """Learned discretizer: quantile boundaries estimated from the data."""
    qs = np.quantile(values, np.linspace(0, 1, n_buckets + 1)[1:-1])
    return np.digitize(values, qs).astype(np.int32)


def one_hot(values: np.ndarray, depth: int) -> np.ndarray:
    out = np.zeros((len(values), depth), np.float32)
    out[np.arange(len(values)), np.clip(values, 0, depth - 1)] = 1.0
    return out


def interact(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Interaction feature: outer product of two one-hot blocks."""
    n = len(a)
    return (a[:, :, None] * b[:, None, :]).reshape(n, -1)


def fixed_bucketize(values: np.ndarray, edges) -> np.ndarray:
    """Row-local discretizer: *fixed* bin edges, so (unlike ``bucketize``)
    each row's bucket is independent of the rest of the column — map-safe
    for chunked execution."""
    return np.digitize(values, np.asarray(edges)).astype(np.int32)


def census_chunk_descriptors(seed: int, n_chunks: int,
                             rows_per_chunk: int) -> list[tuple[int, int]]:
    """Stable per-chunk identities for an append-mostly census table.

    Descriptor ``i`` is ``(seed + i, rows_per_chunk)``; appending a day's
    batch means appending one descriptor, which leaves every existing
    descriptor — and therefore every existing chunk signature — intact."""
    return [(seed + i, rows_per_chunk) for i in range(n_chunks)]


def load_census_chunks(descriptors) -> list[dict]:
    """Source fn for ``Workflow.source(..., chunks=descriptors)``: one
    synthetic census column-dict per descriptor (deterministic per
    descriptor, so a regenerated chunk is bit-identical to its cached
    copy)."""
    from . import synth
    return [synth.census_rows(s, n) for s, n in descriptors]


def standardize(values: np.ndarray) -> np.ndarray:
    v = values.astype(np.float32)
    return ((v - v.mean()) / (v.std() + 1e-9))[:, None]


def assemble(feature_blocks: dict[str, np.ndarray]
             ) -> tuple[np.ndarray, dict[str, list[int]]]:
    """Synthesizer: concatenate blocks into FVs + provenance (extractor →
    feature column indices)."""
    mats, provenance, start = [], {}, 0
    for name in sorted(feature_blocks):
        m = feature_blocks[name]
        if m.ndim == 1:
            m = m[:, None]
        mats.append(m.astype(np.float32))
        provenance[name] = list(range(start, start + m.shape[1]))
        start += m.shape[1]
    return np.concatenate(mats, axis=1), provenance
