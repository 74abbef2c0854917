"""Daily retrain on an append-mostly table: chunk-spliced recomputation
(twin of the JAX package's ``examples/incremental_census.py``).

A census table grows by one day's batch of rows, and the retrain only
pushes the *new* chunk through the map-safe featurization, splicing it
into the cached per-chunk manifests; the model itself (gradient descent
over all rows) still retrains on the assembled whole. The workflow is
numpy, as in the reference: ``--device`` is resolved (``cuda`` without a
card raises) and holds nothing.

    python -m repro_torch.examples.incremental_census           # on the card
    python -m repro_torch.examples.incremental_census --device cpu \\
        --rows-per-chunk 300
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

from .. import workflows as W
from ..core import EngineConfig, IterativeSession, Policy
from ..device import resolve


def show(title: str, rep, seconds: float) -> dict:
    """Print one day's report; return what was printed."""
    ex = rep.execution
    print(f"\n=== {title} ===")
    print(f"  wall {seconds:.2f}s | computed {ex.n_computed}, "
          f"loaded {ex.n_loaded}")
    chunks = {}
    for n in sorted(set(ex.chunk_computed) | set(ex.chunk_reused)):
        chunks[n] = (ex.chunk_computed.get(n, 0), ex.chunk_reused.get(n, 0))
        print(f"   {n:12s} chunks: {chunks[n][0]} computed, "
              f"{chunks[n][1]} spliced from cache")
    print(f"  eval: {rep.outputs['dailyEval']}")
    return {"title": title, "seconds": seconds, "n_computed": ex.n_computed,
            "n_loaded": ex.n_loaded, "chunks": chunks,
            "dailyEval": rep.outputs["dailyEval"]}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows-per-chunk", type=int, default=2_000,
                    help="rows of a day's batch (the reference's 2,000)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    knobs = dataclasses.replace(W.IncrementalCensusKnobs(), n_chunks=6,
                                rows_per_chunk=args.rows_per_chunk)
    days = []
    with tempfile.TemporaryDirectory() as workdir:
        sess = IterativeSession(workdir,
                                engine=EngineConfig(policy=Policy.ALWAYS))

        # Day 0: cold — every chunk of every chunked node computes.
        t0 = time.perf_counter()
        rep = sess.run(W.build_census_incremental(knobs, device=dev))
        days.append(show("day 0 (cold: all chunks computed)", rep,
                         time.perf_counter() - t0))

        # Day 1: one batch appended. The chunked nodes compute exactly
        # one new chunk each and splice the rest; only the opaque model
        # + eval recompute whole.
        knobs = dataclasses.replace(knobs, n_chunks=knobs.n_chunks + 1)
        t0 = time.perf_counter()
        rep = sess.run(W.build_census_incremental(knobs, device=dev))
        days.append(show("day 1 (append: delta chunks spliced)", rep,
                         time.perf_counter() - t0))
    return days


if __name__ == "__main__":
    main()
