"""The genomics workflow (paper Example 1): embed gene mentions, cluster,
iterate (twin of the JAX package's ``examples/genomics_iterate.py``).
Compares OPT against NEVER-materialize cumulative time over 4 edits; the
skip-gram embeddings and k-means run on ``--device``.

    python -m repro_torch.examples.genomics_iterate             # on the card
    python -m repro_torch.examples.genomics_iterate --device cpu --docs 150
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

from .. import workflows as W
from ..core import EngineConfig, IterativeSession, Policy
from ..device import resolve


def edits(n_docs: int) -> list[W.GenomicsKnobs]:
    """The reference's four iterations: cold, an L/I edit of the cluster
    count, a PPR edit of the report, and the cluster count again."""
    base = dataclasses.replace(W.GenomicsKnobs(), n_docs=n_docs, emb_epochs=6)
    return [
        base,
        dataclasses.replace(base, n_clusters=32),     # L/I: cluster count
        dataclasses.replace(base, n_clusters=32, report_top=8),  # PPR
        dataclasses.replace(base, n_clusters=8),      # L/I again
    ]


def run(policy: Policy, n_docs: int, device) -> dict:
    """The four iterations under ``policy`` in a fresh workdir."""
    total, iters = 0.0, []
    with tempfile.TemporaryDirectory() as workdir:
        sess = IterativeSession(workdir, engine=EngineConfig(policy=policy))
        for i, knobs in enumerate(edits(n_docs)):
            t0 = time.perf_counter()
            rep = sess.run(W.build_genomics(knobs, device=device))
            dt = time.perf_counter() - t0
            total += dt
            ex = rep.execution
            report = rep.outputs["clusterReport"]
            iters.append({"seconds": dt, "n_computed": ex.n_computed,
                          "n_loaded": ex.n_loaded, "n_pruned": ex.n_pruned,
                          "clusterReport": report})
            print(f"  [{policy.value}] iter {i}: {dt:6.2f}s  "
                  f"(computed {ex.n_computed}, loaded {ex.n_loaded}, "
                  f"pruned {ex.n_pruned})  inertia={report['inertia']:.0f}")
    return {"total_s": total, "iterations": iters}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=1500,
                    help="documents (the reference's 1,500)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    print("genomics workflow: 4 iterations (cluster-count + report edits)")
    runs = {p.name: run(p, args.docs, dev) for p in (Policy.NEVER, Policy.OPT)}
    t_nm, t_opt = runs["NEVER"]["total_s"], runs["OPT"]["total_s"]
    speedup = t_nm / t_opt
    print(f"\ncumulative: NEVER={t_nm:.2f}s  OPT={t_opt:.2f}s  "
          f"speedup {speedup:.2f}x "
          f"(the expensive word2vec node is reused across edits)")
    return {**runs, "speedup": speedup}


if __name__ == "__main__":
    main()
