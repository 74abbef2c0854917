"""Shared-store concurrent sweep: a census hyperparameter grid (twin of
the JAX package's ``examples/sweep_census.py``).

Eight variants (regularization × decision threshold) run concurrently
against ONE materialization store. The max-flow planner plus the store's
in-flight dedupe (per-signature compute leases) turn every shared prefix
into a single compute and N-1 loads:

* all 8 arms share the data pipeline (parse, feature extraction, example
  assembly), computed once fleet-wide;
* each pair of arms with the same ``reg`` also shares the trained model;
* only the per-arm evaluation differs.

The sweep's wall clock is compared with the same arms run isolated (a
fresh store each, so no reuse); no signature may be computed twice
fleet-wide, which is required. The learner runs on ``--device``.

    python -m repro_torch.examples.sweep_census                # on the card
    python -m repro_torch.examples.sweep_census --device cpu --rows 2000
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

from .. import workflows as W
from ..core import IterativeSession, grid, run_sweep
from ..device import resolve

AXES = {"reg": [0.01, 0.03, 0.1, 0.3], "eval_threshold": [0.5, 0.7]}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=30_000,
                    help="census rows (the reference's 30,000)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    base = dataclasses.replace(W.CensusKnobs(), n_rows=args.rows)
    variants = grid(base, AXES, functools.partial(W.build_census, device=dev),
                    name="census")
    print(f"sweeping {len(variants)} variants: "
          + ", ".join(v.name for v in variants))

    # --- isolated baseline: every arm cold, its own store, same
    # concurrency as the sweep (so the difference below is pure reuse) ----
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        with ThreadPoolExecutor(max_workers=len(variants)) as pool:
            list(pool.map(
                lambda iv: IterativeSession(
                    os.path.join(root, f"iso{iv[0]}")).run(iv[1].build()),
                enumerate(variants)))
    iso_s = time.perf_counter() - t0

    # --- one shared store, all arms concurrent ----------------------------
    with tempfile.TemporaryDirectory() as workdir:
        report = run_sweep(workdir, variants)
        report.raise_errors()

    speedup = iso_s / report.wall_seconds
    print(f"\nisolated (no reuse): {iso_s:6.2f}s")
    print(f"shared-store sweep:  {report.wall_seconds:6.2f}s   "
          f"→ {speedup:.2f}x")
    print(f"store size: {report.store_bytes / 1e6:.1f} MB")
    recomputed = {s: c for s, c in report.fleet_computes().items() if c > 1}
    print(f"signatures computed more than once fleet-wide: "
          f"{len(recomputed)}")

    print("\nper-arm results:")
    arms = []
    for r in report.results:
        ex = r.report.execution
        out = r.report.outputs["checkResults"]
        computed = ex.n_computed - len(ex.deduped)
        reused = ex.n_loaded + len(ex.deduped)
        arms.append({"name": r.variant.name, "computed": computed,
                     "reused": reused, "checkResults": out})
        print(f"  {r.variant.name:40s} "
              f"computed {computed:2d}  reused {reused:2d}  "
              f"{out['metric']}={out['value']:.3f}")
    if recomputed:
        raise AssertionError(f"{len(recomputed)} signatures computed more "
                             f"than once fleet-wide")
    return {"iso_s": iso_s, "sweep_s": report.wall_seconds,
            "speedup": speedup, "store_bytes": report.store_bytes,
            "recomputed": recomputed, "arms": arms}


if __name__ == "__main__":
    main()
