"""Quickstart: the paper's census workflow (Fig. 3), three iterations
(twin of the JAX package's ``examples/quickstart.py``).

Shows the full Helix loop: declare a workflow in the DSL → run → edit →
re-run with cross-iteration reuse. Watch the per-node states: the PPR edit
(iteration 1) loads or prunes everything upstream of the changed reducer
that the first iteration stored, which is required here
(``check_ppr_edit``). The learner runs on ``--device``.

    python -m repro_torch.examples.quickstart                # on the card
    python -m repro_torch.examples.quickstart --device cpu --rows 3000
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

from .. import workflows as W
from ..core import IterativeSession, State
from ..device import resolve


def show(title: str, rep) -> dict:
    """Print one iteration's report; return what was printed."""
    ex = rep.execution
    out = {"title": title, "total_seconds": rep.total_seconds,
           "n_computed": ex.n_computed, "n_loaded": ex.n_loaded,
           "n_pruned": ex.n_pruned, "store_bytes": rep.store_bytes,
           "states": {n: s.value for n, s in sorted(ex.states.items())},
           "original": sorted(rep.original),
           "output": rep.outputs["checkResults"]}
    print(f"\n=== {title} ===")
    print(f"  total {rep.total_seconds:.2f}s | "
          f"computed {ex.n_computed}, loaded {ex.n_loaded}, "
          f"pruned {ex.n_pruned} | store {rep.store_bytes / 1e6:.1f} MB")
    for n, s in out["states"].items():
        mark = "*" if n in rep.original else " "
        print(f"   {mark} {n:14s} {s}")
    print(f"  output: {out['output']}")
    return out


def check_ppr_edit(rep) -> None:
    """The PPR edit's bar: the edited reducer is the only original node,
    the model is not retrained, and every other node upstream of the
    reducer is loaded or pruned, unless the first iteration did not store
    it (OMP found ``2·l >= C``, which for a cheap extractor depends on the
    measured times) or the planner found recomputing it cheaper than its
    load (``chose_compute``)."""
    ex = rep.execution
    rerun = sorted(n for n, s in ex.states.items()
                   if s is State.COMPUTE and n != "checkResults")
    unexplained = [n for n in rerun if rep.load_cost.get(n) is not None
                   and n not in ex.chose_compute]
    if rep.original != {"checkResults"} or "incPred" in rerun or unexplained:
        raise AssertionError(
            f"the PPR edit recomputed {rerun} (original {sorted(rep.original)}"
            f"; loadable and not chosen: {unexplained})")


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=30_000,
                    help="census rows (the reference's 30,000)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    knobs = dataclasses.replace(W.CensusKnobs(), n_rows=args.rows)
    shown = []
    with tempfile.TemporaryDirectory() as workdir:
        sess = IterativeSession(workdir)

        # Iteration 0: everything is original → computed.
        rep = sess.run(W.build_census(knobs, device=dev))
        shown.append(show("iteration 0 (initial)", rep))

        # Iteration 1: PPR edit — switch the metric to F1. Only the reducer
        # re-runs; DPR and the trained model are reused.
        knobs = dataclasses.replace(knobs, eval_metric="f1")
        rep = sess.run(W.build_census(knobs, device=dev))
        shown.append(show("iteration 1 (PPR edit: metric → f1)", rep))
        check_ppr_edit(rep)

        # Iteration 2: L/I edit — change regularization. The model retrains
        # but the parsed rows / features load from the store.
        knobs = dataclasses.replace(knobs, reg=0.01)
        rep = sess.run(W.build_census(knobs, device=dev))
        shown.append(show("iteration 2 (L/I edit: reg → 0.01)", rep))
    return shown


if __name__ == "__main__":
    main()
