"""Reuse-aware tuning: the census grid under an arm budget (twin of the
JAX package's ``examples/tune_census.py``).

Where ``sweep_census`` runs a *fixed* batch the user picked up front, this
example hands the whole candidate grid to the ``SearchDriver`` with a
budget of half the arms and lets it choose. Before every submission the
driver prices each remaining candidate with the server's ``estimate`` RPC
(compiled DAG cost minus everything already materialized or in flight)
and picks the cheapest *marginal* arm, so it spends the budget
signature-adjacent (same ``reg``, different threshold).

Then a successive-halving run races four regularizations over a low
``train_iters`` rung, promotes the best two to full training through the
scheduler's rung priority, and early-stops the losers, whose pins and
ledger reservations are released at once: the ledger-vs-disk drift after
it must be 0 B, which is required. The learner runs on ``--device``.

    python -m repro_torch.examples.tune_census                 # on the card
    HELIX_EXAMPLE_ROWS=2000 python -m repro_torch.examples.tune_census \\
        --device cpu

Env: HELIX_EXAMPLE_ROWS scales the dataset (default 30000).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from .. import workflows as W
from ..core import EngineConfig, StorageLedger
from ..core.search import HalvingConfig, SearchConfig, SearchDriver
from ..device import resolve
from ..serve import SessionServer

REGS = (0.01, 0.03, 0.1, 0.3)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    n_rows = int(os.environ.get("HELIX_EXAMPLE_ROWS", "30000"))
    base = W.CensusKnobs(n_rows=n_rows, train_iters=max(30, n_rows // 100))
    registry = {"census": lambda **p: W.build_census(
        dataclasses.replace(base, **p), device=dev)}
    space = [{"reg": r, "eval_threshold": t}
             for t in (0.5, 0.7) for r in REGS]
    budget = len(space) // 2

    # --- budgeted search: the driver picks WHICH arms run ----------------
    with tempfile.TemporaryDirectory() as workdir:
        server = SessionServer(workdir, registry=registry,
                               engine=EngineConfig(n_sessions=1),
                               poll_interval=0.01)
        try:
            driver = SearchDriver(
                server, "census", space=space,
                config=SearchConfig(strategy="grid", max_arms=budget,
                                    frontier="reuse", max_inflight=2,
                                    metric="checkResults.value"))
            report = driver.run()
        finally:
            server.shutdown()

    print(f"grid of {len(space)} candidates, budget of {budget} arms:")
    arms = []
    for a in report.arms:
        if a.status == "skipped":
            continue
        est = a.estimate or {}
        arms.append({"order": a.order, "params": a.params, "metric": a.metric,
                     "estimate": est})
        print(f"  #{a.order} reg={a.params['reg']:<5} "
              f"thr={a.params['eval_threshold']:<4} "
              f"metric={a.metric if a.metric is not None else '-':<8} "
              f"est_marginal={est.get('marginal_s', float('nan')):.2f} "
              f"(hits={est.get('n_hit', 0)}, follow={est.get('n_follow', 0)})")
    n_models = len({a["params"]["reg"] for a in arms})
    search = {"arms": arms, "signatures": len(report.fleet_computes()),
              "models": n_models, "wasted": report.wasted_recomputes(),
              "best": {"reg": report.best().params["reg"],
                       "metric": report.best().metric}}
    print(f"distinct signatures computed: {search['signatures']}"
          f"  models trained: {n_models} (grid order would train {budget})"
          f"  wasted recomputes: {search['wasted']}")
    print(f"best: reg={search['best']['reg']} "
          f"metric={search['best']['metric']:.3f}\n")

    # --- successive halving over train_iters ------------------------------
    with tempfile.TemporaryDirectory() as workdir:
        server = SessionServer(workdir, registry=registry,
                               engine=EngineConfig(n_sessions=2),
                               poll_interval=0.01)
        try:
            driver = SearchDriver(
                server, "census", space=[{"reg": r} for r in REGS],
                config=SearchConfig(
                    strategy="grid", metric="checkResults.value",
                    max_inflight=2,
                    halving=HalvingConfig(
                        resource="train_iters",
                        levels=[max(10, base.train_iters // 5),
                                base.train_iters],
                        eta=2.0)))
            report = driver.run()
            drift = (StorageLedger(server.store.ledger_path).used()
                     - server.store.total_bytes())
        finally:
            server.shutdown()

    for rung in report.rungs:
        print(f"rung {rung['rung']} (train_iters={rung['level']}): "
              f"{rung['n_done']} ran, promoted {rung['promoted']}")
    best = report.best()
    halving = {"rungs": [{k: rung[k] for k in ("rung", "level", "n_done",
                                               "promoted")}
                         for rung in report.rungs],
               "best": {"reg": best.base_params["reg"],
                        "metric": best.metric, "rung": best.rung},
               "ledger_drift_b": drift,
               "wasted": report.wasted_recomputes()}
    print(f"halving best: reg={best.base_params['reg']} "
          f"metric={best.metric:.3f} at rung {best.rung}")
    print(f"ledger drift after early-stopped arms: {drift:.0f} B "
          f"(must be 0); wasted recomputes: {halving['wasted']}")
    if drift != 0:
        raise AssertionError(f"ledger drift {drift:.0f} B after the "
                             f"early-stopped arms")
    return {"search": search, "halving": halving}


if __name__ == "__main__":
    main()
