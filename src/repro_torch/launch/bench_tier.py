"""Memory-tier acceptance on the LM training workflow (twin of
``bench_tier`` in the JAX package's ``benchmarks/run.py:761``).

One session, one store, two runs of the identical LM workflow
(``workflows.build_lm``):

1. **Cold**: trains the small transformer and materializes every node
   (``Policy.ALWAYS``); the store's write-through memory tier admits each
   durable value on the way to disk.
2. **Warm** (same process): reruns the same workflow; every reuse is a
   signature hit that the memory tier must serve.

Asserted, not just reported: the warm run is bit-identical to the cold
run; ≥ 90 % of its reused bytes come from the memory tier; the warm run's
hit path reads **zero** ``.npy`` leaf files; a timed memory hit on the
largest signature beats a fresh-store disk reload of the same signature by
≥ 5x; and after both runs each tier's ledger equals the bytes it holds.
Each check raises (``python -O`` keeps it).

    python -m repro_torch.launch.bench_tier                 # on the card
    python -m repro_torch.launch.bench_tier --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import shutil
import time
from typing import Callable

from .. import workflows as W
from ..core import IterativeSession, Policy, Store, StorageLedger
from ..core.config import EngineConfig, StoreConfig
from ..device import resolve

BUDGET = 10 * 1024 ** 3    # paper §6.3: 10 GB storage budget


@dataclasses.dataclass
class TierResult:
    session: IterativeSession
    reports: list                 # the cold and the warm IterationReport
    stats: dict                   # what the printed line reports


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _timed_load(store: Store, sig: str) -> float:
    t0 = time.perf_counter()
    store.load(sig)               # waits for a copy onto a card itself
    return (time.perf_counter() - t0) * 1e6


def bench_tier(workdir: str, k: W.LMKnobs = W.LMKnobs(), *,
               device=None, around: Callable | None = None) -> TierResult:
    """Run the check in ``workdir`` (emptied first) on ``device`` (default
    ``cuda``). ``around(label)``, a context manager, wraps each iteration
    (``"cold"``, ``"warm"``). Returns the session for further iterations."""
    dev = resolve(device)
    around = around or (lambda label: contextlib.nullcontext())
    shutil.rmtree(workdir, ignore_errors=True)
    sess = IterativeSession(
        workdir, engine=EngineConfig(policy=Policy.ALWAYS),
        storage=StoreConfig(budget_bytes=float(BUDGET),
                            shared_budget=True,   # arms the ledger check
                            mem_budget_bytes=256e6))
    store = sess.store

    t0 = time.perf_counter()
    with around("cold"):
        rep_cold = sess.run(W.build_lm(k, device=dev))
    cold_s = time.perf_counter() - t0

    # Snapshot the counters the warm run must (not) move.
    def stats_snap():
        return {t: dict(s) for t, s in store.load_stats.items()}

    before = stats_snap()
    npy_before = store.npy_leaf_reads
    t0 = time.perf_counter()
    with around("warm"):
        rep_warm = sess.run(W.build_lm(k, device=dev))
    warm_s = time.perf_counter() - t0
    after = stats_snap()
    npy_delta = store.npy_leaf_reads - npy_before

    _require(rep_warm.outputs["evalLoss"] == rep_cold.outputs["evalLoss"],
             "warm memory-served rerun diverged from the cold run")

    mem_bytes = after["memory"]["bytes"] - before["memory"]["bytes"]
    disk_bytes = after["local"]["bytes"] - before["local"]["bytes"]
    reused = mem_bytes + disk_bytes
    mem_frac = mem_bytes / max(reused, 1)
    _require(reused > 0, "warm rerun reused nothing — no signature hits")
    _require(mem_frac >= 0.9,
             f"memory tier served only {mem_frac:.0%} of reused bytes "
             f"({mem_bytes}B mem vs {disk_bytes}B disk)")
    _require(npy_delta == 0,
             f"warm hit path read {npy_delta} .npy leaf files (must be 0)")

    # Timed hit-vs-reload on the largest materialization (the TrainState).
    store.writer_drain()
    big_sig = max(store.entries().items(),
                  key=lambda kv: kv[1].get("nbytes", 0))[0]
    mem_us = min(_timed_load(store, big_sig) for _ in range(5))
    cold_store = Store(store.root, mem_budget_bytes=0.0)
    disk_us = min(_timed_load(cold_store, big_sig) for _ in range(5))
    ratio = disk_us / max(mem_us, 1e-9)
    _require(ratio >= 5.0,
             f"memory hit ({mem_us:.0f}us) only {ratio:.1f}x faster than "
             f"disk reload ({disk_us:.0f}us); need >=5x")

    # Per-tier ledger == bytes held.
    ledger_drift = StorageLedger(store.ledger_path).used() \
        - store.total_bytes()
    tiers = store.tier_status()
    mem_drift = tiers["memory"]["bytes"] - store._mem.recount()
    _require(ledger_drift == 0, f"shared ledger drift: {ledger_drift}B")
    _require(mem_drift == 0, f"memory-tier accounting drift: {mem_drift}B")

    stats = {"cold_s": cold_s, "warm_s": warm_s, "mem_frac": mem_frac,
             "npy_reads": npy_delta, "mem_hit_us": mem_us,
             "disk_load_us": disk_us, "hit_speedup": ratio,
             "mem_hits": after["memory"]["hits"] - before["memory"]["hits"],
             "ledger_drift_b": ledger_drift, "mem_drift_b": mem_drift,
             "largest_sig": big_sig}
    print(f"lm_tier_warm,{warm_s * 1e6:.0f},"
          f"cold_s={cold_s:.2f};warm_s={warm_s:.2f};"
          f"mem_frac={mem_frac:.2f};npy_reads={npy_delta};"
          f"mem_hit_us={mem_us:.0f};disk_load_us={disk_us:.0f};"
          f"hit_speedup={ratio:.1f}x;mem_hits={stats['mem_hits']};"
          f"ledger_drift_b={ledger_drift};mem_drift_b={mem_drift};"
          f"device={dev}", flush=True)
    return TierResult(session=sess, reports=[rep_cold, rep_warm], stats=stats)


def main(argv: list[str] | None = None) -> TierResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=W.LMKnobs.steps)
    ap.add_argument("--d-model", type=int, default=W.LMKnobs.d_model)
    ap.add_argument("--workdir", default=os.path.join("results", "bench",
                                                      "lm_tier"))
    args = ap.parse_args(argv)
    k = dataclasses.replace(W.LMKnobs(), steps=args.steps,
                            d_model=args.d_model)
    return bench_tier(args.workdir, k, device=args.device)


if __name__ == "__main__":
    main()
