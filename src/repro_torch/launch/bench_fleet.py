"""The fleet benches on the port (twin of six benches of the JAX package's
``benchmarks/run.py``), each against ``repro_torch.serve`` and the sweep
and search drivers, with the workflows' learners on ``device``:

- ``bench_sweep_reuse`` (reference :243): a K-variant grid through
  ``run_sweep`` on one shared store against K isolated cold runs at the
  same concurrency, on census and MNIST;
- ``bench_server_reuse`` (:322): the server's shared-prefix-first schedule
  against the arrival-order (fifo) baseline at K/2 session slots;
- ``bench_eviction`` (:401): evict-to-admit against refuse-on-exhausted at
  half the sweep's working set, the store pre-squatted by junk entries;
- ``bench_remote_reuse`` (:485): a 2-host sweep warms a shared remote
  tier; a cold host then runs the grid against the warm tier and against
  an empty one;
- ``bench_search_reuse`` (:571): the reuse-aware ``SearchDriver`` against
  a fixed-batch fifo sweep at equal arm count, then eager successive
  halving over ``train_iters``;
- ``bench_multitenant`` (:898): consistent-hash routing against seeded
  random placement over a 2-shard fleet on warm reruns.

Same workflows, sizes, arm counts and asserted bars as the reference;
``--scale`` means what ``HELIX_BENCH_SWEEP_SCALE`` means there. Rows are
the reference's CSV, ``name,us_per_call,derived``, with its field names
and the device last in ``derived``.

    python -m repro_torch.launch.bench_fleet                 # on the card
    python -m repro_torch.launch.bench_fleet --device cpu --scale 0.05

The workdirs go under a temporary directory, removed at the end.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import shutil
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import workflows as W
from ..core import (FsObjectStore, IterativeSession, RemoteStore,
                    StorageLedger, Store, SweepVariant, grid, run_sweep)
from ..core.config import EngineConfig, StoreConfig
from ..core.search import HalvingConfig, SearchConfig, SearchDriver
from ..core.workflow import Workflow
from ..device import resolve
from ..serve import FleetRouter, SessionServer, TenantSpec

BUDGET = 10 * 1024 ** 3    # paper §6.3: 10 GB storage budget
REGS = [0.03, 0.3, 0.01, 1.0, 0.1, 3.0]


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _fresh(root: str, name: str) -> str:
    path = os.path.join(root, name)
    shutil.rmtree(path, ignore_errors=True)
    return path


def _grid_cases(n_var: int, scale: float, dev) -> dict:
    """The census and MNIST grids of the sweep benches: a learner knob ×
    a result-analysis knob, ⌈K/2⌉ learner values and 2 analysis values."""
    n_regs = max(1, (n_var + 1) // 2)
    return {
        "census": (W.CensusKnobs(n_rows=max(2000, int(120_000 * scale))),
                   functools.partial(W.build_census, device=dev),
                   {"reg": REGS[:n_regs], "eval_threshold": [0.5, 0.7]}),
        "mnist": (W.MNISTKnobs(n_images=max(500, int(12_000 * scale)),
                               epochs=max(5, int(60 * scale))),
                  functools.partial(W.build_mnist, device=dev),
                  {"reg": [r * 1e-2 for r in REGS[:n_regs]],
                   "eval_k": [1, 2]}),
    }


def bench_sweep_reuse(root: str, *, n_var: int = 4, scale: float = 1.0,
                      device=None) -> dict:
    """K-variant sweep on one shared store vs K isolated cold runs at the
    same concurrency (the sequential sum is ``iso_seq_s``)."""
    dev = resolve(device)
    out = {}
    for name, (base, build, axes) in _grid_cases(n_var, scale, dev).items():
        variants = grid(base, axes, build, name=name)[:n_var]
        n_eff = len(variants)
        if n_eff < n_var:
            print(f"# {name}: {n_var} variants requested, grid yields "
                  f"{n_eff}", flush=True)

        def run_isolated(i_kn, name=name, build=build):
            i, kn = i_kn
            sess = IterativeSession(
                _fresh(root, f"{name}_sweep_iso{i}"),
                storage=StoreConfig(budget_bytes=float(BUDGET)))
            t0 = time.perf_counter()
            sess.run(build(kn))
            return time.perf_counter() - t0

        knob_list = [v.knobs for v in variants]
        iso_seq = sum(run_isolated(ik) for ik in enumerate(knob_list))
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n_eff) as pool:
            list(pool.map(run_isolated, enumerate(knob_list)))
        iso_par = time.perf_counter() - t0

        report = run_sweep(_fresh(root, f"{name}_sweep_shared"), variants,
                           storage=StoreConfig(budget_bytes=float(BUDGET)))
        report.raise_errors()
        shared_recomputed = report.wasted_recomputes()
        speedup = iso_par / max(report.wall_seconds, 1e-9)
        print(f"{name}_sweep_reuse,"
              f"{report.wall_seconds * 1e6 / n_eff:.0f},"
              f"iso_par_s={iso_par:.2f};iso_seq_s={iso_seq:.2f};"
              f"sweep_s={report.wall_seconds:.2f};"
              f"variants={n_eff};speedup={speedup:.2f}x;"
              f"shared_recomputed={shared_recomputed};"
              f"store_kb={report.store_bytes / 1024:.0f};device={dev}",
              flush=True)
        out[name] = {"iso_par_s": iso_par, "iso_seq_s": iso_seq,
                     "sweep_s": report.wall_seconds, "variants": n_eff,
                     "speedup": speedup,
                     "shared_recomputed": shared_recomputed,
                     "fleet_computes": report.fleet_computes(),
                     "store_bytes": report.store_bytes}
    return out


def bench_server_reuse(root: str, *, n_var: int = 4, scale: float = 1.0,
                       device=None) -> dict:
    """The prefix schedule vs the arrival-order (fifo, static horizon K)
    baseline, both at K/2 session slots on one shared store."""
    dev = resolve(device)
    out = {}
    for name, (base, build, axes) in _grid_cases(n_var, scale, dev).items():
        variants = grid(base, axes, build, name=name)[:n_var]
        n_eff = len(variants)
        n_conc = max(2, n_eff // 2)
        walls, wasted, deliberate = {}, {}, {}
        for mode in ("fifo", "prefix"):
            report = run_sweep(
                _fresh(root, f"{name}_server_{mode}"), variants,
                engine=EngineConfig(
                    n_sessions=n_conc, schedule=mode,
                    horizon=float(n_eff) if mode == "fifo" else None),
                storage=StoreConfig(budget_bytes=float(BUDGET)))
            report.raise_errors()
            walls[mode] = report.wall_seconds
            wasted[mode] = report.wasted_recomputes()
            deliberate[mode] = sum(
                1 for cnt in report.fleet_computes().values() if cnt > 1
            ) - wasted[mode]
        speedup = walls["fifo"] / max(walls["prefix"], 1e-9)
        print(f"{name}_server_reuse,"
              f"{walls['prefix'] * 1e6 / n_eff:.0f},"
              f"fifo_s={walls['fifo']:.2f};"
              f"prefix_s={walls['prefix']:.2f};"
              f"variants={n_eff};slots={n_conc};"
              f"speedup={speedup:.2f}x;"
              f"shared_recomputed={wasted['prefix']};"
              f"planner_recomputed={deliberate['prefix']};device={dev}",
              flush=True)
        out[name] = {"fifo_s": walls["fifo"], "prefix_s": walls["prefix"],
                     "variants": n_eff, "slots": n_conc, "speedup": speedup,
                     "shared_recomputed": wasted["prefix"],
                     "shared_recomputed_fifo": wasted["fifo"],
                     "planner_recomputed": deliberate["prefix"]}
    return out


def bench_eviction(root: str, *, n_var: int = 4, scale: float = 1.0,
                   device=None) -> dict:
    """Evict-to-admit vs refuse-on-exhausted at half the sweep's working
    set, the budget pre-squatted by junk entries; the ledger must equal
    the bytes on disk at drain."""
    dev = resolve(device)
    rng = np.random.default_rng(0)
    out = {}
    for name, (base, build, axes) in _grid_cases(n_var, scale, dev).items():
        variants = grid(base, axes, build, name=name)[:n_var]
        n_eff = len(variants)
        ws_report = run_sweep(_fresh(root, f"{name}_evict_ws"), variants)
        ws_report.raise_errors()
        ws = max(ws_report.store_bytes, 1)
        budget = max(ws // 2, 1)
        chunk = max(512, budget // (8 * 6))   # ≈6 junk entries
        walls, dups, drift = {}, {}, {}
        ev_stats: dict = {}
        for mode in ("refuse", "evict"):
            workdir = _fresh(root, f"{name}_evict_{mode}")
            store = Store(os.path.join(workdir, "store"))
            junk, i = 0, 0
            while junk < budget:
                junk += store.save(f"junk{i:04d}", "junk",
                                   rng.standard_normal(chunk)).nbytes
                i += 1
            report = run_sweep(
                workdir, variants,
                storage=StoreConfig(budget_bytes=float(budget),
                                    evict_to_admit=(mode == "evict")))
            report.raise_errors()
            walls[mode] = report.wall_seconds
            dups[mode] = sum(c - 1
                             for c in report.fleet_computes().values()
                             if c > 1)
            ev_stats[mode] = report.evictions
            drift[mode] = (StorageLedger(store.ledger_path).used()
                           - store.total_bytes())
        ev = ev_stats["evict"]
        speedup = walls["refuse"] / max(walls["evict"], 1e-9)
        print(f"{name}_eviction,"
              f"{walls['evict'] * 1e6 / n_eff:.0f},"
              f"refuse_s={walls['refuse']:.2f};"
              f"evict_s={walls['evict']:.2f};"
              f"speedup={speedup:.2f}x;variants={n_eff};"
              f"ws_kb={ws / 1024:.0f};budget_kb={budget / 1024:.0f};"
              f"dup_refuse={dups['refuse']};dup_evict={dups['evict']};"
              f"evicted={ev.get('n_evicted', 0)};"
              f"vetoed_live={ev.get('n_vetoed_live', 0)};"
              f"ledger_drift_b={drift['evict']:.0f};"
              f"ledger_drift_refuse_b={drift['refuse']:.0f};device={dev}",
              flush=True)
        out[name] = {"refuse_s": walls["refuse"], "evict_s": walls["evict"],
                     "speedup": speedup, "variants": n_eff, "ws_bytes": ws,
                     "budget_bytes": budget, "dup_refuse": dups["refuse"],
                     "dup_evict": dups["evict"],
                     "evicted": ev.get("n_evicted", 0),
                     "vetoed_live": ev.get("n_vetoed_live", 0),
                     "ledger_drift_b": drift["evict"],
                     "ledger_drift_refuse_b": drift["refuse"]}
    return out


def bench_remote_reuse(root: str, *, n_var: int = 4, scale: float = 1.0,
                       device=None) -> dict:
    """A 2-host sweep warms a shared remote tier (``fleet_dup`` counts
    blind duplicate computes across hosts); a cold host then runs the
    grid against the warm tier and against an empty one. ``evict_leased``
    counts remote deletes that succeeded under a live read pin."""
    dev = resolve(device)
    n_regs = max(1, (n_var + 1) // 2)
    base = W.CensusKnobs(n_rows=max(2000, int(120_000 * scale)))
    axes = {"reg": REGS[:n_regs], "eval_threshold": [0.5, 0.7]}
    variants = grid(base, axes, functools.partial(W.build_census,
                                                  device=dev),
                    name="census")[:n_var]
    n_eff = len(variants)

    remote_root = _fresh(root, "census_remote_tier")
    warm = run_sweep(_fresh(root, "census_remote_warm"), variants,
                     n_hosts=2, storage=StoreConfig(remote=remote_root))
    warm.raise_errors()
    fleet_dup = warm.wasted_recomputes()

    prober = RemoteStore(FsObjectStore(remote_root))
    warm_sigs = sorted(prober.entries())
    evict_leased = 0
    if warm_sigs:
        pin = prober.acquire_pin(warm_sigs[0])
        evictor_handle = RemoteStore(FsObjectStore(remote_root))
        if evictor_handle.delete_entry(warm_sigs[0]) > 0:
            evict_leased += 1
        evictor_handle.close()
        if pin is not None:
            pin.release()
    prober.close()

    walls, stats = {}, {}
    for mode, tier in (("warm", remote_root),
                       ("empty", _fresh(root, "census_remote_empty"))):
        report = run_sweep(_fresh(root, f"census_remote_cold_{mode}"),
                           variants, storage=StoreConfig(remote=tier))
        report.raise_errors()
        walls[mode] = report.wall_seconds
        stats[mode] = report.remote
    speedup = walls["empty"] / max(walls["warm"], 1e-9)
    veto = stats["warm"].get("n_veto_protected", 0)
    fetches = stats["warm"].get("n_fetches", 0)
    print(f"census_remote_reuse,"
          f"{walls['warm'] * 1e6 / n_eff:.0f},"
          f"cold_s={walls['empty']:.2f};warm_s={walls['warm']:.2f};"
          f"variants={n_eff};speedup={speedup:.2f}x;"
          f"fleet_dup={fleet_dup};"
          f"remote_fetches={fetches};"
          f"evict_leased={evict_leased};evict_vetoed={veto};device={dev}",
          flush=True)
    return {"cold_s": walls["empty"], "warm_s": walls["warm"],
            "variants": n_eff, "speedup": speedup, "fleet_dup": fleet_dup,
            "remote_fetches": fetches, "evict_leased": evict_leased,
            "evict_vetoed": veto}


def bench_search_reuse(root: str, *, n_var: int = 4, scale: float = 1.0,
                       device=None) -> dict:
    """Phase 1: the reuse-aware ``SearchDriver`` vs a fixed-batch fifo
    sweep of the grid's first K arms (reg varies fastest), equal arm
    count. Phase 2: eager successive halving of four regs over
    ``train_iters``; ``ledger_drift_b`` and ``wasted`` must be 0."""
    dev = resolve(device)
    iters = max(30, int(300 * scale))
    base = W.CensusKnobs(n_rows=max(2000, int(120_000 * scale)),
                         train_iters=iters)
    budget = max(2, n_var)
    n_regs = min(len(REGS), budget)
    space = [{"reg": r, "eval_threshold": t}
             for t in (0.5, 0.7) for r in REGS[:n_regs]]

    def factory(**params):
        return W.build_census(dataclasses.replace(base, **params),
                              device=dev)

    fixed_variants = [
        SweepVariant(name=f"fix{i}", build=(lambda p=p: factory(**p)),
                     knobs=p)
        for i, p in enumerate(space[:budget])]
    fixed = run_sweep(_fresh(root, "census_search_fixed"), fixed_variants,
                      engine=EngineConfig(schedule="fifo"), storage=None)
    fixed.raise_errors()
    fixed_nodes = sum(
        r.report.execution.n_computed - len(r.report.execution.deduped)
        for r in fixed.results)
    fixed_sigs = len(fixed.fleet_computes())
    fixed_models = len({v.knobs["reg"] for v in fixed_variants})

    server = SessionServer(_fresh(root, "census_search_tuner"),
                           registry={"census": factory},
                           engine=EngineConfig(n_sessions=1),
                           poll_interval=0.01)
    try:
        # max_inflight=2 over one slot: the next pick is queued while the
        # current arm runs, so its shared signatures enter the live
        # multiplicity map and the leader persists them
        tuned = SearchDriver(
            server, "census", space=space,
            config=SearchConfig(strategy="grid", max_arms=budget,
                                frontier="reuse", max_inflight=2)).run()
    finally:
        server.shutdown()
    tuner_nodes = tuned.total_node_computes()
    tuner_sigs = len(tuned.fleet_computes())
    tuner_models = len({a.params["reg"] for a in tuned.arms
                        if a.status != "skipped"})
    print(f"census_search_reuse,"
          f"{tuned.wall_seconds * 1e6 / budget:.0f},"
          f"fixed_sigs={fixed_sigs};tuner_sigs={tuner_sigs};"
          f"saved_sigs={fixed_sigs - tuner_sigs};"
          f"fixed_models={fixed_models};tuner_models={tuner_models};"
          f"fixed_nodes={fixed_nodes};tuner_nodes={tuner_nodes};"
          f"fixed_s={fixed.wall_seconds:.2f};"
          f"tuner_s={tuned.wall_seconds:.2f};"
          f"arms={budget};grid={len(space)};"
          f"wasted={tuned.wasted_recomputes()};device={dev}", flush=True)

    server = SessionServer(_fresh(root, "census_search_halving"),
                           registry={"census": factory},
                           engine=EngineConfig(n_sessions=2),
                           poll_interval=0.01)
    try:
        halved = SearchDriver(
            server, "census",
            space=[{"reg": r} for r in REGS[:4]],
            config=SearchConfig(
                strategy="grid", metric="checkResults.value",
                max_inflight=2,
                halving=HalvingConfig(resource="train_iters",
                                      levels=[max(10, iters // 5), iters],
                                      eta=2.0, eager=True))).run()
        drift = (StorageLedger(server.store.ledger_path).used()
                 - server.store.total_bytes())
    finally:
        server.shutdown()
    best = halved.best()
    print(f"census_search_halving,"
          f"{halved.wall_seconds * 1e6 / max(len(halved.arms), 1):.0f},"
          f"rungs={len(halved.rungs)};arms={len(halved.arms)};"
          f"cancelled={halved.n_cancelled()};"
          f"skipped={sum(1 for a in halved.arms if a.status == 'skipped')};"
          f"best_reg={best.base_params['reg'] if best else 'na'};"
          f"best_metric={best.metric if best else 'na'};"
          f"ledger_drift_b={drift:.0f};"
          f"wasted={halved.wasted_recomputes()};device={dev}", flush=True)
    return {"search": {"fixed_sigs": fixed_sigs, "tuner_sigs": tuner_sigs,
                       "fixed_models": fixed_models,
                       "tuner_models": tuner_models,
                       "fixed_nodes": fixed_nodes, "tuner_nodes": tuner_nodes,
                       "fixed_s": fixed.wall_seconds,
                       "tuner_s": tuned.wall_seconds,
                       "wasted": tuned.wasted_recomputes()},
            "halving": {"rungs": len(halved.rungs), "arms": len(halved.arms),
                        "cancelled": halved.n_cancelled(),
                        "best_metric": best.metric if best else None,
                        "ledger_drift_b": drift,
                        "wasted": halved.wasted_recomputes(),
                        "wall_s": halved.wall_seconds}}


def bench_multitenant(root: str, *, scale: float = 1.0, families: int = 6,
                      seed: int = 1234, device=None) -> dict:
    """Hash routing vs seeded random placement on warm reruns of
    ``families`` workflow families over a 2-shard fair-share fleet: hash
    routing must recompute nothing (asserted); the row reports both wall
    clocks and the ledger-vs-disk drift of each shard."""
    dev = resolve(device)
    work = max(40, int(150 * scale))
    dim = 128
    lock = threading.Lock()
    feat_calls: dict[str, int] = {}

    def build(family="f0", reg=0.1):
        wf = Workflow(f"{family}-{reg}")
        src = wf.source(
            "src",
            lambda d=dim: np.arange(d * d, dtype=np.float64).reshape(d, d),
            config=("v1", family))

        def featurize(m, fam=family):
            with lock:
                feat_calls[fam] = feat_calls.get(fam, 0) + 1
            acc = m.copy()
            for _ in range(work):
                acc = np.tanh(acc @ m.T @ m / m.size)
            return acc

        feat = wf.extractor("feat", featurize, [src],
                            config=("feat", family))
        model = wf.learner("model",
                           lambda z, r=reg: float(np.sum(z * z)) * r,
                           [feat], config=("LR", reg))
        out = wf.reducer("eval", lambda m: {"score": m}, [model],
                         config=("eval",))
        wf.output(out)
        return wf

    registry = {"fam": build}
    servers = {sid: SessionServer(
        _fresh(root, f"multitenant_{sid}"), registry=registry,
        tenants={"*": TenantSpec(weight=1.0)},
        engine=EngineConfig(schedule="fair", n_sessions=2),
        poll_interval=0.01) for sid in ("s0", "s1")}
    arms = [(f"f{i}", 0.1) for i in range(families)]

    def run_all(router):
        jobs = [router.submit("fam", {"family": f, "reg": r})
                for f, r in arms]
        for j in jobs:
            out = router.wait(j, timeout=600.0)
            _require(out["status"] == "done", str(out))

    def total_feats():
        with lock:
            return sum(feat_calls.values())

    try:
        run_all(FleetRouter(servers, registry=registry, tenant="warm"))
        warmed = total_feats()
        _require(warmed == families,
                 "warm pass must compute each family once")

        t0 = time.perf_counter()
        run_all(FleetRouter(servers, registry=registry, tenant="rerun"))
        hash_s = time.perf_counter() - t0
        hash_recomputed = total_feats() - warmed
        _require(hash_recomputed == 0,
                 "hash routing recomputed a cached prefix on a warm fleet")

        t0 = time.perf_counter()
        run_all(FleetRouter(servers, registry=registry, tenant="rerun",
                            route="random", seed=seed))
        random_s = time.perf_counter() - t0
        random_recomputed = total_feats() - warmed - hash_recomputed

        drift = max(abs(StorageLedger(s.store.ledger_path).used()
                        - s.store.total_bytes())
                    for s in servers.values())
    finally:
        for s in servers.values():
            s.shutdown()

    speedup = random_s / max(hash_s, 1e-9)
    print(f"multitenant_routing,"
          f"{hash_s * 1e6 / len(arms):.0f},"
          f"hash_s={hash_s:.3f};random_s={random_s:.3f};"
          f"speedup={speedup:.2f}x;"
          f"families={families};shards=2;seed={seed};"
          f"hash_recomputed={hash_recomputed};"
          f"random_recomputed={random_recomputed};"
          f"ledger_drift_b={drift:.0f};device={dev}", flush=True)
    return {"hash_s": hash_s, "random_s": random_s, "speedup": speedup,
            "families": families, "hash_recomputed": hash_recomputed,
            "random_recomputed": random_recomputed, "ledger_drift_b": drift}


BENCHES = {"sweep_reuse": bench_sweep_reuse,
           "server_reuse": bench_server_reuse,
           "eviction": bench_eviction,
           "remote_reuse": bench_remote_reuse,
           "search_reuse": bench_search_reuse,
           "multitenant": bench_multitenant}


def run(benches=tuple(BENCHES), *, scale: float = 1.0, n_var: int = 4,
        families: int = 6, seed: int = 1234, device=None,
        root: str | None = None) -> dict:
    """Run ``benches`` (names of ``BENCHES``) under ``root`` (a temporary
    directory, removed at the end, when None); returns each one's
    numbers by name."""
    dev = resolve(device)
    unknown = sorted(set(benches) - set(BENCHES))
    if unknown:
        raise ValueError(f"unknown benches {unknown}; choose from {BENCHES}")
    tmp = root is None
    root = tempfile.mkdtemp(prefix="helix-bench-fleet-") if tmp else root
    try:
        out = {}
        for name in benches:
            kw = (dict(families=families, seed=seed)
                  if name == "multitenant" else dict(n_var=n_var))
            t0 = time.perf_counter()
            out[name] = BENCHES[name](root, scale=scale, device=dev, **kw)
            out[name]["bench_s"] = time.perf_counter() - t0
        return out
    finally:
        if tmp:
            shutil.rmtree(root, ignore_errors=True)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="input-size scale (the reference's "
                         "HELIX_BENCH_SWEEP_SCALE)")
    ap.add_argument("--variants", type=int, default=4,
                    help="sweep arms (HELIX_BENCH_SWEEP_VARIANTS)")
    ap.add_argument("--families", type=int, default=6,
                    help="bench_multitenant's workflow families "
                         "(HELIX_BENCH_TENANT_FAMILIES)")
    ap.add_argument("--seed", type=int, default=1234,
                    help="random placement's seed (HELIX_CHAOS_SEED)")
    ap.add_argument("--benches", default=",".join(BENCHES))
    args = ap.parse_args(argv)
    return run(args.benches.split(","), scale=args.scale,
               n_var=args.variants, families=args.families, seed=args.seed,
               device=args.device)


if __name__ == "__main__":
    main()
