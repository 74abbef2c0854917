"""The paper's workflow experiments on the port (twin of the workflow
benches of the JAX package's ``benchmarks/run.py``):

- ``bench_cumulative_runtime`` (reference :125): paper Fig. 5 / Fig.
  9(a,b,e,f), the cumulative runtime of ``iteration_schedule(wd, N,
  seed=0)`` for each workflow under NM (``Policy.NEVER``, KeystoneML-like),
  AM (``Policy.ALWAYS``, DeepDive-like) and OPT, with the speedup over NM;
- ``bench_storage`` (:141): paper Fig. 9(c,d), the store's size after the
  runs and at its peak;
- ``bench_state_fractions`` (:154): paper Fig. 8, the compute / load /
  prune shares of the reuse iterations, OPT against AM;
- ``bench_incremental`` (:706): census's daily retrain on an append-mostly
  chunked source; the spliced delta retrain must give the cold retrain's
  outputs (``==``) in under half its wall clock.

Each check raises (``python -O`` keeps it). Rows are the reference's CSV,
``name,us_per_call,derived``, with the device last in ``derived``.

    python -m repro_torch.launch.bench_workflows            # on the card
    python -m repro_torch.launch.bench_workflows --device cpu --iters 3 \\
        --workflows census,nlp

The workdirs go under a temporary directory, removed at the end.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
import time

from .. import workflows as W
from ..core import IterativeSession, Policy
from ..core.config import EngineConfig, StoreConfig
from ..device import resolve

BUDGET = 10 * 1024 ** 3    # paper §6.3: 10 GB storage budget
N_ITERS = 10
POLICIES = (Policy.NEVER, Policy.ALWAYS, Policy.OPT)
SURVEY = ("census", "genomics", "nlp", "mnist")


@dataclasses.dataclass
class PolicyRun:
    times: list[float]            # wall seconds of each iteration's run
    reports: list                 # each iteration's IterationReport


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _session(workdir: str, policy: Policy) -> IterativeSession:
    return IterativeSession(workdir, engine=EngineConfig(policy=policy),
                            storage=StoreConfig(budget_bytes=float(BUDGET)))


def run_policy(wd: W.WorkflowDef, policy: Policy, workdir: str,
               n_iters: int = N_ITERS, *, device=None, seed: int = 0
               ) -> PolicyRun:
    """Run ``iteration_schedule(wd, n_iters, seed)`` under ``policy`` in
    ``workdir`` (emptied first), each workflow built on ``device``."""
    dev = resolve(device)
    shutil.rmtree(workdir, ignore_errors=True)
    sess = _session(workdir, policy)
    run = PolicyRun([], [])
    for kn in W.iteration_schedule(wd, n_iters, seed):
        wf = wd.build(kn, device=dev)
        t0 = time.perf_counter()
        rep = sess.run(wf)
        run.times.append(time.perf_counter() - t0)
        run.reports.append(rep)
    return run


def run_policies(wd: W.WorkflowDef, root: str, n_iters: int = N_ITERS, *,
                 device=None, seed: int = 0) -> dict[Policy, PolicyRun]:
    """``run_policy`` under NM, AM and OPT, each in its own workdir."""
    return {p: run_policy(wd, p, os.path.join(root, f"{wd.name}_{p.value}"),
                          n_iters, device=device, seed=seed)
            for p in POLICIES}


def bench_cumulative_runtime(results: dict[str, dict[Policy, PolicyRun]],
                             device) -> dict:
    """Fig. 5 / 9: cumulative runtime per workflow per policy. Returns
    ``{name: {policy: (total seconds, speedup over NM)}}``."""
    out = {}
    for name, runs in results.items():
        nm = sum(runs[Policy.NEVER].times)
        out[name] = {}
        for policy, run in runs.items():
            total = sum(run.times)
            speedup = nm / max(total, 1e-9)
            out[name][policy] = (total, speedup)
            print(f"{name}_{policy.value}_cumulative,"
                  f"{total * 1e6 / len(run.times):.0f},"
                  f"total_s={total:.2f};speedup_vs_nm={speedup:.2f}x;"
                  f"device={device}", flush=True)
    return out


def bench_storage(results: dict[str, dict[Policy, PolicyRun]], device
                  ) -> dict:
    """Fig. 9(c,d): the store's bytes after the last iteration and at its
    peak, under AM and OPT. Returns ``{name: {policy: (final, peak)}}``."""
    out = {}
    for name, runs in results.items():
        out[name] = {}
        for policy in (Policy.ALWAYS, Policy.OPT):
            reports = runs[policy].reports
            final = reports[-1].store_bytes
            peak = max(r.store_bytes for r in reports)
            out[name][policy] = (final, peak)
            print(f"{name}_{policy.value}_storage,"
                  f"{final / 1024:.0f},"
                  f"peak_kb={peak / 1024:.0f};device={device}", flush=True)
    return out


def bench_state_fractions(results: dict[str, dict[Policy, PolicyRun]],
                          device) -> dict:
    """Fig. 8: the states of the reuse iterations (all but the first),
    under OPT and AM. Returns ``{name: {policy: (computed, loaded,
    pruned)}}``."""
    out = {}
    for name, runs in results.items():
        out[name] = {}
        for policy in (Policy.OPT, Policy.ALWAYS):
            reports = runs[policy].reports[1:]
            comp = sum(r.execution.n_computed for r in reports)
            load = sum(r.execution.n_loaded for r in reports)
            prune = sum(r.execution.n_pruned for r in reports)
            tot = max(comp + load + prune, 1)
            out[name][policy] = (comp, load, prune)
            print(f"{name}_{policy.value}_states,"
                  f"{comp},"
                  f"compute={comp / tot:.2f};load={load / tot:.2f};"
                  f"prune={prune / tot:.2f};device={device}", flush=True)
    return out


def bench_incremental(root: str, n_chunks: int = 10, rows: int = 8000, *,
                      device=None) -> dict:
    """Daily retrain on an append-mostly source: warm a store with an
    ``n_chunks``-chunk census table, append one chunk, retrain in the warm
    workdir (delta: the map and assoc_reduce nodes splice cached chunks,
    only the appended chunk runs) and in a cold workdir (full recompute).
    Requires the delta retrain's outputs to equal the cold one's and its
    wall clock to be under 0.5x the cold one's. Returns the seconds and
    chunk counts."""
    dev = resolve(device)
    k0 = W.IncrementalCensusKnobs(n_chunks=n_chunks, rows_per_chunk=rows)
    k1 = dataclasses.replace(k0, n_chunks=n_chunks + 1)   # +10 % append

    def timed_run(workdir, knobs, reuse=False):
        if not reuse:
            shutil.rmtree(workdir, ignore_errors=True)
        sess = _session(workdir, Policy.ALWAYS)
        t0 = time.perf_counter()
        rep = sess.run(W.build_census_incremental(knobs, device=dev))
        return time.perf_counter() - t0, rep

    warm_dir = os.path.join(root, "incremental_warm")
    warm_s, _ = timed_run(warm_dir, k0)
    delta_s, delta_rep = timed_run(warm_dir, k1, reuse=True)
    cold_s, cold_rep = timed_run(os.path.join(root, "incremental_cold"), k1)
    _require(delta_rep.outputs["dailyEval"] == cold_rep.outputs["dailyEval"],
             "delta retrain diverged from cold recompute")
    spliced = sum(delta_rep.execution.chunk_reused.values())
    recomputed = sum(delta_rep.execution.chunk_computed.values())
    ratio = delta_s / max(cold_s, 1e-9)
    print(f"incremental_daily_retrain,{delta_s * 1e6:.0f},"
          f"delta_s={delta_s:.2f};cold_s={cold_s:.2f};"
          f"ratio={ratio:.2f};spliced={spliced};recomputed={recomputed};"
          f"device={dev}", flush=True)
    _require(ratio < 0.5,
             f"delta retrain {delta_s:.2f}s not under 0.5x cold {cold_s:.2f}s")
    return {"warm_s": warm_s, "delta_s": delta_s, "cold_s": cold_s,
            "ratio": ratio, "spliced": spliced, "recomputed": recomputed,
            "outputs": delta_rep.outputs["dailyEval"]}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=N_ITERS)
    ap.add_argument("--workflows", default=",".join(SURVEY))
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    names = args.workflows.split(",")
    unknown = sorted(set(names) - set(SURVEY))
    if unknown:
        ap.error(f"unknown workflows {unknown}; choose from {SURVEY}")
    root = tempfile.mkdtemp(prefix="helix-bench-workflows-")
    try:
        results = {n: run_policies(W.WORKFLOWS[n], root, args.iters,
                                   device=dev) for n in names}
        return {"cumulative": bench_cumulative_runtime(results, dev),
                "storage": bench_storage(results, dev),
                "states": bench_state_fractions(results, dev),
                "incremental": bench_incremental(root, device=dev)}
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
