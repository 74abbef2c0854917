"""The engine benches on the port (twin of three benches of the JAX
package's ``benchmarks/run.py``):

- ``bench_optimizer_overhead`` (reference :170): the OEP max-flow solve
  time against DAG size, 50/200/1000 nodes, on ``default_rng(0)`` DAGs
  built as the reference builds them. Host work only: ``device`` is only
  resolved and named in the row;
- ``bench_parallel_speedup`` (:193): the sequential engine
  (``max_workers=1``, the paper's §5.3 discipline) against the pipelined
  one (``n_workers``, LOAD prefetch 8, the async writer queue), each on the
  3-iteration ``iteration_schedule(wd, 3, seed=0)`` in a fresh store under
  OPT with a 10 GB budget, on census at its default knobs and on MNIST
  with 12 random-FFT towers. Census's learner runs on ``device`` and its
  outputs must be equal across the engines. MNIST's tower heads are numpy
  in both packages (``workflows.build_mnist``), so that case measures the
  host and the engine, not the card; its towers are nondeterministic, so
  its outputs are not compared. Each engine's per-node
  ``ExecutionReport.runtime`` (C(n)) comes back beside the row;
- ``bench_engine_overlap`` (:862): an 8-wide diamond of 150 ms
  ``time.sleep`` stubs under ``Policy.NEVER`` at 1 and 8 workers, the
  scheduler's overlap ceiling.

On ``cuda`` the CLI first runs one small census iteration (``warm_up``),
so that the sequential engine, which runs first, does not pay the card's
first use (the context, the library handles, each kernel's first load) in
its learner's C(n); and it ends by profiling one more cold pipelined
census iteration (``census_busy_share``): the card's busy share while the
engine runs its workers on one stream. Rows are the reference's CSV,
``name,us_per_call,derived``, with the device last in ``derived``. The CLI
pins BLAS to one thread before numpy loads, as the reference does, prints
the thread counts it ran with, and prints its numbers as one JSON object
on its last line.

    python -m repro_torch.launch.bench_engine                # on the card
    python -m repro_torch.launch.bench_engine --device cpu --workers 4

The workdirs go under a temporary directory, removed at the end.
"""
from __future__ import annotations

import os

from . import _blas

if __name__ == "__main__":
    _blas.pin()       # before numpy and torch load, as the reference does

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from .. import workflows as W  # noqa: E402
from ..core import IterativeSession, Policy, oep  # noqa: E402
from ..core.config import EngineConfig, StoreConfig  # noqa: E402
from ..core.dag import DAG, Kind, Node, State  # noqa: E402
from ..core.executor import execute  # noqa: E402
from ..core.omp import Materializer  # noqa: E402
from ..core.store import Store  # noqa: E402
from ..device import resolve  # noqa: E402

BUDGET = 10 * 1024 ** 3    # paper §6.3: 10 GB storage budget
OEP_SIZES = (50, 200, 1000)
OEP_REPS = 5
SPEEDUP_ITERS = 3
OVERLAP_WIDTH = 8
OVERLAP_SLEEP_S = 0.15


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def default_workers() -> int:
    """The reference's ``HELIX_BENCH_PAR_WORKERS`` default."""
    return max(2, os.cpu_count() or 2)


# ------------------------------------------------------------------ OEP
@dataclasses.dataclass
class OEPCase:
    """One seeded planning problem: node specs ``(name, parents,
    is_output)`` and the compute and load costs (``None``: not stored)."""
    n: int
    nodes: list[tuple[str, tuple[str, ...], bool]]
    compute_cost: dict[str, float]
    load_cost: dict[str, float | None]

    def dag(self, node_cls=Node, dag_cls=DAG):
        """The case as a DAG of ``node_cls`` (the reference's ``Node`` and
        ``DAG`` build its twin)."""
        return dag_cls([node_cls(name=name, fn=None, parents=parents,
                                 is_output=out)
                        for name, parents, out in self.nodes])


def oep_cases(sizes=OEP_SIZES) -> list[OEPCase]:
    """The reference's DAGs: one ``default_rng(0)`` stream drawn through
    the sizes in order, each node taking up to 3 random earlier parents,
    compute costs in [0.1, 10) s, and a load cost in [0.1, 5) s for ~70%
    of the nodes."""
    rng = np.random.default_rng(0)
    cases = []
    for n in sizes:
        nodes = []
        for i in range(n):
            k = int(min(i, 3))
            parents = tuple(f"n{j}" for j in
                            rng.choice(i, k, replace=False)) if i else ()
            nodes.append((f"n{i}", parents, i == n - 1))
        cc = {f"n{i}": float(rng.uniform(0.1, 10)) for i in range(n)}
        lc = {f"n{i}": (float(rng.uniform(0.1, 5))
                        if rng.random() < 0.7 else None) for i in range(n)}
        cases.append(OEPCase(n, nodes, cc, lc))
    return cases


def bench_optimizer_overhead(sizes=OEP_SIZES, *, device=None) -> dict:
    """OEP (max-flow) solve time against DAG size, the mean of
    ``OEP_REPS`` solves. Returns ``{n: µs a solve}``."""
    dev = resolve(device)
    out = {}
    for case in oep_cases(sizes):
        dag = case.dag()
        t0 = time.perf_counter()
        for _ in range(OEP_REPS):
            oep.plan(dag, case.compute_cost, case.load_cost, original=set())
        dt = (time.perf_counter() - t0) / OEP_REPS
        out[case.n] = dt * 1e6
        print(f"oep_solver_n{case.n},{dt * 1e6:.0f},nodes={case.n};"
              f"device={dev}", flush=True)
    return out


# ------------------------------------------------------- parallel speedup
def speedup_cases() -> dict[str, W.WorkflowDef]:
    """census at its default knobs; MNIST as a 12-tower ensemble whose
    PPR-only edits keep the fan-out stable, so every iteration reruns all
    12 fft → head → logits branches (the towers are nondeterministic)."""
    return {
        "census": W.WORKFLOWS["census"],
        "mnist": dataclasses.replace(
            W.WORKFLOWS["mnist"],
            knobs0=dataclasses.replace(W.MNISTKnobs(), n_towers=12,
                                       n_features=6144, n_images=8000,
                                       epochs=4),
            freqs={"PPR": 1.0}),
    }


def _engine(workers: int) -> EngineConfig:
    return EngineConfig(policy=Policy.OPT, max_workers=workers,
                        prefetch_depth=8,
                        async_materialization=workers > 1)


def learner_nodes(wd: W.WorkflowDef, device) -> list[str]:
    """The learner nodes of ``wd``'s first workflow."""
    dag = wd.build(wd.knobs0, device=device).build()
    return [n for n, node in dag.nodes.items() if node.kind is Kind.LEARNER]


def bench_parallel_speedup(root: str, *, n_workers: int | None = None,
                           n_iters: int = SPEEDUP_ITERS, cases=None,
                           device=None) -> dict:
    """Sequential against pipelined engine, the sum of ``execute()``'s
    wall clock over the schedule, for each workflow of ``cases`` (default
    ``speedup_cases()``). Census (any case named ``census``) must give
    the same outputs under both engines in every iteration. Returns, by
    case, the seconds and speedup, and each engine's per-iteration
    outputs, node states and C(n)."""
    dev = resolve(device)
    n_workers = n_workers or default_workers()
    cases = speedup_cases() if cases is None else cases
    out = {}
    for name, wd in cases.items():
        runs = {}
        for mode, workers in (("seq", 1), ("par", n_workers)):
            workdir = os.path.join(root, f"{name}_speedup_{mode}")
            shutil.rmtree(workdir, ignore_errors=True)
            sess = IterativeSession(
                workdir, engine=_engine(workers),
                storage=StoreConfig(budget_bytes=float(BUDGET)))
            run = {"secs": 0.0, "outputs": [], "states": [], "runtime": []}
            for kn in W.iteration_schedule(wd, n_iters, seed=0):
                rep = sess.run(wd.build(kn, device=dev))
                run["secs"] += rep.execution.total_seconds
                run["outputs"].append(rep.outputs)
                run["states"].append({n: s.name for n, s in
                                      rep.execution.states.items()})
                run["runtime"].append(dict(rep.execution.runtime))
            runs[mode] = run
        seq_s, par_s = runs["seq"]["secs"], runs["par"]["secs"]
        speedup = seq_s / max(par_s, 1e-9)
        equal = runs["seq"]["outputs"] == runs["par"]["outputs"]
        if name == "census":
            _require(equal, "census: the pipelined engine's outputs differ "
                            "from the sequential engine's")
        print(f"{name}_parallel_speedup,{par_s * 1e6 / n_iters:.0f},"
              f"seq_s={seq_s:.2f};par_s={par_s:.2f};workers={n_workers};"
              f"speedup={speedup:.2f}x;device={dev}", flush=True)
        out[name] = {"seq_s": seq_s, "par_s": par_s, "speedup": speedup,
                     "workers": n_workers, "outputs_equal": equal,
                     "learners": learner_nodes(wd, dev),
                     **{f"{k}_{mode}": runs[mode][k] for mode in runs
                        for k in ("outputs", "states", "runtime")}}
    return out


def warm_up(root: str, *, device=None) -> float:
    """One census iteration at 2,000 rows in a throwaway store on
    ``device``; returns its wall seconds."""
    dev = resolve(device)
    wd = W.WORKFLOWS["census"]
    workdir = os.path.join(root, "warm_up")
    t0 = time.perf_counter()
    IterativeSession(workdir).run(wd.build(
        dataclasses.replace(wd.knobs0, n_rows=2000), device=dev))
    shutil.rmtree(workdir, ignore_errors=True)
    return time.perf_counter() - t0


def census_busy_share(root: str, *, n_workers: int | None = None,
                      device=None) -> dict:
    """One cold census iteration under the pipelined engine, profiled
    (``torch.profiler``, CUDA activity): the wall seconds from the first
    node to the synchronised end, the card's device seconds (kernels and
    copies) and their share, and the device launches. Card only."""
    from .profile_serve import profiled
    dev = resolve(device)
    _require(dev.type == "cuda", "the busy share is a card measurement")
    wd = W.WORKFLOWS["census"]
    workdir = os.path.join(root, "census_busy")

    def setup():   # a cold session, outside the profiled window
        shutil.rmtree(workdir, ignore_errors=True)
        sess = IterativeSession(workdir, engine=_engine(n_workers
                                                        or default_workers()),
                                storage=StoreConfig(budget_bytes=float(BUDGET)))
        return sess, wd.build(wd.knobs0, device=dev)

    def cold_iteration(arg):
        sess, wf = arg
        t0 = time.perf_counter()
        rep = sess.run(wf)
        torch.cuda.synchronize()
        return rep, time.perf_counter() - t0

    times, calls, (rep, wall) = profiled(cold_iteration, setup=setup)
    busy = sum(times.values()) / 1e6
    print(f"census_busy_share,{wall * 1e6:.0f},wall_s={wall:.3f};"
          f"device_s={busy:.4f};busy={busy / wall:.4f};"
          f"launches={sum(calls.values())};computed="
          f"{rep.execution.n_computed};device={dev}", flush=True)
    return {"wall_s": wall, "device_s": busy, "busy": busy / wall,
            "launches": sum(calls.values()),
            "runtime": dict(rep.execution.runtime)}


# ------------------------------------------------------------- overlap
def bench_engine_overlap(*, width: int = OVERLAP_WIDTH, device=None) -> dict:
    """A ``width``-wide diamond of GIL-releasing 150 ms waits (no CPU
    contention) at 1 and ``width`` workers: near-width x means the
    ready-set engine adds no serialization beyond the DAG itself."""
    dev = resolve(device)
    secs = {}
    for workers in (1, width):
        nodes = [Node("src", lambda: 0.0)]
        for i in range(width):
            nodes.append(Node(f"b{i}", lambda x: (time.sleep(OVERLAP_SLEEP_S),
                                                  x)[1], parents=("src",)))
        nodes.append(Node("join", lambda *vs: sum(vs),
                          parents=tuple(f"b{i}" for i in range(width)),
                          is_output=True))
        dag = DAG(nodes)
        states = {n: State.COMPUTE for n in dag.nodes}
        with tempfile.TemporaryDirectory() as td:
            t0 = time.perf_counter()
            execute(dag, {n: f"sig-{n}" for n in dag.nodes}, states,
                    Store(td), Materializer(policy=Policy.NEVER),
                    max_workers=workers)
            secs[workers] = time.perf_counter() - t0
    speedup = secs[1] / max(secs[width], 1e-9)
    print(f"engine_overlap_w{width},{secs[width] * 1e6:.0f},"
          f"seq_s={secs[1]:.2f};par_s={secs[width]:.2f};"
          f"speedup={speedup:.2f}x;device={dev}", flush=True)
    return {"seq_s": secs[1], "par_s": secs[width], "speedup": speedup,
            "width": width}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=default_workers(),
                    help="the pipelined engine's width "
                         "(HELIX_BENCH_PAR_WORKERS)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    threads = _blas.threads()
    print("# threads: " + ";".join(f"{k}={v}" for k, v in threads.items()),
          flush=True)
    root = tempfile.mkdtemp(prefix="helix-bench-engine-")
    try:
        out = {"threads": threads, "device": str(dev)}
        if dev.type == "cuda":
            out["warm_up_s"] = warm_up(root, device=dev)
            print(f"# warm-up: {out['warm_up_s']:.3f} s", flush=True)
        out["optimizer_overhead"] = bench_optimizer_overhead(device=dev)
        out["parallel_speedup"] = bench_parallel_speedup(
            root, n_workers=args.workers, device=dev)
        out["engine_overlap"] = bench_engine_overlap(device=dev)
        if dev.type == "cuda":
            out["census_busy"] = census_busy_share(
                root, n_workers=args.workers, device=dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
