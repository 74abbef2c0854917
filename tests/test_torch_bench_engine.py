"""The port's engine benches (``repro_torch.launch.bench_engine``) and its
by-name bench CLI (``repro_torch.launch.bench``), twins of three benches
and of the dispatcher of the JAX package's ``benchmarks/run.py``, on the
CPU at tiny knobs.

- ``oep_cases`` draws the reference's seeded DAGs at 50, 200 and 1000
  nodes, and the port's ``oep.plan`` gives ``repro.core.oep.plan``'s node
  states on each.
- ``bench_parallel_speedup`` on a small census (equal outputs under the
  sequential and pipelined engines) and a 4-tower MNIST (nondeterministic
  towers: shapes and range only).
- The 8-wide overlap diamond reaches at least 3x (sleeping threads reach
  that on a loaded host; the reference expects 7-8x).
- The rows keep the reference's names and fields, the device last.
- ``launch.bench`` knows the reference's 14 names in its order, sends
  each to the port's twin with the reference's environment knobs, and
  refuses an unknown name with the reference's message.
"""
import contextlib
import dataclasses
import io
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import run as jrun
from repro.core import oep as joep
from repro.core.dag import DAG as JDAG, Node as JNode
from repro_torch import workflows as W
from repro_torch.core import oep as toep
from repro_torch.launch import _blas, bench, bench_engine as B

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: when several test processes
    share the cores, torch's OpenMP pool spins at each of the learners'
    thousands of small ops and runs them ~100x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(fn, *args, **kw):
    """(return value, the CSV rows ``fn`` printed as (name, us, {key:
    value}))."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    rows = []
    for line in buf.getvalue().splitlines():
        if line.startswith("#"):
            continue
        name, us, derived = line.split(",", 2)
        rows.append((name, us, dict(f.split("=", 1)
                                    for f in derived.split(";"))))
    return out, rows


# ------------------------------------------------------------------- OEP
@pytest.fixture(scope="module")
def oep_cases():
    return {c.n: c for c in B.oep_cases()}


@pytest.mark.parametrize("n", B.OEP_SIZES)
def test_oep_plan_gives_the_references_states(oep_cases, n):
    case = oep_cases[n]
    assert len(case.nodes) == n and case.nodes[-1][2]
    got = toep.plan(case.dag(), case.compute_cost, case.load_cost,
                    original=set())
    want = joep.plan(case.dag(JNode, JDAG), case.compute_cost,
                     case.load_cost, original=set())
    assert {k: s.name for k, s in got.items()} == \
        {k: s.name for k, s in want.items()}
    assert set(got) == {name for name, _, _ in case.nodes}
    assert {s.name for s in got.values()} >= {"LOAD", "PRUNE"}


def test_oep_cases_are_the_references_draws(oep_cases):
    """The reference's draws, replayed: the same rng calls in the same
    order give the same parents and costs."""
    rng = np.random.default_rng(0)
    for n in B.OEP_SIZES:
        for i in range(n):
            k = int(min(i, 3))
            parents = tuple(f"n{j}" for j in
                            rng.choice(i, k, replace=False)) if i else ()
            assert oep_cases[n].nodes[i] == (f"n{i}", parents, i == n - 1)
        assert oep_cases[n].compute_cost == {
            f"n{i}": float(rng.uniform(0.1, 10)) for i in range(n)}
        assert oep_cases[n].load_cost == {
            f"n{i}": (float(rng.uniform(0.1, 5)) if rng.random() < 0.7
                      else None) for i in range(n)}


def test_optimizer_overhead_rows_are_the_references():
    _, want = _rows(jrun.bench_optimizer_overhead)
    got, rows = _rows(B.bench_optimizer_overhead, device="cpu")
    assert sorted(got) == list(B.OEP_SIZES) and all(v > 0 for v in got.values())
    assert [r[0] for r in rows] == [r[0] for r in want]
    for (_, us, d), (_, _, dw) in zip(rows, want):
        assert int(us) > 0
        assert d == {**dw, "device": "cpu"}


# ------------------------------------------------------ parallel speedup
TINY = {
    "census": dataclasses.replace(
        W.WORKFLOWS["census"],
        knobs0=W.CensusKnobs(n_rows=2000, train_iters=50)),
    "mnist": dataclasses.replace(
        B.speedup_cases()["mnist"],
        knobs0=W.MNISTKnobs(n_towers=4, n_features=64, n_images=300,
                            epochs=2)),
}


@pytest.fixture(scope="module")
def speedup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("speedup"))
    return _rows(B.bench_parallel_speedup, root, n_workers=4, cases=TINY,
                 device="cpu")


def test_speedup_cases_are_the_references():
    cases = B.speedup_cases()
    assert cases["census"] == W.WORKFLOWS["census"]
    mnist = cases["mnist"]
    assert mnist.freqs == {"PPR": 1.0}
    assert mnist.knobs0 == dataclasses.replace(
        W.MNISTKnobs(), n_towers=12, n_features=6144, n_images=8000, epochs=4)
    assert B.SPEEDUP_ITERS == 3 and B.BUDGET == jrun.BUDGET


def test_census_outputs_equal_across_engines(speedup):
    out, _ = speedup
    census = out["census"]
    assert census["outputs_equal"]
    assert census["outputs_seq"] == census["outputs_par"]
    assert len(census["outputs_seq"]) == B.SPEEDUP_ITERS
    assert census["workers"] == 4 and census["learners"] == ["incPred",
                                                             "predictions"]
    # the cold iteration computes every node under both engines, and each
    # engine's C(n) covers exactly the nodes it ran
    for mode in ("seq", "par"):
        assert set(census[f"states_{mode}"][0].values()) == {"COMPUTE"}
        for states, runtime in zip(census[f"states_{mode}"],
                                   census[f"runtime_{mode}"]):
            assert set(runtime) == {n for n, s in states.items()
                                    if s != "PRUNE"}
            assert all(t >= 0 for t in runtime.values())


def test_mnist_towers_run_under_both_engines(speedup):
    """The towers are nondeterministic: every iteration recomputes all
    four, and the ensemble's accuracy is a share in [0, 1]."""
    mnist = speedup[0]["mnist"]
    for mode in ("seq", "par"):
        assert len(mnist[f"outputs_{mode}"]) == B.SPEEDUP_ITERS
        for out, states in zip(mnist[f"outputs_{mode}"],
                               mnist[f"states_{mode}"]):
            assert list(out) == ["evalAcc"]
            assert 0.0 <= out["evalAcc"]["top1"] <= 1.0
            assert all(states[f"fftTower{t}"] == "COMPUTE" for t in range(4))
    assert mnist["seq_s"] > 0 and mnist["par_s"] > 0


def test_speedup_rows_are_the_references(speedup):
    """The reference's row (``benchmarks/run.py:229-232``):
    ``<case>_parallel_speedup,<par µs an iteration>,seq_s;par_s;workers;
    speedup``, here with the device last."""
    out, rows = speedup
    assert [r[0] for r in rows] == ["census_parallel_speedup",
                                    "mnist_parallel_speedup"]
    for (name, us, d), case in zip(rows, ("census", "mnist")):
        assert list(d) == ["seq_s", "par_s", "workers", "speedup", "device"]
        assert d["workers"] == "4" and d["device"] == "cpu"
        assert d["speedup"].endswith("x")
        assert int(us) == round(out[case]["par_s"] * 1e6 / B.SPEEDUP_ITERS)


def test_warm_up_runs_a_small_census_iteration_and_leaves_nothing(tmp_path):
    secs = B.warm_up(str(tmp_path), device="cpu")
    assert secs > 0 and os.listdir(tmp_path) == []


# --------------------------------------------------------------- overlap
def test_engine_overlap_reaches_3x_and_keeps_the_references_row():
    _, want = _rows(jrun.bench_engine_overlap)
    got, rows = _rows(B.bench_engine_overlap, device="cpu")
    assert got["speedup"] >= 3.0, got
    assert got["seq_s"] >= B.OVERLAP_WIDTH * B.OVERLAP_SLEEP_S
    assert [r[0] for r in rows] == [r[0] for r in want] == ["engine_overlap_w8"]
    assert list(rows[0][2]) == list(want[0][2]) + ["device"]


# ------------------------------------------------------ the by-name CLI
def test_bench_names_are_the_references_in_its_order():
    ref = [n for n in jrun.main.__code__.co_names if n.startswith("bench_")]
    assert list(bench.BENCHES) == ref
    assert sorted(bench.BENCHES) == sorted(
        n for n, v in vars(jrun).items()
        if n.startswith("bench_") and callable(v))
    assert all(callable(getattr(bench.Suite, n)) for n in bench.BENCHES)


def test_knobs_read_the_references_environment():
    assert bench.Knobs.from_env({}) == bench.Knobs()
    d = bench.Knobs()
    assert (d.iters, d.workflows, d.sweep_variants, d.sweep_scale,
            d.lm_steps, d.lm_dm, d.tenant_families, d.chaos_seed,
            d.inc_chunks, d.inc_rows) == (
        10, ("census", "genomics", "nlp", "mnist"), 4, 1.0, 4, 128, 6,
        1234, 10, 8000)
    assert d.par_workers == max(2, os.cpu_count() or 2)
    env = {"HELIX_BENCH_ITERS": "3", "HELIX_BENCH_WORKFLOWS": "census,nlp",
           "HELIX_BENCH_PAR_WORKERS": "5", "HELIX_BENCH_SWEEP_VARIANTS": "2",
           "HELIX_BENCH_SWEEP_SCALE": "0.05", "HELIX_BENCH_LM_STEPS": "2",
           "HELIX_BENCH_LM_DM": "64", "HELIX_BENCH_TENANT_FAMILIES": "3",
           "HELIX_CHAOS_SEED": "7", "HELIX_BENCH_INC_CHUNKS": "4",
           "HELIX_BENCH_INC_ROWS": "500"}
    assert bench.Knobs.from_env(env) == bench.Knobs(
        iters=3, workflows=("census", "nlp"), par_workers=5, sweep_variants=2,
        sweep_scale=0.05, lm_steps=2, lm_dm=64, tenant_families=3,
        chaos_seed=7, inc_chunks=4, inc_rows=500)


KNOBS = bench.Knobs(iters=3, workflows=("census", "nlp"), par_workers=5,
                    sweep_variants=2, sweep_scale=0.05, lm_steps=2, lm_dm=64,
                    tenant_families=3, chaos_seed=7, inc_chunks=4,
                    inc_rows=500)
# each name → (module, function, what the call must carry)
ROUTES = {
    "bench_cumulative_runtime": ("bench_workflows", "bench_cumulative_runtime",
                                 {}),
    "bench_storage": ("bench_workflows", "bench_storage", {}),
    "bench_state_fractions": ("bench_workflows", "bench_state_fractions", {}),
    "bench_optimizer_overhead": ("bench_engine", "bench_optimizer_overhead",
                                 {}),
    "bench_parallel_speedup": ("bench_engine", "bench_parallel_speedup",
                               {"n_workers": 5}),
    "bench_sweep_reuse": ("bench_fleet", "sweep_reuse",
                          {"n_var": 2, "scale": 0.05}),
    "bench_server_reuse": ("bench_fleet", "server_reuse",
                           {"n_var": 2, "scale": 0.05}),
    "bench_eviction": ("bench_fleet", "eviction", {"n_var": 2, "scale": 0.05}),
    "bench_remote_reuse": ("bench_fleet", "remote_reuse",
                           {"n_var": 2, "scale": 0.05}),
    "bench_search_reuse": ("bench_fleet", "search_reuse",
                           {"n_var": 2, "scale": 0.05}),
    "bench_incremental": ("bench_workflows", "bench_incremental",
                          {"args": (4, 500)}),
    "bench_tier": ("bench_tier", "bench_tier", {"steps": 2, "d_model": 64}),
    "bench_engine_overlap": ("bench_engine", "bench_engine_overlap", {}),
    "bench_multitenant": ("bench_fleet", "multitenant",
                          {"families": 3, "seed": 7, "scale": 0.05}),
}


@pytest.mark.parametrize("name", bench.BENCHES)
def test_each_name_runs_the_ports_twin(name, monkeypatch):
    """Each name reaches its port function with the knobs, on the device
    asked for (the functions are replaced by recorders here; the benches
    themselves are tested in their own files)."""
    calls = []

    def recorder(*args, **kw):
        calls.append((args, kw))
        return types.SimpleNamespace(stats={})     # bench_tier's .stats

    module, fn, carry = ROUTES[name]
    mod = getattr(bench, module)
    if module == "bench_fleet":
        monkeypatch.setitem(mod.BENCHES, fn, recorder)
    else:
        monkeypatch.setattr(mod, fn, recorder)
    monkeypatch.setattr(bench.bench_workflows, "run_policies",
                        lambda wd, root, n, device: ("runs", wd.name, n))
    out = bench.run([name], device="cpu", knobs=KNOBS)
    assert list(out) == [name] and len(calls) == 1
    args, kw = calls[0]
    if fn in ("bench_cumulative_runtime", "bench_storage",
              "bench_state_fractions"):
        assert args == ({"census": ("runs", "census", 3),
                         "nlp": ("runs", "nlp", 3)}, torch.device("cpu"))
        return
    assert kw["device"] == torch.device("cpu")
    if fn == "bench_tier":
        assert (args[1].steps, args[1].d_model) == (2, 64)
    elif "args" in carry:
        assert args[1:] == carry["args"]
    else:
        assert {k: kw[k] for k in carry} == carry


def test_unknown_name_is_refused_with_the_references_message():
    with pytest.raises(SystemExit) as exc:
        bench.main(["bench_engine_overlap", "bench_nope", "--device", "cpu"])
    assert str(exc.value) == (
        "unknown benchmark 'bench_nope'; available: "
        + ", ".join(sorted(bench.BENCHES)))
    with pytest.raises(ValueError, match="bench_nope"):
        bench.run(["bench_nope"], device="cpu")


def test_cli_pins_blas_and_runs_by_name():
    """``python -m repro_torch.launch.bench <name>`` pins the BLAS
    variables to 1 before numpy loads (torch's intra-op pool follows
    ``OMP_NUM_THREADS``), prints them, then the bench's rows."""
    env = {k: v for k, v in os.environ.items() if k not in _blas.VARS}
    env["PYTHONPATH"] = os.path.abspath(SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.bench",
         "bench_optimizer_overhead", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == ("# threads: OPENBLAS_NUM_THREADS=1;OMP_NUM_THREADS=1;"
                        "MKL_NUM_THREADS=1;torch_threads=1")
    assert [ln.split(",")[0] for ln in lines[1:]] == [
        f"oep_solver_n{n}" for n in B.OEP_SIZES]
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.bench", "bench_nope"],
        env=env, capture_output=True, text=True, timeout=120)
    assert bad.returncode == 1 and "unknown benchmark 'bench_nope'" in bad.stderr
