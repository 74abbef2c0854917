"""The port's sweep engine (``repro_torch.core.sweep``): cross-variant
reuse over one shared store. Twins of ``tests/test_sweep.py``.

Correctness bar: a K-variant sweep sharing one store
produces outputs bit-identical to K isolated cold runs, and computes each
shared-prefix signature exactly once fleet-wide.
"""
import dataclasses
import threading

import numpy as np
import pytest

from repro_torch.core import (IterativeSession, Policy, SweepVariant, grid,
                              run_sweep)
from repro_torch.core.locking import HAVE_FLOCK, StorageLedger
from repro_torch.core.workflow import Workflow

pytestmark = pytest.mark.skipif(
    not HAVE_FLOCK, reason="fleet mode needs POSIX flock")


class Calls:
    """Thread-safe per-node compute counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts: dict[str, int] = {}

    def hit(self, name: str) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + 1


@dataclasses.dataclass(frozen=True)
class ToyKnobs:
    reg: float = 0.1
    bias: float = 0.0


def build_toy(k: ToyKnobs, calls: Calls | None = None) -> Workflow:
    """source → parse → feat (slow, shared) → model(reg) → eval(bias):
    everything up to ``feat`` is knob-independent, i.e. the shared
    prefix; the learner/eval tail differs per variant."""
    def count(name):
        if calls is not None:
            calls.hit(name)

    wf = Workflow("toy")
    src = wf.source(
        "src", lambda: (count("src"), np.arange(4096, dtype=np.float64))[1],
        config="v1")
    parsed = wf.scanner(
        "parse", lambda x: (count("parse"), x.reshape(64, 64))[1],
        [src], config="v1")

    def featurize(m):
        count("feat")
        acc = m.copy()
        # Heavy enough (~100ms) that a 32 KB store LOAD decisively beats
        # recomputing even when a loaded machine makes the measured store
        # bandwidth look terrible — the OEP planner must pick LOAD for
        # late arrivals by economics, not by luck.
        for _ in range(2000):
            acc = np.tanh(acc @ m.T @ m / m.size)
        return acc

    feat = wf.extractor("feat", featurize, [parsed], config="v1")
    model = wf.learner(
        "model",
        lambda z, reg=k.reg: (count("model"), float(np.sum(z * z)) * reg)[1],
        [feat], config=("LR", k.reg))
    out = wf.reducer(
        "eval",
        lambda m, b=k.bias: (count("eval"), {"score": m + b})[1],
        [model], config=("eval", k.bias))
    wf.output(out)
    return wf


REGS = [0.1, 0.2, 0.4]


def _variants(calls=None):
    return [SweepVariant(name=f"reg{r}",
                         build=(lambda r=r: build_toy(ToyKnobs(reg=r),
                                                      calls)),
                         knobs=ToyKnobs(reg=r))
            for r in REGS]


def test_sweep_bit_identical_to_isolated_cold_runs(tmp_path):
    sweep = run_sweep(str(tmp_path / "shared"), _variants())
    sweep.raise_errors()
    isolated = {}
    for r in REGS:
        sess = IterativeSession(str(tmp_path / f"iso{r}"))
        isolated[f"reg{r}"] = sess.run(build_toy(ToyKnobs(reg=r))).outputs
    assert sweep.outputs == isolated   # bit-identical, not approx


def test_sweep_computes_shared_prefix_exactly_once(tmp_path):
    calls = Calls()
    sweep = run_sweep(str(tmp_path), _variants(calls))
    sweep.raise_errors()
    # Shared-prefix operators ran once fleet-wide; per-variant tails ran K×.
    assert calls.counts["feat"] == 1
    assert calls.counts["src"] == 1
    assert calls.counts["parse"] == 1
    assert calls.counts["model"] == len(REGS)
    assert calls.counts["eval"] == len(REGS)
    # and the report agrees: no signature was computed by two variants
    assert all(n == 1 for n in sweep.fleet_computes().values())
    assert sweep.wasted_recomputes() == 0


def test_sweep_shared_budget_respected(tmp_path):
    budget = 40_000  # fits ~one 64×64 float64 feat value, not much more
    sweep = run_sweep(str(tmp_path), _variants(),
                      storage_budget_bytes=budget)
    sweep.raise_errors()
    assert all(r.report is not None for r in sweep.results)
    # the shared on-disk ledger never exceeded the budget
    from repro_torch.core import Store
    store = Store(str(tmp_path / "store"))
    assert store.total_bytes() <= budget
    assert 0 <= StorageLedger(store.ledger_path).used() <= budget


def test_sweep_sequential_arrival_reuses_store(tmp_path):
    """n_concurrent=1: later variants arrive after the prefix landed and
    the OEP planner turns it into plain LOADs — reuse without any lease
    contention."""
    calls = Calls()
    sweep = run_sweep(str(tmp_path), _variants(calls), n_concurrent=1)
    sweep.raise_errors()
    assert calls.counts["feat"] == 1
    later = [r.report for r in sweep.results[1:]]
    assert all(rep.execution.n_loaded >= 1 for rep in later)


def test_sweep_shared_nondet_nonces(tmp_path):
    """share_nondet pins one nonce per node name sweep-wide: the unseeded
    featurizer runs once and every variant sees the same draw."""
    calls = Calls()

    def build_nd(scale):
        wf = Workflow("nd")
        src = wf.source("src", lambda: np.ones(512), config="v1")

        def noisy(x):
            calls.hit("noisy")
            return x * np.random.default_rng().uniform(0.5, 1.5, x.shape)

        feat = wf.extractor("noisy", noisy, [src], config="n1",
                            deterministic=False)
        out = wf.reducer("out",
                         lambda z, s=scale: {"v": float(z.sum()) * s},
                         [feat], config=("s", scale))
        wf.output(out)
        return wf

    scales = [1.0, 2.0, 4.0]
    variants = [SweepVariant(name=f"s{s}", build=(lambda s=s: build_nd(s)))
                for s in scales]
    sweep = run_sweep(str(tmp_path / "pinned"), variants)
    sweep.raise_errors()
    assert calls.counts["noisy"] == 1
    vals = [sweep.outputs[f"s{s}"]["out"]["v"] / s for s in scales]
    assert vals[0] == vals[1] == vals[2]   # same underlying draw

    # independent mode: every variant draws (and computes) its own
    calls2 = Calls()

    def build_nd2(scale):
        wf = Workflow("nd")
        src = wf.source("src", lambda: np.ones(512), config="v1")

        def noisy(x):
            calls2.hit("noisy")
            return x * np.random.default_rng().uniform(0.5, 1.5, x.shape)

        feat = wf.extractor("noisy", noisy, [src], config="n1",
                            deterministic=False)
        out = wf.reducer("out",
                         lambda z, s=scale: {"v": float(z.sum()) * s},
                         [feat], config=("s", scale))
        wf.output(out)
        return wf

    variants2 = [SweepVariant(name=f"s{s}", build=(lambda s=s: build_nd2(s)))
                 for s in scales]
    sweep2 = run_sweep(str(tmp_path / "indep"), variants2,
                       share_nondet=False)
    sweep2.raise_errors()
    assert calls2.counts["noisy"] == len(scales)


def test_grid_helper():
    vs = grid(ToyKnobs(), {"reg": [0.1, 0.2], "bias": [0.0, 1.0]},
              build=lambda k: build_toy(k))
    assert len(vs) == 4
    assert {v.knobs.reg for v in vs} == {0.1, 0.2}
    assert {v.knobs.bias for v in vs} == {0.0, 1.0}
    wf = vs[0].build()
    assert "feat" in wf.build().nodes


def test_sweep_policies_and_reuse_second_wave(tmp_path):
    """A second sweep over the same workdir (e.g. a refined grid) reuses
    the first wave's materializations through ordinary OEP planning."""
    calls = Calls()
    run_sweep(str(tmp_path), _variants(calls)).raise_errors()
    assert calls.counts["feat"] == 1
    second = [SweepVariant(name="reg9",
                           build=(lambda: build_toy(ToyKnobs(reg=0.9),
                                                    calls)))]
    sweep2 = run_sweep(str(tmp_path), second, policy=Policy.OPT)
    sweep2.raise_errors()
    assert calls.counts["feat"] == 1   # loaded, not recomputed
    rep = sweep2.results[0].report
    assert rep.execution.n_loaded >= 1


# ---------------------------------------------------------------------------
# the port against the reference: the census grid; the fleet benches
# ---------------------------------------------------------------------------
# fp32 learners that differ from their JAX twins only in summation order
# (as in tests/test_torch_workflows.py)
LEARNER_TOL = 1e-5
FLIP_MARGIN = 1e-4


@pytest.fixture
def one_torch_thread():
    """One intra-op thread: several test processes share the cores, and
    torch's OpenMP pool spins at each of the learners' small ops."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_census_grid_sweep_matches_reference(tmp_path, one_torch_thread):
    """A 4-arm census grid (reg × eval_threshold) at 2,000 rows through
    both packages' ``run_sweep`` under ``Policy.ALWAYS``: the same set of
    signatures computed, each once in the port, the host
    values are ``==``, the logistic weights agree within LEARNER_TOL of
    max(1, max |ref|), a prediction flips only within FLIP_MARGIN of the
    boundary, and where none flips the outputs are ``==``."""
    import os

    import workflows as JW
    from repro.core import run_sweep as ref_run_sweep, grid as ref_grid
    from repro.core.config import EngineConfig as JEngine
    from repro.core.omp import Policy as JPolicy
    from repro.core.store import Store as JStore
    from repro_torch import workflows as TW
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.store import Store

    axes = {"reg": [0.03, 0.3], "eval_threshold": [0.5, 0.7]}
    reps = {
        "jax": ref_run_sweep(
            str(tmp_path / "jax"),
            ref_grid(JW.CensusKnobs(n_rows=2000), axes, JW.build_census,
                     name="census"),
            engine=JEngine(policy=JPolicy.ALWAYS)),
        "torch": run_sweep(
            str(tmp_path / "torch"),
            grid(TW.CensusKnobs(n_rows=2000), axes,
                 lambda k: TW.build_census(k, device="cpu"), name="census"),
            engine=EngineConfig(policy=Policy.ALWAYS))}
    for rep in reps.values():
        rep.raise_errors()
    fleet = {pkg: rep.fleet_computes() for pkg, rep in reps.items()}
    assert set(fleet["torch"]) == set(fleet["jax"])
    # each signature once in the port; the reference can compute a fast
    # node twice under load (it re-checks the store after taking a lease
    # only with a remote tier: test_torch_fleet_faults.py), so only its
    # signature set is held here
    assert set(fleet["torch"].values()) == {1}
    assert reps["torch"].wasted_recomputes() == 0
    stores = {"jax": JStore(os.path.join(tmp_path, "jax", "store")),
              "torch": Store(os.path.join(tmp_path, "torch", "store"))}
    for j_res, t_res in zip(reps["jax"].results, reps["torch"].results):
        assert t_res.variant.name == j_res.variant.name
        assert t_res.report.sigs == j_res.report.sigs

        def value(pkg, res, name):
            return stores[pkg].load(res.report.sigs[name])[0]

        ex_j = value("jax", j_res, "income")
        ex_t = value("torch", t_res, "income")
        for key in ("X", "y"):
            assert ex_t[key].dtype == ex_j[key].dtype
            np.testing.assert_array_equal(ex_t[key], ex_j[key])
        wj = np.asarray(value("jax", j_res, "incPred"))
        wt = value("torch", t_res, "incPred")
        assert wt.dtype == wj.dtype == np.float32
        assert np.abs(wt - wj).max() / max(1.0, np.abs(wj).max()) \
            <= LEARNER_TOL
        X = ex_j["X"]
        flipped = TW.logreg_predict(wt, X) != JW.logreg_predict(wj, X)
        assert np.all(np.abs((X @ wj[:-1] + wj[-1])[flipped]) < FLIP_MARGIN)
        if not flipped.any():
            assert t_res.outputs == j_res.outputs


@pytest.mark.parametrize("bench", ["sweep_reuse", "server_reuse",
                                   "eviction", "remote_reuse",
                                   "search_reuse", "multitenant"])
def test_bench_fleet_runs_each_bench_on_the_cpu(bench, tmp_path, capsys,
                                                one_torch_thread):
    """``launch.bench_fleet`` at the smallest sizes (census 2,000 rows,
    MNIST 500 images): each bench prints its rows with the reference's
    field names and meets the bars a fleet must hold at any size (no
    blind duplicate compute, ledger == disk, hash reruns recompute
    nothing)."""
    from repro_torch.launch import bench_fleet

    out = bench_fleet.run([bench], scale=0.01, device="cpu",
                          root=str(tmp_path))[bench]
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.endswith("device=cpu")]
    fields = {ln.split(",")[0]: dict(kv.split("=") for kv in
                                     ln.split(",", 2)[2].split(";"))
              for ln in rows}
    expect = {
        "sweep_reuse": {"census_sweep_reuse", "mnist_sweep_reuse"},
        "server_reuse": {"census_server_reuse", "mnist_server_reuse"},
        "eviction": {"census_eviction", "mnist_eviction"},
        "remote_reuse": {"census_remote_reuse"},
        "search_reuse": {"census_search_reuse", "census_search_halving"},
        "multitenant": {"multitenant_routing"}}[bench]
    assert set(fields) == expect
    if bench == "sweep_reuse":
        for name in ("census", "mnist"):
            assert out[name]["shared_recomputed"] == 0
            assert set(out[name]["fleet_computes"].values()) == {1}
        assert fields["census_sweep_reuse"].keys() >= {
            "iso_par_s", "iso_seq_s", "sweep_s", "variants", "speedup",
            "shared_recomputed", "store_kb"}
    elif bench == "server_reuse":
        assert all(out[n]["shared_recomputed"] == 0
                   for n in ("census", "mnist"))
    elif bench == "eviction":
        for name in ("census", "mnist"):
            assert out[name]["ledger_drift_b"] == 0
            assert out[name]["ledger_drift_refuse_b"] == 0
            assert out[name]["evicted"] > 0
    elif bench == "remote_reuse":
        assert out["fleet_dup"] == 0 and out["evict_leased"] == 0
        assert out["remote_fetches"] > 0
    elif bench == "search_reuse":
        assert out["search"]["wasted"] == out["halving"]["wasted"] == 0
        assert out["halving"]["ledger_drift_b"] == 0
        assert out["search"]["tuner_models"] < out["search"]["fixed_models"]
    else:
        assert out["hash_recomputed"] == 0 and out["ledger_drift_b"] == 0
