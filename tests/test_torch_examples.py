"""The port's examples (``repro_torch.examples``, twins of the JAX
package's ``examples/*.py``) on the CPU at small knobs, each through its
``main(argv)``. Where the reference example's workflow is deterministic,
the same knobs go through the reference's ``benchmarks/workflows.py`` in a
``repro.core.IterativeSession`` and the outputs agree at the learners'
1e-5: quickstart's ``checkResults``, incremental_census's ``dailyEval``,
genomics' ``clusterReport`` and the census answers of session_server.
Each example's own bar holds (quickstart's PPR edit retrains nothing and
loads or prunes what the first iteration stored; sweep_census computes no
signature twice; tune_census leaves 0 B of ledger drift).
``train_lm --small`` resumes bitwise, and without ``--small`` it trains
the published helix100m.
"""
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

import workflows as JW
from repro import configs as jconfigs
from repro.core import IterativeSession as JSession
from repro.core.config import EngineConfig as JEngine
from repro.core.omp import Policy as JPolicy
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager, ckpt as tckpt
from repro_torch.core.store import Store
from repro_torch.core.tree import tree_flatten
from repro_torch.examples import (genomics_iterate, incremental_census,
                                  quickstart, serve_lm, session_server,
                                  sweep_census, train_lm, tune_census)
from repro_torch.train import steps as tsteps

LEARNER_TOL = 1e-5
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: when several test processes
    share the cores, torch's OpenMP pool spins at each of the learners'
    thousands of small ops and runs them ~100x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(ref, got, what):
    """Equal keys; floats within LEARNER_TOL of max(1, |ref|), the rest
    equal."""
    assert type(got) is type(ref) or isinstance(ref, float), (what, got, ref)
    if isinstance(ref, dict):
        assert list(got) == list(ref), (what, got, ref)
        for k in ref:
            _close(ref[k], got[k], f"{what}.{k}")
    elif isinstance(ref, float):
        assert abs(got - ref) <= LEARNER_TOL * max(1.0, abs(ref)), (what, got,
                                                                    ref)
    else:
        assert got == ref, (what, got, ref)


def _reference_runs(tmp_path, knobs_list, build, policy=JPolicy.OPT):
    sess = JSession(str(tmp_path / "ref"), engine=JEngine(policy=policy))
    return [sess.run(build(k)) for k in knobs_list]


def _jknobs(k):
    return getattr(JW, type(k).__name__)(**dataclasses.asdict(k))


# -------------------------------------------------------------- quickstart
def test_quickstart_matches_the_reference_workflow(tmp_path, capsys):
    shown = quickstart.main(CPU + ["--rows", "3000"])
    out = capsys.readouterr().out
    assert "iteration 1 (PPR edit: metric → f1)" in out
    assert [s["title"][:11] for s in shown] == ["iteration 0",
                                                "iteration 1", "iteration 2"]
    assert shown[0]["n_computed"] == len(shown[0]["states"]) == 14
    # the PPR edit: the reducer is the only original node, the model is
    # reused (the example raises otherwise, ``check_ppr_edit``)
    assert shown[1]["original"] == ["checkResults"]
    assert shown[1]["states"]["incPred"] in ("load", "prune")
    k0 = JW.CensusKnobs(n_rows=3000)
    k1 = dataclasses.replace(k0, eval_metric="f1")
    refs = _reference_runs(tmp_path, [k0, k1, dataclasses.replace(k1, reg=0.01)],
                           JW.build_census)
    for i, (s, ref) in enumerate(zip(shown, refs)):
        _close(ref.outputs["checkResults"], s["output"], f"iteration {i}")


def _ppr_report(states, original=("checkResults",), stored=(), chosen=()):
    from repro_torch.core import State
    return types.SimpleNamespace(
        original=set(original),
        load_cost={n: (0.01 if n in stored else None) for n in states},
        execution=types.SimpleNamespace(
            states={n: State[s] for n, s in states.items()},
            chose_compute=frozenset(chosen)))


def test_quickstart_ppr_bar():
    """A node upstream of the edited reducer may be recomputed only where
    no stored value existed (OMP declined it) or the planner chose to;
    the model is never retrained, and no other node may be original."""
    ok = {"checkResults": "COMPUTE", "income": "COMPUTE",
          "predictions": "LOAD", "incPred": "PRUNE"}
    quickstart.check_ppr_edit(_ppr_report(ok, stored=("predictions",)))
    quickstart.check_ppr_edit(_ppr_report(ok, stored=("income",),
                                          chosen=("income",)))
    for bad in (_ppr_report(ok, stored=("income",)),
                _ppr_report({**ok, "incPred": "COMPUTE"}),
                _ppr_report(ok, original=("checkResults", "income"))):
        with pytest.raises(AssertionError, match="PPR edit"):
            quickstart.check_ppr_edit(bad)


# ---------------------------------------------------------------- genomics
def test_genomics_iterate_matches_the_reference_workflow(tmp_path):
    out = genomics_iterate.main(CPU + ["--docs", "120"])
    assert set(out) == {"NEVER", "OPT", "speedup"}
    edits = genomics_iterate.edits(120)
    assert [k.n_clusters for k in edits] == [16, 32, 32, 8]
    refs = _reference_runs(tmp_path, [_jknobs(k) for k in edits],
                           JW.build_genomics)
    for policy in ("NEVER", "OPT"):
        iters = out[policy]["iterations"]
        assert len(iters) == 4
        if policy == "NEVER":
            assert all(it["n_computed"] == 7 for it in iters)
        for i, (it, ref) in enumerate(zip(iters, refs)):
            _close(ref.outputs["clusterReport"], it["clusterReport"],
                   f"{policy} iteration {i}")
    assert out["OPT"]["iterations"][2]["n_loaded"] > 0   # the PPR edit


# ------------------------------------------------------------- incremental
def test_incremental_census_matches_the_reference_workflow(tmp_path):
    days = incremental_census.main(CPU + ["--rows-per-chunk", "300"])
    k0 = dataclasses.replace(JW.IncrementalCensusKnobs(), n_chunks=6,
                             rows_per_chunk=300)
    refs = _reference_runs(
        tmp_path, [k0, dataclasses.replace(k0, n_chunks=7)],
        JW.build_census_incremental, JPolicy.ALWAYS)
    for day, ref in zip(days, refs):
        _close(ref.outputs["dailyEval"], day["dailyEval"], day["title"])
        assert day["chunks"] == {
            n: (ref.execution.chunk_computed.get(n, 0),
                ref.execution.chunk_reused.get(n, 0))
            for n in sorted(set(ref.execution.chunk_computed)
                            | set(ref.execution.chunk_reused))}
    assert all(c == (1, 6) for c in days[1]["chunks"].values())


# ----------------------------------------------------------- session server
def test_session_server_serves_three_users(tmp_path):
    out = session_server.main(CPU + ["--rows", "2000"])
    assert sorted(out["dispatch_log"]) == ["alice", "bob", "carol"]
    res = out["results"]
    assert all(res[u]["status"] == "done" for u in ("alice", "bob", "carol"))
    # alice and bob share the pipeline and the model: one of them computed
    # them, the other deduplicated or loaded them
    assert sum(res[u]["execution"]["n_deduped"]
               + res[u]["execution"]["n_loaded"] for u in ("alice", "bob")) > 0
    refs = _reference_runs(
        tmp_path, [JW.CensusKnobs(n_rows=2000, reg=0.1, eval_threshold=t)
                   for t in (0.5, 0.7)], JW.build_census)
    for user, ref in zip(("alice", "bob"), refs):
        _close(ref.outputs, res[user]["outputs"], user)
    x = np.linspace(0, 1, 200_000)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    assert res["carol"]["outputs"] == {
        "area": {"area": float(trapezoid(np.sin(x * np.pi) * 2.0, x))}}


# -------------------------------------------------------------- sweeps
def test_sweep_census_computes_no_signature_twice():
    out = sweep_census.main(CPU + ["--rows", "2000"])
    assert out["recomputed"] == {}
    assert len(out["arms"]) == 8 and out["sweep_s"] > 0 and out["iso_s"] > 0
    by_reg = {}
    for arm in out["arms"]:
        reg = arm["name"].split("_")[1]
        by_reg.setdefault(reg, set()).add(arm["checkResults"]["value"])
    # the two thresholds of one reg share the model: one accuracy
    assert len(by_reg) == 4 and all(len(v) == 1 for v in by_reg.values())


def test_tune_census_leaves_no_ledger_drift(monkeypatch):
    monkeypatch.setenv("HELIX_EXAMPLE_ROWS", "2000")
    out = tune_census.main(CPU)
    search, halving = out["search"], out["halving"]
    assert len(search["arms"]) == 4 and search["wasted"] == 0
    assert search["models"] <= 4 and search["best"]["reg"] in tune_census.REGS
    assert halving["ledger_drift_b"] == 0 and halving["wasted"] == 0
    assert [r["level"] for r in halving["rungs"]] == [10, 30]
    assert halving["best"]["rung"] == 1


# ---------------------------------------------------------- model entry points
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-130m"])
def test_serve_lm_serves_the_reduced_config(arch, capsys):
    res = serve_lm.main(CPU + ["--arch", arch, "--batch", "2",
                               "--prompt-len", "8", "--gen-tokens", "3"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke batch=2 prompt=8 gen=3 device=cpu" in out
    cfg = tconfigs.reduced(tconfigs.get(arch))
    assert tuple(res.tokens.shape) == (2, 3)
    assert 0 <= int(res.tokens.min()) and int(res.tokens.max()) < cfg.vocab_size
    assert bool(torch.isfinite(res.last_logits).all())


def _same_bits(a, b) -> bool:
    (la, da), (lb, db) = tree_flatten(a), tree_flatten(b)
    return da == db and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def test_train_lm_small_resumes_bitwise(tmp_path):
    """``--small`` for 4 steps with a segment at 2; the step-4 checkpoint
    is removed (the job taken as preempted after step 2's landed) and
    ``--resume`` replays steps 2 and 3 onto the uninterrupted state."""
    argv = CPU + ["--small", "--steps", "4", "--segment-steps", "2",
                  "--batch", "2", "--seq", "16", "--workdir", str(tmp_path)]
    assert train_lm.trainer_argv(argv)[:14] == [
        "--arch", "helix100m", "--steps", "4", "--workdir",
        "results/train_lm", "--segment-steps", "25", "--batch", "8",
        "--seq", "128", "--lr", "3e-3"]
    full = train_lm.main(argv)
    run = "helix100m-smoke-s0"
    store = Store(os.path.join(tmp_path, "store"))
    assert CheckpointManager(store, run).latest_step() == 4
    assert store.delete(tckpt._sig(run, 4)) > 0
    resumed = train_lm.main(argv + ["--resume"])
    assert resumed.start_step == 2 and resumed.losses == full.losses[2:]
    assert _same_bits(resumed.state, full.state)


def test_train_lm_without_small_trains_the_published_config(monkeypatch,
                                                            tmp_path):
    """As the reference's example: no ``--small`` is the ~100M helix100m
    (checked where the state would be made, without making it)."""
    seen = {}

    def stop(cfg, generator, device):
        seen["cfg"] = cfg
        raise KeyboardInterrupt

    monkeypatch.setattr(tsteps, "init_train_state", stop)
    with pytest.raises(KeyboardInterrupt):
        train_lm.main(CPU + ["--workdir", str(tmp_path)])
    assert seen["cfg"] == tconfigs.get("helix100m")
    assert seen["cfg"].param_count() == jconfigs.get("helix100m").param_count()
    assert "--reduced" not in train_lm.trainer_argv([])
    assert train_lm.trainer_argv(["--small"])[-3:] == ["--reduced", "--batch",
                                                       "16"]
