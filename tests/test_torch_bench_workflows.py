"""The port's workflow experiments (``repro_torch.launch.bench_workflows``,
twin of the workflow benches of ``benchmarks/run.py``) on the CPU at small
knobs: each workflow under NM, AM and OPT, the Fig. 5/8/9 rows computed
from those runs, and the daily-retrain bench with its own two assertions.
Under every policy the deterministic workflows give the same outputs in
every iteration (a load gives what a recompute gives), and MNIST recomputes
its random-FFT nodes in every iteration. Imports no JAX."""
import dataclasses

import pytest
import torch

from repro_torch import workflows as W
from repro_torch.core import Policy, State
from repro_torch.launch import bench_workflows as B

SMALL = {"census": W.CensusKnobs(n_rows=2000, train_iters=50),
         "genomics": W.GenomicsKnobs(n_docs=150, vocab=800, kb_size=40,
                                     emb_dim=16, emb_epochs=3),
         "nlp": W.NLPKnobs(n_docs=40, vocab=300),
         "mnist": W.MNISTKnobs(n_images=400, n_features=48, epochs=5)}
N_ITERS = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: when several test processes
    share the cores, torch's OpenMP pool spins at each of the learners'
    thousands of small ops and runs them ~100x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    out = {}
    for name, k in SMALL.items():
        wd = dataclasses.replace(W.WORKFLOWS[name], knobs0=k)
        out[name] = B.run_policies(wd, root, N_ITERS, device="cpu")
    return out


def _small_schedule(name):
    wd = dataclasses.replace(W.WORKFLOWS[name], knobs0=SMALL[name])
    return W.iteration_schedule(wd, N_ITERS, 0)


@pytest.mark.parametrize("name", list(SMALL))
def test_each_policy_runs_the_schedule(results, name):
    runs = results[name]
    assert list(runs) == [Policy.NEVER, Policy.ALWAYS, Policy.OPT]
    for run in runs.values():
        assert len(run.times) == len(run.reports) == N_ITERS
        assert all(t > 0 for t in run.times)
        assert [r.sigs.keys() for r in run.reports] == \
            [W.WORKFLOWS[name].build(k, device="cpu").build().nodes.keys()
             for k in _small_schedule(name)]
    nm = runs[Policy.NEVER].reports
    assert all(r.execution.n_loaded == 0 for r in nm)
    assert any(r.execution.n_loaded > 0
               for r in runs[Policy.ALWAYS].reports[1:])


@pytest.mark.parametrize("name", ["census", "genomics", "nlp"])
def test_deterministic_workflows_agree_across_policies(results, name):
    runs = results[name]
    for it in range(N_ITERS):
        outs = [run.reports[it].outputs for run in runs.values()]
        assert outs[0] == outs[1] == outs[2], (name, it)


def test_mnist_recomputes_its_features_under_every_policy(results):
    for policy, run in results["mnist"].items():
        for rep in run.reports:
            assert rep.execution.states["randomFFT"] is State.COMPUTE, policy
            assert rep.execution.states["softmax"] is State.COMPUTE, policy


def test_bench_rows_are_computed_from_the_runs(results, capsys):
    cum = B.bench_cumulative_runtime(results, "cpu")
    storage = B.bench_storage(results, "cpu")
    states = B.bench_state_fractions(results, "cpu")
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == 4 * (3 + 2 + 2)
    assert all(len(r.split(",")) == 3 and r.endswith("device=cpu")
               for r in rows)
    assert rows[0].startswith("census_never_cumulative,")
    for name, runs in results.items():
        for policy, run in runs.items():
            total, speedup = cum[name][policy]
            assert total == sum(run.times)
            assert speedup == pytest.approx(
                sum(runs[Policy.NEVER].times) / total)
        assert cum[name][Policy.NEVER][1] == 1.0
        for policy in (Policy.ALWAYS, Policy.OPT):
            final, peak = storage[name][policy]
            assert final == runs[policy].reports[-1].store_bytes <= peak
            comp, load, prune = states[name][policy]
            n_nodes = sum(len(r.execution.states)
                          for r in runs[policy].reports[1:])
            assert comp + load + prune == n_nodes
        assert storage[name][Policy.ALWAYS][1] > 0


def test_bench_incremental_passes_its_assertions_on_cpu(tmp_path, capsys):
    stats = B.bench_incremental(str(tmp_path), n_chunks=6, rows=1500,
                                device="cpu")
    out = capsys.readouterr().out
    assert out.startswith("incremental_daily_retrain,") and "device=cpu" in out
    assert stats["ratio"] < 0.5
    # the appended chunk is the only chunk of each map node that runs
    assert stats["recomputed"] > 0 and stats["spliced"] > 0
    assert stats["outputs"]["n_rows"] == 7 * 1500


def test_bench_workflows_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the rule under test is for machines without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        B.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        B.run_policy(W.WORKFLOWS["census"], Policy.OPT, "unused", 1)


def test_bench_workflows_refuses_unknown_workflows():
    with pytest.raises(SystemExit):
        B.main(["--device", "cpu", "--workflows", "census,lm"])
