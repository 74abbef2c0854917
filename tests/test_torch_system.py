"""Twins of ``tests/test_system.py`` on the port (``repro_torch``, on the
CPU): the census workflow through ``IterativeSession`` under all three
policies, with the reference's values from the same process beside them;
the census learner against the majority class; a tiny LM trained as three
Helix segments, crashed and resumed; and MNIST's nondeterministic
``randomFFT`` recomputed with its descendants."""
import dataclasses

import numpy as np
import pytest
import torch

import workflows as JW
from repro.core import IterativeSession as JSession
from repro_torch import configs, workflows as W
from repro_torch.core import IterativeSession, Policy, Workflow
from repro_torch.data import synth
from repro_torch.data.pipeline import TokenBatcher
from repro_torch.train import steps


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: with several test processes sharing the
    cores, torch's OpenMP pool spins at the learners' small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small_census():
    return dataclasses.replace(W.CensusKnobs(), n_rows=4000)


def test_census_end_to_end_all_policies(tmp_path, small_census):
    outs = {}
    for policy in (Policy.OPT, Policy.ALWAYS, Policy.NEVER):
        sess = IterativeSession(str(tmp_path / policy.value), policy=policy)
        r0 = sess.run(W.build_census(small_census, device="cpu"))
        # PPR edit: only the reducer changes
        k1 = dataclasses.replace(small_census, eval_metric="f1")
        r1 = sess.run(W.build_census(k1, device="cpu"))
        outs[policy] = (r0.outputs["checkResults"]["value"],
                        r1.outputs["checkResults"]["value"])
        # census raceExt must be sliced away (paper Fig. 3)
        assert "raceExt" in r0.sliced_away
        if policy is Policy.OPT:
            # PPR iteration: the expensive learner must not retrain
            assert "incPred" not in r1.original
            states = r1.execution.states
            assert states["incPred"].value in ("prune", "load")
    # identical numbers under every policy (Theorem 1)
    vals = list(outs.values())
    assert all(v == vals[0] for v in vals)
    # the model actually learned something
    assert vals[0][0] > 0.6
    # and the reference's session gives the same accuracy and f1
    jk = dataclasses.replace(JW.CensusKnobs(), n_rows=small_census.n_rows)
    jsess = JSession(str(tmp_path / "reference"))
    ref = tuple(jsess.run(JW.build_census(k)).outputs["checkResults"]["value"]
                for k in (jk, dataclasses.replace(jk, eval_metric="f1")))
    assert vals[0] == ref


def test_census_model_quality(tmp_path, small_census):
    """The LR learner must beat the majority-class baseline."""
    rep = IterativeSession(str(tmp_path)).run(
        W.build_census(small_census, device="cpu"))
    acc = rep.outputs["checkResults"]["value"]
    rows = synth.census_rows(7, small_census.n_rows)
    majority = max(np.mean(rows["target"]), 1 - np.mean(rows["target"]))
    assert acc > majority + 0.02


def test_training_segments_resume_after_crash(tmp_path):
    """Train a tiny LM as 3 Helix segment nodes; 'crash' after segment 2 and
    restart: the new session must LOAD segments 1-2 and compute only 3."""
    cfg = configs.reduced(configs.get("internlm2-1.8b"))
    tokens = synth.lm_tokens(0, 30_000, cfg.vocab_size)
    batcher = TokenBatcher(tokens, batch=4, seq=32)

    def step(st, b):
        return steps.train_step(cfg, st, b, peak_lr=1e-3, warmup_steps=2,
                                total_steps=100)

    def make_wf(n_segments):
        wf = Workflow("train-lm")
        prev = wf.source(
            "init", lambda: steps.init_train_state(
                cfg, torch.Generator().manual_seed(0), "cpu"),
            config="init-v1")
        for s in range(n_segments):
            def seg_fn(state, _s=s):
                for i in range(_s * 3, (_s + 1) * 3):
                    state, _ = step(state, {
                        k: torch.from_numpy(v)
                        for k, v in batcher.batch_at(i).items()})
                return state
            prev = wf.segment(f"seg{s}", seg_fn, [prev], config=("seg", s, 3))
        out = wf.reducer("final_step", lambda st: float(st.opt.step),
                         [prev], config="v1")
        wf.output(out)
        return wf

    # run 1: only two segments "completed" before the crash
    s1 = IterativeSession(str(tmp_path))
    r1 = s1.run(make_wf(2))
    assert r1.outputs["final_step"] == 6.0
    # run 2 (restart with the full plan): segments 0-1 reused
    s2 = IterativeSession(str(tmp_path))
    r2 = s2.run(make_wf(3))
    states = r2.execution.states
    assert states["seg0"].value in ("load", "prune")
    assert states["seg1"].value == "load"
    assert states["seg2"].value == "compute"
    assert r2.outputs["final_step"] == 9.0


def test_nondeterministic_workflow_not_reused(tmp_path):
    knobs = dataclasses.replace(W.MNISTKnobs(), n_images=800, epochs=5,
                                n_features=64)
    sess = IterativeSession(str(tmp_path))
    sess.run(W.build_mnist(knobs, device="cpu"))
    r1 = sess.run(W.build_mnist(knobs, device="cpu"))   # identical knobs…
    # …but randomFFT is nondeterministic → it and descendants recompute
    assert r1.execution.states["randomFFT"].value == "compute"
    assert r1.execution.states["softmax"].value == "compute"
    assert "randomFFT" in r1.original and "mnist" not in r1.original
