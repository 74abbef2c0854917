"""The LM training workflow on the port (``repro_torch.workflows``) vs the
JAX package's (``benchmarks/workflows.py`` ``build_lm``), each in its own
package's ``IterativeSession``: a cold run, a warm rerun and an ``LI``
edit of ``peak_lr``, under ``Policy.ALWAYS`` with a memory tier. Both get
the same signatures and node states in every iteration, and the same
losses within LOSS_RTOL. The port starts from the reference's initial
``TrainState`` (``make_state``), which both workflows draw within this
process. Costs are pinned (compute and load), so the plans do not depend on this
machine's timings. Also: the port's ``bench_tier`` passes its own assertions on the
CPU.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

import workflows as JW
from repro.core import config as jconfig, costs as jcosts
from repro.core import session as jsession
from repro.core.omp import Policy as JPolicy
from repro.train import steps as jsteps
from repro_torch import workflows as TW
from repro_torch.core import config as tconfig, costs as tcosts
from repro_torch.core import session as tsession
from repro_torch.core.omp import Policy as TPolicy
from repro_torch.core.tree import tree_flatten
from repro_torch.launch import bench_tier
from repro_torch.models import convert
from repro_torch.train import steps as tsteps

# Four AdamW steps of a bf16 model whose gradients differ by a few bf16
# ulps between the packages (tests/test_torch_train.py): the fp32 losses
# agree to ~1e-5 relative; held at 1e-3. The trained params as in
# tests/test_torch_train.py: within 2·peak_lr·steps plus two ulps of the
# leaf's max (the moments are held there, after three steps).
LOSS_RTOL = 1e-3


def _ulp(max_abs: float, dtype) -> float:
    bits = {torch.bfloat16: 7, torch.float32: 23}[dtype]
    return 2.0 ** (np.floor(np.log2(max(max_abs, 1e-30))) - bits)


def _check_trained_state(jval, tval, k):
    jstate, tstate = jval["state"], tval["state"]
    assert isinstance(tstate, tsteps.TrainState)
    assert int(tstate.opt.step) == int(jstate.opt.step) == k.steps
    for a, b in zip(jax.tree_util.tree_leaves(jstate.params),
                    tree_flatten(tstate.params)[0]):
        a = np.asarray(a, np.float32)
        bound = 2 * k.peak_lr * k.steps + 2 * _ulp(np.abs(a).max(), b.dtype)
        assert np.abs(a - b.float().numpy()).max() <= bound
    np.testing.assert_allclose(tval["losses"], jval["losses"], rtol=LOSS_RTOL)


def _pinned(cost_model_cls):
    class Pinned(cost_model_cls):
        def compute_cost(self, sig, hint=None, default=1.0):
            return 1.0
    return Pinned


SESSIONS = {"jax": (jsession.IterativeSession, _pinned(jcosts.CostModel),
                    jconfig, JPolicy),
            "torch": (tsession.IterativeSession, _pinned(tcosts.CostModel),
                      tconfig, TPolicy)}


def _session(pkg, workdir):
    """A session whose planner sees every compute cost as 1 s and every
    load as 0.01 s (the store's estimate comes from measured bandwidth)."""
    cls, costs, config, pol = SESSIONS[pkg]
    sess = cls(workdir, cost_model=costs(os.path.join(workdir, "costs.json")),
               engine=config.EngineConfig(policy=pol.ALWAYS),
               storage=config.StoreConfig(mem_budget_bytes=64e6))
    sess.store.est_load_seconds = lambda nbytes, sig=None: 0.01
    return sess


def _states(rep):
    return {n: s.name for n, s in rep.execution.states.items()}


def test_lm_workflow_session_matches_reference(tmp_path):
    k0 = TW.LMKnobs()
    assert dataclasses.asdict(k0) == dataclasses.asdict(JW.LMKnobs())
    edits = [k0, k0, dataclasses.replace(k0, peak_lr=3e-3)]
    # the reference's initial state, as its initState node draws it here
    jstate0 = jsteps.init_train_state(JW._lm_arch(k0), jax.random.PRNGKey(k0.seed))
    host0 = jax.tree_util.tree_map(np.asarray, jstate0)
    made = []

    def make_state():
        made.append(1)
        return convert.train_state_from_numpy(host0, "cpu")

    sess = {pkg: _session(pkg, str(tmp_path / pkg)) for pkg in SESSIONS}
    expect = [{n: "COMPUTE" for n in ("tokens", "initState", "train",
                                      "evalLoss")},
              {"tokens": "PRUNE", "initState": "PRUNE", "train": "PRUNE",
               "evalLoss": "LOAD"},
              {"tokens": "LOAD", "initState": "LOAD", "train": "COMPUTE",
               "evalLoss": "COMPUTE"}]
    outs = []
    for it, k in enumerate(edits):
        j_rep = sess["jax"].run(JW.build_lm(k))
        t_rep = sess["torch"].run(TW.build_lm(k, device="cpu",
                                              make_state=make_state))
        assert t_rep.sigs == j_rep.sigs, it
        assert _states(t_rep) == _states(j_rep), it
        assert _states(t_rep) == expect[it], (it, _states(t_rep))
        j_out, t_out = j_rep.outputs["evalLoss"], t_rep.outputs["evalLoss"]
        assert set(t_out) == set(j_out) == {"eval_loss", "train_losses"}
        for want, got in zip([j_out["eval_loss"]] + j_out["train_losses"],
                             [t_out["eval_loss"]] + t_out["train_losses"]):
            assert abs(got - want) <= LOSS_RTOL * abs(want), (it, want, got)
        outs.append(t_out)
        if _states(t_rep)["train"] == "COMPUTE":    # the stored trained state
            sig = t_rep.sigs["train"]
            _check_trained_state(sess["jax"].store.load(sig)[0],
                                 sess["torch"].store.load(sig)[0], k)
    assert made == [1]                 # initState computed once, then loaded
    assert outs[1] == outs[0]          # the warm rerun: the stored result
    assert outs[2]["train_losses"][0] == outs[0]["train_losses"][0]
    assert outs[2]["train_losses"][1:] != outs[0]["train_losses"][1:]


def test_train_node_leaves_the_stored_state_as_it_was(tmp_path):
    """The ``train`` node steps a clone: after an edit that reloads the
    initial state from the memory tier and trains from it, the stored
    entry is still the state the initState node made."""
    k = dataclasses.replace(TW.LMKnobs(), n_layers=1, d_model=64, d_ff=128,
                            vocab=128, seq_len=16, batch=2, steps=2)
    sess = _session("torch", str(tmp_path))
    r1 = sess.run(TW.build_lm(k, device="cpu"))
    first, _ = sess.store.load(r1.sigs["initState"])
    snapshot = [t.clone() for t in tree_flatten(first)[0]]
    r2 = sess.run(TW.build_lm(dataclasses.replace(k, peak_lr=3e-3),
                              device="cpu"))
    assert r2.execution.states["initState"].name == "LOAD"
    again, _ = sess.store.load(r1.sigs["initState"])
    assert isinstance(again, tsteps.TrainState)
    for a, b in zip(snapshot, tree_flatten(again)[0]):
        assert torch.equal(a, b)


def test_default_initial_state_is_the_same_on_every_device():
    """Drawn on the host from ``torch.Generator().manual_seed(seed)``."""
    k = dataclasses.replace(TW.LMKnobs(), n_layers=1, d_model=64, d_ff=128,
                            vocab=128)
    node = TW.build_lm(k, device="cpu").build().nodes["initState"]
    a, b = node.fn(), node.fn()
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        assert torch.equal(x, y)


def test_mutate_lm_is_the_references():
    k = TW.LMKnobs()
    for kind in ("DPR", "LI", "PPR"):
        for seed in range(4):
            want = JW.mutate_lm(JW.LMKnobs(), kind, np.random.default_rng(seed))
            got = TW.mutate_lm(k, kind, np.random.default_rng(seed))
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_bench_tier_passes_its_own_assertions_on_cpu(tmp_path, capsys):
    res = bench_tier.main(["--device", "cpu", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("lm_tier_warm,") and "device=cpu" in out
    assert res.stats["npy_reads"] == 0 and res.stats["mem_frac"] >= 0.9
    assert res.stats["hit_speedup"] >= 5.0
    cold, warm = res.reports
    assert _states(warm)["evalLoss"] == "LOAD"
    assert warm.outputs == cold.outputs


def test_bench_tier_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the rule under test is for machines without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_tier.main(["--workdir", str(tmp_path)])
