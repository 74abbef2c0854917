"""``IterativeSession`` in the port vs the JAX package's: the same
workflows, run cold, after an edit and after a restart on the same
workdir, under ``Policy.ALWAYS`` and ``Policy.NEVER``, give the same
signatures and states per node and the same outputs. Two workflows: a toy
numpy one, and the serving workflow that ``chip_smoke.py`` phase 5 drives
on the card (params → prompts → prefill → decode) at a reduced size on the
CPU. Also: a value the store holds is bitwise unchanged after a warm
iteration that reused it (the decode node clones the KV cache it writes
into), and an operator that mutates its input would corrupt it. Costs are
pinned (every node computes in 1 s as far as the planner knows), so the
plans do not depend on this machine's timings."""
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import config as jconfig, costs as jcosts
from repro.core import session as jsession
from repro.core.omp import Policy as JPolicy
from repro.core.workflow import Workflow as JWorkflow
from repro.models import registry as jregistry
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.core import config as tconfig, costs as tcosts
from repro_torch.core import session as tsession
from repro_torch.core.omp import Policy as TPolicy
from repro_torch.core.store import Store
from repro_torch.core.workflow import Workflow as TWorkflow
from repro_torch.models import convert

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from test_torch_serve import (  # noqa: E402
    _teacher_forced_logits, assert_every_step_and_clear_tokens_match)

REL_TOL = 3e-2     # as tests/test_torch_serve.py: bf16 in both packages
B, S, MAX_LEN, GENS = 2, 16, 24, (4, 6)


def _pinned(cost_model_cls):
    class Pinned(cost_model_cls):
        def compute_cost(self, sig, hint=None, default=1.0):
            return 1.0
    return Pinned


SESSIONS = {"jax": (jsession.IterativeSession, _pinned(jcosts.CostModel),
                    jconfig, JPolicy),
            "torch": (tsession.IterativeSession, _pinned(tcosts.CostModel),
                      tconfig, TPolicy)}


def _session(pkg, workdir, policy, mem_budget=0.0):
    cls, costs, config, pol = SESSIONS[pkg]
    return cls(workdir, cost_model=costs(os.path.join(workdir, "costs.json")),
               engine=config.EngineConfig(policy=getattr(pol, policy)),
               storage=config.StoreConfig(mem_budget_bytes=mem_budget))


def _iterate(pkg, tmp_path, policy, build, edits, mem_budget=0.0):
    """Cold run, an edit, then a restart (a fresh session on the same
    workdir) at the edited config; returns the three reports."""
    workdir = str(tmp_path / f"{pkg}-{policy}")
    sess = _session(pkg, workdir, policy, mem_budget)
    reports = [sess.run(build(edits[0])), sess.run(build(edits[1]))]
    sess.store.writer_drain()
    sess = _session(pkg, workdir, policy, mem_budget)
    reports.append(sess.run(build(edits[1])))
    return reports


def _states(rep):
    return {n: s.name for n, s in rep.execution.states.items()}


# -- a toy numpy workflow ----------------------------------------------------------

def _toy(workflow_cls, reg):
    wf = workflow_cls("toy")
    src = wf.source("src", lambda: np.arange(2000, dtype=np.float64),
                    config="v1")
    p = wf.scanner("parse", lambda x: np.sort(x % 97), [src], config="v1")
    f = wf.extractor("feat", lambda x: np.stack([x, x ** 2]), [p], config=2)
    m = wf.learner("model", lambda x: x.mean(axis=1) * reg, [f], config=reg)
    wf.extractor("unused", lambda x: x + 1, [src], config="v1")
    wf.output(wf.reducer("eval", lambda x: float(np.sum(x)), [m],
                         config="v1"))
    return wf


@pytest.mark.parametrize("policy", ["ALWAYS", "NEVER"])
def test_toy_session_matches_reference(tmp_path, policy):
    got = {pkg: _iterate(pkg, tmp_path, policy,
                         functools.partial(_toy, cls), (0.1, 0.5))
           for pkg, cls in (("jax", JWorkflow), ("torch", TWorkflow))}
    for j_rep, t_rep in zip(got["jax"], got["torch"]):
        assert t_rep.sigs == j_rep.sigs
        assert _states(t_rep) == _states(j_rep)
        assert t_rep.outputs == j_rep.outputs
        assert t_rep.sliced_away == j_rep.sliced_away == {"unused"}
    assert _states(got["torch"][2])["eval"] == "LOAD"


# -- the serving workflow, reduced -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_steps(jcfg):
    prefill = jax.jit(lambda p, t: jsteps.prefill_step(
        jcfg, p, {"tokens": t}, max_len=MAX_LEN))
    decode = jax.jit(lambda p, t, c: jsteps.decode_step(jcfg, p, t, c))
    return prefill, decode


def _reference_serve_workflow(jcfg, tcfg, jparams, gen, computed):
    """The twin of ``chip_smoke.serve_workflow`` on the JAX package, with
    the port's node configs (so both sign the same); its attention is the
    reference's chunked path, which the port's flash path is held against.
    Its decode also returns every step's logits (for the top-2 margins)."""
    prefill_j, decode_j = _reference_steps(jcfg)
    conf = chip_smoke.serve_node_configs(tcfg, gen, batch=B, prompt=S,
                                         max_len=MAX_LEN)

    def prefill(params, tokens):
        logits, cache = prefill_j(params, jnp.asarray(tokens))
        computed["prefill"] = np.asarray(logits, np.float32)
        return {"logits": logits, "cache": cache}

    def decode(params, pre):
        logits, cache = jnp.asarray(pre["logits"]), pre["cache"]
        out, every = [jnp.argmax(logits, -1)[:, None].astype(jnp.int32)], [logits]
        for _ in range(gen - 1):
            logits, cache = decode_j(params, out[-1], cache)
            out.append(jnp.argmax(logits, -1)[:, None].astype(jnp.int32))
            every.append(logits)
        return {"tokens": np.asarray(jnp.concatenate(out, 1)),
                "logits": np.stack([np.asarray(x, np.float32)
                                    for x in every], 1)}

    wf = JWorkflow(f"serve-{tcfg.name}")
    p = wf.source("params", lambda: jparams, config=conf["params"])
    t = wf.source("prompts", lambda: chip_smoke.synth_prompts(tcfg, B, S),
                  config=conf["prompts"])
    pre = wf.extractor("prefill", prefill, [p, t], config=conf["prefill"])
    wf.output(wf.extractor("decode", decode, [p, pre], config=conf["decode"]))
    return wf


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get("internlm2-1.8b")),
                               num_layers=2, attn_impl="chunked")
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get("internlm2-1.8b")),
                               num_layers=2, attn_impl="flash")
    jparams = jregistry.init(jcfg, jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, host


def _port_serve_workflow(tcfg, host_params, gen, computed):
    return chip_smoke.serve_workflow(
        tcfg, lambda: convert.params_from_numpy(host_params, "cpu"), gen,
        device="cpu", batch=B, prompt=S, max_len=MAX_LEN, computed=computed)


@pytest.mark.parametrize("policy", ["ALWAYS", "NEVER"])
def test_serve_session_matches_reference(tmp_path, policy):
    jcfg, tcfg, jparams, host = _models()
    computed = {"jax": [], "torch": []}

    def build(pkg, gen):
        computed[pkg].append({})
        if pkg == "jax":
            return _reference_serve_workflow(jcfg, tcfg, jparams, gen,
                                             computed[pkg][-1])
        return _port_serve_workflow(tcfg, host, gen, computed[pkg][-1])

    reps = {pkg: _iterate(pkg, tmp_path, policy,
                          functools.partial(build, pkg), GENS)
            for pkg in ("jax", "torch")}
    expect = {"ALWAYS": [{"params": "COMPUTE", "prompts": "COMPUTE",
                          "prefill": "COMPUTE", "decode": "COMPUTE"},
                         {"params": "LOAD", "prompts": "PRUNE",
                          "prefill": "LOAD", "decode": "COMPUTE"},
                         {"params": "PRUNE", "prompts": "PRUNE",
                          "prefill": "PRUNE", "decode": "LOAD"}],
              "NEVER": [{n: "COMPUTE" for n in ("params", "prompts",
                                                 "prefill", "decode")}] * 2
              + [{"params": "PRUNE", "prompts": "PRUNE", "prefill": "PRUNE",
                  "decode": "LOAD"}]}[policy]

    tokens = torch.as_tensor(chip_smoke.synth_prompts(tcfg, B, S))
    tparams = convert.params_from_numpy(host, "cpu")
    for it, (j_rep, t_rep) in enumerate(zip(reps["jax"], reps["torch"])):
        gen = GENS[min(it, 1)]
        assert t_rep.sigs == j_rep.sigs
        assert _states(t_rep) == _states(j_rep) == expect[it]
        got = t_rep.outputs["decode"]["tokens"]
        # the port's session gives its own direct path's tokens exactly
        assert torch.equal(got, chip_smoke.prefill_and_decode(
            tcfg, tparams, tokens, gen, MAX_LEN)[2]["tokens"])
        # every step's logits of the port, teacher-forced on the
        # reference's tokens, within the tolerance of the reference's; and
        # the reference's tokens up to the first step where the reference's
        # top-1/top-2 gap is within the tolerance (bf16 may pick either)
        ref_tokens = np.asarray(j_rep.outputs["decode"]["tokens"])
        ref_logits = np.asarray(j_rep.outputs["decode"]["logits"])
        forced = _teacher_forced_logits(tcfg, tparams, tokens, ref_tokens,
                                        MAX_LEN)
        assert_every_step_and_clear_tokens_match(ref_tokens, ref_logits,
                                                 forced, got.numpy())
        top2 = np.sort(ref_logits, -1)[..., -2:]
        margin = (top2[..., 1] - top2[..., 0]) / np.abs(ref_logits).max(-1)
        if all(margin[:, :gen].min(1) > REL_TOL):
            last = ref_logits[:, gen - 1]
            err = np.abs(last - t_rep.outputs["decode"]["last_logits"]
                         .float().numpy()).max()
            assert err / np.abs(last).max() < REL_TOL
    # the prefill logits of the cold iteration, both computed
    ref = computed["jax"][0]["prefill"]
    port = computed["torch"][0]["prefill"]["logits"].float().numpy()
    assert np.abs(ref - port).max() / np.abs(ref).max() < REL_TOL


def _bits_equal(a, b):
    return all(torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8))
               for x, y in ((a["logits"], b["logits"]),
                            (a["cache"]["k"], b["cache"]["k"]),
                            (a["cache"]["v"], b["cache"]["v"]))) \
        and a["cache"]["pos"] == b["cache"]["pos"]


def test_stored_prefill_unchanged_after_warm_reuse(tmp_path):
    """The memory tier hands the stored KV cache itself to the warm
    iteration's decode node, which writes a cache in place: the entry is
    bitwise the value the prefill node computed, in memory and on disk."""
    _, tcfg, _, host = _models()
    sess = _session("torch", str(tmp_path), "ALWAYS", mem_budget=64e6)
    computed = {}
    r1 = sess.run(_port_serve_workflow(tcfg, host, GENS[0], computed))
    r2 = sess.run(_port_serve_workflow(tcfg, host, GENS[1], {}))
    sig = r1.sigs["prefill"]
    assert r2.execution.states["prefill"].name == "LOAD"
    assert sess.store.load_stats["memory"]["hits"] >= 1
    in_memory, _ = sess.store.load(sig)
    on_disk, _ = Store(str(tmp_path / "store")).load(sig)
    assert _bits_equal(in_memory, computed["prefill"])
    assert _bits_equal(on_disk, computed["prefill"])


def test_mutating_operator_would_corrupt_the_memory_tier(tmp_path):
    """Why the rule in ``core/workflow.py`` exists: an operator that writes
    into its input in place changes its parent's value before the store
    snapshots it (the disk entry holds ones, not the zeros ``src``
    computed), and a warm iteration that loads it zero-copy from the
    memory tier changes the stored value again (twos)."""
    def build(step):
        wf = TWorkflow("mutate")
        src = wf.source("src", lambda: torch.zeros(4), config="v1")
        wf.output(wf.extractor("bump", lambda x: x.add_(1.0).sum(), [src],
                               config=step))
        return wf

    sess = _session("torch", str(tmp_path), "ALWAYS", mem_budget=1e6)
    r1 = sess.run(build(0))
    sess.run(build(1))                     # src is loaded, then mutated
    stored, _ = sess.store.load(r1.sigs["src"])
    assert torch.equal(stored, torch.full((4,), 2.0))
    on_disk, _ = Store(str(tmp_path / "store")).load(r1.sigs["src"])
    assert torch.equal(on_disk, torch.ones(4))
