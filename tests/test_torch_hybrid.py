"""The port's hybrid family (jamba-v0.1-52b: groups of Mamba-2 layers and
one attention layer, MoE on every other layer) vs the JAX package's, on
the CPU at reduced size.

``configs.reduced`` gives jamba 8 layers in 2 groups of ``attn_every`` 4
(3 Mamba-2 layers, then attention; MoE on sublayers 1 and 3), 8 experts
top 2. Weights come from the reference ``registry.init`` and cross
through ``convert.params_from_numpy`` in this process; tokens are numpy
from a seed. The reference runs its plain SSD scan (its stack leaves the
kernel off) and "chunked" attention; the port its stack as served: the
SSD wrapper and flash, each taking its plain version on the CPU.

Routing is discrete, and near-ties flip between two bf16 programs
(``tests/test_torch_moe.py``), so the model tests run as that file's do:
each package routes on its own once, to hold the share of (token, layer)
rows whose picks agree, and the logits are held with the port taking the
reference's picks, at ``reduced()``'s drop-free capacity factor and at
the published 1.25, where decode runs at capacity 1 and drops.

Tolerance: 6e-2 of max |logit| (and of each cache leaf's max), the bound
``chip_smoke.py`` holds full-depth serving to, not the 3e-2 the 4-layer
reduced configs of the other families meet. The reduced jamba has 8
layers, 6 of them Mamba-2 layers whose states integrate every upstream
rounding, and two differences add up there: the packages round bf16 at
other places (with the port running the reference's own plain scan, up
to 0.039 on the logits and 0.033 on a cache leaf over 40 hash seeds), and
the port's SSD wrapper keeps ``y`` in fp32 where the reference's stack
rounds it to bf16 (up to 0.022 between the two port paths on shared
picks). The port's served path reached 0.031 on the logits and 0.043 on
the second group's SSM state over 28 runs; the reference's own
``test_prefill_decode_consistency[jamba-v0.1-52b]`` fails its 3e-2 now
and then for the same reason. A wiring fault (a group's cache or
parameters crossed, a layer's FFN of the wrong kind) moves them by order
1.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm, registry as jregistry
from repro.models.params import P as JP
from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models import (convert, lm as tlm, moe as tmoe,
                                registry as tregistry, ssd as tssd)
from repro_torch.models.params import P as TP, tree_map
from repro_torch.train import steps as tsteps
from test_torch_moe import _serve_both, port_picks, reference_picks

NAME = "jamba-v0.1-52b"
REL_TOL = 6e-2        # logits and cache leaves: see the module docstring
AUX_TOL = 3e-2        # the aux loss: on the same picks, the mean router
#                       probabilities differ only by the bf16 hidden state
B, PREFILL, TOTAL = 2, 16, 22


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: several test processes share
    the cores, and torch's OpenMP pool would spin at each small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_err(ref, out) -> float:
    ref, out = np.asarray(ref, np.float32), np.asarray(out, np.float32)
    return float(np.max(np.abs(ref - out)) / (np.max(np.abs(ref)) + 1e-9))


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _flat(tree, prefix=()):
    """{path: leaf} over nested dicts and lists (a list index is a key)."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _jflat(tree, is_leaf=None):
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path): x
            for path, x in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_leaf)[0]}


def _models(cf=None):
    """(reference cfg, port cfg, reference params, port params) of the
    reduced config, at ``reduced()``'s drop-free capacity factor or
    ``cf``; the port serves through flash."""
    jcfg = jconfigs.reduced(jconfigs.get(NAME))
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get(NAME)),
                               attn_impl="flash")
    if cf is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
    jparams = jregistry.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------ structure
def test_jamba_structure():
    """Twin of ``tests/test_smoke_archs.py::test_jamba_structure``, and the
    group the port's tree builds from it: SSM sublayers, attention last,
    MoE on odd sublayers (the attention sublayer, 7, among them)."""
    cfg = tconfigs.get(NAME)
    assert [i for i in range(cfg.num_layers) if cfg.layer_is_attn(i)] == \
        [7, 15, 23, 31]
    assert len([i for i in range(cfg.num_layers) if cfg.layer_is_moe(i)]) \
        == 16
    group = tregistry.param_defs(cfg)["groups"]
    assert len(group) == cfg.attn_every == 8
    assert ["attn" in g for g in group] == [False] * 7 + [True]
    assert ["moe" in g for g in group] == [i % 2 == 1 for i in range(8)]
    assert ["mlp" in g for g in group] == [i % 2 == 0 for i in range(8)]
    assert all(p.shape[0] == 4 for g in group for p in _flat(g).values())


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_hybrid_param_defs_match_reference_leaf_for_leaf(reduced):
    jcfg, tcfg = jconfigs.get(NAME), tconfigs.get(NAME)
    if reduced:
        jcfg, tcfg = jconfigs.reduced(jcfg), tconfigs.reduced(tcfg)
    jflat = _jflat(jregistry.param_defs(jcfg),
                   is_leaf=lambda x: isinstance(x, JP))
    tflat = _flat(tregistry.param_defs(tcfg))
    assert set(jflat) == set(tflat)
    for path, jp in jflat.items():
        tp = tflat[path]
        assert isinstance(tp, TP)
        assert (tp.shape, tp.axes, tp.init, tp.scale) == \
            (jp.shape, jp.axes, jp.init, jp.scale), path
        assert str(tp.dtype).removeprefix("torch.") == np.dtype(jp.dtype).name
    assert "blocks" not in tflat and ("groups", 0, "ssm", "in_proj") in tflat


@pytest.mark.parametrize("layers, n_params", [(32, 51_460_000_640),
                                              (8, 13_267_656_416)])
def test_config_on_meta_matches_eval_shape(layers, n_params):
    """The published config and the 8-layer cut served on the card (one
    full group): the port's tree on ``meta`` against ``jax.eval_shape`` of
    the reference's init, leaf for leaf, and the count within 2e-5 of
    ``ArchConfig.param_count``'s estimate."""
    jcfg = dataclasses.replace(jconfigs.get(NAME), num_layers=layers)
    tcfg = dataclasses.replace(tconfigs.get(NAME), num_layers=layers)
    jshapes = jax.eval_shape(lambda: jregistry.init(jcfg,
                                                    jax.random.PRNGKey(0)))
    tmeta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                           device="meta"),
                     tregistry.param_defs(tcfg))
    jl, tl = _jflat(jshapes), _flat(tmeta)
    assert set(jl) == set(tl)
    for path, a in jl.items():
        assert tuple(tl[path].shape) == a.shape, path
        assert str(tl[path].dtype).removeprefix("torch.") == \
            np.dtype(a.dtype).name
    assert sum(t.numel() for t in tl.values()) == n_params
    assert abs(n_params / tcfg.param_count() - 1) < 2e-5


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_hybrid_init_cache_matches_reference(reduced):
    """Leaves, shapes, dtypes and fill: K/V (groups, B, S_max, KV, D) bf16,
    conv (groups, attn_every - 1, B, d_conv - 1, C) bf16 and h (groups,
    attn_every - 1, B, H, P, N) fp32, all zero; ``pos`` 0. The full
    config on ``meta`` against ``jax.eval_shape``."""
    jcfg, tcfg = jconfigs.get(NAME), tconfigs.get(NAME)
    if reduced:
        jcfg, tcfg = jconfigs.reduced(jcfg), tconfigs.reduced(tcfg)
        jc = jax.tree_util.tree_map(np.asarray,
                                    jlm.init_cache(jcfg, 3, 20))
        tc = tregistry.init_cache(tcfg, 3, 20, "cpu")
    else:
        jc = jax.eval_shape(lambda: jlm.init_cache(jcfg, 4, 544))
        tc = tregistry.init_cache(tcfg, 4, 544, "meta")
    assert set(tc) == set(jc) == {"k", "v", "conv", "h", "pos"}
    assert tc["pos"] == 0
    for key in ("k", "v", "conv", "h"):
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert str(tc[key].dtype).removeprefix("torch.") == \
            np.dtype(jc[key].dtype).name, key
        if reduced:
            assert not tc[key].any() and not jc[key].any(), key
    n_groups = tcfg.num_layers // tcfg.attn_every
    assert tc["conv"].shape[:2] == (n_groups, tcfg.attn_every - 1)


# ------------------------------------------------------------ the model
@pytest.fixture(scope="module", params=["drop_free", 1.25])
def served(request):
    """Both packages on the same weights and numpy tokens: prefill of
    PREFILL, teacher-forced decode to TOTAL (``test_torch_moe``'s
    ``_serve_both``), and each one's no-cache forward over all TOTAL
    tokens with its aux loss (the port's on the reference's picks)."""
    cf = request.param
    jcfg, tcfg, jparams, tparams = _models(None if cf == "drop_free" else cf)
    toks = _tokens(jcfg, (B, TOTAL), seed=3)
    out = _serve_both(jcfg, tcfg, jparams, tparams, toks, PREFILL)
    out["cfgs"] = (jcfg, tcfg)
    with reference_picks() as jpicks:
        jfull = jlm.forward(jcfg, jparams, jnp.asarray(toks))
        jax.effects_barrier()
    with torch.no_grad(), port_picks(jpicks):
        full = tlm.forward(tcfg, tparams, torch.from_numpy(toks))
    out["full"] = ((_np(jfull.logits), float(jfull.aux_loss)),
                   (_np(full.logits), float(full.aux_loss)))
    return out


def _moe_calls(cfg) -> int:
    """MoE calls a forward: the MoE sublayers of every group."""
    groups = cfg.num_layers // cfg.attn_every
    return groups * sum(cfg.layer_is_moe(i) for i in range(cfg.attn_every))


def test_hybrid_prefill_and_teacher_forced_decode_match_reference(served):
    """Every step's logits against the reference's cached path, with drops
    (cf 1.25: decode at capacity 1) and without, on its picks."""
    assert len(served["steps"]) == TOTAL - PREFILL + 1
    for step, (jl, tl) in enumerate(served["steps"]):
        assert rel_err(jl, tl) < REL_TOL, step


def test_hybrid_routing_agrees_with_reference_on_its_own(served):
    """4 MoE calls a forward (2 groups x sublayers 1 and 3): 7 forwards;
    the picks agree on all but the rows a near-tie flips."""
    jpicks, own = served["picks"]
    cfg = served["cfgs"][1]
    assert _moe_calls(cfg) == 4
    assert len(jpicks) == len(own) == (1 + TOTAL - PREFILL) * 4
    assert served["agreement"] >= 0.9, served["agreement"]


def test_hybrid_caches_match_reference(served):
    """The K/V of each group's attention layer, and the conv and SSM states
    of each group's Mamba-2 layers, after prefill and six decode steps,
    each group's leaf at 6e-2 of its max."""
    jc, tc = served["cache"]
    assert tc["pos"] == int(jc["pos"]) == TOTAL
    for key in ("k", "v", "conv", "h"):
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert tc[key].dtype == convert.tensor_from_numpy(jc[key]).dtype
        for g in range(jc[key].shape[0]):
            assert rel_err(jc[key][g], _np(tc[key][g])) < REL_TOL, (key, g)


def test_hybrid_no_cache_forward_and_aux_loss_match_reference(served):
    """The no-cache forward's logits and its aux loss: the sum over the 4
    MoE layers of E·Σ density·mean(probs), each about 1 when balanced."""
    (jl, jaux), (tl, taux) = served["full"]
    assert tl.shape == jl.shape
    assert rel_err(jl, tl) < REL_TOL
    assert taux > 0.5 * _moe_calls(served["cfgs"][1])
    assert abs(jaux - taux) < AUX_TOL * abs(jaux)


def test_hybrid_decode_at_cf_1_25_runs_at_capacity_one_and_drops(monkeypatch):
    """The published capacity factor at batch 4: every decode step's MoE
    calls run with capacity 1 per expert and drop where two tokens pick
    one expert."""
    _, tcfg, _, tparams = _models(1.25)
    seen = []
    real = tmoe.route
    monkeypatch.setattr(tmoe, "route", lambda *a: seen.append(real(*a))
                        or seen[-1])
    toks = torch.from_numpy(_tokens(tcfg, (4, 10), seed=5))
    with torch.inference_mode():
        _, cache = tsteps.prefill_step(tcfg, tparams, {"tokens": toks[:, :8]},
                                       max_len=10)
        n_prefill = len(seen)
        for i in (8, 9):
            tsteps.decode_step(tcfg, tparams, toks[:, i:i + 1], cache)
    assert n_prefill == _moe_calls(tcfg)
    decode = seen[n_prefill:]
    assert len(decode) == 2 * n_prefill and all(rt.cap == 1 for rt in decode)
    assert 0 < sum(int((~rt.keep).sum()) for rt in decode)


def test_hybrid_ssm_layers_take_the_kernel_path(monkeypatch):
    """Prefill runs every Mamba-2 sublayer through the SSD wrapper
    (``use_kernel=True``: on the card, the chunk kernel), decode through
    the recurrence; the attention sublayer sees positions, the SSM ones do
    not need them."""
    _, tcfg, _, tparams = _models()
    calls = []
    real = tssd.ssd_ops.ssd
    monkeypatch.setattr(tssd.ssd_ops, "ssd", lambda *a, **k: calls.append(
        a[0].shape) or real(*a, **k))
    toks = torch.from_numpy(_tokens(tcfg, (2, 12), seed=6))
    with torch.inference_mode():
        _, cache = tsteps.prefill_step(tcfg, tparams, {"tokens": toks[:, :11]},
                                       max_len=12)
        assert len(calls) == 2 * 3
        _, cache = tsteps.decode_step(tcfg, tparams, toks[:, 11:], cache)
    assert len(calls) == 6 and cache["pos"] == 12


def test_serve_cli_runs_reduced_hybrid_on_cpu(capsys):
    serve.main(["--arch", NAME, "--device", "cpu", "--batch", "2",
                "--prompt-len", "12", "--gen-tokens", "5"])
    out = capsys.readouterr().out
    assert f"arch={NAME}-smoke" in out and "first sequence:" in out
