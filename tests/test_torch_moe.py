"""The port's MoE family vs the JAX package's, on the CPU at reduced size.

``moe_block`` is held against ``repro.models.moe.moe_block`` on the same
numpy inputs and weights. The reference's routing integers (its top-k
experts, the stable argsort, ``keep``, ``token_for_slot``, ``filled``) are
read from its own computation: the block is traced to a jaxpr and its
equations are evaluated one by one, as eager JAX runs them, keeping what
each one gives (``_reference_trace``). They must equal the port's bit for
bit. The output is held at the reference's tolerances (fp32 1e-5, bf16
3e-2 relative to max |out|), the aux loss at 1e-5; given the reference's
expert outputs and gates, the port's fixed-order combine gives the bits
of the reference's bf16 scatter-add.

The reference's own tests run MoE only at ``configs.reduced``'s capacity
factor (the expert count: no assignment is ever dropped). The real
configs use 1.25, at which a decode step of batch 4 has capacity 1 per
expert. So the model tests run the reduced granite and qwen2-moe configs
both ways: prefill and teacher-forced decode against the reference's
``prefill_step``/``decode_step`` with a cache, each step's logits at 3e-2
relative, as ``tests/test_smoke_archs.py`` holds the reference's own.
Model weights come from the reference ``registry.init`` and cross through
``convert.params_from_numpy`` in this process.
"""
import contextlib
import dataclasses
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm, moe as jmoe, registry as jregistry
from repro.models.config import MoECfg as JMoECfg
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models import (convert, lm as tlm, moe as tmoe,
                                registry as tregistry)
from repro_torch.models.config import MoECfg as TMoECfg
from repro_torch.models.params import tree_map
from repro_torch.train import steps as tsteps

REL_TOL = 3e-2
OUT_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
AUX_TOL = 1e-5
MOE_ARCHS = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"]
B, PREFILL, TOTAL = 2, 16, 22        # prefill 16, teacher-forced decode to 22


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: several test processes share
    the cores, and torch's OpenMP pool would spin at each small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_err(ref, out) -> float:
    ref, out = np.asarray(ref, np.float32), _np(out)
    return float(np.max(np.abs(ref - out)) / (np.max(np.abs(ref)) + 1e-9))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.bfloat16
                      else x.dtype).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


# ------------------------------------------------------------ the reference
def _reference_trace(mcfg, p, x) -> dict:
    """Run the reference ``moe_block`` equation by equation and keep its
    intermediates: the top-k experts and the renormalised gates, the
    stable argsort, ``keep`` (rank < cap), the two slot tables, the
    experts' outputs ``ye``, the bf16 combine, the output and the aux."""
    closed = jax.make_jaxpr(lambda p, x: jmoe.moe_block(mcfg, p, x))(p, x)
    jaxpr = closed.jaxpr
    env = {}

    def read(v):
        return v.val if hasattr(v, "val") else env[v]

    for v, c in zip(jaxpr.constvars, closed.consts):
        env[v] = c
    for v, a in zip(jaxpr.invars, jax.tree_util.tree_leaves((p, x))):
        env[v] = a
    got, producer = {}, {}
    n, k = x.shape[0] * x.shape[1], mcfg.top_k
    for eqn in jaxpr.eqns:
        outs = eqn.primitive.bind(*[read(v) for v in eqn.invars],
                                  **eqn.params)
        if not eqn.primitive.multiple_results:
            outs = [outs]
        for v, o in zip(eqn.outvars, outs):
            env[v] = o
            producer[v] = eqn
        name = eqn.primitive.name
        if name == "top_k":
            got["expert_idx"] = outs[1]
        elif name == "div" and outs[0].shape == (n, k):
            got["gate"] = outs[0]
        elif name == "jit" and eqn.params["name"] == "argsort":
            got["order"] = outs[0]
        elif (name == "lt" and outs[0].shape == (n * k,)
              and producer[eqn.invars[0]].primitive.name == "sub"):
            got["keep"] = outs[0]               # rank < cap
        elif name == "scatter":
            got["filled" if outs[0].dtype == jnp.bool_
                else "token_for_slot"] = outs[0]
        elif name == "dot_general" and len(outs[0].shape) == 3:
            got["ye"] = outs[0]                 # the last: w_down's
        elif name == "scatter-add" and outs[0].dtype != jnp.int32:
            got["combined"] = outs[0]
    got["out"], got["aux"] = (read(v) for v in jaxpr.outvars)
    assert set(got) >= {"expert_idx", "gate", "order", "keep", "filled",
                        "token_for_slot", "ye", "combined"}, sorted(got)
    return got


# ------------------------------------------------------------ moe_block cases
# name -> (B, S, D, E, k, F, shared experts, capacity factor)
CASES = {
    "no_drops": (2, 16, 64, 8, 2, 32, 0, 8.0),
    "drops_cf1.25": (2, 16, 64, 8, 2, 32, 0, 1.25),
    "decode_cap1_granite": (4, 1, 64, 32, 8, 32, 0, 1.25),
    "decode_cap1_qwen2": (4, 1, 64, 60, 4, 32, 4, 1.25),
    "top1": (3, 7, 64, 8, 1, 32, 0, 1.25),
    "top8": (3, 7, 64, 16, 8, 32, 0, 1.25),
    "shared_drops": (2, 16, 64, 8, 2, 32, 2, 1.25),
    "tied_router": (4, 12, 64, 8, 2, 32, 0, 1.25),
}


def _moe_case(name, dtype, seed=0):
    """(reference MoECfg, port MoECfg, numpy weights, numpy x). Weights are
    seeded numpy at the model's dtypes (bf16 experts, fp32 router and
    shared gate), or all fp32; the router is wider than the init's 0.02
    so that routing is clear of rounding. ``tied_router`` zeroes experts
    2 and 5's columns: their logits are exactly 0 whatever the summation
    order, so they tie, at the top-k boundary for some tokens."""
    b, s, d, e, k, f, shared, cf = CASES[name]
    jm = JMoECfg(num_experts=e, top_k=k, expert_d_ff=f, num_shared=shared,
                 shared_d_ff=3 * f if shared else 0, capacity_factor=cf)
    tm = TMoECfg(**dataclasses.asdict(jm))
    rng = np.random.default_rng(seed)
    wdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def w(*shape, scale=0.1, dt=wdt):
        return np.array(jnp.asarray(rng.standard_normal(shape) * scale, dt))

    p = {"router": w(d, e, scale=0.5, dt=jnp.float32),
         "w_gate": w(e, d, f), "w_up": w(e, d, f), "w_down": w(e, f, d)}
    if name == "tied_router":
        p["router"][:, [2, 5]] = 0.0
    if shared:
        p["shared"] = {"w_gate": w(d, 3 * f), "w_up": w(d, 3 * f),
                       "w_down": w(3 * f, d)}
        p["shared_gate"] = w(d, 1, dt=jnp.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    return jm, tm, p, x


def _run_both(name, dtype):
    jm, tm, p, x = _moe_case(name, dtype)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    ref = _reference_trace(jm, jax.tree_util.tree_map(jnp.asarray, p), jx)
    tp = convert.params_from_numpy(p)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    rt = tmoe.route(tm, tp["router"], tx.reshape(-1, x.shape[-1]))
    out, aux = tmoe.moe_block(tm, tp, tx)
    return ref, rt, out, aux


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_moe_block_routing_is_the_references_bit_for_bit(name, dtype):
    ref, rt, _, _ = _run_both(name, dtype)
    assert rt.cap * CASES[name][3] == ref["token_for_slot"].shape[0]
    for key in ("expert_idx", "order", "keep", "token_for_slot", "filled"):
        got = getattr(rt, key)
        assert np.array_equal(np.asarray(ref[key]), got.numpy()), key
    np.testing.assert_allclose(rt.gate.numpy(), np.asarray(ref["gate"]),
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_moe_block_output_and_aux_match_reference(name, dtype):
    ref, _, out, aux = _run_both(name, dtype)
    assert out.dtype == getattr(torch, dtype)
    assert tuple(out.shape) == ref["out"].shape
    assert rel_err(ref["out"], out) < OUT_TOL[dtype]
    assert abs(float(aux) - float(ref["aux"])) < AUX_TOL


@pytest.mark.parametrize("name", ["no_drops", "drops_cf1.25",
                                  "decode_cap1_granite", "top8"])
def test_combine_gives_the_references_scatter_add_bits(name):
    """Fed the reference's expert outputs and gates, the fixed-order sum
    gives the bf16 bits of the reference's ``.at[st].add``."""
    ref, rt, _, _ = _run_both(name, "bfloat16")
    rt = rt._replace(gate=torch.from_numpy(np.array(ref["gate"])))
    ye = convert.tensor_from_numpy(np.asarray(ref["ye"]))
    out = tmoe.combine(rt, ye.reshape(-1, ye.shape[-1]))
    assert np.array_equal(_bits(out), _bits(ref["combined"]))


def test_the_cases_drop_where_the_reference_drops():
    """The capacity cases really drop: cf 1.25 over 32 tokens, and batch 4
    at capacity 1 (granite: 32 assignments into 32 slots; qwen2-moe: 16
    into 60); the drop-free case drops nothing."""
    drops = {}
    for name in CASES:
        ref, rt, _, _ = _run_both(name, "float32")
        drops[name] = int((~rt.keep).sum())
        assert drops[name] == int((~np.asarray(ref["keep"])).sum())
    assert drops["no_drops"] == 0
    assert drops["drops_cf1.25"] > 0 and drops["decode_cap1_granite"] > 0
    assert drops["decode_cap1_qwen2"] > 0


def test_ties_go_to_the_lower_expert_index():
    """Experts 2 and 5 have the same logit (0) for every token: wherever
    one of them is picked in a column, 5 comes after 2, and where only one
    fits, it is 2."""
    ref, rt, _, _ = _run_both("tied_router", "float32")
    idx = rt.expert_idx.numpy()
    assert np.array_equal(idx, np.asarray(ref["expert_idx"]))
    has2, has5 = (idx == 2).any(1), (idx == 5).any(1)
    assert has2.any() and not (has5 & ~has2).any()
    boundary = has2 & ~has5                 # the tie decided at the k-th pick
    assert boundary.any()
    both = np.nonzero(has2 & has5)[0]
    for t in both:
        row = list(idx[t])
        assert row.index(2) < row.index(5)


@pytest.mark.parametrize("n, k, e, cf", [
    (4, 8, 32, 1.25), (4, 4, 60, 1.25), (2048, 8, 32, 1.25),
    (2048, 4, 60, 1.25), (2, 2, 8, 1.25), (5, 1, 2, 1.0), (10, 1, 4, 1.0),
    (3, 2, 4, 1.0), (32, 2, 8, 8.0)])
def test_capacity_is_the_references_python_round(n, k, e, cf):
    """``round(n·k/E·cf)`` at least 1, half to even: 5·1/2 = 2.5 gives 2,
    10·1/4 = 2.5 gives 2, 3·2/4 = 1.5 gives 2."""
    mcfg = TMoECfg(num_experts=e, top_k=k, expert_d_ff=8, capacity_factor=cf)
    assert tmoe.capacity(mcfg, n) == int(max(1, round(n * k / e * cf)))
    ref = _reference_trace(
        JMoECfg(num_experts=e, top_k=k, expert_d_ff=8, capacity_factor=cf),
        {"router": jnp.zeros((8, e), jnp.float32),
         "w_gate": jnp.zeros((e, 8, 8), jnp.bfloat16),
         "w_up": jnp.zeros((e, 8, 8), jnp.bfloat16),
         "w_down": jnp.zeros((e, 8, 8), jnp.bfloat16)},
        jnp.zeros((1, n, 8), jnp.bfloat16))
    assert ref["token_for_slot"].shape == (e * tmoe.capacity(mcfg, n),)


def test_moe_block_is_the_same_bits_on_every_run_deterministic_mode():
    _, tm, p, x = _moe_case("drops_cf1.25", "bfloat16")
    tp = convert.params_from_numpy(p)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        (a, aux_a), (b, aux_b) = (tmoe.moe_block(tm, tp, tx) for _ in range(2))
    finally:
        torch.use_deterministic_algorithms(was)
    assert np.array_equal(_bits(a), _bits(b))
    assert float(aux_a) == float(aux_b)


def test_moe_source_has_no_float_scatter_add():
    src = (pathlib.Path(tmoe.__file__)).read_text()
    code = "\n".join(ln.split("#")[0] for ln in src.splitlines())
    for word in ("index_add_", "scatter_add_", "scatter_reduce", "atomicAdd",
                 "index_put_"):
        assert word not in code, word


# ------------------------------------------------------------ the family
def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_param_defs_match_reference_leaf_for_leaf(name):
    from repro.models.params import P as JP
    from repro_torch.models.params import P as TP
    jdefs = jregistry.param_defs(jconfigs.reduced(jconfigs.get(name)))
    tdefs = tregistry.param_defs(tconfigs.reduced(tconfigs.get(name)))
    jflat = {tuple(getattr(k, "key", k) for k in path): p
             for path, p in jax.tree_util.tree_flatten_with_path(
                 jdefs, is_leaf=lambda x: isinstance(x, JP))[0]}
    tflat = _flat(tdefs)
    assert set(jflat) == set(tflat)
    for path, jp in jflat.items():
        tp = tflat[path]
        assert isinstance(tp, TP)
        assert (tp.shape, tp.axes, tp.init, tp.scale) == \
            (jp.shape, jp.axes, jp.init, jp.scale), path
        assert str(tp.dtype).removeprefix("torch.") == np.dtype(jp.dtype).name
    assert "moe" in jdefs["blocks"] and "mlp" not in jdefs["blocks"]


@pytest.mark.parametrize("name, n_params", [
    ("granite-moe-1b-a400m", 1_384_963_072),
    ("qwen2-moe-a2.7b", 14_315_784_192)])
def test_full_config_on_meta_matches_eval_shape(name, n_params):
    """The published configs, nothing cut: the port's tree materialised
    on ``meta`` against ``jax.eval_shape`` of the reference's init, leaf
    for leaf, and the parameter count (``ArchConfig.param_count``'s
    estimate leaves out the norms and biases: within 2e-5 of it)."""
    jcfg, tcfg = jconfigs.get(name), tconfigs.get(name)
    jshapes = jax.eval_shape(lambda: jregistry.init(jcfg,
                                                    jax.random.PRNGKey(0)))
    tmeta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                           device="meta"),
                     tregistry.param_defs(tcfg))
    jl = jax.tree_util.tree_leaves(jshapes)
    tl = jax.tree_util.tree_leaves(tmeta)
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).removeprefix("torch.") == np.dtype(a.dtype).name
    assert sum(t.numel() for t in tl) == n_params
    assert abs(n_params / tcfg.param_count() - 1) < 2e-5


def _models(name, cf=None, moe=None):
    """(reference cfg, port cfg, reference params, port params) of the
    reduced config, at ``reduced()``'s drop-free capacity factor or ``cf``,
    or with the MoE fields ``moe``; the port serves through flash (its
    plain version on the CPU)."""
    jcfg = jconfigs.reduced(jconfigs.get(name))
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get(name)),
                               attn_impl="flash")
    if moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=JMoECfg(**moe))
        tcfg = dataclasses.replace(tcfg, moe=TMoECfg(**moe))
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


# Routing is discrete: where two experts' probabilities nearly tie, a
# one-ulp difference in the bf16 hidden state (the packages round
# attention and the norms at other places) picks the other one, and that
# token's logits move by several percent. Over the 4 layers and 44 routed
# tokens of a run such a flip happens in about one run of five, at any
# router scale (the order of the logits is scale-free). So the model
# tests run each package's own routing once, to count on how many (token,
# layer) rows the port's picks agree with the reference's, and hold the
# logits with the port taking the reference's picks (its own gates at
# them): everything after the top-k (gates, capacity, dispatch, experts,
# combine, caches) then meets the reference at 3e-2. The top-k itself is
# held bit for bit on equal inputs above.
@contextlib.contextmanager
def reference_picks():
    """Record the reference's top-k experts of every MoE call, in call
    order; the reference runs jitted, so through an ordered callback.
    Read the list after ``jax.effects_barrier()``."""
    picks, real = [], jax.lax.top_k

    def top_k(x, k):
        out = real(x, k)
        jax.debug.callback(lambda i: picks.append(np.asarray(i)), out[1],
                           ordered=True)
        return out

    jax.lax.top_k = top_k
    try:
        yield picks
    finally:
        jax.lax.top_k = real


@contextlib.contextmanager
def port_picks(forced=None):
    """Record the port's top-k experts of every MoE call; with ``forced``
    (a list of the reference's, in call order) take those instead, each
    gated by the port's own probabilities."""
    picks, real = [], tmoe.top_k

    def top_k(probs, k):
        if forced is None:
            _, idx = real(probs, k)
        else:
            idx = torch.from_numpy(np.array(forced[len(picks)])).long()
        picks.append(idx.numpy().copy())
        return probs.gather(1, idx), idx

    tmoe.top_k = top_k
    try:
        yield picks
    finally:
        tmoe.top_k = real


def _agreement(a, b) -> float:
    """The share of (token, layer) rows whose k picks agree, in order."""
    assert len(a) == len(b) and all(x.shape == y.shape for x, y in zip(a, b))
    rows = sum(len(x) for x in a)
    return sum(int((x == y).all(1).sum()) for x, y in zip(a, b)) / rows


def _serve_both(jcfg, tcfg, jparams, tparams, toks, prefill_len):
    """Prefill ``prefill_len`` tokens, then teacher-forced decode of the
    rest, in both packages: the reference's logits a step and cache, its
    picks; the port's own picks; then the port's logits a step and cache
    on the reference's picks."""
    total = toks.shape[1]
    prefill = jax.jit(lambda p, b: jsteps.prefill_step(jcfg, p, b,
                                                      max_len=total))
    decode = jax.jit(lambda p, t, c: jsteps.decode_step(jcfg, p, t, c))
    with reference_picks() as jpicks:
        jl, jc = prefill(jparams, {"tokens": jnp.asarray(toks[:, :prefill_len])})
        jsteps_ = [np.asarray(jl, np.float32)]
        for i in range(prefill_len, total):
            jl, jc = decode(jparams, jnp.asarray(toks[:, i:i + 1]), jc)
            jsteps_.append(np.asarray(jl, np.float32))
        jax.effects_barrier()

    def port(forced):
        with torch.inference_mode(), port_picks(forced) as picks:
            tl, tc = tsteps.prefill_step(
                tcfg, tparams,
                {"tokens": torch.from_numpy(toks[:, :prefill_len])},
                max_len=total)
            logits = [_np(tl)]
            for i in range(prefill_len, total):
                tl, tc = tsteps.decode_step(
                    tcfg, tparams, torch.from_numpy(toks[:, i:i + 1]), tc)
                logits.append(_np(tl))
        return logits, tc, picks

    _, _, own = port(None)
    tsteps_, tc, _ = port(jpicks)
    return {"steps": list(zip(jsteps_, tsteps_)),
            "cache": (jax.tree_util.tree_map(np.asarray, jc), tc),
            "agreement": _agreement(jpicks, own), "picks": (jpicks, own)}


@pytest.fixture(scope="module", params=[
    (name, cf) for name in MOE_ARCHS for cf in ("drop_free", 1.25)],
    ids=lambda p: f"{p[0]}-{p[1]}")
def served(request):
    """Both packages on the same weights and numpy tokens: prefill of
    PREFILL, teacher-forced decode to TOTAL (``_serve_both``), and each
    one's no-cache forward over all TOTAL tokens (the port's on the
    reference's picks)."""
    name, cf = request.param
    jcfg, tcfg, jparams, tparams = _models(
        name, None if cf == "drop_free" else cf)
    toks = _tokens(jcfg, (B, TOTAL), seed=3)
    out = _serve_both(jcfg, tcfg, jparams, tparams, toks, PREFILL)
    out["cfgs"] = (jcfg, tcfg)
    with reference_picks() as jpicks:
        jfull = jlm.forward(jcfg, jparams, jnp.asarray(toks))
        jax.effects_barrier()
    with torch.no_grad(), port_picks(jpicks):
        full = tlm.forward(tcfg, tparams, torch.from_numpy(toks))
    out["full"] = ((np.asarray(jfull.logits, np.float32),
                    float(jfull.aux_loss)),
                   (_np(full.logits), float(full.aux_loss)))
    return out


def test_moe_prefill_and_teacher_forced_decode_match_reference(served):
    """Every step's logits, with drops (cf 1.25: decode at capacity 1) and
    without, against the reference's cached path."""
    assert len(served["steps"]) == TOTAL - PREFILL + 1
    for step, (jl, tl) in enumerate(served["steps"]):
        assert rel_err(jl, tl) < REL_TOL, step


def test_moe_routing_agrees_with_reference_on_its_own(served):
    """Each package routing on its own hidden states: the picks agree on
    all but the few (token, layer) rows that a near-tie flips; a wiring
    fault (a wrong router, softmax axis or top-k order) disagrees on most.
    One call a layer per forward: 4 prefill calls of 32 rows, then 4 a
    decode step of 2 rows."""
    jpicks, own = served["picks"]
    cfg = served["cfgs"][1]
    assert len(jpicks) == (1 + TOTAL - PREFILL) * cfg.num_layers
    assert served["agreement"] >= 0.9, served["agreement"]


def test_moe_kv_cache_matches_reference(served):
    jc, tc = served["cache"]
    assert tc["pos"] == int(jc["pos"]) == TOTAL
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        for layer in range(jc[key].shape[0]):
            assert rel_err(jc[key][layer], tc[key][layer]) < REL_TOL, (key,
                                                                       layer)


def test_moe_no_cache_forward_and_aux_loss_match_reference(served):
    """The no-cache forward's logits, and its aux loss: the sum over the
    layers of E·Σ density·mean(probs), each about 1 when balanced, not the
    zeros of a dense model. On the same picks the densities are equal, and
    the mean probabilities differ only by the bf16 hidden state."""
    (jl, jaux), (tl, taux) = served["full"]
    assert tl.shape == jl.shape
    assert rel_err(jl, tl) < REL_TOL
    assert taux > 0.5 * served["cfgs"][1].num_layers
    assert abs(jaux - taux) < REL_TOL * abs(jaux)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_decode_at_cf_1_25_runs_at_capacity_one_and_drops(name, monkeypatch):
    """The serving configs' capacity factor at batch 4: every decode step
    routes with capacity 1 per expert, and drops assignments where two
    tokens pick one expert, as the reference does."""
    _, tcfg, _, tparams = _models(name, 1.25)
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
    assert n_prefill == tcfg.num_layers
    decode = seen[n_prefill:]
    assert len(decode) == 2 * tcfg.num_layers
    assert all(rt.cap == 1 for rt in decode)
    # at capacity 1 each expert keeps one of its picks
    for rt in decode:
        assert int(rt.keep.sum()) == len(torch.unique(rt.expert_idx))
    dropped = sum(int((~rt.keep).sum()) for rt in decode)
    assert 0 < dropped < len(decode) * 4 * tcfg.moe.top_k


def test_windowed_config_with_moe_layers_matches_reference():
    """A reduced gemma3 whose every layer is MoE, served through the ring
    caches (``_windowed_stack``'s MoE branch, as the reference's
    ``ffn``): prefill of 12 tokens (longer than the window of 8) and
    teacher-forced decode to 16, each step's logits at 3e-2 on the
    reference's picks, and the picks on the port's own."""
    moe = dict(num_experts=4, top_k=2, expert_d_ff=64, capacity_factor=1.25)
    jcfg, tcfg, jparams, tparams = _models("gemma3-4b", moe=moe)
    assert jcfg.window_cache and "moe" in tparams["blocks"]
    toks = _tokens(jcfg, (B, 16), seed=4)
    out = _serve_both(jcfg, tcfg, jparams, tparams, toks, 12)
    assert len(out["picks"][0]) == 5 * jcfg.num_layers
    for step, (jl, tl) in enumerate(out["steps"]):
        assert rel_err(jl, tl) < REL_TOL, step
    jc, tc = out["cache"]
    assert np.array_equal(jc["kpl"], tc["kpl"].numpy())
    assert out["agreement"] >= 0.9, out["agreement"]


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_serve_cli_runs_reduced_moe_on_cpu(capsys, name):
    serve.main(["--arch", name, "--device", "cpu", "--batch", "2",
                "--prompt-len", "12", "--gen-tokens", "5"])
    out = capsys.readouterr().out
    assert f"arch={name}-smoke" in out and "attn_impl=flash" in out
    assert "first sequence:" in out
