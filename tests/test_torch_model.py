"""The port's dense LM vs the JAX package's, on the CPU at reduced size.

Weights come from the reference ``registry.init`` and cross through
``convert.params_from_numpy`` in this process: reference init keys hash
strings (``params.py:52-57``), so re-initialising on both sides would not
reproduce them. Inputs are numpy from a seed, fed to both packages.

The port runs ``attn_impl="flash"`` (on the CPU its wrapper takes the plain
version with per-row offsets); the reference runs its default "chunked"
path, because its own flash path breaks at batch > 1 (``layers.py:184``
passes (B,) offsets, ``flash_attention.py:135`` reshapes them to (1,)).

Tolerance: a relative error (max |a − b| / max |a|) below 3e-2, as
``tests/test_smoke_archs.py::test_prefill_decode_consistency`` uses: both
models run in bf16, and XLA and torch round bf16 at other places.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers, lm as jlm, registry as jregistry
from repro.models.params import P as JP
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.models import (convert, layers as tlayers, lm as tlm,
                                registry as tregistry)
from repro_torch.models.params import P as TP, tree_map
from repro_torch.train import steps as tsteps

REL_TOL = 3e-2
ARCHS = ["internlm2-1.8b", "helix100m"]
B, S, N_DECODE = 2, 12, 8


def rel_err(ref, out) -> float:
    ref, out = np.asarray(ref, np.float32), np.asarray(out, np.float32)
    return float(np.max(np.abs(ref - out)) / (np.max(np.abs(ref)) + 1e-9))


def _t2np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(reference cfg, port cfg, reference params, port params) — the same
    weights on both sides."""
    jcfg = jconfigs.reduced(jconfigs.get(request.param))
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get(request.param)),
                               attn_impl="flash")
    jparams = jregistry.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------- structure
def _flat_defs(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_defs(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("name", ARCHS + ["mamba2-130m"])
def test_param_defs_match_reference_leaf_for_leaf(name):
    jdefs = jregistry.param_defs(jconfigs.reduced(jconfigs.get(name)))
    tdefs = tregistry.param_defs(tconfigs.reduced(tconfigs.get(name)))
    jflat = {tuple(getattr(k, "key", k) for k in path): p
             for path, p in jax.tree_util.tree_flatten_with_path(
                 jdefs, is_leaf=lambda x: isinstance(x, JP))[0]}
    tflat = _flat_defs(tdefs)
    assert set(jflat) == set(tflat)
    for path, jp in jflat.items():
        tp = tflat[path]
        assert isinstance(tp, TP)
        assert (tp.shape, tp.axes, tp.init, tp.scale) == \
            (jp.shape, jp.axes, jp.init, jp.scale), path
        assert str(tp.dtype).removeprefix("torch.") == np.dtype(jp.dtype).name


def test_init_params_draws_the_reference_distributions():
    cfg = tconfigs.reduced(tconfigs.get("internlm2-1.8b"))
    gen = torch.Generator().manual_seed(0)
    params = tregistry.init(cfg, gen, "cpu")
    defs = _flat_defs(tregistry.param_defs(cfg))
    leaves = _flat_defs(params)
    assert set(leaves) == set(defs)
    for path, p in defs.items():
        t = leaves[path]
        assert tuple(t.shape) == p.shape and t.dtype == p.dtype, path
        if p.init == "ones":
            assert torch.all(t == 1)
        elif p.init == "zeros":
            assert torch.all(t == 0)
        else:
            assert abs(float(t.float().std()) - 0.02) < 2e-3, path
    again = tregistry.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["embed"], params["embed"])


@pytest.mark.parametrize("name", ARCHS + ["mamba2-130m"])
def test_convert_carries_bf16_bits_exactly(name):
    """Every leaf crosses bit for bit: bf16 (embeddings, projections, the
    ssm block's in_proj/conv/out_proj) and fp32 (norms, a_log, dt_bias,
    d_skip)."""
    jparams = jregistry.init(jconfigs.reduced(jconfigs.get(name)),
                             jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    jl = jax.tree_util.tree_leaves(jparams)
    tl = jax.tree_util.tree_leaves(tparams)
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name
        if a.dtype.name == "bfloat16":
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), a)


# ---------------------------------------------------------------- layers
def test_embed_lookup_is_bit_equal_to_reference_onehot(arch):
    jcfg, tcfg, jparams, tparams = arch
    assert jcfg.embed_impl == "onehot"
    toks = _tokens(jcfg, (B, S))
    exp = jlm.embed_lookup(jcfg, jparams["embed"], jnp.asarray(toks))
    out = tlm.embed_lookup(tcfg, tparams["embed"], torch.from_numpy(toks))
    assert np.array_equal(out.view(torch.int16).numpy(),
                          np.asarray(exp).view(np.int16))


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    pos = rng.integers(0, 100, (2, 6)).astype(np.int32)
    out = tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    exp = jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(_t2np(out), np.asarray(exp), atol=1e-5)
    out = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    exp = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    # fp32 cos/sin of angles up to 100 rad: a few ulp of the angle apart
    np.testing.assert_allclose(_t2np(out), np.asarray(exp), atol=1e-4)
    np.testing.assert_allclose(tlayers.rope_freqs(32, 1e4),
                               jlayers.rope_freqs(32, 1e4), rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["reference", "chunked", "flash"])
@pytest.mark.parametrize("sq", [1, 9])
def test_gqa_attention_matches_reference(impl, sq):
    """Each port impl vs the reference's chunked (prefill) or reference
    (decode, Sq == 1, with ``valid_len``) path, fp32, a cache longer than
    the live part, a window."""
    rng = np.random.default_rng(5)
    b, sk, h, kvh, d, base = 2, 20, 4, 2, 32, 11
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)])
    q_pos = np.broadcast_to(base - sq + 1 + np.arange(sq, dtype=np.int32),
                            (b, sq)).copy()
    k_pos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    valid = np.full((b,), base + 1, np.int32)
    kw = dict(causal=True, window=8)
    exp = jlayers.gqa_attention(
        *map(jnp.asarray, (q, k, v, q_pos, k_pos)), valid_len=jnp.asarray(valid),
        impl="chunked" if sq > 1 else "reference", **kw)
    out = tlayers.gqa_attention(
        *map(torch.from_numpy, (q, k, v, q_pos, k_pos)),
        valid_len=torch.from_numpy(valid), impl=impl, **kw)
    np.testing.assert_allclose(_t2np(out), np.asarray(exp), atol=2e-5)


def test_attn_block_writes_cache_like_reference(arch):
    jcfg, tcfg, jparams, tparams = arch
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 5, jcfg.d_model)).astype(np.float32) * 0.5
    pos = np.broadcast_to(3 + np.arange(5, dtype=np.int32), (B, 5)).copy()
    jp = jax.tree_util.tree_map(lambda t: t[0], jparams["blocks"]["attn"])
    tp = tree_map(lambda t: t[0], tparams["blocks"]["attn"])
    kv_shape = (B, 10, jcfg.num_kv_heads, jcfg.resolved_head_dim)
    jout, (jk, jv) = jlayers.attn_block(
        jcfg, jp, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), window=None,
        kv_cache=(jnp.zeros(kv_shape, jnp.bfloat16),) * 2,
        cache_pos=jnp.int32(3))
    kc = torch.zeros(kv_shape, dtype=torch.bfloat16)
    vc = torch.zeros(kv_shape, dtype=torch.bfloat16)
    tout, (tk, tv) = tlayers.attn_block(
        tcfg, tp, torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(pos),
        window=None, kv_cache=(kc, vc), cache_pos=3)
    assert tk is kc and tv is vc      # written in place
    assert rel_err(jout, _t2np(tout)) < REL_TOL
    for j, t in ((jk, tk), (jv, tv)):
        assert rel_err(j, _t2np(t)) < REL_TOL
        assert not _t2np(t)[:, :3].any() and not _t2np(t)[:, 8:].any()


# ---------------------------------------------------------------- model
def test_forward_logits_match_reference(arch):
    jcfg, tcfg, jparams, tparams = arch
    toks = _tokens(jcfg, (B, 16))
    exp = jlm.forward(jcfg, jparams, jnp.asarray(toks)).logits
    out = tlm.forward(tcfg, tparams, torch.from_numpy(toks)).logits
    assert tuple(out.shape) == (B, 16, jcfg.vocab_size)
    assert rel_err(exp, _t2np(out)) < REL_TOL


@pytest.fixture(scope="module")
def served(arch):
    """Reference and port prefill of S tokens into a cache of S + N_DECODE,
    then N_DECODE teacher-forced decode steps on the same numpy tokens."""
    jcfg, tcfg, jparams, tparams = arch
    toks = _tokens(jcfg, (B, S + N_DECODE), seed=7)
    max_len = S + N_DECODE
    prefill = jax.jit(lambda p, b: jsteps.prefill_step(jcfg, p, b,
                                                      max_len=max_len))
    decode = jax.jit(lambda p, t, c: jsteps.decode_step(jcfg, p, t, c))
    jl, jc = prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tc = tsteps.prefill_step(tcfg, tparams,
                                 {"tokens": torch.from_numpy(toks[:, :S])},
                                 max_len=max_len)
    out = {"prefill": (np.asarray(jl, np.float32), _t2np(tl)),
           "cache": (jax.tree_util.tree_map(np.asarray, jc),
                     {"k": tc["k"].clone(), "v": tc["v"].clone(),
                      "pos": tc["pos"]}),
           "decode": []}
    for i in range(S, S + N_DECODE):
        jl, jc = decode(jparams, jnp.asarray(toks[:, i:i + 1]), jc)
        tl, tc = tsteps.decode_step(tcfg, tparams,
                                    torch.from_numpy(toks[:, i:i + 1]), tc)
        out["decode"].append((np.asarray(jl, np.float32), _t2np(tl)))
    return out


def test_prefill_last_logits_and_cache_match_reference(served):
    jl, tl = served["prefill"]
    assert rel_err(jl, tl) < REL_TOL
    jc, tc = served["cache"]
    assert tc["pos"] == int(jc["pos"]) == S
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert tc[key].dtype == torch.bfloat16
        for layer in range(jc[key].shape[0]):
            assert rel_err(jc[key][layer], _t2np(tc[key][layer])) < REL_TOL
        assert not _t2np(tc[key])[:, :, S:].any()   # slots past the prompt


def test_teacher_forced_decode_logits_match_reference(served):
    assert len(served["decode"]) == N_DECODE
    for step, (jl, tl) in enumerate(served["decode"]):
        assert rel_err(jl, tl) < REL_TOL, step


def test_greedy_tokens_match_where_the_reference_margin_is_clear(served):
    """Top-1 tokens agree wherever the reference's top-1/top-2 gap exceeds
    the tolerance (relative to max |logit|); below it, bf16 rounding may
    legitimately pick the other token."""
    checked = 0
    for jl, tl in [served["prefill"]] + served["decode"]:
        top2 = np.sort(jl, -1)[:, -2:]
        margin = (top2[:, 1] - top2[:, 0]) / np.max(np.abs(jl), -1)
        clear = margin > REL_TOL
        assert np.array_equal(jl.argmax(-1)[clear], tl.argmax(-1)[clear])
        checked += int(clear.sum())
    assert checked > 0


def test_port_prefill_decode_consistent_with_forward(arch):
    _, tcfg, _, tparams = arch
    toks = torch.from_numpy(_tokens(tcfg, (B, 16), seed=8))
    full = tlm.forward(tcfg, tparams, toks)
    cache = tregistry.init_cache(tcfg, B, 20, "cpu")
    pre = tlm.forward(tcfg, tparams, toks[:, :15], cache=cache)
    dec = tlm.forward(tcfg, tparams, toks[:, 15:], cache=pre.cache)
    assert dec.cache["pos"] == 16
    assert rel_err(_t2np(full.logits[:, -1]), _t2np(dec.logits[:, 0])) < REL_TOL


def test_serve_cli_refuses_the_audio_family_as_the_reference_does():
    """The reference's launcher refuses an enc-dec arch with this message
    (``src/repro/launch/serve.py``); the port's ``main`` keeps it, and
    serves the family through ``serve.run`` only."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="use an LM-family arch for serve "
                       r"\(enc-dec decode is exercised in tests\)"):
        serve.main(["--arch", "whisper-medium", "--device", "cpu"])


def test_audio_train_step_refuses_flash_attention():
    """The audio family trains, through the plain attention paths: the
    FlashAttention kernel has no backward."""
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get("whisper-medium")),
                              attn_impl="flash")
    state = tsteps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
             "frames": torch.zeros((2, 16, cfg.d_model))}
    with pytest.raises(NotImplementedError, match="no backward"):
        tsteps.train_step(cfg, state, batch)
