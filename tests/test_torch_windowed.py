"""The port's windowed family (gemma3: ring KV caches for the local layers,
flash at head_dim 256) vs the JAX package's, on the CPU at reduced size.

Weights come from the reference ``registry.init`` and cross through
``convert.params_from_numpy`` in this process, as in
``tests/test_torch_model.py``; every other input is numpy from a seed. No
check needs a property of the reference's per-process weights.

Three configs: the reference's ``configs.reduced(gemma3-4b)`` (4 layers,
``global_every`` 2, window 8: two groups, no tail layer); a tail config
(7 layers, ``global_every`` 3: two groups and one tail ring layer, which
the reduced config never reaches); and a narrow one at gemma3's head_dim
256 (d_model 128, 2 heads over 1 KV head). The port runs
``attn_impl="flash"`` (on the CPU the wrapper takes its plain version),
the reference its default ``"chunked"``.

Tolerances: the ring's positions and, wherever both packages are given the
same K/V, its K/V bits are held exactly; logits and K/V that each package
computes from the weights at 3e-2 relative (max |a − b| / max |a|), as
``tests/test_smoke_archs.py::test_gemma3_ring_window_cache`` holds the
reference's own ring path (bf16 in both, rounded at other places).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention import ref as fa_ref
from repro.models import layers as jlayers, lm as jlm, registry as jregistry
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.kernels.flash_attention import ops as tfa_ops
from repro_torch.launch import serve
from repro_torch.models import (convert, layers as tlayers, lm as tlm,
                                registry as tregistry)
from repro_torch.models.params import tree_map
from repro_torch.train import steps as tsteps

REL_TOL = 3e-2
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py's
NEG = -(1 << 30)
B, PREFILL, TOTAL = 2, 20, 28        # prefill 20 > window 8, decode to 28
RING_LEAVES = ("kl", "vl", "kpl", "kg", "vg", "kt", "vt", "kpt")

# name -> the fields replaced in configs.reduced(gemma3-4b), in both packages
CONFIGS = {
    "reduced": {},
    "tail": {"num_layers": 7, "global_every": 3},
    "d256": {"num_heads": 2, "num_kv_heads": 1, "head_dim": 256},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: several test processes share
    the cores, and torch's OpenMP pool would spin at each small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(name):
    """(reference cfg, port cfg) of a named config."""
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get("gemma3-4b")),
                               **CONFIGS[name])
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get("gemma3-4b")),
                               **CONFIGS[name], attn_impl="flash")
    assert jcfg.window_cache and tcfg.window_cache and jcfg.window == 8
    return jcfg, tcfg


def _models(name):
    jcfg, tcfg = _cfgs(name)
    jparams = jregistry.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def rel_err(ref, out) -> float:
    ref, out = np.asarray(ref, np.float32), _np(out)
    return float(np.max(np.abs(ref - out)) / (np.max(np.abs(ref)) + 1e-9))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bits(x) -> np.ndarray:
    """The raw bits of a bf16 or int32 array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.bfloat16
                      else x.dtype).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------ ring_update
# (B, W, KV, hd, S, cache_pos): a decode write that wraps; S < W (the
# phantom slots past the last position); S == W; S > W; an S > 1 write at
# a non-zero position (the function's own contract)
RING_CASES = {
    "decode_wraps": (2, 8, 2, 16, 1, 13),
    "prefill_shorter_than_ring": (2, 8, 2, 16, 6, 0),
    "prefill_fills_ring": (2, 8, 2, 16, 8, 0),
    "prefill_longer_than_ring": (2, 8, 2, 16, 20, 0),
    "write_at_offset": (1, 8, 1, 16, 3, 5),
}


def _ring_inputs(b, w, kvh, hd, s, seed=0):
    """A ring already holding entries (random K/V, positions in [-5, 3),
    some empty) and S new rows, as fp32 numpy."""
    rng = np.random.default_rng(seed)
    kc, vc = (rng.standard_normal((b, w, kvh, hd)).astype(np.float32)
              for _ in range(2))
    kp = rng.integers(-5, 3, (b, w)).astype(np.int32)
    kp[:, ::3] = NEG
    k, v = (rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
            for _ in range(2))
    return kc, vc, kp, k, v


def _both_ring_updates(arrays, cache_pos):
    kc, vc, kp, k, v = arrays
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (kc, vc, k, v)]
    jout = jlayers.ring_update(bf[0], bf[1], jnp.asarray(kp), bf[2], bf[3],
                               jnp.int32(cache_pos))
    tt = [torch.from_numpy(a).bfloat16() for a in (kc, vc, k, v)]
    ring = (tt[0], tt[1], torch.from_numpy(kp.copy()))
    tout = tlayers.ring_update(*ring, tt[2], tt[3], cache_pos)
    assert all(o is r for o, r in zip(tout, ring))     # written in place
    return jout, tout


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_update_is_bitwise_the_reference(case):
    b, w, kvh, hd, s, pos = RING_CASES[case]
    jout, tout = _both_ring_updates(_ring_inputs(b, w, kvh, hd, s), pos)
    for j, t in zip(jout, tout):
        assert t.dtype == (torch.int32 if j.dtype == jnp.int32
                           else torch.bfloat16)
        assert np.array_equal(_bits(j), _bits(t))


def test_ring_update_prefill_shorter_than_ring_keeps_the_phantom_slots():
    """W = 8, a prefill of 6 into an empty ring: the reference's truncated
    remainder gives slots 6 and 7 positions 6 and 7 and the K/V of position
    5 (a floored remainder would leave them empty)."""
    k = np.arange(6, dtype=np.float32).reshape(1, 6, 1, 1)
    empty = (np.zeros((1, 8, 1, 1), np.float32),) * 2 + (
        np.full((1, 8), NEG, np.int32),)
    jout, tout = _both_ring_updates(empty + (k, k), 0)
    for out in (jout, tout):
        assert _bits(out[2]).tolist() == [list(range(8))]
        assert _np(out[0]).ravel().tolist() == [0, 1, 2, 3, 4, 5, 5, 5]


def test_ring_width_is_the_window_or_max_len():
    """``init_cache`` sizes the ring ``min(window, max_len)``: at max_len
    6 < window 8 a 5-token prefill leaves one phantom slot in 6."""
    jcfg, tcfg = _cfgs("reduced")
    jc = jlm.init_cache(jcfg, B, 6)
    tc = tlm.init_cache(tcfg, B, 6, "cpu")
    assert tc["kl"].shape[3] == jc["kl"].shape[3] == 6
    arrays = _ring_inputs(B, 6, 2, 16, 5)
    jout, tout = _both_ring_updates(arrays, 0)
    for j, t in zip(jout, tout):
        assert np.array_equal(_bits(j), _bits(t))


# ------------------------------------------------------------ attn_block_ring
def _block_inputs(jcfg, s, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, s, jcfg.d_model)).astype(np.float32) * 0.5


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_attn_block_ring_matches_reference(mode):
    """Prefill (12 tokens into an 8-slot ring: attend within the sequence,
    then gather the last 8) or one decode step at position 12 (write slot 4,
    then attend over the 8 slots by their stored positions). The output and
    the ring's K/V at the attention tolerance, its positions exactly."""
    jcfg, tcfg, jparams, tparams = _models("reduced")
    jp = jax.tree_util.tree_map(lambda t: t[0], jparams["blocks"]["attn"])
    tp = tree_map(lambda t: t[0], tparams["blocks"]["attn"])
    kvh, hd, w = jcfg.num_kv_heads, jcfg.resolved_head_dim, jcfg.window
    rng = np.random.default_rng(3)
    if mode == "prefill":
        s, pos0 = 12, 0
        kc = vc = np.zeros((B, w, kvh, hd), np.float32)
        kp = np.full((B, w), NEG, np.int32)
    else:
        s, pos0 = 1, 12
        kc, vc = (rng.standard_normal((B, w, kvh, hd)).astype(np.float32)
                  for _ in range(2))
        kp = np.broadcast_to(np.array([8, 9, 10, 11, 4, 5, 6, 7], np.int32),
                             (B, w)).copy()
    x = _block_inputs(jcfg, s, seed=4)
    pos = np.broadcast_to(pos0 + np.arange(s, dtype=np.int32), (B, s)).copy()
    jout, jring = jlayers.attn_block_ring(
        jcfg, jp, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
        (jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16),
         jnp.asarray(kp)), jnp.int32(pos0), w)
    ring = (torch.from_numpy(kc).bfloat16(), torch.from_numpy(vc).bfloat16(),
            torch.from_numpy(kp.copy()))
    tout, tring = tlayers.attn_block_ring(
        tcfg, tp, torch.from_numpy(x).bfloat16(), torch.from_numpy(pos),
        ring, pos0, w)
    assert all(t is r for t, r in zip(tring, ring))     # in place
    assert tuple(tout.shape) == (B, s, jcfg.d_model)
    assert rel_err(jout, tout) < REL_TOL
    assert np.array_equal(_bits(jring[2]), _bits(tring[2]))
    for j, t in zip(jring[:2], tring[:2]):
        assert rel_err(j, t) < REL_TOL
    if mode == "decode":      # only slot 4 moved
        keep = [i for i in range(w) if i != 4]
        before = torch.from_numpy(kc).bfloat16()
        assert np.array_equal(_bits(tring[0])[:, keep], _bits(before)[:, keep])


def test_attn_block_ring_refuses_a_prefill_past_position_0():
    """The reference's precondition (prefill attends only within the
    sequence), which the port keeps, raised instead of assumed."""
    jcfg, tcfg = _cfgs("reduced")
    tparams = tregistry.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    tp = tree_map(lambda t: t[0], tparams["blocks"]["attn"])
    cache = tlm.init_cache(tcfg, B, 16, "cpu")
    x = torch.zeros(B, 3, tcfg.d_model, dtype=torch.bfloat16)
    pos = torch.arange(5, 8, dtype=torch.int32).expand(B, 3)
    with pytest.raises(ValueError, match="position 0"):
        tlayers.attn_block_ring(tcfg, tp, x, pos, (cache["kl"][0, 0],
                                cache["vl"][0, 0], cache["kpl"][0, 0]), 5, 8)


# ------------------------------------------------------------ init_cache
def _leaves_like(jc, tc):
    assert sorted(tc) == sorted(jc)
    assert tc["pos"] == 0 and isinstance(tc["pos"], int)
    for key in RING_LEAVES:
        j, t = jc[key], tc[key]
        assert tuple(t.shape) == tuple(j.shape), key
        assert str(t.dtype).removeprefix("torch.") == np.dtype(j.dtype).name


@pytest.mark.parametrize("name", ["reduced", "tail"])
def test_init_cache_matches_reference(name):
    jcfg, tcfg = _cfgs(name)
    jc = jlm.init_cache(jcfg, B, 12)
    tc = tlm.init_cache(tcfg, B, 12, "cpu")
    _leaves_like(jc, tc)
    for key in RING_LEAVES:
        assert np.array_equal(_bits(jc[key]), _bits(tc[key])), key
    assert tc["kpl"].unique().tolist() == [NEG]
    if name == "tail":
        assert tlm._window_groups(tcfg) == jlm._window_groups(jcfg) == (2, 3, 1)
        assert tc["kt"].shape[0] == 1


def test_init_cache_full_gemma3_on_meta_matches_eval_shape():
    """The full gemma3-4b (5 groups of 6 and 4 tail ring layers) at the
    reference test's 524,288 tokens: the same leaves as ``jax.eval_shape``
    of the reference, and the ring cache under 0.2x the uniform cache."""
    jcfg = jconfigs.get("gemma3-4b")
    tcfg = tconfigs.get("gemma3-4b")
    n = 524288
    jc = jax.eval_shape(lambda: jlm.init_cache(jcfg, 1, n))
    tc = tlm.init_cache(tcfg, 1, n, "meta")
    _leaves_like(jc, tc)
    assert tlm._window_groups(tcfg) == (5, 6, 4)
    uniform = tlm.init_cache(dataclasses.replace(tcfg, window_cache=False),
                             1, n, "meta")
    assert set(uniform) == {"k", "v", "pos"}
    nbytes = lambda c: sum(t.numel() * t.element_size()  # noqa: E731
                           for t in c.values() if isinstance(t, torch.Tensor))
    assert nbytes(tc) < 0.2 * nbytes(uniform)


# ------------------------------------------------------------ windowed forward
@pytest.fixture(scope="module", params=["reduced", "tail", "d256"])
def served(request):
    """Both packages: prefill PREFILL tokens into a ring cache of
    min(8, TOTAL) slots, then teacher-forced decode of the same numpy
    tokens up to TOTAL (the ring wraps); and each package's no-cache
    forward over all TOTAL tokens."""
    jcfg, tcfg, jparams, tparams = _models(request.param)
    toks = _tokens(jcfg, (B, TOTAL), seed=7)
    prefill = jax.jit(lambda p, b: jsteps.prefill_step(jcfg, p, b,
                                                      max_len=TOTAL))
    decode = jax.jit(lambda p, t, c: jsteps.decode_step(jcfg, p, t, c))
    jl, jc = prefill(jparams, {"tokens": jnp.asarray(toks[:, :PREFILL])})
    with torch.inference_mode():
        tl, tc = tsteps.prefill_step(
            tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :PREFILL])},
            max_len=TOTAL)
        out = {"name": request.param, "cfgs": (jcfg, tcfg),
               "prefill": (np.asarray(jl, np.float32), _np(tl)),
               "cache": (jax.tree_util.tree_map(np.asarray, jc),
                         {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                          for k, v in tc.items()}),
               "decode": []}
        for i in range(PREFILL, TOTAL):
            jl, jc = decode(jparams, jnp.asarray(toks[:, i:i + 1]), jc)
            tl, tc = tsteps.decode_step(tcfg, tparams,
                                        torch.from_numpy(toks[:, i:i + 1]), tc)
            out["decode"].append((np.asarray(jl, np.float32), _np(tl)))
        out["final_positions"] = (np.asarray(jc["kpl"]), tc["kpl"].clone())
        full = tlm.forward(tcfg, tparams, torch.from_numpy(toks))
    out["full"] = (np.asarray(jlm.forward(
        dataclasses.replace(jcfg, window_cache=False), jparams,
        jnp.asarray(toks)).logits, np.float32), _np(full.logits))
    return out


def test_windowed_prefill_logits_and_cache_match_reference(served):
    jl, tl = served["prefill"]
    assert rel_err(jl, tl) < REL_TOL
    jc, tc = served["cache"]
    assert tc["pos"] == int(jc["pos"]) == PREFILL
    for key in RING_LEAVES:
        j, t = jc[key], tc[key]
        assert tuple(t.shape) == j.shape, key
        if j.dtype == np.int32:      # the slots' positions: exactly
            assert np.array_equal(j, _bits(t)), key
            continue
        assert t.dtype == torch.bfloat16
        for layer in np.ndindex(j.shape[:-4]):
            assert rel_err(j[layer], t[layer]) < REL_TOL, (key, layer)
    # ring of 8 after 20 tokens: slot j holds position 16 + (j - 16) % 8
    assert _bits(tc["kpl"])[0, 0, 0].tolist() == [16, 17, 18, 19, 12, 13,
                                                  14, 15]
    # the global layers' caches hold the prompt, nothing past it
    assert not _np(tc["kg"])[:, :, :, PREFILL:].any()


def test_windowed_teacher_forced_decode_matches_reference(served):
    """Every decode step's logits through a ring that wraps (positions 20
    to 27 overwrite slots 4 to 7, then 0 to 3), and the final positions."""
    assert len(served["decode"]) == TOTAL - PREFILL
    for step, (jl, tl) in enumerate(served["decode"]):
        assert rel_err(jl, tl) < REL_TOL, step
    jp, tp = served["final_positions"]
    assert np.array_equal(jp, _bits(tp))
    assert sorted(_bits(tp)[0, 0, 0].tolist()) == list(range(20, 28))


def test_windowed_no_cache_forward_matches_reference(served):
    """The uniform stack with per-layer windows (no cache): the oracle the
    ring path is held against, in both packages."""
    jl, tl = served["full"]
    assert tl.shape == (B, TOTAL, served["cfgs"][0].vocab_size)
    assert rel_err(jl, tl) < REL_TOL


def test_ring_decode_matches_the_ports_own_no_cache_forward(served):
    """The twin of ``test_gemma3_ring_window_cache``: the port's ring-cache
    prefill and decode against its own uniform no-cache forward, every
    step, at 3e-2 of the forward's max |logit|."""
    _, full = served["full"]
    scale = np.abs(full).max() + 1e-9
    errs = [np.abs(served["prefill"][1] - full[:, PREFILL - 1]).max()]
    for step, (_, tl) in enumerate(served["decode"]):
        errs.append(np.abs(tl - full[:, PREFILL + step]).max())
    assert max(errs) < REL_TOL * scale, errs


# ------------------------------------------------------------ head_dim 256
D256_CASES = [  # tests/test_kernels.py's cases at head_dim 256
    (2, 128, 128, 4, 2, 256, True, 0, 0),
    (1, 256, 256, 8, 8, 256, True, 0, 0),
    (2, 128, 128, 4, 4, 256, True, 16, 0),
    (1, 64, 128, 4, 2, 256, True, 0, 64),
    (2, 128, 128, 2, 1, 256, False, 0, 0),
    (1, 512, 512, 2, 2, 256, True, 128, 0),
]


@pytest.mark.parametrize("case", D256_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_at_head_dim_256_matches_reference_oracle(case, dtype):
    bq, sq, sk, h, kvh, d, causal, window, qoff = case
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((bq, sq, h, d), (bq, sk, kvh, d), (bq, sk, kvh, d))]
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    qj, kj, vj = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    out = tfa_ops.flash_attention(q, k, v, qoff, causal=causal, window=window)
    exp = fa_ref.attention_ref(qj, kj, vj, qoff, causal=causal, window=window)
    assert out.dtype == q.dtype and d in tfa_ops.HEAD_DIMS
    np.testing.assert_allclose(_np(out), _np(exp), atol=FLASH_TOL[dtype])


# ------------------------------------------------------------ wiring
def test_without_window_cache_the_uniform_cache_and_stack_serve(monkeypatch):
    """``window_cache=False`` keeps the uniform (layers, B, S, KV, D) cache
    and ``_attn_stack`` with per-layer windows; ``window_cache=True`` with
    a cache takes ``_windowed_stack``, and without one ``_attn_stack``."""
    _, tcfg = _cfgs("reduced")
    params = tregistry.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(tcfg, (B, 6)))
    taken = []
    for name in ("_attn_stack", "_windowed_stack"):
        real = getattr(tlm, name)
        monkeypatch.setattr(tlm, name, lambda *a, _n=name, _f=real:
                            taken.append(_n) or _f(*a))
    uniform = dataclasses.replace(tcfg, window_cache=False)
    cache = tregistry.init_cache(uniform, B, 8, "cpu")
    assert set(cache) == {"k", "v", "pos"}
    assert tuple(cache["k"].shape) == (4, B, 8, 2, 32)
    tlm.forward(uniform, params, toks, cache=cache)
    tlm.forward(tcfg, params, toks, cache=tregistry.init_cache(tcfg, B, 8,
                                                               "cpu"))
    tlm.forward(tcfg, params, toks)
    assert taken == ["_attn_stack", "_windowed_stack", "_attn_stack"]


def test_serve_cli_runs_reduced_gemma3_on_cpu(capsys):
    serve.main(["--arch", "gemma3-4b", "--device", "cpu", "--batch", "2",
                "--prompt-len", "12", "--gen-tokens", "6"])
    out = capsys.readouterr().out
    assert "arch=gemma3-4b-smoke" in out and "attn_impl=flash" in out
    assert "first sequence:" in out
