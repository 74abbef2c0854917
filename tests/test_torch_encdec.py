"""The port's audio family (whisper-medium's encoder-decoder) vs the JAX
package's, on the CPU at reduced size (2 + 2 layers, d_model 128, head_dim
32, qkv bias, ``cross_len`` 16).

Weights come from the reference ``registry.init`` and cross through
``convert.params_from_numpy`` in this process; inputs (frames, tokens) are
numpy from a seed, fed to both packages as the same bf16 values.

The port runs ``attn_impl="flash"`` where it serves (on the CPU the
wrapper takes its plain version); the reference runs its default
``"chunked"`` path, because its own flash path breaks at batch > 1
(``layers.py`` passes (B,) offsets that ``flash_attention.py:135``
reshapes to (1,)).

Tolerances, each stated where it is used:
- ``cross_attn_block`` alone in fp32: 1e-5 of max |out| (XLA and torch
  sum in other orders);
- encoder states, logits and every KV cache leaf: 3e-2 of the reference's
  max |value|, as ``tests/test_smoke_archs.py::test_prefill_decode_consistency``
  holds the reference's own (both packages run bf16 and round it at other
  places);
- training as ``tests/test_torch_train.py`` holds it: the fp32 loss of
  bf16 logits at 1e-4, the grad norm at 2e-3, the step's update element
  by element in units of its lr, and each leaf's moments after the step:
  the first at 6e-2 of its max, the second at twice that. The moments'
  bound is the measured floor's: ``tests/torch_twin_tolerance.py`` reads
  the reference against itself (attention ``"reference"`` against
  ``"chunked"``) at up to 3.86e-2 in the first moment and 7.16e-2 in the
  second over 200 salted inits, 3.89e-2 and 5.66e-2 over hash seeds 0–63,
  always at the encoder's attention biases, where 3e-2 failed the port in
  about one process in 30 (4.51e-2 at hash seed 23); the port reads 3.83e-2
  and 7.20e-2 salted, 4.51e-2 and 5.30e-2 over the hash seeds.

The reference's init draws other weights in every process (its leaf keys
hash strings), so no check may rest on a property of those weights. A
causal encoder moved the encoder states by 0.19–0.27 of max |state|, and
zero encoder states moved the logits by 0.39–0.71, under five hash seeds:
the tests that show the tolerance sees those faults ask for 3x the bound.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import encdec as jencdec, layers as jlayers
from repro.models import registry as jregistry
from repro.models.params import P as JP
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import serve
from repro_torch.models import (convert, encdec as tencdec, layers as tlayers,
                                lm as tlm, registry as tregistry)
from repro_torch.models.params import P as TP, tree_map
from repro_torch.train import steps as tsteps
from test_torch_hybrid import _flat, _jflat
from test_torch_moe_train import _assert_updates_close

NAME = "whisper-medium"
REL_TOL = 3e-2
CROSS_TOL = 1e-5
GRAD_RTOL = 3e-2       # bf16 gradients, relative to each leaf's max |g|
# the train step's first moments (v at twice it), relative to each leaf's
# max: the reference against itself reads up to 3.89e-2 at the encoder's
# attention biases (tests/torch_twin_tolerance.py; module docstring)
M_RTOL = 6e-2
LOSS_RTOL = 1e-4       # the fp32 loss of bf16 logits
GNORM_RTOL = 2e-3      # the fp32 norm over every bf16 gradient
B, S_ENC, PREFILL, TOTAL = 2, 16, 12, 18


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


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.fixture(scope="module")
def models():
    """(reference cfg, port cfg, reference params, port params) of the
    reduced whisper; the port serves through flash (its plain version on
    the CPU), the reference through its default "chunked" path."""
    jcfg = jconfigs.reduced(jconfigs.get(NAME))
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get(NAME)),
                               attn_impl="flash")
    jparams = jregistry.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _bf16(a: np.ndarray):
    """The same bf16 values for both packages."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, convert.tensor_from_numpy(np.asarray(j))


def _inputs(cfg, seq, seed=0, batch=B, s_enc=S_ENC):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    frames = rng.normal(size=(batch, s_enc, cfg.d_model)).astype(np.float32)
    return toks, frames


# -------------------------------------------------------------- structure
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_encdec_param_defs_match_reference_leaf_for_leaf(reduced):
    """Every leaf's path, shape, sharding axes, init, scale and dtype, at
    the reduced config and at whisper-medium's (24 + 24 layers, d 1024,
    vocab 51,865)."""
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
        assert (tp.shape, tp.axes, tp.init, tp.scale) == (
            jp.shape, jp.axes, jp.init, jp.scale), path
        assert str(tp.dtype).removeprefix("torch.") == \
            np.dtype(jp.dtype).name, path


def test_full_config_on_meta_matches_eval_shape():
    """whisper-medium's tree from the port's defs on ``meta`` against
    ``jax.eval_shape`` of the reference's init, leaf for leaf: ~1.0 B
    parameters."""
    jcfg, tcfg = jconfigs.get(NAME), tconfigs.get(NAME)
    jshapes = _jflat(jax.eval_shape(lambda: jregistry.init(
        jcfg, jax.random.PRNGKey(0))))
    tmeta = _flat(tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                                 device="meta"),
                           tregistry.param_defs(tcfg)))
    assert set(jshapes) == set(tmeta)
    for path, a in jshapes.items():
        assert tuple(tmeta[path].shape) == a.shape, path
        assert str(tmeta[path].dtype).removeprefix("torch.") == \
            np.dtype(a.dtype).name, path
    n = sum(t.numel() for t in tmeta.values())
    assert 1.0e9 < n < 1.1e9, n


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_encdec_init_cache_matches_reference(reduced):
    """K/V (dec_layers, B, max_len, KV, D) and ``enc_out`` (B, cross_len,
    d_model), bf16 zeros, and ``pos`` 0; the full config on ``meta``
    against ``jax.eval_shape``."""
    jcfg, tcfg = jconfigs.get(NAME), tconfigs.get(NAME)
    if reduced:
        jcfg, tcfg = jconfigs.reduced(jcfg), tconfigs.reduced(tcfg)
        jc = jax.tree_util.tree_map(np.asarray,
                                    jregistry.init_cache(jcfg, 3, 20))
        tc = tregistry.init_cache(tcfg, 3, 20, "cpu")
    else:
        jc = jax.eval_shape(lambda: jregistry.init_cache(jcfg, 4, 160))
        tc = tregistry.init_cache(tcfg, 4, 160, "meta")
    assert set(tc) == set(jc) == {"k", "v", "enc_out", "pos"}
    assert tc["pos"] == 0
    for key in ("k", "v", "enc_out"):
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert str(tc[key].dtype).removeprefix("torch.") == \
            np.dtype(jc[key].dtype).name, key
        if reduced:
            assert not tc[key].any() and not jc[key].any(), key
    if not reduced:
        assert tc["enc_out"].shape == (4, 1500, 1024)


def test_lm_refuses_the_audio_family_and_points_to_encdec():
    cfg = tconfigs.reduced(tconfigs.get(NAME))
    with pytest.raises(ValueError, match="models.encdec"):
        tlm.forward(cfg, {}, torch.zeros((1, 4), dtype=torch.int32))


# ------------------------------------------------------------------ layers
def test_cross_attn_block_matches_reference_in_fp32():
    """fp32 weights and inputs, queries over 7 positions against 20
    encoder states, with non-zero biases that both packages leave out:
    1e-5 of max |out|."""
    cfg = jconfigs.reduced(jconfigs.get(NAME))
    rng = np.random.default_rng(1)
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    p = {"wq": rng.normal(0, 0.1, (d, h, hd)), "wk": rng.normal(0, 0.1, (d, h, hd)),
         "wv": rng.normal(0, 0.1, (d, h, hd)), "wo": rng.normal(0, 0.1, (h, hd, d)),
         "bq": rng.normal(size=(h, hd)), "bk": rng.normal(size=(h, hd)),
         "bv": rng.normal(size=(h, hd))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 7, d)).astype(np.float32)
    enc = rng.normal(size=(2, 20, d)).astype(np.float32)
    want = np.asarray(jlayers.cross_attn_block(
        cfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(enc)))
    got = tlayers.cross_attn_block(
        cfg, {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x), torch.from_numpy(enc)).numpy()
    assert got.shape == want.shape == (2, 7, d)
    assert rel_err(want, got) < CROSS_TOL


# ----------------------------------------------------------------- encoder
@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("s_enc", [S_ENC, 23])
def test_encode_matches_reference(models, impl, s_enc):
    """The encoder states over 16 frames (``cross_len``) and a ragged 23,
    through the port's chunked attention and its flash path (the plain
    version on the CPU), against the reference's "chunked": 3e-2 of max
    |state|."""
    jcfg, tcfg, jparams, tparams = models
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    _, frames = _inputs(jcfg, 1, seed=2, s_enc=s_enc)
    jf, tf = _bf16(frames)
    want = np.asarray(jencdec.encode(jcfg, jparams, jf), np.float32)
    with torch.no_grad():
        got = tencdec.encode(tcfg, tparams, tf)
    assert got.dtype == torch.bfloat16
    assert got.shape == want.shape == (B, s_enc, jcfg.d_model)
    assert rel_err(want, _np(got)) < REL_TOL


def test_encoder_attends_over_every_frame(models, monkeypatch):
    """The encoder matches the reference, and a causal encoder moves its
    states past 3x the bound: the tolerance can see the fault."""
    jcfg, tcfg, jparams, tparams = models
    _, frames = _inputs(jcfg, 1, seed=3)
    jf, tf = _bf16(frames)
    want = np.asarray(jencdec.encode(jcfg, jparams, jf), np.float32)
    with torch.no_grad():
        got = _np(tencdec.encode(tcfg, tparams, tf))
        real = tlayers.attn_block
        monkeypatch.setattr(tlayers, "attn_block", lambda *a, **kw: real(
            *a, **dict(kw, causal=True)))
        causal = _np(tencdec.encode(tcfg, tparams, tf))
    assert rel_err(want, got) < REL_TOL
    assert rel_err(want, causal) > 3 * REL_TOL


# ----------------------------------------------------------------- decoder
def test_teacher_forced_decode_matches_reference(models):
    """``decode`` without a cache over 18 tokens, on the reference's
    encoder states (the same bf16 values): every position's logits at 3e-2
    of max |logit|; ``forward`` (encode, then decode) the same."""
    jcfg, tcfg, jparams, tparams = models
    toks, frames = _inputs(jcfg, TOTAL, seed=4)
    jf, tf = _bf16(frames)
    enc = jencdec.encode(jcfg, jparams, jf)
    want = jencdec.decode(jcfg, jparams, jnp.asarray(toks), enc)
    full = jencdec.forward(jcfg, jparams, jf, jnp.asarray(toks))
    with torch.no_grad():
        got = tencdec.decode(tcfg, tparams, torch.from_numpy(toks),
                             convert.tensor_from_numpy(np.asarray(enc)))
        fwd = tencdec.forward(tcfg, tparams, tf, torch.from_numpy(toks))
    assert got.cache is None
    assert got.logits.shape == want.logits.shape == (B, TOTAL, jcfg.vocab_size)
    assert rel_err(want.logits, _np(got.logits)) < REL_TOL
    assert rel_err(full.logits, _np(fwd.logits)) < REL_TOL
    assert float(fwd.aux_loss) == float(full.aux_loss) == 0.0


def test_decoder_reads_the_encoder(models):
    """The decoder matches the reference on its encoder states, and the
    same decode over zero encoder states moves the logits past 3x the
    bound: cross-attention reads ``enc_out``."""
    jcfg, tcfg, jparams, tparams = models
    toks, frames = _inputs(jcfg, PREFILL, seed=5)
    jf, _ = _bf16(frames)
    enc = jencdec.encode(jcfg, jparams, jf)
    want = jencdec.decode(jcfg, jparams, jnp.asarray(toks), enc).logits
    tenc = convert.tensor_from_numpy(np.asarray(enc))
    with torch.no_grad():
        got = tencdec.decode(tcfg, tparams, torch.from_numpy(toks), tenc)
        zero = tencdec.decode(tcfg, tparams, torch.from_numpy(toks),
                              torch.zeros_like(tenc))
    assert rel_err(want, _np(got.logits)) < REL_TOL
    assert rel_err(want, _np(zero.logits)) > 3 * REL_TOL


# -------------------------------------------------------- prefill + decode
@pytest.fixture(scope="module")
def served(models):
    """``prefill_step`` over PREFILL tokens and the frames, then
    teacher-forced ``decode_step`` to TOTAL, in both packages; the port's
    no-cache forward over all TOTAL tokens."""
    jcfg, tcfg, jparams, tparams = models
    toks, frames = _inputs(jcfg, TOTAL, seed=6)
    jf, tf = _bf16(frames)
    prefill = jax.jit(lambda p, b: jsteps.prefill_step(jcfg, p, b,
                                                      max_len=TOTAL))
    decode = jax.jit(lambda p, t, c: jsteps.decode_step(jcfg, p, t, c))
    jl, jc = prefill(jparams, {"tokens": jnp.asarray(toks[:, :PREFILL]),
                               "frames": jf})
    jsteps_ = [np.asarray(jl, np.float32)]
    for i in range(PREFILL, TOTAL):
        jl, jc = decode(jparams, jnp.asarray(toks[:, i:i + 1]), jc)
        jsteps_.append(np.asarray(jl, np.float32))
    with torch.inference_mode():
        tl, tc = tsteps.prefill_step(
            tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :PREFILL]),
                            "frames": tf}, max_len=TOTAL)
        tsteps_ = [_np(tl)]
        for i in range(PREFILL, TOTAL):
            tl, tc = tsteps.decode_step(tcfg, tparams,
                                        torch.from_numpy(toks[:, i:i + 1]), tc)
            tsteps_.append(_np(tl))
        full = tencdec.forward(tcfg, tparams, tf, torch.from_numpy(toks))
    return {"steps": list(zip(jsteps_, tsteps_)),
            "cache": (jax.tree_util.tree_map(np.asarray, jc), tc),
            "full": _np(full.logits)}


def test_encdec_prefill_and_teacher_forced_decode_match_reference(served):
    assert len(served["steps"]) == TOTAL - PREFILL + 1
    for step, (jl, tl) in enumerate(served["steps"]):
        assert rel_err(jl, tl) < REL_TOL, step


def test_encdec_cache_matches_reference(served):
    """Every cache leaf: K and V of each decoder layer, the encoder states
    the cache carries, and ``pos``."""
    jc, tc = served["cache"]
    assert set(tc) == set(jc) == {"k", "v", "enc_out", "pos"}
    assert tc["pos"] == int(jc["pos"]) == TOTAL
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        for layer in range(jc[key].shape[0]):
            assert rel_err(jc[key][layer], _np(tc[key][layer])) < REL_TOL
    assert tc["enc_out"].dtype == torch.bfloat16
    assert tuple(tc["enc_out"].shape) == jc["enc_out"].shape
    assert rel_err(jc["enc_out"], _np(tc["enc_out"])) < REL_TOL


def test_encdec_decode_consistent_with_forward(served):
    """Twin of ``tests/test_smoke_archs.py::test_prefill_decode_consistency``:
    each cached step against the no-cache forward at its position."""
    full = served["full"]
    for i, (_, tl) in enumerate(served["steps"]):
        assert rel_err(full[:, PREFILL - 1 + i], tl) < REL_TOL, i


# ---------------------------------------------------------------- training
def test_encdec_loss_fn_matches_reference(models):
    """The teacher-forced next-token loss with a loss mask, at 1e-4."""
    jcfg, tcfg, jparams, tparams = models
    tcfg = dataclasses.replace(tcfg, attn_impl="chunked")
    toks, frames = _inputs(jcfg, 16, seed=7)
    jf, tf = _bf16(frames)
    mask = np.ones(toks.shape, np.float32)
    mask[:, :3] = 0
    jl, jm = jsteps.loss_fn(jcfg, jparams, {"tokens": jnp.asarray(toks),
                                            "frames": jf,
                                            "loss_mask": jnp.asarray(mask)})
    with torch.no_grad():
        tl, tm = tsteps.loss_fn(tcfg, tparams, {
            "tokens": torch.from_numpy(toks), "frames": tf,
            "loss_mask": torch.from_numpy(mask)})
    assert rel_err(jl, float(tl)) < LOSS_RTOL
    assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0


def test_encdec_train_step_at_grad_accum_2_matches_reference():
    """One ``train_step`` at ``grad_accum`` 2 from the same state and batch
    (frames split into microbatches along B): loss and grad norm; the
    step's update of every leaf element by element in units of its lr
    (``_assert_updates_close``: an update skipped reads about 1, one of
    the wrong sign about 2); every leaf's moments, the first (0.1 x the
    clipped gradient) at M_RTOL of its max and the second at twice it, the
    measured floor's bound (module docstring). The cross-attention biases,
    which neither package adds, get zero gradients in both."""
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(NAME)),
                               grad_accum=2)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get(NAME)),
                               grad_accum=2)
    j0 = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0))
    t0 = convert.train_state_from_numpy(jax.tree_util.tree_map(np.asarray, j0))
    toks, frames = _inputs(jcfg, 16, seed=8, batch=4)
    jf, tf = _bf16(frames)
    j1, jmet = jax.jit(lambda s, b: jsteps.train_step(jcfg, s, b))(
        j0, {"tokens": jnp.asarray(toks), "frames": jf})
    t1, tmet = tsteps.train_step(
        tcfg, t0, {"tokens": torch.from_numpy(toks), "frames": tf})
    assert rel_err(jmet["loss"], _np(tmet["loss"])) < LOSS_RTOL
    assert rel_err(jmet["grad_norm"], _np(tmet["grad_norm"])) < GNORM_RTOL
    _assert_updates_close(j0, j1, t0, t1, float(jmet["lr"]), GRAD_RTOL, [])
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(j1.opt.m)[0]]
    for tree, tol in (("m", M_RTOL), ("v", 2 * M_RTOL)):
        for name, a, b in zip(names,
                              jax.tree_util.tree_leaves(getattr(j1.opt, tree)),
                              tree_leaves(getattr(t1.opt, tree))):
            if "xattn" in name and "'b" in name:
                assert not np.asarray(a).any() and not b.any(), (tree, name)
                continue
            assert float(b.abs().max()) > 0, (tree, name)
            err = rel_err(a, _np(b))
            assert err < tol, (tree, name, err, tol)


# ----------------------------------------------------------------- serving
def test_serve_run_feeds_the_frames_to_prefill_only(models, monkeypatch):
    """``serve.run`` encodes the frames once, in prefill; each decode step
    reads the encoder states from the cache. Its tokens are the greedy
    picks of the steps' logits."""
    _, tcfg, _, tparams = models
    toks, frames = _inputs(tcfg, PREFILL, seed=9)
    _, tf = _bf16(frames)
    encoded, decoded = [], []
    real_encode, real_decode = tencdec.encode, tencdec.decode

    def encode(cfg, params, frames):
        encoded.append(tuple(frames.shape))
        return real_encode(cfg, params, frames)

    def decode(cfg, params, tokens, enc_out, cache=None):
        decoded.append((tokens.shape[1], enc_out.data_ptr()))
        return real_decode(cfg, params, tokens, enc_out, cache)

    monkeypatch.setattr(tencdec, "encode", encode)
    monkeypatch.setattr(tencdec, "decode", decode)
    res = serve.run(tcfg, tparams, toks, 4, device="cpu", frames=tf)
    assert encoded == [(B, S_ENC, tcfg.d_model)]
    assert [s for s, _ in decoded] == [PREFILL, 1, 1, 1]
    assert len({ptr for _, ptr in decoded}) == 1
    assert tuple(res.tokens.shape) == (B, 4)
    assert torch.equal(res.tokens[:, 0],
                       res.prefill_logits.argmax(-1).to(torch.int32))
