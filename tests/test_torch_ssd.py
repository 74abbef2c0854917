"""The port's SSD path (kernel wrapper, Mamba-2 block, ssm LM) vs the JAX
package's, on the CPU at reduced size.

Kernel level: the plain chunk version (what the CUDA kernel computes, and
what the wrapper takes for CPU tensors) against ``ssd_chunk_pallas`` in
interpret mode, and the full ``ops.ssd`` against the reference ``ops.ssd``
and the sequential oracle ``ssd_ref``, at the reference's ``SSD_CASES``
plus a ragged S, with and without an initial state. Tolerance:
1e-4·max|y| and 1e-4·max(max|h|, 1), the reference's own
(``tests/test_kernels.py``), on fp32 inputs.

Block and model level: ``ssm_block`` in both ``use_kernel`` branches
against the reference's, and reduced mamba2-130m (4 layers, d_model 128,
SSMCfg 16/16/chunk 8, vocab 512) forward, prefill caches, teacher-forced
decode and ``serve.run`` tokens. Both packages run in bf16, so the
tolerance is a relative 3e-2, as ``tests/test_torch_model.py`` states.
Weights come from the port's seeded ``init`` and cross to JAX bit for bit
(``tests/test_torch_model.py`` checks the other direction,
``convert.params_from_numpy``, for mamba2 too); inputs are numpy from a
seed.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.kernels.ssd import ops as jssd_ops, ref as jssd_ref
from repro.kernels.ssd.ssd import ssd_chunk_pallas
from repro.models import lm as jlm, ssd as jssd
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.data import synth as tsynth
from repro_torch.kernels.ssd import ops as tssd_ops, ref as tssd_ref
from repro_torch.launch import serve
from repro_torch.models import convert, lm as tlm, registry as tregistry
from repro_torch.models import ssd as tssd
from repro_torch.models.params import tree_map
from repro_torch.train import steps as tsteps

from test_torch_serve import (_reference_serve, _teacher_forced_logits,
                              assert_every_step_and_clear_tokens_match)

REL_TOL = 3e-2
ARCH = "mamba2-130m"
B, S, N_DECODE = 2, 12, 8        # S = 12 is not a multiple of the chunk 8
SSD_CASES = [
    # b, S, H, P, N, chunk (tests/test_kernels.py's cases, then a ragged S)
    (2, 64, 3, 16, 32, 16),
    (1, 128, 4, 32, 16, 32),
    (2, 48, 2, 16, 8, 16),
    (1, 96, 8, 8, 8, 32),
    (2, 50, 2, 16, 8, 16),
]


def rel_err(ref, out) -> float:
    ref, out = _np(ref), _np(out)
    return float(np.max(np.abs(ref - out)) / (np.max(np.abs(ref)) + 1e-9))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pair(a: np.ndarray, dtype: str = "float32"):
    """One fp32 numpy array as a JAX and a torch array of ``dtype`` (both
    round fp32 → bf16 to nearest even: the same bits)."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _ssd_inputs(case, seed=0, dtype="float32"):
    """(x, dt, a, B, C, h0) as (jax, torch) pairs: the reference test's
    distributions, drawn with numpy."""
    b, S, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((b, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, S, N)) * 0.5).astype(np.float32)
    h0 = rng.standard_normal((b, H, P, N)).astype(np.float32)
    return (_pair(x, dtype), _pair(dt), _pair(a), _pair(Bm, dtype),
            _pair(Cm, dtype), _pair(h0))


def _assert_y_h(y, h, y_exp, h_exp):
    y, h, y_exp, h_exp = map(_np, (y, h, y_exp, h_exp))
    assert y.shape == y_exp.shape and h.shape == h_exp.shape
    np.testing.assert_allclose(y, y_exp, atol=1e-4 * (np.abs(y_exp).max() + 1e-6))
    np.testing.assert_allclose(h, h_exp,
                               atol=1e-4 * max(np.abs(h_exp).max(), 1.0))


# ------------------------------------------------------------------ kernel
@pytest.mark.parametrize("case", [c for c in SSD_CASES if c[1] % c[5] == 0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_plain_matches_reference_pallas_interpret(case, dtype):
    """What the CUDA kernel computes, cell for cell, vs the TPU kernel."""
    L = case[5]
    (xj, xt), (dtj, dtt), (aj, at), (Bj, Bt), (Cj, Ct), _ = _ssd_inputs(
        case, dtype=dtype)
    b, S, H = dtt.shape
    cs = np.cumsum((dtt * at).reshape(b, S // L, L, H).numpy(), axis=2,
                   dtype=np.float32).reshape(b, S, H)
    csj, cst = _pair(cs)
    y_exp, st_exp = ssd_chunk_pallas(xj, dtj, csj, Bj, Cj, chunk=L,
                                     interpret=True)
    y, st = tssd_ops.ssd_chunk(xt, dtt, cst, Bt, Ct, chunk=L)
    assert y.dtype == st.dtype == torch.float32
    _assert_y_h(y, st, y_exp, st_exp)
    y2, st2 = tssd_ref.ssd_chunk_ref(xt, dtt, cst, Bt, Ct, chunk=L)
    assert torch.equal(y, y2) and torch.equal(st, st2)   # CPU: the plain version


def test_ssd_chunk_plain_never_multiplies_the_overflowing_half():
    """A 128-long chunk whose cumulative log-decay falls to ~-240 (the JAX
    init's a = -e, dt ~ 0.7): exp(cs_i - cs_j) is inf for j > i, and the
    result must still be finite."""
    rng = np.random.default_rng(1)
    b, L, H, P, N = 1, 128, 2, 8, 8
    x = torch.from_numpy(rng.standard_normal((b, L, H, P)).astype(np.float32))
    dt = torch.full((b, L, H), 0.7)
    cs = torch.cumsum(dt * -np.e, dim=1)
    Bm = torch.from_numpy(rng.standard_normal((b, L, N)).astype(np.float32))
    assert bool(torch.isinf(torch.exp(cs[0, 0] - cs[0, -1])).all())
    y, st = tssd_ops.ssd_chunk(x, dt, cs, Bm, Bm, chunk=L)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())


# ------------------------------------------------------------------ routes
@pytest.mark.parametrize("case", [
    # dtype, chunk, d_state, head_dim -> kernel
    ("bfloat16", 128, 128, 64, "tc"),    # mamba2-130m serving
    ("bfloat16", 128, 16, 64, "tc"),     # jamba's SSMCfg
    ("bfloat16", 64, 48, 32, "tc"),
    ("float32", 128, 128, 64, "simt"),   # the tensor cores cannot hold 1e-4
    ("bfloat16", 32, 16, 32, "simt"),    # chunk not 64 or 128
    ("bfloat16", 16, 32, 16, "simt"),
    ("bfloat16", 128, 8, 64, "simt"),    # d_state not a multiple of 16
    ("bfloat16", 128, 128, 8, "simt"),   # head_dim not a multiple of 16
    ("bfloat16", 8, 16, 16, "simt"),     # the reduced mamba2 config
], ids=str)
def test_ssd_route_picks_the_tensor_core_kernel_by_dtype_and_shape(case):
    dtype, chunk, n, p, want = case
    assert tssd_ops.route(getattr(torch, dtype), chunk, n, p) == want


@pytest.mark.parametrize("case", [
    # batch, chunks, heads, SMs -> heads per block
    ((4, 4, 24, 132), 3),      # serving: 16 cells x 8 groups = 128 blocks
    ((1, 2, 4, 132), 1),       # few cells: a block per head
    ((4, 8, 10, 132), 3),      # 32 cells x 4 groups, the last of 1 head
    ((8, 16, 5, 132), 5),      # 128 cells: one block a cell
    ((50, 10, 24, 132), 8),    # more cells than SMs: at most 8 a block
], ids=str)
def test_ssd_head_group_fills_about_one_wave(case):
    (b, nc, h, sms), want = case
    g = tssd_ops.head_group(b, nc, h, sms)
    assert g == want and 1 <= g <= tssd_ops.MAX_GROUP
    blocks = b * nc * -(-h // g)
    assert blocks <= sms or g == min(h, tssd_ops.MAX_GROUP)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_plain_path_counts_no_kernel_launch(dtype):
    """On CPU tensors the wrapper takes the plain version: neither count
    moves, whichever kernel the dtype and shape would route to."""
    case = (1, 256, 4, 64, 16, 128)
    (_, xt), (_, dtt), (_, at), (_, Bt), (_, Ct), _ = _ssd_inputs(case, dtype=dtype)
    cs = torch.cumsum((dtt * at).reshape(1, 2, 128, 4), 2).reshape(1, 256, 4)
    before = (tssd_ops.ssd.launches, tssd_ops.ssd.launches_tc)
    tssd_ops.ssd_chunk(xt, dtt, cs, Bt, Ct, chunk=128)
    assert (tssd_ops.ssd.launches, tssd_ops.ssd.launches_tc) == before


def test_split_bf16_products_hold_the_reference_tolerance():
    """The tensor-core kernel's arithmetic in plain torch at jamba's widths:
    bf16 x, B, C; C Bᵀ exact in fp32; W and X ∘ dte split into bf16 hi +
    lo halves, each product exact in fp32. It holds the reference's 1e-4
    tolerance, which plain bf16 W does not."""
    case = (1, 256, 4, 64, 16, 128)
    b, S, H, P, N, L = case
    (_, xt), (_, dtt), (_, at), (_, Bt), (_, Ct), _ = _ssd_inputs(
        case, seed=3, dtype="bfloat16")
    cs = torch.cumsum((dtt * at).reshape(b, S // L, L, H), 2).reshape(b, S, H)
    y_exp, st_exp = tssd_ref.ssd_chunk_ref(xt, dtt, cs, Bt, Ct, chunk=L)

    def split(t):
        hi = t.bfloat16().float()
        return hi, (t - hi).bfloat16().float()

    nc = S // L
    x = xt.float().reshape(b, nc, L, H, P)
    dtc, csc = dtt.reshape(b, nc, L, H), cs.reshape(b, nc, L, H)
    Bc, Cc = Bt.float().reshape(b, nc, L, N), Ct.float().reshape(b, nc, L, N)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None]
    causal = torch.ones(L, L, dtype=torch.bool).tril()[..., None]
    arg = torch.where(causal, csc[:, :, :, None] - csc[:, :, None], -torch.inf)
    w = cb * torch.exp(arg) * dtc[:, :, None]
    dte = dtc * torch.exp(csc[:, :, -1:] - csc)
    y, st = 0, 0
    for part in split(w):
        y = y + torch.einsum("bcijh,bcjhp->bcihp", part, x)
    for part in split(x * dte[..., None]):
        st = st + torch.einsum("bcln,bclhp->bchnp", Bc, part)
    _assert_y_h(y.reshape(b, S, H, P), st, y_exp, st_exp)
    y_plain = torch.einsum("bcijh,bcjhp->bcihp", w.bfloat16().float(), x)
    assert float((y_plain.reshape(b, S, H, P) - y_exp).abs().max()) > \
        1e-4 * float(y_exp.abs().max())


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_matches_reference_ops_and_sequential_oracle(case):
    (xj, xt), (dtj, dtt), (aj, at), (Bj, Bt), (Cj, Ct), _ = _ssd_inputs(case)
    y, h = tssd_ops.ssd(xt, dtt, at, Bt, Ct, chunk=case[5])
    assert y.shape == xt.shape and y.dtype == h.dtype == torch.float32
    _assert_y_h(y, h, *jssd_ops.ssd(xj, dtj, aj, Bj, Cj, chunk=case[5]))
    _assert_y_h(y, h, *jssd_ref.ssd_ref(xj, dtj, aj, Bj, Cj))


@pytest.mark.parametrize("case", [SSD_CASES[0], SSD_CASES[-1]])
def test_ssd_respects_initial_state(case):
    (xj, xt), (dtj, dtt), (aj, at), (Bj, Bt), (Cj, Ct), (h0j, h0t) = \
        _ssd_inputs(case, seed=2)
    y, h = tssd_ops.ssd(xt, dtt, at, Bt, Ct, chunk=case[5], h0=h0t)
    _assert_y_h(y, h, *jssd_ref.ssd_ref(xj, dtj, aj, Bj, Cj, h0=h0j))
    _assert_y_h(y, h, *jssd_ops.ssd(xj, dtj, aj, Bj, Cj, chunk=case[5],
                                    h0=h0j))


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_sequential_oracle_matches_reference_oracle(with_h0):
    (xj, xt), (dtj, dtt), (aj, at), (Bj, Bt), (Cj, Ct), (h0j, h0t) = \
        _ssd_inputs(SSD_CASES[2], seed=3)
    y, h = tssd_ref.ssd_ref(xt, dtt, at, Bt, Ct,
                            h0=h0t if with_h0 else None)
    _assert_y_h(y, h, *jssd_ref.ssd_ref(xj, dtj, aj, Bj, Cj,
                                        h0=h0j if with_h0 else None))


# ------------------------------------------------------------------ block parts
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_reference_matches_reference(dtype):
    case = SSD_CASES[-1]
    (xj, xt), (dtj, dtt), (aj, at), (Bj, Bt), (Cj, Ct), (h0j, h0t) = \
        _ssd_inputs(case, seed=4, dtype=dtype)
    y, h = tssd.ssd_scan_reference(xt, dtt, at, Bt, Ct, case[5], h0=h0t)
    y_exp, h_exp = jssd.ssd_scan_reference(xj, dtj, aj, Bj, Cj, case[5],
                                           h0=h0j)
    assert str(y.dtype).removeprefix("torch.") == np.dtype(y_exp.dtype).name
    if dtype == "float32":
        _assert_y_h(y, h, y_exp, h_exp)
    else:
        assert rel_err(y_exp, y) < REL_TOL and rel_err(h_exp, h) < REL_TOL


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(5)
    xbc = rng.standard_normal((2, 7, 24)).astype(np.float32)
    w = (rng.standard_normal((4, 24)) * 0.5).astype(np.float32)
    bias = (rng.standard_normal(24) * 0.1).astype(np.float32)
    state = rng.standard_normal((2, 3, 24)).astype(np.float32)
    pairs = [_pair(a, "bfloat16") for a in (xbc, w, bias, state)]
    (xj, xt), (wj, wt), (bj, bt), (sj, st) = pairs
    out, new = tssd._causal_conv(xt, wt, bt, st if with_state else None)
    out_exp, new_exp = jssd._causal_conv(xj, wj, bj, sj if with_state else None)
    assert out.dtype == new.dtype == torch.bfloat16
    assert rel_err(out_exp, out) < REL_TOL
    assert np.array_equal(_np(new), _np(new_exp))    # a copy of the inputs


def test_ssd_decode_step_matches_reference():
    (xj, xt), (dtj, dtt), (aj, at), (Bj, Bt), (Cj, Ct), (hj, ht) = \
        _ssd_inputs((2, 1, 3, 8, 16, 8), seed=6)
    y, h = tssd.ssd_decode_step(xt[:, 0], dtt[:, 0], at, Bt[:, 0], Ct[:, 0], ht)
    y_exp, h_exp = jssd.ssd_decode_step(xj[:, 0], dtj[:, 0], aj, Bj[:, 0],
                                        Cj[:, 0], hj)
    _assert_y_h(y, h, y_exp, h_exp)


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def mamba():
    """(reference cfg, port cfg, reference params, port params) — the same
    weights on both sides, drawn by the port's seeded ``init`` and carried
    to JAX bit for bit. (The reference ``init`` folds ``hash(str)`` of each
    leaf's path into its key, so its weights change with the process's hash
    seed; the greedy-token test needs the same weights in every run.)"""
    jcfg = jconfigs.reduced(jconfigs.get(ARCH))
    tcfg = tconfigs.reduced(tconfigs.get(ARCH))
    tparams = tregistry.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    jparams = tree_map(lambda t: jnp.asarray(
        t.float().numpy(), getattr(jnp, str(t.dtype).removeprefix("torch."))),
        tparams)
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("mode", ["prefill", "prefill_zero_state", "decode"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_block_matches_reference(mamba, mode, use_kernel):
    jcfg, tcfg, jparams, tparams = mamba
    jp = jax.tree_util.tree_map(lambda t: t[1], jparams["blocks"]["ssm"])
    tp = tree_map(lambda t: t[1], tparams["blocks"]["ssm"])
    rng = np.random.default_rng(7)
    s = 1 if mode == "decode" else S
    x = (rng.standard_normal((B, s, jcfg.d_model)) * 0.5).astype(np.float32)
    conv, h = jssd.init_ssm_state(jcfg, jcfg.ssm, B)
    if mode == "decode":    # a live state, as after a prefill
        conv = jnp.asarray(rng.standard_normal(conv.shape), jnp.bfloat16)
        h = jnp.asarray(rng.standard_normal(h.shape) * 0.1, jnp.float32)
    jstate = None if mode == "prefill" else (conv, h)
    tstate = None if jstate is None else tuple(
        convert.tensor_from_numpy(np.asarray(t)) for t in jstate)
    xj, xt = _pair(x, "bfloat16")
    out_exp, (conv_exp, h_exp) = jssd.ssm_block(
        jcfg, jcfg.ssm, jp, xj, jstate, use_kernel=use_kernel)
    out, (conv_new, h_new) = tssd.ssm_block(
        tcfg, tcfg.ssm, tp, xt, tstate, use_kernel=use_kernel)
    assert out.dtype == torch.bfloat16 and out.shape == xt.shape
    assert conv_new.dtype == torch.bfloat16 and h_new.dtype == torch.float32
    assert rel_err(out_exp, out) < REL_TOL
    assert rel_err(conv_exp, conv_new) < REL_TOL
    assert rel_err(h_exp, h_new) < REL_TOL


def test_forward_logits_match_reference(mamba):
    jcfg, tcfg, jparams, tparams = mamba
    toks = _tokens(jcfg, (B, 16))
    exp = jlm.forward(jcfg, jparams, jnp.asarray(toks)).logits
    out = tlm.forward(tcfg, tparams, torch.from_numpy(toks)).logits
    assert tuple(out.shape) == (B, 16, jcfg.vocab_size)
    assert rel_err(exp, out) < REL_TOL


@pytest.fixture(scope="module")
def served(mamba):
    """Reference and port prefill of S tokens, then N_DECODE teacher-forced
    decode steps on the same numpy tokens."""
    jcfg, tcfg, jparams, tparams = mamba
    toks = _tokens(jcfg, (B, S + N_DECODE), seed=7)
    max_len = S + N_DECODE
    prefill = jax.jit(lambda p, b: jsteps.prefill_step(jcfg, p, b,
                                                      max_len=max_len))
    decode = jax.jit(lambda p, t, c: jsteps.decode_step(jcfg, p, t, c))
    jl, jc = prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tc = tsteps.prefill_step(tcfg, tparams,
                                 {"tokens": torch.from_numpy(toks[:, :S])},
                                 max_len=max_len)
    out = {"prefill": (_np(jl), _np(tl)),
           "cache": (jax.tree_util.tree_map(np.asarray, jc),
                     {"conv": tc["conv"].clone(), "h": tc["h"].clone(),
                      "pos": tc["pos"]}),
           "decode": []}
    for i in range(S, S + N_DECODE):
        jl, jc = decode(jparams, jnp.asarray(toks[:, i:i + 1]), jc)
        tl, tc = tsteps.decode_step(tcfg, tparams,
                                    torch.from_numpy(toks[:, i:i + 1]), tc)
        out["decode"].append((_np(jl), _np(tl)))
    return out


def test_init_cache_matches_reference_shapes(mamba):
    jcfg, tcfg, _, _ = mamba
    jc = jlm.init_cache(jcfg, B, 20)
    tc = tregistry.init_cache(tcfg, B, 20, "cpu")
    assert tc["pos"] == 0
    for key in ("conv", "h"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert str(tc[key].dtype).removeprefix("torch.") == jc[key].dtype.name
        assert not tc[key].any()


def test_prefill_last_logits_and_cache_match_reference(served):
    jl, tl = served["prefill"]
    assert rel_err(jl, tl) < REL_TOL
    jc, tc = served["cache"]
    assert tc["pos"] == int(jc["pos"]) == S
    for key, dtype in (("conv", torch.bfloat16), ("h", torch.float32)):
        assert tuple(tc[key].shape) == jc[key].shape
        assert tc[key].dtype == dtype
        for layer in range(jc[key].shape[0]):
            assert rel_err(jc[key][layer], tc[key][layer]) < REL_TOL


def test_teacher_forced_decode_logits_match_reference(served):
    assert len(served["decode"]) == N_DECODE
    for step, (jl, tl) in enumerate(served["decode"]):
        assert rel_err(jl, tl) < REL_TOL, step


def test_greedy_tokens_match_where_the_reference_margin_is_clear(served):
    checked = 0
    for jl, tl in [served["prefill"]] + served["decode"]:
        top2 = np.sort(jl, -1)[:, -2:]
        margin = (top2[:, 1] - top2[:, 0]) / np.max(np.abs(jl), -1)
        clear = margin > REL_TOL
        assert np.array_equal(jl.argmax(-1)[clear], tl.argmax(-1)[clear])
        checked += int(clear.sum())
    assert checked > 0


def test_port_prefill_decode_consistent_with_forward(mamba):
    _, tcfg, _, tparams = mamba
    toks = torch.from_numpy(_tokens(tcfg, (B, 16), seed=8))
    full = tlm.forward(tcfg, tparams, toks)
    cache = tregistry.init_cache(tcfg, B, 20, "cpu")
    pre = tlm.forward(tcfg, tparams, toks[:, :13], cache=cache)
    out = [pre.logits[:, -1]]
    c = pre.cache
    for i in range(13, 16):
        dec = tlm.forward(tcfg, tparams, toks[:, i:i + 1], cache=c)
        out.append(dec.logits[:, 0])
        c = dec.cache
    assert c["pos"] == 16 and c["conv"] is cache["conv"]   # written in place
    for k, t in enumerate(out):
        assert rel_err(full.logits[:, 12 + k], t) < REL_TOL, k


def test_serve_run_on_cpu_gives_the_reference_tokens(mamba):
    """As ``test_torch_serve.py``'s dense case: every step's logits,
    teacher-forced on the reference's tokens, agree with the reference's;
    per sequence, tokens agree up to the first step where the reference's
    top-1/top-2 gap is within the tolerance."""
    jcfg, tcfg, jparams, tparams = mamba
    b, s, gen = 8, 20, 10
    prompts = tsynth.lm_tokens(0, b * s + 1, jcfg.vocab_size)[:b * s].reshape(b, s)
    ref_tokens, ref_logits = _reference_serve(jcfg, jparams, prompts, gen)
    res = serve.run(tcfg, tparams, prompts, gen, device="cpu")
    assert res.tokens.shape == (b, gen) and res.tokens.dtype == torch.int32
    forced = _teacher_forced_logits(tcfg, tparams, prompts, ref_tokens,
                                    s + gen)
    assert_every_step_and_clear_tokens_match(ref_tokens, ref_logits, forced,
                                             res.tokens.numpy())
    assert rel_err(ref_logits[:, 0], res.prefill_logits) < REL_TOL
