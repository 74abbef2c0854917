"""Training the ssm family: the port's SSD backward and mamba2's train
step vs the JAX package's, on the CPU at small sizes.

Kernel level: ``ssd_chunk_bwd_ref`` (the hand-derived backward, what the
CUDA backward kernel computes and what the wrapper takes on the CPU)
against autograd of the forward's plain version ``ssd_chunk_ref``; then
the gradients of the whole ``ops.ssd`` (x, dt, a, B, C, h0, through
``SSDChunkFn``) against ``jax.vjp`` of the reference's sequential oracle
``repro.kernels.ssd.ref.ssd_ref`` at chunks 8, 32 and 128 with a ragged
S, and at chunks 8 and 32 of its chunked scan
``repro.models.ssd.ssd_scan_reference`` too. All in fp32, held relative to
each gradient's max |g|: 1e-5 where both sides compute one chunk's
function in another summation order, 1e-4 (the reference's own SSD
tolerance, ``tests/test_kernels.py``) where the sequential oracle's
recurrence over 150 steps is the yardstick.

A reference behaviour, recorded: at chunk 128 with the reference init's a
= -e and dt ~ 0.7, the reference's chunked scan takes exp of the masked
half of the decay (cs_i - cs_j ~ +240 for j > i, inf in fp32) and selects
after it, so its gradient is inf · 0 = NaN. The port masks the exponent
first (a stated divergence): the same forward, a finite gradient.

Model level, reduced mamba2-130m (4 layers, d_model 128, SSMCfg 16/16,
vocab 512): weights from the port's seeded ``init`` carried to JAX bit
for bit (the reference's own init follows the process's hash seed).
Both packages run the model in bf16, and the port's SSD runs in fp32
where the reference's chunked scan rounds W and X to bf16 before their
product. Two bf16 programs that differ only so disagree by 1-5% of a
leaf's max |g| at this size: over 3 weight seeds x 2 batches the
reference's chunked scan against its own sequential oracle reached 3.5%,
the port against the reference 3.2%, the port against the reference on
its oracle 5.1% (``dt_bias``). So gradients and first moments are held at
8e-2 of each leaf's max |g|, second moments (~g²) at twice that; a wiring
fault (a wrong sign or index in the backward) moves a gradient by O(1).
The loss is held at 2e-3 relative (measured up to 1.3e-4).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.kernels.ssd.ref import ssd_ref as jssd_ref
from repro.models import ssd as jssd
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.ssd import ops as tssd_ops, ref as tssd_ref
from repro_torch.launch import train as ttrain
from repro_torch.models import convert, registry as tregistry
from repro_torch.models import ssd as tssd
from repro_torch.models.params import tree_map
from repro_torch.train import steps as tsteps

ARCH = "mamba2-130m"
FORMULA_RTOL = 1e-5    # one chunk's function, another summation order (fp32)
ORACLE_RTOL = 1e-4     # vs the 150-step recurrence (the reference's SSD tol)
GRAD_RTOL = 8e-2       # bf16 gradients, relative to each leaf's max |g|
LOSS_RTOL = 2e-3       # the fp32 loss of bf16 logits, fp32 vs bf16 SSD products
GNORM_RTOL = 1e-2      # the fp32 norm over every bf16 gradient
CHUNK_CASES = [        # b, S, H, P, N, chunk: tests/test_kernels.py's cases,
    (2, 64, 3, 16, 32, 16),   # reduced mamba2, and jamba's and mamba2's chunk
    (1, 128, 4, 32, 16, 32),
    (2, 48, 2, 16, 8, 16),
    (1, 96, 8, 8, 8, 32),
    (2, 16, 16, 16, 16, 8),
    (1, 256, 2, 16, 16, 128),
]
GRADS = ("x", "dt", "a", "B", "C", "h0")
B, S_RAGGED = 2, 150           # S = 150 is ragged at chunks 8, 32 and 128


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test under xdist (the cores are shared)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(want, got) -> float:
    want, got = _np(want), _np(got)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _model_inputs(b, S, H, P, N, seed):
    """x, dt, a, B, C, h0 and the cotangents of (y, h_final), as numpy:
    dt = softplus(N(0, 0.55²)) and a = -e, as the reference init makes
    them (a_log = 1, dt_bias = 0), so a 128-long chunk decays to cs ~ -240
    and exp(cs_i - cs_j) overflows fp32 for j > i."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"x": rng.standard_normal((b, S, H, P)).astype(f),
            "dt": np.log1p(np.exp(0.55 * rng.standard_normal((b, S, H)))).astype(f),
            "a": np.full((H,), -np.e, f),
            "B": (0.5 * rng.standard_normal((b, S, N))).astype(f),
            "C": (0.5 * rng.standard_normal((b, S, N))).astype(f),
            "h0": (0.5 * rng.standard_normal((b, H, P, N))).astype(f),
            "gy": rng.standard_normal((b, S, H, P)).astype(f),
            "gh": rng.standard_normal((b, H, P, N)).astype(f)}


def _port_grads(fn, inp):
    """(y, h, {name: grad}) of ``fn(x, dt, a, B, C, h0)`` under the
    cotangents ``gy``, ``gh``, through torch.autograd."""
    leaves = {k: torch.from_numpy(inp[k]).requires_grad_() for k in GRADS}
    y, h = fn(*(leaves[k] for k in GRADS))
    grads = torch.autograd.grad(
        (y, h), [leaves[k] for k in GRADS],
        (torch.from_numpy(inp["gy"]), torch.from_numpy(inp["gh"])))
    return y.detach(), h.detach(), dict(zip(GRADS, grads))


def _reference_grads(fn, inp):
    """The same through ``jax.vjp`` of the reference ``fn``."""
    (y, h), vjp = jax.vjp(fn, *(jnp.asarray(inp[k]) for k in GRADS))
    grads = vjp((jnp.asarray(inp["gy"]), jnp.asarray(inp["gh"])))
    return y, h, dict(zip(GRADS, grads))


# ------------------------------------------------------------ the formula
@pytest.mark.parametrize("case", CHUNK_CASES, ids=str)
def test_ssd_chunk_bwd_ref_matches_autograd_of_masked_forward(case):
    b, S, H, P, N, L = case
    inp = _model_inputs(b, S, H, P, N, seed=1)
    x, dt, Bm, Cm = (torch.from_numpy(inp[k]) for k in ("x", "dt", "B", "C"))
    cs = torch.cumsum((dt * torch.from_numpy(inp["a"])).reshape(
        b, S // L, L, H), 2).reshape(b, S, H)
    if L == 128:   # the masked half overflows: the exponents reach ~+240
        assert float(cs.reshape(b, S // L, L, H)[:, :, -1].max()) < -150
    rng = np.random.default_rng(2)
    dy = torch.from_numpy(rng.standard_normal((b, S, H, P)).astype(np.float32))
    dst = torch.from_numpy(rng.standard_normal(
        (b, S // L, H, N, P)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (x, dt, cs, Bm, Cm)]
    y, st = tssd_ref.ssd_chunk_ref(*leaves, chunk=L)
    auto = torch.autograd.grad((y, st), leaves, (dy, dst))
    got = tssd_ref.ssd_chunk_bwd_ref(x, dt, cs, Bm, Cm, dy, dst, chunk=L)
    assert all(g.dtype == torch.float32 for g in got)
    for name, a, g in zip(("dx", "ddt", "dcs", "dB", "dC"), auto, got):
        assert bool(torch.isfinite(a).all()), name
        assert a.shape == g.shape, name
        assert rel_err(a, g) < FORMULA_RTOL, (name, rel_err(a, g))
    # the wrapper takes the plain version for CPU tensors, and counts none
    before = tssd_ops.ssd.launches_bwd
    wrapped = tssd_ops.ssd_chunk_bwd(x, dt, cs, Bm, Cm, dy, dst, chunk=L)
    assert all(torch.equal(u, v) for u, v in zip(got, wrapped))
    assert tssd_ops.ssd.launches_bwd == before


def test_ssd_chunk_fn_returns_gradients_in_the_inputs_dtypes():
    b, S, H, P, N, L = CHUNK_CASES[0]
    inp = _model_inputs(b, S, H, P, N, seed=3)
    x, Bm, Cm = (torch.from_numpy(inp[k]).bfloat16().requires_grad_()
                 for k in ("x", "B", "C"))
    dt = torch.from_numpy(inp["dt"]).requires_grad_()
    cs = torch.cumsum(dt.detach() * -np.e, 1).requires_grad_()
    y, st = tssd_ops.SSDChunkFn.apply(x, dt, cs, Bm, Cm, L)
    (y.sum() + st.sum()).backward()
    assert (x.grad.dtype, Bm.grad.dtype, Cm.grad.dtype) == (torch.bfloat16,) * 3
    assert dt.grad.dtype == cs.grad.dtype == torch.float32
    want = tssd_ref.ssd_chunk_ref(x, dt, cs, Bm, Cm, chunk=L)
    assert torch.equal(y, want[0]) and torch.equal(st, want[1])


# ------------------------------------- the tensor-core backward's plan
def test_ssd_bwd_route_sends_the_train_shapes_to_the_tensor_cores():
    """``bwd_route``: bf16 where the forward takes the tensor cores, but
    head_dim at most 64 at chunk 128 (a wider head's operands do not fit
    one block's shared memory there); fp32 and every other shape on the
    CUDA cores."""
    bf, f32 = torch.bfloat16, torch.float32
    assert tssd_ops.bwd_route(bf, 128, 128, 64) == "tc"     # mamba2's train shape
    assert tssd_ops.bwd_route(bf, 128, 16, 64) == "tc"      # jamba's
    assert tssd_ops.bwd_route(bf, 128, 48, 32) == "tc"      # N, P padded
    assert tssd_ops.bwd_route(bf, 64, 32, 128) == "tc"      # P 128 at L 64
    assert tssd_ops.bwd_route(bf, 64, 96, 80) == "tc"
    assert tssd_ops.bwd_route(bf, 128, 64, 128) == "simt"   # P 128 at L 128
    assert tssd_ops.bwd_route(bf, 128, 128, 80) == "simt"
    assert tssd_ops.bwd_route(f32, 128, 128, 64) == "simt"  # fp32 input
    assert tssd_ops.bwd_route(bf, 8, 16, 16) == "simt"      # reduced mamba2
    assert tssd_ops.bwd_route(bf, 32, 16, 32) == "simt"
    assert tssd_ops.bwd_route(bf, 128, 24, 64) == "simt"    # N not a multiple of 16
    for dtype in (bf, f32):
        for L in (8, 16, 32, 64, 128):
            for N in (8, 16, 24, 32, 64, 128):
                for P in (8, 16, 32, 64, 80, 128):
                    if tssd_ops.bwd_route(dtype, L, N, P) == "tc":
                        assert tssd_ops.route(dtype, L, N, P) == "tc"


def _split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An fp32 operand as the kernel feeds it to the tensor cores: bf16
    hi + lo (each held in fp32)."""
    hi = a.bfloat16().float()
    return hi, (a - hi).bfloat16().float()


def _tc_mm(a, b, exact_a=False, exact_b=False, lo=True):
    """a @ b as the tensor-core backward takes it: a bf16 operand (x, B, C)
    exact, an fp32 one split into hi + lo with lo·lo dropped; every product
    of two bf16 values is exact in fp32, summed in fp32. ``lo=False`` keeps
    the hi halves only (plain bf16 products)."""
    ah, al = (a, None) if exact_a else _split(a)
    bh, bl = (b, None) if exact_b else _split(b)
    out = ah @ bh
    if lo and bl is not None:
        out = out + ah @ bl
    if lo and al is not None:
        out = out + al @ bh
    return out


def _tc_bwd_cell(x, dt, cs, Bm, Cm, dy, dst, lo=True):
    """The tensor-core backward's arithmetic at one (batch row, chunk):
    x, dy (L, H, P), dt, cs (L, H), B, C (L, N), dst (H, N, P), every L x L
    matrix held transposed (rows j, columns i >= j) as the kernel holds it;
    returns dx (L, H, P), ddt, dcs (L, H), dB, dC (L, N)."""
    L, H, P = x.shape
    causal = torch.ones(L, L, dtype=torch.bool).triu()     # [j, i]: i >= j
    bc = Bm @ Cm.T                                          # B Cᵀ, exact
    dB = torch.zeros(L, Bm.shape[1])
    dcb = torch.zeros(L, L)
    dx, ddt, dcs = torch.empty(L, H, P), torch.empty(L, H), torch.empty(L, H)
    for h in range(H):
        c, d = cs[:, h], dt[:, h]
        seg = torch.exp(c[-1] - c)
        dte = d * seg
        e = torch.exp(torch.where(causal, c[None, :] - c[:, None],
                                  float("-inf")))           # E_ij at [j, i]
        bdst = _tc_mm(Bm, dst[h], exact_a=True, lo=lo)
        ddte = (x[:, h] * bdst).sum(1)
        dw = _tc_mm(x[:, h], dy[:, h].T, exact_a=True, lo=lo)   # dWᵀ = x dyᵀ
        q = dw * bc * e
        w = bc * e * d[:, None]
        dx[:, h] = dte[:, None] * bdst + _tc_mm(w, dy[:, h], lo=lo)
        rq = q.sum(1)
        ddt[:, h] = rq + ddte * seg
        dcs[:, h] = (q * d[:, None]).sum(0) - d * rq - ddte * dte
        dcs[-1, h] += (ddte * dte).sum()
        dB += dte[:, None] * _tc_mm(x[:, h], dst[h].T, exact_a=True, lo=lo)
        dcb += dw * e * d[:, None]
    dB += _tc_mm(dcb, Cm, exact_b=True, lo=lo)
    dC = _tc_mm(dcb.T, Bm, exact_b=True, lo=lo)
    return dx, ddt, dcs, dB, dC


def test_the_parts_cut_from_the_tensor_core_backward_find_their_places():
    """``launch/ssd_bwd_parts.py`` times the tensor-core backward with parts
    cut out of a copy of ``ssd.cu``: each cut still finds its text, once,
    inside the tensor-core backward, and changes nothing else."""
    from repro_torch.launch import ssd_bwd_parts as parts
    src = open(tssd_ops.SOURCE).read()
    start, end = src.index("namespace tcb {"), src.index("}  // namespace tcb")
    cuts = parts._cut_sources()
    assert list(cuts) == list(parts.CUTS)
    for name, text in cuts.items():
        for old, new in parts.CUTS[name]:
            assert src.count(old) == 1 and start < src.index(old) < end, name
            assert text.count(old) == (old in new), name
        assert text[:start] == src[:start], name
        assert text[-(len(src) - end):] == src[end:], name


@pytest.mark.parametrize("heads,d_state", [(24, 128), (128, 16)],
                         ids=["mamba2", "jamba"])
def test_tensor_core_backward_precision_plan_holds_the_bound(heads, d_state):
    """Split-bf16 products (lo·lo dropped, fp32 sums) at one (batch row,
    chunk) of mamba2's train cell (24 heads, P 64, N 128, L 128) and of
    jamba's (128 heads, N 16): every output within SSD_TOL = 1e-4 of its
    max |ref| of ``ssd_chunk_bwd_ref``, on inputs drawn as
    ``chip_smoke.ssd_inputs`` draws them (cs reaches ~ -240). Plain bf16
    products (the hi halves only) miss the bound, so the lo terms are
    needed."""
    L, P, tol = 128, 64, 1e-4
    rng = np.random.default_rng(27)
    f = np.float32
    bf16 = lambda a: torch.from_numpy(a).bfloat16().float()   # noqa: E731
    x = bf16(rng.standard_normal((L, heads, P)).astype(f))
    dt = torch.from_numpy(np.log1p(np.exp(
        0.55 * rng.standard_normal((L, heads)))).astype(f))
    Bm = bf16((0.5 * rng.standard_normal((L, d_state))).astype(f))
    Cm = bf16((0.5 * rng.standard_normal((L, d_state))).astype(f))
    dy = torch.from_numpy(rng.standard_normal((L, heads, P)).astype(f))
    dst = torch.from_numpy(rng.standard_normal((heads, d_state, P)).astype(f))
    cs = torch.cumsum(dt * -np.e, 0)
    assert float(cs[-1].max()) < -150
    want = tssd_ref.ssd_chunk_bwd_ref(
        x[None], dt[None], cs[None], Bm[None], Cm[None], dy[None],
        dst[None, None], chunk=L)
    names = ("dx", "ddt", "dcs", "dB", "dC")
    for lo in (True, False):
        got = _tc_bwd_cell(x, dt, cs, Bm, Cm, dy, dst, lo=lo)
        errs = {k: rel_err(w[0], g) for k, w, g in zip(names, want, got)}
        worst = max(errs.values())
        print(f"{'split' if lo else 'plain'} bf16 products, {heads} heads, "
              f"N {d_state}: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f"; the bound {tol:g} is {tol / worst:.1f}x the worst")
        if lo:
            assert all(np.isfinite(list(errs.values())))
            assert worst <= tol, errs
        else:
            assert worst > tol, errs


# ---------------------------------------------- the wrapper vs the reference
@pytest.mark.parametrize("chunk", [8, 32, 128])
def test_ssd_gradients_match_reference_sequential_oracle(chunk):
    """Every gradient of ``ops.ssd`` (pad, cumsum, ``SSDChunkFn``, the
    inter-chunk scan) against ``jax.vjp`` of ``ssd_ref``; all finite."""
    inp = _model_inputs(B, S_RAGGED, 3, 8, 16, seed=4)
    y, h, got = _port_grads(
        lambda *a: tssd_ops.ssd(*a[:5], chunk=chunk, h0=a[5]), inp)
    y_exp, h_exp, want = _reference_grads(
        lambda x, dt, a, Bm, Cm, h0: jssd_ref(x, dt, a, Bm, Cm, h0=h0), inp)
    assert rel_err(y_exp, y) < ORACLE_RTOL and rel_err(h_exp, h) < ORACLE_RTOL
    for name in GRADS:
        assert bool(torch.isfinite(got[name]).all()), name
        assert rel_err(want[name], got[name]) < ORACLE_RTOL, (
            name, rel_err(want[name], got[name]))


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_gradients_match_reference_chunked_scan(chunk):
    """Where the reference's chunked scan is finite (its exponents stay
    within fp32 at these chunks), ``ops.ssd`` matches its gradients too."""
    inp = _model_inputs(B, S_RAGGED, 3, 8, 16, seed=5)
    _, _, got = _port_grads(
        lambda *a: tssd_ops.ssd(*a[:5], chunk=chunk, h0=a[5]), inp)
    _, _, want = _reference_grads(
        lambda x, dt, a, Bm, Cm, h0: jssd.ssd_scan_reference(
            x, dt, a, Bm, Cm, chunk, h0=h0), inp)
    for name in GRADS:
        assert bool(np.isfinite(np.asarray(want[name])).all()), name
        assert rel_err(want[name], got[name]) < ORACLE_RTOL, (
            name, rel_err(want[name], got[name]))


def test_reference_chunked_scan_gradient_is_nan_at_chunk_128():
    """The recorded reference behaviour: ``jax.vjp`` of the reference's
    chunked scan at mamba2's chunk of 128 has NaN in dt and a. The port's
    wrapper and its twin of that scan (``models/ssd.py``
    ``ssd_scan_reference``, masked before the exp) give finite gradients
    that match the sequential oracle, and the same forward bits as
    selecting after the exp."""
    inp = _model_inputs(B, S_RAGGED, 3, 8, 16, seed=6)
    _, _, ref_chunked = _reference_grads(
        lambda x, dt, a, Bm, Cm, h0: jssd.ssd_scan_reference(
            x, dt, a, Bm, Cm, 128, h0=h0), inp)
    assert np.isnan(np.asarray(ref_chunked["dt"])).any()
    assert np.isnan(np.asarray(ref_chunked["a"])).any()
    _, _, oracle = _reference_grads(
        lambda x, dt, a, Bm, Cm, h0: jssd_ref(x, dt, a, Bm, Cm, h0=h0), inp)
    for fn in (lambda *a: tssd_ops.ssd(*a[:5], chunk=128, h0=a[5]),
               lambda *a: tssd.ssd_scan_reference(*a[:5], 128, h0=a[5])):
        _, _, got = _port_grads(fn, inp)
        for name in GRADS:
            assert bool(torch.isfinite(got[name]).all()), name
            assert rel_err(oracle[name], got[name]) < ORACLE_RTOL, name


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def mamba():
    """(reference cfg, port cfg, reference params, port params): the
    port's seeded ``init``, carried to JAX bit for bit."""
    jcfg = jconfigs.reduced(jconfigs.get(ARCH))
    tcfg = tconfigs.reduced(tconfigs.get(ARCH))
    tparams = tregistry.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    jparams = tree_map(lambda t: jnp.asarray(
        t.float().numpy(), getattr(jnp, str(t.dtype).removeprefix("torch."))),
        tparams)
    return jcfg, tcfg, jparams, tparams


def _tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _leaf_names(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_grads_close(jgrads, tgrads):
    for name, a, b in zip(_leaf_names(jgrads), jax.tree_util.tree_leaves(jgrads),
                          tree_leaves(tgrads)):
        assert b.dtype == convert.tensor_from_numpy(np.asarray(a)).dtype, name
        assert bool(torch.isfinite(b).all()) and float(b.abs().max()) > 0, name
        assert rel_err(a, b) < GRAD_RTOL, (name, rel_err(a, b))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_ssm_block_parameter_gradients_match_reference(mamba, use_kernel):
    """The Mamba-2 mixer's parameter and input gradients under a random
    cotangent, the reference's chunked scan (chunk 8) on its side."""
    jcfg, tcfg, jparams, tparams = mamba
    jp = jax.tree_util.tree_map(lambda t: t[1], jparams["blocks"]["ssm"])
    tp = {k: v.detach().clone().requires_grad_()
          for k, v in tree_map(lambda t: t[1], tparams["blocks"]["ssm"]).items()}
    rng = np.random.default_rng(8)
    x = (0.5 * rng.standard_normal((B, 20, jcfg.d_model))).astype(np.float32)
    g = rng.standard_normal((B, 20, jcfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    gj = jnp.asarray(g, jnp.bfloat16)

    def jloss(p, x):
        out, _ = jssd.ssm_block(jcfg, jcfg.ssm, p, x)
        return jnp.sum(out.astype(jnp.float32) * gj.astype(jnp.float32))

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, xj)
    out, _ = tssd.ssm_block(tcfg, tcfg.ssm, tp, xt, use_kernel=use_kernel)
    (out.float() * torch.from_numpy(g).bfloat16().float()).sum().backward()
    for name in jg_p:
        assert tp[name].grad.dtype == tp[name].dtype, name
        assert rel_err(jg_p[name], tp[name].grad) < GRAD_RTOL, (
            name, rel_err(jg_p[name], tp[name].grad))
    assert rel_err(jg_x, xt.grad) < GRAD_RTOL


def _reference_state(jparams):
    return jsteps.TrainState(params=jparams, opt=jadamw.init(jparams))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(mamba, accum):
    """One optimizer step of reduced mamba2 from the same state: loss,
    grad norm, lr and step; the first moments at GRAD_RTOL and the second
    (~g²) at twice it; the params within
    2·lr (a sign flip of a tiny gradient moves an element by up to that)
    plus two ulps of the leaf's max in its dtype."""
    jcfg, tcfg, jparams, tparams = mamba
    jcfg = dataclasses.replace(jcfg, grad_accum=accum)
    tcfg = dataclasses.replace(tcfg, grad_accum=accum)
    peak_lr = 1e-3
    tok = _tokens((4, 20), seed=10)
    jstate, jmet = jax.jit(lambda s, b: jsteps.train_step(
        jcfg, s, b, peak_lr=peak_lr, warmup_steps=2, total_steps=4))(
        _reference_state(jparams), {"tokens": jnp.asarray(tok)})
    tstate = tsteps.TrainState(params=tparams, opt=tsteps.adamw.init(tparams))
    tstate, tmet = tsteps.train_step(
        tcfg, tstate, {"tokens": torch.from_numpy(tok)}, peak_lr=peak_lr,
        warmup_steps=2, total_steps=4)
    assert rel_err(jmet["loss"], tmet["loss"]) < LOSS_RTOL
    assert rel_err(jmet["grad_norm"], tmet["grad_norm"]) < GNORM_RTOL
    assert rel_err(jmet["lr"], tmet["lr"]) < 1e-6
    assert float(tmet["step"]) == float(jmet["step"]) == 1
    names = _leaf_names(jstate.params)
    for tree, tol in (("m", GRAD_RTOL), ("v", 2 * GRAD_RTOL)):
        for name, a, b in zip(names,
                              jax.tree_util.tree_leaves(getattr(jstate.opt, tree)),
                              tree_leaves(getattr(tstate.opt, tree))):
            assert bool(torch.isfinite(b).all()), (tree, name)
            assert rel_err(a, b) < tol, (tree, name, rel_err(a, b))
    for name, a, b in zip(names, jax.tree_util.tree_leaves(jstate.params),
                          tree_leaves(tstate.params)):
        a = np.asarray(a, np.float32)
        bits = {torch.bfloat16: 7, torch.float32: 23}[b.dtype]
        ulp = 2.0 ** (np.floor(np.log2(max(float(np.abs(a).max()), 1e-30))) - bits)
        err = float(np.abs(a - b.float().numpy()).max())
        assert err <= 2 * peak_lr + 2 * ulp, (name, err)


def test_remat_block_gives_the_same_gradients_as_none(mamba):
    """Recomputing each Mamba-2 layer in the backward is the same
    arithmetic, so the gradients are the same bits."""
    _, tcfg, _, tparams = mamba
    batch = {"tokens": torch.from_numpy(_tokens((2, 20), seed=11))}
    _, g_block = tsteps.value_and_grad(
        dataclasses.replace(tcfg, remat="block"), tparams, batch)
    _, g_none = tsteps.value_and_grad(
        dataclasses.replace(tcfg, remat="none"), tparams, batch)
    for a, b in zip(tree_leaves(g_block), tree_leaves(g_none)):
        assert torch.equal(a, b)


def test_remat_runs_two_ssd_forwards_and_one_backward_a_layer(mamba):
    """``SSDChunkFn`` calls per gradient: L forwards without remat, 2L
    with it (each layer again in the backward); L backwards either way;
    RMSNorm's 2L + 1 and 4L + 1 (ln1 and the gated norm a layer). On the
    CPU the wrappers count no launch, so the calls are counted by
    wrapping them."""
    _, tcfg, _, tparams = mamba
    batch = {"tokens": torch.from_numpy(_tokens((2, 20), seed=12))}
    calls = dict.fromkeys(("ssd", "ssd_bwd", "rms", "rms_bwd"), 0)
    saved = {}

    def counting(cls, attr, key):
        fn = getattr(cls, attr)
        saved[(cls, attr)] = fn

        def wrapped(ctx, *a):
            calls[key] += 1
            return fn(ctx, *a)
        setattr(cls, attr, staticmethod(wrapped))

    L = tcfg.num_layers
    try:
        counting(tssd_ops.SSDChunkFn, "forward", "ssd")
        counting(tssd_ops.SSDChunkFn, "backward", "ssd_bwd")
        counting(rn_ops.RMSNormFn, "forward", "rms")
        counting(rn_ops.RMSNormFn, "backward", "rms_bwd")
        for remat, k in (("block", 2), ("none", 1)):
            calls.update(dict.fromkeys(calls, 0))
            tsteps.value_and_grad(dataclasses.replace(tcfg, remat=remat),
                                  tparams, batch)
            assert calls == {"ssd": k * L, "ssd_bwd": L,
                             "rms": k * 2 * L + 1, "rms_bwd": 2 * L + 1}, (
                remat, calls)
    finally:
        for (cls, attr), fn in saved.items():
            setattr(cls, attr, staticmethod(fn))


def test_model_gradients_at_chunk_128_match_reference_with_sequential_oracle(
        mamba, monkeypatch):
    """At mamba2-130m's own chunk of 128 (reduced widths, a ragged S of
    150): the reference's gradients are NaN through its chunked scan; with
    that scan swapped for its sequential oracle (``monkeypatch`` on the
    reference module, no file edited) they are finite, and the port's,
    through ``SSDChunkFn``, match them."""
    jcfg, tcfg, jparams, tparams = mamba
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, chunk=128))
    tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, chunk=128))
    tok = {"tokens": _tokens((B, S_RAGGED), seed=13)}

    def reference_grads():
        return jax.jit(jax.grad(lambda p, b: jsteps.loss_fn(jcfg, p, b)[0]))(
            jparams, {"tokens": jnp.asarray(tok["tokens"])})

    nan_leaves = [n for n, g in zip(_leaf_names(jparams),
                                    jax.tree_util.tree_leaves(reference_grads()))
                  if np.isnan(np.asarray(g, np.float32)).any()]
    assert nan_leaves, "the reference's chunked scan gave finite gradients"

    def sequential(x, dt, a, Bm, Cm, chunk, h0=None):
        y, h = jssd_ref(x, dt, a, Bm, Cm, h0=h0)
        return y, h

    monkeypatch.setattr(jssd, "ssd_scan_reference", sequential)
    jgrads = reference_grads()
    _, tgrads = tsteps.value_and_grad(
        tcfg, tparams, {"tokens": torch.from_numpy(tok["tokens"])})
    _assert_grads_close(jgrads, tgrads)


# -------------------------------------------------------- the train entry
def test_require_trainable_admits_the_ssm_family_only_of_the_new_ones():
    """The ssm family trains, and so do the MoE and hybrid families since
    their backward (``tests/test_torch_{moe,hybrid}_train.py``): only
    ``attn_impl="flash"`` is refused."""
    tok = {"tokens": torch.zeros(1, 4, dtype=torch.int32)}
    for name in (ARCH, "jamba-v0.1-52b", "granite-moe-1b-a400m"):
        tsteps._require_trainable(tconfigs.get(name))
        tsteps._require_trainable(tconfigs.reduced(tconfigs.get(name)))
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get("internlm2-1.8b")),
                              attn_impl="flash")
    with pytest.raises(NotImplementedError, match="no backward"):
        tsteps.loss_fn(cfg, {}, tok)


def test_cpu_training_counts_no_kernel_launch(mamba):
    _, tcfg, _, tparams = mamba
    counts = [(tssd_ops.ssd, "launches"), (tssd_ops.ssd, "launches_tc"),
              (tssd_ops.ssd, "launches_bwd"), (tssd_ops.ssd, "launches_bwd_tc"),
              (rn_ops.rmsnorm, "launches"),
              (rn_ops.rmsnorm_bwd, "launches")]
    before = [getattr(w, a) for w, a in counts]
    state = tsteps.TrainState(params=tparams, opt=tsteps.adamw.init(tparams))
    _, met = tsteps.train_step(
        tcfg, state, {"tokens": torch.from_numpy(_tokens((2, 20), seed=14))})
    assert bool(torch.isfinite(met["loss"]))
    assert [getattr(w, a) for w, a in counts] == before


def test_train_cli_trains_reduced_mamba2_on_cpu(tmp_path):
    res = ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "24",
                       "--workdir", str(tmp_path)])
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert all(t.device.type == "cpu" for t in tree_leaves(res.state.params))
