"""The port's training step vs the JAX package's, on the CPU at reduced
size (internlm2-1.8b reduced to 2 layers): the RMSNorm gradient
(``RMSNormFn``, whose CPU backward is ``rmsnorm_bwd_ref``'s formula), the
loss and the gradient of every leaf, and three train steps from the same
state. Weights come from the reference's ``init_train_state`` and cross
in-process (``convert.train_state_from_numpy``); inputs are numpy from a
seed. No check depends on a property of those per-process weights.

Tolerances, each stated where it is used: both packages run the model in
bf16, and XLA and torch round bf16 at other places, so bf16 gradients
differ by a few ulps (2^-8 relative each) of the leaf's largest entry.
"""
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.data import synth as jsynth
from repro.models import layers as jlayers
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import TokenBatcher
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.models import convert
from repro_torch.train import steps as tsteps
from test_torch_moe_train import _assert_updates_close

GRAD_RTOL = 3e-2       # bf16 gradients, relative to each leaf's max |g|
LOSS_RTOL = 1e-4       # the fp32 loss of bf16 logits
GNORM_RTOL = 2e-3      # the fp32 norm over every bf16 gradient
B, S = 4, 32


def tiny(pkg_configs, **kw):
    cfg = pkg_configs.reduced(pkg_configs.get("internlm2-1.8b"))
    return dataclasses.replace(cfg, num_layers=2, **kw)


def rel_err(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _tokens(seed, shape=(B, S), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_state():
    """The reference's initial TrainState (jax) and its numpy form."""
    jstate = jsteps.init_train_state(tiny(jconfigs), jax.random.PRNGKey(0))
    return jstate, jax.tree_util.tree_map(np.asarray, jstate)


def _leaf_names(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


# ------------------------------------------------------------------ RMSNorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_fn_backward_matches_jax_grad(dtype):
    """dx and dw of the port's differentiable rmsnorm against
    ``jax.vjp`` of the reference's jnp rmsnorm, for the same cotangent.
    fp32: sums in another order, 1e-5 of the scale. bf16: dx rounds to
    bf16 once on each side (one ulp, 2^-8, apart at most); dw is fp32 on
    both sides."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    dy = rng.normal(size=(3, 5, 64)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx, jdy = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    y, vjp = jax.vjp(jlayers.rmsnorm, jx, jnp.asarray(w))
    jdx, jdw = vjp(jdy)

    tx = convert.tensor_from_numpy(np.asarray(jx)).requires_grad_()
    tw = torch.from_numpy(w.copy()).requires_grad_()
    out = rn_ops.rmsnorm(tx, tw)
    assert out.grad_fn is not None and out.dtype == tx.dtype
    assert rel_err(np.asarray(y, np.float32), out.detach()) < 1e-2
    out.backward(convert.tensor_from_numpy(np.asarray(jdy)))
    assert tx.grad.dtype == tx.dtype and tw.grad.dtype == torch.float32
    scale = lambda a: max(1.0, float(np.abs(np.asarray(a, np.float32)).max()))
    dx_tol = 2 ** -8 if dtype == "bfloat16" else 1e-5
    assert np.abs(np.asarray(jdx, np.float32) - tx.grad.float().numpy()).max() \
        <= dx_tol * scale(jdx)
    assert np.abs(np.asarray(jdw, np.float32) - tw.grad.numpy()).max() \
        <= 1e-5 * scale(jdw)


def test_rmsnorm_fn_passes_gradcheck_in_fp64():
    """The backward formula itself, against finite differences: on fp64
    CPU tensors both the forward and ``rmsnorm_bwd_ref`` compute in fp64."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 3, 16, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(16, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: rn_ops.RMSNormFn.apply(a, b, 1e-5), (x, w))


def test_rmsnorm_takes_the_direct_path_without_grad():
    x = torch.randn(2, 8, requires_grad=True)
    w = torch.ones(8, requires_grad=True)
    with torch.no_grad():
        assert rn_ops.rmsnorm(x, w).grad_fn is None
    with torch.inference_mode():
        assert rn_ops.rmsnorm(x.detach(), w.detach()).grad_fn is None
    assert rn_ops.rmsnorm(x.detach(), w.detach()).grad_fn is None
    assert type(rn_ops.rmsnorm(x, w).grad_fn).__name__ == "RMSNormFnBackward"


# ------------------------------------------------------------------ the loss
@functools.lru_cache(maxsize=None)
def _reference_grad(impl):
    cfg = tiny(jconfigs, xent_impl=impl)
    return jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.loss_fn(cfg, p, b), has_aux=True))


@pytest.mark.parametrize("impl", ["onehot", "gather"])
def test_loss_and_every_leaf_gradient_match_reference(impl):
    jstate, host = _reference_state()
    tok = _tokens(0)
    (jtotal, jmet), jgrads = _reference_grad(impl)(
        jstate.params, {"tokens": jnp.asarray(tok)})
    tcfg = tiny(tconfigs, xent_impl=impl)
    tparams = convert.params_from_numpy(host.params)
    tmet, tgrads = tsteps.value_and_grad(tcfg, tparams,
                                         {"tokens": torch.from_numpy(tok)})
    assert rel_err(jmet["loss"], tmet["loss"]) < LOSS_RTOL
    assert float(tmet["aux_loss"]) == float(jmet["aux_loss"]) == 0.0
    total, _ = tsteps.loss_fn(tcfg, tparams, {"tokens": torch.from_numpy(tok)})
    assert rel_err(jtotal, total.detach()) < LOSS_RTOL
    names = _leaf_names(jgrads)
    for name, a, b in zip(names, jax.tree_util.tree_leaves(jgrads),
                          tree_leaves(tgrads)):
        assert b.dtype == convert.tensor_from_numpy(np.asarray(a)).dtype, name
        assert float(b.abs().max()) > 0, name
        assert rel_err(a, b) < GRAD_RTOL, (name, rel_err(a, b))


def test_loss_mask_weights_the_mean():
    cfg = tiny(tconfigs)
    _, host = _reference_state()
    params = convert.params_from_numpy(host.params)
    tok = torch.from_numpy(_tokens(2))
    mask = torch.ones(B, S)
    mask[:, S // 2:] = 0.0
    full, _ = tsteps.loss_fn(cfg, params, {"tokens": tok})
    half, _ = tsteps.loss_fn(cfg, params, {"tokens": tok, "loss_mask": mask})
    jfull, _ = jsteps.loss_fn(tiny(jconfigs), _reference_state()[0].params,
                              {"tokens": jnp.asarray(tok.numpy()),
                               "loss_mask": jnp.asarray(mask.numpy())})
    assert rel_err(jfull, half) < LOSS_RTOL
    assert float(full) != float(half)


# ------------------------------------------------------------ three steps
def _ulp(max_abs: float, dtype) -> float:
    """One unit in the last place at ``max_abs`` in ``dtype``."""
    bits = {torch.bfloat16: 7, torch.float32: 23}[dtype]
    return 2.0 ** (np.floor(np.log2(max(max_abs, 1e-30))) - bits)


def test_three_train_steps_match_reference():
    """Three steps from the same state, held as the MoE family's train
    twins are (``tests/test_torch_moe_train.py``). Each step: loss, grad
    norm, lr and step, and the step's update of every leaf element by
    element in units of its lr (``_assert_updates_close``: on the elements
    whose gradient no bf16 rounding can flip, within UPDATE_TOL; at the
    first step every element within 2·lr). After the first step the
    moments: m at GRAD_RTOL, v (~g², whose relative error is twice g's) at
    2·GRAD_RTOL. After the third the params, at atol = 2·peak_lr·steps
    plus two ulps of the leaf's max in its dtype (a rounding difference
    that flips a tiny gradient's sign moves an element by up to 2·lr a
    step).

    The moments are not held after the third step: there the reference
    against itself (``tests/torch_train_tolerance.py``: attention and
    cross-entropy computed another way, so bf16 rounds elsewhere) reads
    up to 3.33e-2 in v over 600 inits, 4 of them at or above GRAD_RTOL,
    and the port 3.36e-2, 5 of them. The init follows the hash seed, so v
    held there at GRAD_RTOL failed about one process in 120. After the
    first step the port's v reads at most 2.99e-2 over those inits."""
    peak_lr, n = 1e-3, 3
    jcfg, tcfg = tiny(jconfigs), tiny(tconfigs)
    jstate, host = _reference_state()
    tstate = convert.train_state_from_numpy(host)
    step = jax.jit(lambda s, b: jsteps.train_step(
        jcfg, s, b, peak_lr=peak_lr, warmup_steps=2, total_steps=4))
    names = _leaf_names(jstate.params)
    resolved = []
    for i in range(n):
        tok = _tokens(10 + i)
        j_new, jmet = step(jstate, {"tokens": jnp.asarray(tok)})
        t_new, tmet = tsteps.train_step(
            tcfg, tstate, {"tokens": torch.from_numpy(tok)},
            peak_lr=peak_lr, warmup_steps=2, total_steps=4)
        assert set(tmet) == set(jmet) == {"loss", "aux_loss", "grad_norm",
                                          "lr", "step"}, (i + 1, set(tmet))
        for key, tol in (("loss", LOSS_RTOL), ("grad_norm", GNORM_RTOL),
                         ("lr", 1e-6)):
            err = rel_err(jmet[key], tmet[key])
            assert err < tol, (f"step {i + 1}", key, float(jmet[key]),
                               float(tmet[key]), err, tol)
        assert float(tmet["step"]) == float(jmet["step"]) == i + 1, \
            (f"step {i + 1}", float(tmet["step"]), float(jmet["step"]))
        try:
            _assert_updates_close(jstate, j_new, tstate, t_new,
                                  float(jmet["lr"]), GRAD_RTOL, resolved)
        except AssertionError as e:
            raise AssertionError(f"step {i + 1} update (leaf, lr units): "
                                 f"{e}") from e
        if i == 0:
            for tree, tol in (("m", GRAD_RTOL), ("v", 2 * GRAD_RTOL)):
                for name, a, b in zip(
                        names,
                        jax.tree_util.tree_leaves(getattr(j_new.opt, tree)),
                        tree_leaves(getattr(t_new.opt, tree))):
                    assert b.dtype == torch.float32, (tree, name, b.dtype)
                    err = rel_err(a, b)
                    assert err < tol, ("step 1", tree, name, err, tol)
        jstate, tstate = j_new, t_new
    assert tstate.opt.step.dtype == torch.int32, tstate.opt.step.dtype
    assert int(tstate.opt.step) == int(jstate.opt.step) == n, \
        (int(tstate.opt.step), int(jstate.opt.step))
    for name, a, b in zip(names, jax.tree_util.tree_leaves(jstate.params),
                          tree_leaves(tstate.params)):
        a = np.asarray(a, np.float32)
        bound = 2 * peak_lr * n + 2 * _ulp(float(np.abs(a).max()), b.dtype)
        err = float(np.abs(a - b.float().numpy()).max())
        assert err <= bound, (f"step {n} params", name, err, bound)


# ------------------------------------------------------------- the port alone
def test_grad_accum_equivalent():
    """accum=2 must match accum=1 on the same global batch (up to fp),
    at the reference test's tolerance."""
    base, split = tiny(tconfigs, grad_accum=1), tiny(tconfigs, grad_accum=2)
    _, host = _reference_state()
    batch = {"tokens": torch.from_numpy(_tokens(5, (4, 16)))}
    s0 = convert.train_state_from_numpy(host)
    s1, m1 = tsteps.train_step(base, s0, batch)
    s2, m2 = tsteps.train_step(split, s0, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-3
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=5e-3, rtol=1e-2)


def test_remat_block_gives_the_same_gradients_as_none():
    """Recomputing each layer in the backward is the same arithmetic, so
    the gradients are the same bits; so is recomputing it but for the
    saved products (``"dots"``, ``tests/test_torch_remat.py``)."""
    _, host = _reference_state()
    params = convert.params_from_numpy(host.params)
    batch = {"tokens": torch.from_numpy(_tokens(6))}
    _, g_none = tsteps.value_and_grad(tiny(tconfigs, remat="none"), params,
                                      batch)
    for remat in ("block", "dots"):
        _, g = tsteps.value_and_grad(tiny(tconfigs, remat=remat), params,
                                     batch)
        for a, b in zip(tree_leaves(g), tree_leaves(g_none), strict=True):
            assert torch.equal(a, b), remat


def test_remat_counts_one_recomputed_forward_per_norm():
    """Forward launches of the norm wrapper per gradient: 2L + 1 without
    remat, 4L + 1 with it (each layer's two norms again in the backward);
    backward 2L + 1 either way. On the CPU the wrapper counts no launch,
    so the count is taken by wrapping it."""
    _, host = _reference_state()
    params = convert.params_from_numpy(host.params)
    batch = {"tokens": torch.from_numpy(_tokens(7))}
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = rn_ops.RMSNormFn.forward, rn_ops.RMSNormFn.backward

    def count_fwd(ctx, *a):
        calls["fwd"] += 1
        return fwd(ctx, *a)

    def count_bwd(ctx, *a):
        calls["bwd"] += 1
        return bwd(ctx, *a)

    L = 2
    try:
        rn_ops.RMSNormFn.forward = staticmethod(count_fwd)
        rn_ops.RMSNormFn.backward = staticmethod(count_bwd)
        for remat, want in (("block", 4 * L + 1), ("none", 2 * L + 1)):
            calls.update(fwd=0, bwd=0)
            tsteps.value_and_grad(tiny(tconfigs, remat=remat), params, batch)
            assert calls == {"fwd": want, "bwd": 2 * L + 1}, (remat, calls)
    finally:
        rn_ops.RMSNormFn.forward = staticmethod(fwd)
        rn_ops.RMSNormFn.backward = staticmethod(bwd)


def test_other_families_and_flash_refuse_to_train():
    """Every family trains (the MoE and hybrid ones since their backward,
    ``tests/test_torch_{moe,hybrid}_train.py``); only ``attn_impl="flash"``
    is refused, whatever the family: the flash kernel has no backward."""
    tok = {"tokens": torch.zeros(1, 4, dtype=torch.int32)}
    for name in tconfigs.ASSIGNED:
        cfg = tconfigs.reduced(tconfigs.get(name))
        tsteps._require_trainable(cfg)
        with pytest.raises(NotImplementedError, match="no backward"):
            tsteps.loss_fn(dataclasses.replace(cfg, attn_impl="flash"), {},
                           tok)
    with pytest.raises(NotImplementedError, match="backward"):
        tsteps.loss_fn(tiny(tconfigs, attn_impl="flash"), {}, tok)


def test_loss_decreases_on_learnable_stream():
    """Twin of ``tests/test_train.py``'s, from the port's own seeded init."""
    cfg = tconfigs.reduced(tconfigs.get("internlm2-1.8b"))
    tokens = jsynth.lm_tokens(0, 60_000, cfg.vocab_size)
    batcher = TokenBatcher(tokens, batch=8, seq=32)
    state = tsteps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    losses = []
    for i in range(30):
        batch = {k: torch.from_numpy(v) for k, v in batcher.batch_at(i).items()}
        state, m = tsteps.train_step(cfg, state, batch, peak_lr=1e-2,
                                     warmup_steps=5, total_steps=100)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3
