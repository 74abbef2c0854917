"""The port's AdamW and LR schedules vs the JAX package's, on the same
numpy trees. Everything here is fp32, where the two differ only in the
order of sums (XLA's and torch's reductions) and in ``pow``'s last bit:
held at 1e-6 relative to each leaf's largest magnitude."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.optim import adamw as jadamw, schedules as jschedules
from repro_torch.optim import adamw as tadamw, schedules as tschedules

RTOL = 1e-6


def _close(want, got, rtol=RTOL):
    want = np.asarray(want, np.float64)
    got = (got.double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    assert want.shape == got.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(want - got).max()) <= rtol * scale, (
        float(np.abs(want - got).max()), scale)


def _trees(seed=0):
    """params, grads and moments with a stacked (L, D) norm-like leaf, a
    (D,) leaf and a 3-d leaf, as numpy fp32."""
    rng = np.random.default_rng(seed)
    shapes = {"blocks": {"ln1": (3, 16), "w": (16, 4, 8)}, "final": (16,)}

    def tree(scale, positive=False):
        def leaf(shape):
            a = rng.normal(0, scale, shape).astype(np.float32)
            return np.abs(a) if positive else a
        return {"blocks": {k: leaf(s) for k, s in shapes["blocks"].items()},
                "final": leaf(shapes["final"])}
    return tree(1.0), tree(0.1), tree(0.01), tree(1e-3, positive=True)


def _to_j(tree):
    return {k: _to_j(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _to_t(tree):
    return {k: _to_t(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + k + ".")
        else:
            yield prefix + k, tree[k]


@pytest.mark.parametrize("kw", [
    dict(peak_lr=1e-3, warmup_steps=2, total_steps=4),
    dict(peak_lr=3e-3, warmup_steps=20, total_steps=300),
    dict(peak_lr=3e-4, warmup_steps=0, total_steps=10, min_ratio=0.0),
], ids=["lm-workflow", "trainer", "no-warmup"])
def test_warmup_cosine_matches_reference(kw):
    for step in list(range(0, 30)) + [150, 299, 300, 301, 1000]:
        want = jschedules.warmup_cosine(step, **kw)
        got = tschedules.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                       **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        _close(want, got)
    _close(jschedules.constant(7, peak_lr=2e-3),
           tschedules.constant(torch.tensor(7), peak_lr=2e-3))


@pytest.mark.parametrize("step0", [0, 5])
def test_adamw_update_matches_reference(step0):
    p, g, m, v = _trees()
    lr = np.float32(3e-3)
    jst = jadamw.AdamWState(m=_to_j(m), v=_to_j(v),
                            step=jnp.asarray(step0, jnp.int32))
    tst = tadamw.AdamWState(m=_to_t(m), v=_to_t(v),
                            step=torch.tensor(step0, dtype=torch.int32))
    jp, jnew = jadamw.update(_to_j(p), _to_j(g), jst, lr=jnp.asarray(lr))
    tparams_in = _to_t(p)
    tp, tnew = tadamw.update(tparams_in, _to_t(g), tst, lr=torch.tensor(lr))
    assert int(tnew.step) == int(jnew.step) == step0 + 1
    assert tnew.step.dtype == torch.int32
    for (name, a), (_, b) in zip(_leaves(jp), _leaves(tp)):
        _close(a, b)
    for tree_j, tree_t in ((jnew.m, tnew.m), (jnew.v, tnew.v)):
        for (name, a), (_, b) in zip(_leaves(tree_j), _leaves(tree_t)):
            assert b.dtype == torch.float32, name
            _close(a, b)
    # functional, as the reference: the inputs are left as they were
    for (_, a), (_, b) in zip(_leaves(p), _leaves(tparams_in)):
        assert np.array_equal(a, b.numpy())


def test_adamw_bf16_params_update_in_fp32_and_keep_their_dtype():
    p = {"w": torch.randn(8, 8).bfloat16()}
    g = {"w": torch.randn(8, 8)}
    new, st = tadamw.update(p, g, tadamw.init(p), lr=torch.tensor(1e-2))
    assert new["w"].dtype == torch.bfloat16
    assert st.m["w"].dtype == st.v["w"].dtype == torch.float32


def test_adamw_decays_stacked_norms_but_not_vectors():
    """The reference's rule, ``p.ndim >= 2``: the stacked norm weights
    ``blocks.ln1``/``ln2`` are (L, D) and are decayed; ``final_norm`` (D,)
    is not. With zero gradients the moments stay 0, so the update is the
    decay alone: p · (1 − lr · wd)."""
    params = {"blocks": {"ln1": torch.ones(3, 16)}, "final_norm": torch.ones(16)}
    grads = {"blocks": {"ln1": torch.zeros(3, 16)},
             "final_norm": torch.zeros(16)}
    lr, wd = 0.1, 0.5
    new, _ = tadamw.update(params, grads, tadamw.init(params),
                           lr=torch.tensor(lr), weight_decay=wd)
    want = np.float32(1.0) - np.float32(lr) * (np.float32(wd) * np.float32(1.0))
    assert torch.all(new["blocks"]["ln1"] == torch.tensor(want))
    assert torch.all(new["final_norm"] == 1.0)
    jnew, _ = jadamw.update(
        {"blocks": {"ln1": jnp.ones((3, 16))}, "final_norm": jnp.ones(16)},
        {"blocks": {"ln1": jnp.zeros((3, 16))}, "final_norm": jnp.zeros(16)},
        jadamw.init({"blocks": {"ln1": jnp.ones((3, 16))},
                     "final_norm": jnp.ones(16)}),
        lr=lr, weight_decay=wd)
    _close(jnew["blocks"]["ln1"], new["blocks"]["ln1"])
    _close(jnew["final_norm"], new["final_norm"])


def test_adamw_weight_decay_decoupled():
    params = {"w": torch.ones(4, 4), "b": torch.ones(4)}
    st = tadamw.init(params)
    grads = {"w": torch.zeros(4, 4), "b": torch.zeros(4)}
    new, _ = tadamw.update(params, grads, st, lr=0.1, weight_decay=0.5)
    # zero grad: matrices shrink by decay, vectors untouched
    assert float(new["w"][0, 0]) < 1.0
    assert float(new["b"][0]) == pytest.approx(1.0)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_global_norm_and_clip_match_reference(max_norm):
    _, g, _, _ = _trees(3)
    g = {"blocks": {k: a * 30 for k, a in g["blocks"].items()},
         "final": g["final"] * 30}
    _close(jadamw.global_norm(_to_j(g)), tadamw.global_norm(_to_t(g)))
    jc, jn = jadamw.clip_by_global_norm(_to_j(g), max_norm)
    tc, tn = tadamw.clip_by_global_norm(_to_t(g), max_norm)
    _close(jn, tn)
    for (_, a), (_, b) in zip(_leaves(jc), _leaves(tc)):
        _close(a, b)


def test_clip_by_global_norm():
    grads = {"a": torch.full((10,), 10.0)}
    clipped, norm = tadamw.clip_by_global_norm(grads, 1.0)
    assert float(norm) > 1.0
    assert float(tadamw.global_norm(clipped)) == pytest.approx(1.0, rel=1e-4)
