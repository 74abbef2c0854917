"""Twins of ``tests/test_models.py`` on the port: RoPE and M-RoPE, the
sliding window, the MoE block's routing and capacity, the chunked
attention, and zero-weight extractor pruning. Inputs come from numpy
seeds; where it is cheap each twin also holds the port's output against
the reference function's on the same inputs, with the tolerance stated
beside it (fp32 on both sides: another summation order, ~1e-7). The two
property tests hold the port alone, as the reference's do: each example
draws new shapes, on which the reference's eager functions compile again
(~0.25 s a call); the sliding-window and capacity twins hold the same
functions against the reference."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip(
    "hypothesis", reason="dev dependency; see requirements-dev.txt")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.pruning import zero_weight_extractors as jzero  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.config import MoECfg as JMoECfg  # noqa: E402
from repro.models.moe import moe_block as jmoe_block  # noqa: E402
from repro_torch.core.pruning import zero_weight_extractors  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.config import MoECfg  # noqa: E402
from repro_torch.models.moe import moe_block, moe_defs  # noqa: E402
from repro_torch.models.params import init_params, tree_map  # noqa: E402

REF_TOL = 1e-5     # port vs reference, relative to max(1, max |ref|)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: with several test processes sharing the
    cores, torch's OpenMP pool spins at the small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def normal(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


def positions(b, s, offset=0):
    row = offset + np.arange(s, dtype=np.int32)
    return np.broadcast_to(row, (b, s)).copy()


def assert_like_reference(ref, got, tol=REF_TOL):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max())


def test_rope_preserves_norm():
    x = normal(0, (2, 8, 4, 64))
    pos = positions(2, 8)
    y = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(np.linalg.norm(x, axis=-1),
                               np.linalg.norm(y.numpy(), axis=-1), rtol=1e-5)
    assert_like_reference(
        jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), y)


def test_rope_relative_property():
    """q·k after RoPE depends only on relative distance."""
    d = 64
    q, k = normal(0, (1, 1, 1, d)), normal(1, (1, 1, 1, d))

    def dot_at(p1, p2):
        pos1 = np.full((1, 1), p1, np.int32)
        pos2 = np.full((1, 1), p2, np.int32)
        qr = layers.apply_rope(torch.from_numpy(q), torch.from_numpy(pos1),
                               10_000.0)
        kr = layers.apply_rope(torch.from_numpy(k), torch.from_numpy(pos2),
                               10_000.0)
        ref = float(jnp.sum(jlayers.apply_rope(jnp.asarray(q), pos1, 10_000.0)
                            * jlayers.apply_rope(jnp.asarray(k), pos2,
                                                 10_000.0)))
        got = float((qr * kr).sum())
        assert got == pytest.approx(ref, rel=REF_TOL, abs=REF_TOL)
        return got

    assert dot_at(5, 3) == pytest.approx(dot_at(105, 103), rel=1e-4)
    assert dot_at(5, 3) != pytest.approx(dot_at(5, 4), rel=1e-3)


def test_mrope_equals_rope_when_positions_tied():
    """M-RoPE with t=h=w positions must reduce to standard RoPE."""
    x = normal(0, (2, 8, 2, 64))
    pos = positions(2, 8)
    mpos = np.broadcast_to(pos, (3, 2, 8)).copy()
    y1 = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           10_000.0)
    y2 = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(mpos),
                           10_000.0, mrope_sections=(8, 12, 12))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)
    assert_like_reference(
        jlayers.apply_rope(jnp.asarray(x), jnp.asarray(mpos), 10_000.0,
                           mrope_sections=(8, 12, 12)), y2)


def test_sliding_window_masks_past():
    """With window w, token i must ignore tokens < i-w+1."""
    b, s, h, d = 1, 32, 2, 32
    q, k, v = normal(0, (b, s, h, d)), normal(1, (b, s, h, d)), \
        normal(2, (b, s, h, d))
    pos = torch.from_numpy(positions(b, s))
    out_w = layers.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), pos, pos, causal=True,
                                 window=4)
    # perturb k/v far outside every window of the last query
    k2, v2 = k.copy(), v.copy()
    k2[:, :8] += 100.0
    v2[:, :8] += 100.0
    out_w2 = layers.gqa_attention(torch.from_numpy(q), torch.from_numpy(k2),
                                  torch.from_numpy(v2), pos, pos, causal=True,
                                  window=4)
    np.testing.assert_allclose(out_w[:, -1].numpy(), out_w2[:, -1].numpy(),
                               atol=1e-5)
    jpos = jnp.asarray(pos.numpy())
    assert_like_reference(
        jlayers.gqa_attention(jnp.asarray(q), jnp.asarray(k2), jnp.asarray(v2),
                              jpos, jpos, causal=True, window=4), out_w2)


def moe_case(mcfg, n, seed=0):
    """The port's seeded MoE weights, bf16-valued but held in fp32 (the
    reference promotes its bf16 weights against fp32 tokens; torch's
    products take one dtype), and fp32 tokens (1, n, 8)."""
    p = tree_map(lambda t: t.float(), init_params(
        moe_defs(8, mcfg), torch.Generator().manual_seed(seed), "cpu"))
    return p, normal(seed + 1, (1, n, 8))


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 6), st.integers(1, 3))
def test_moe_combine_weights_sum(n_tokens_log, k):
    """MoE with capacity ≫ tokens must route every token (no drops), and
    the output must be the gate-weighted sum of expert outputs."""
    e = 4
    k = min(k, e)
    n = 2 ** n_tokens_log
    mcfg = MoECfg(num_experts=e, top_k=k, expert_d_ff=16,
                  capacity_factor=float(e))  # huge capacity → no drops
    p, x = moe_case(mcfg, n)
    out, aux = moe_block(mcfg, p, torch.from_numpy(x))
    assert out.shape == (1, n, 8)
    assert bool(torch.isfinite(out).all())
    assert float(aux) > 0


def test_moe_capacity_drops_tokens():
    """capacity_factor ≪ 1 must drop tokens (outputs become zero-ish);
    both outputs and aux losses are the reference's on the same weights
    and tokens."""
    e, k = 4, 1
    mcfg_full = MoECfg(num_experts=e, top_k=k, expert_d_ff=16,
                       capacity_factor=4.0)
    mcfg_tiny = MoECfg(num_experts=e, top_k=k, expert_d_ff=16,
                       capacity_factor=0.05)
    p, x = moe_case(mcfg_full, 64)
    jp = tree_map(lambda t: jnp.asarray(t.numpy()), p)
    outs = []
    for mcfg in (mcfg_full, mcfg_tiny):
        out, aux = moe_block(mcfg, p, torch.from_numpy(x))
        jout, jaux = jmoe_block(JMoECfg(**dataclasses.asdict(mcfg)), jp,
                                jnp.asarray(x))
        assert_like_reference(jout, out)
        assert float(aux) == pytest.approx(float(jaux), rel=REF_TOL)
        outs.append(out)
    assert float(outs[1].abs().sum()) < float(outs[0].abs().sum())


@settings(max_examples=15, deadline=None)
@given(st.integers(8, 80), st.integers(8, 130), st.booleans(),
       st.sampled_from([None, 4, 16]))
def test_chunked_attention_matches_reference(sq, sk, causal, window):
    """Property: the flash-style chunked attention (arbitrary Sq/Sk,
    padding path) must match the dense reference."""
    b, h, kv, d = 1, 2, 1, 16
    seed = sq * 131 + sk
    q, k, v = normal(seed, (b, sq, h, d)), normal(seed + 1, (b, sk, kv, d)), \
        normal(seed + 2, (b, sk, kv, d))
    off = max(sk - sq, 0)
    qp, kp = positions(b, sq, off), positions(b, sk)
    args = [torch.from_numpy(a) for a in (q, k, v, qp, kp)]
    o1 = layers.gqa_attention(*args, causal=causal, window=window,
                              impl="reference")
    o2 = layers.gqa_attention(*args, causal=causal, window=window,
                              impl="chunked")
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=2e-5)


def test_zero_weight_extractor_pruning():
    w = np.array([0.0, 0.0, 0.5, 1e-12, 2.0])
    prov = {"dead": [0, 1], "half": [2, 3], "live": [4]}
    assert zero_weight_extractors(w, prov) == jzero(w, prov) == {"dead"}
