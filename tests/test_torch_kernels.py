"""Port kernels vs the JAX package's kernels and oracles.

On the CPU the port's wrappers take their plain PyTorch versions; these are
held against the reference ``ops`` (Pallas in interpret mode, as
``tests/test_kernels.py`` runs them) and ``ref`` oracles on the same numpy
inputs. The CUDA kernels are held against the same plain versions on the
card in ``tests/test_torch_cuda.py``, which imports no JAX.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro.kernels.rmsnorm import ops as rn_ops, ref as rn_ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as tfa_ops
from repro_torch.kernels.rmsnorm import ops as trn_ops

# the same cases as tests/test_kernels.py
FLASH_CASES = [
    # B, Sq, Sk, H, KV, D, causal, window, qoff
    (2, 128, 128, 4, 2, 64, True, 0, 0),
    (1, 256, 256, 8, 8, 32, True, 0, 0),
    (2, 128, 128, 4, 4, 64, True, 16, 0),
    (1, 64, 128, 4, 2, 64, True, 0, 64),
    (2, 128, 128, 2, 1, 128, False, 0, 0),
    (1, 512, 512, 2, 2, 64, True, 128, 0),
]
RMSNORM_SHAPES = [(8, 128), (3, 5, 64), (257, 96), (1, 8)]
# tolerances of tests/test_kernels.py: fp32 differs only in summation
# order; bf16 outputs may round one ulp apart (2^-8 relative at |x| ~ 1)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
RMSNORM_TOL = 2e-2
DTYPES = ["float32", "bfloat16"]


def _pair(a: np.ndarray, dtype: str):
    """One fp32 numpy array as a JAX and a torch array of ``dtype``: both
    round fp32 → bf16 to nearest even, so the two hold the same bits."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(case, dtype, seed=0):
    B, Sq, Sk, H, KV, D = case[:6]
    rng = np.random.default_rng(seed)
    shapes = [(B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)]
    return [_pair(rng.standard_normal(s).astype(np.float32), dtype)
            for s in shapes]


# ------------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("shape", RMSNORM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_plain_matches_reference(shape, dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    out = trn_ops.rmsnorm(xt, torch.from_numpy(w))
    assert out.dtype == xt.dtype and out.shape == xt.shape
    for exp in (rn_ops.rmsnorm(xj, jnp.asarray(w)),
                rn_ref.rmsnorm_ref(xj, jnp.asarray(w))):
        np.testing.assert_allclose(_np(out), _np(exp), atol=RMSNORM_TOL)


# (rows, D, bytes per element) -> threads of the RMSNorm kernel's block per
# row on a 132-SM card: one per 16-byte vector under 2 rows an SM (decode:
# 4 rows of D 768/1536/2048 bf16 -> 96/192/256; fp32 twice that), one per
# two vectors from 264 rows on (prefill), whole warps, at most 512
RMSNORM_PLANS = [
    ((4, 768, 2), 96), ((4, 1536, 2), 192), ((4, 2048, 2), 256),
    ((4, 1536, 4), 384), ((4, 2048, 4), 512), ((1, 8, 4), 32),
    ((263, 2048, 2), 256), ((264, 2048, 2), 128),
    ((2048, 2048, 2), 128), ((2048, 1536, 4), 192), ((2048, 768, 2), 64),
    ((100_000, 2048, 2), 128), ((4, 40_000, 2), 512), ((2048, 40_000, 4), 512),
]


@pytest.mark.parametrize("case", RMSNORM_PLANS, ids=str)
def test_rmsnorm_block_fits_the_row_count(case):
    (n_rows, d, elem_bytes), want = case
    assert trn_ops.plan(n_rows, d, elem_bytes, 132) == want


def test_rmsnorm_plan_covers_every_vector_of_a_row():
    """Whole warps, at most 512 threads, and at most two vectors a thread
    wherever 512 threads can cover the row (wider rows hold up to 16 a
    thread in registers and re-read the rest)."""
    for n_rows in (1, 4, 7, 263, 264, 2048, 9001):
        for d in (8, 96, 776, 2048, 12288, 40_000):
            for elem_bytes in (2, 4):
                threads = trn_ops.plan(n_rows, d, elem_bytes, 132)
                vecs = d * elem_bytes // 16
                assert threads % 32 == 0 and 32 <= threads <= trn_ops.MAX_THREADS
                per_thread = 1 if n_rows < 264 else 2
                assert threads * per_thread >= min(vecs, 512 * per_thread)
                assert threads - 32 < -(-vecs // per_thread)


# ------------------------------------------------------------------ flash
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plain_matches_reference_oracle(case, dtype):
    *_, causal, window, qoff = case
    (qj, qt), (kj, kt), (vj, vt) = _qkv(case, dtype)
    out = tfa_ops.flash_attention(qt, kt, vt, qoff, causal=causal,
                                  window=window)
    exp = fa_ref.attention_ref(qj, kj, vj, qoff, causal=causal, window=window)
    assert out.dtype == qt.dtype
    np.testing.assert_allclose(_np(out), _np(exp), atol=FLASH_TOL[dtype])


# interpret mode is slow on the CPU: three cases (GQA, window, offset)
@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[2],
                                  FLASH_CASES[3]])
def test_flash_plain_matches_reference_pallas_interpret(case):
    *_, causal, window, qoff = case
    (qj, qt), (kj, kt), (vj, vt) = _qkv(case, "float32")
    out = tfa_ops.flash_attention(qt, kt, vt, qoff, causal=causal,
                                  window=window)
    exp = fa_ops.flash_attention(qj, kj, vj, jnp.int32(qoff), causal=causal,
                                 window=window)
    np.testing.assert_allclose(_np(out), _np(exp), atol=FLASH_TOL["float32"])


def test_flash_plain_odd_shape_matches_reference():
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng.standard_normal((1, 15, 2, 64)).astype(np.float32),
                   "float32")
    kj, kt = _pair(rng.standard_normal((1, 15, 2, 64)).astype(np.float32),
                   "float32")
    out = tfa_ops.flash_attention(qt, kt, kt, causal=True, window=0)
    exp = fa_ops.flash_attention(qj, kj, kj, causal=True, window=0)
    np.testing.assert_allclose(_np(out), _np(exp), atol=FLASH_TOL["float32"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plain_per_row_offsets_match_reference_rows(dtype):
    """B = 2 with distinct per-row offsets vs the reference oracle one batch
    row at a time (its wrapper takes one scalar offset)."""
    case = (2, 32, 96, 4, 2, 64)
    offsets = [0, 50]
    (qj, qt), (kj, kt), (vj, vt) = _qkv(case, dtype, seed=3)
    out = tfa_ops.flash_attention(
        qt, kt, vt, torch.tensor(offsets, dtype=torch.int32), causal=True,
        window=24)
    for b, off in enumerate(offsets):
        exp = fa_ref.attention_ref(qj[b:b + 1], kj[b:b + 1], vj[b:b + 1],
                                   off, causal=True, window=24)
        np.testing.assert_allclose(_np(out[b:b + 1]), _np(exp),
                                   atol=FLASH_TOL[dtype])


def test_flash_global_window_sentinel_means_global():
    (_, qt), (_, kt), (_, vt) = _qkv((1, 16, 16, 2, 1, 32), "float32")
    a = tfa_ops.flash_attention(qt, kt, vt, causal=True,
                                window=tfa_ops.GLOBAL_WINDOW)
    b = tfa_ops.flash_attention(qt, kt, vt, causal=True, window=0)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plain_path_counts_no_kernel_launch(dtype):
    """A CPU tensor takes the plain version: neither launch count moves."""
    (_, qt), (_, kt), (_, vt) = _qkv((1, 16, 16, 2, 1, 32), dtype)
    fa = tfa_ops.flash_attention
    before = (fa.launches, fa.launches_tc)
    fa(qt, kt, vt, causal=True)
    assert (fa.launches, fa.launches_tc) == before


# ------------------------------------------------------------------ build
def test_library_name_is_keyed_by_source_content(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path(src)
    src.write_text("// two\n")
    assert _build.library_path(src) != first
    assert first.parent == _build.BUILD_DIR
    assert sorted(p.name for p in _build.sources()) == [
        "flash_attention.cu", "rmsnorm.cu", "ssd.cu"]


def test_library_name_is_keyed_by_shared_headers(monkeypatch, tmp_path):
    """A source that includes a header of ``include/`` is rebuilt when the
    header changes: the header's content is part of the library's name."""
    (tmp_path / "include").mkdir()
    header = tmp_path / "include" / "common.cuh"
    header.write_text("// one\n")
    src = tmp_path / "k" / "csrc" / "k.cu"
    src.parent.mkdir(parents=True)
    src.write_text('#include "../../include/common.cuh"\n')
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path)
    assert _build.headers() == [header]
    first = _build.library_path(src)
    header.write_text("// two\n")
    assert _build.library_path(src) != first
    header.write_text("// one\n")
    assert _build.library_path(src) == first
    monkeypatch.undo()
    assert [p.name for p in _build.headers()] == ["hopper.cuh"]


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    src = tmp_path / "k.cu"
    src.write_text("// never compiled here\n")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all([src])
