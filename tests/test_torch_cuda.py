"""The CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (inside the ``cuda`` fixture) where
``torch.cuda.is_available()`` is False. This file imports no JAX, so it
runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: fp32 differs only in
summation order; a bf16 output may round one ulp apart (2^-8 relative).
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as tfa_ops, ref as tfa_ref
from repro_torch.kernels.rmsnorm import ops as trn_ops, ref as trn_ref

FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
RMSNORM_TOL = 2e-2
DTYPES = ["float32", "bfloat16"]
RMSNORM_SHAPES = [(8, 128), (3, 5, 64), (257, 96), (1, 8)]
FLASH_CASES = [
    # B, Sq, Sk, H, KV, D, causal, window, qoff (tests/test_kernels.py's cases)
    (2, 128, 128, 4, 2, 64, True, 0, 0),
    (1, 256, 256, 8, 8, 32, True, 0, 0),
    (2, 128, 128, 4, 4, 64, True, 16, 0),
    (1, 64, 128, 4, 2, 64, True, 0, 64),
    (2, 128, 128, 2, 1, 128, False, 0, 0),
    (1, 512, 512, 2, 2, 64, True, 128, 0),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RMSNORM_SHAPES + [(2048, 2048), (4, 1, 2048)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(getattr(torch, dtype))
    w = torch.randn(shape[-1:], generator=g, device=cuda)
    before = trn_ops.rmsnorm.launches
    out = trn_ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert trn_ops.rmsnorm.launches == before + 1
    torch.testing.assert_close(out.float(), trn_ref.rmsnorm_ref(x, w).float(),
                               atol=RMSNORM_TOL, rtol=0)


@pytest.mark.cuda
def test_rmsnorm_kernel_rejects_what_it_does_not_take(cuda):
    w = torch.ones(12, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        trn_ops.rmsnorm(torch.ones(4, 12, device=cuda), w)
    with pytest.raises(ValueError, match="dtype"):
        trn_ops.rmsnorm(torch.ones(4, 16, device=cuda, dtype=torch.float16),
                        torch.ones(16, device=cuda))


FLASH_CUDA_CASES = FLASH_CASES + [
    (1, 15, 15, 2, 2, 64, True, 0, 0),        # ragged Sq and Sk
    (4, 512, 544, 16, 8, 128, True, 0, 0),    # the serving prefill shape
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CUDA_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    B, Sq, Sk, H, KV, D, causal, window, qoff = case
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda).to(dt)
    k = torch.randn(B, Sk, KV, D, generator=g, device=cuda).to(dt)
    v = torch.randn(B, Sk, KV, D, generator=g, device=cuda).to(dt)
    off = torch.arange(B, dtype=torch.int32, device=cuda) * 7 + qoff
    before = tfa_ops.flash_attention.launches
    out = tfa_ops.flash_attention(q, k, v, off, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa_ops.flash_attention.launches == before + 1
    exp = tfa_ref.attention_ref(q, k, v, off, causal=causal, window=window)
    torch.testing.assert_close(out.float(), exp.float(),
                               atol=FLASH_TOL[dtype], rtol=0)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.ones(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfa_ops.flash_attention(q, q, q)
    q = torch.ones(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tfa_ops.flash_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2), q)
