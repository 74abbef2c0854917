"""The CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (inside the ``cuda`` fixture) where
``torch.cuda.is_available()`` is False. This file imports no JAX, so it
runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: fp32 differs only in
summation order; a bf16 output may round one ulp apart (2^-8 relative).
The SSD kernel computes in fp32 from either input type, so it is held at
the reference's 1e-4·max|y| and 1e-4·max(max|h|, 1) for both.
"""
import time

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as tfa_ops, ref as tfa_ref
from repro_torch.kernels.rmsnorm import ops as trn_ops, ref as trn_ref
from repro_torch.kernels.ssd import ops as tssd_ops, ref as tssd_ref

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


# (rows, D): each serving D at decode (4 rows: a thread per 16-byte
# vector) and prefill (2,048 rows: a thread per two vectors); then shapes
# that leave each branch ragged: a part-filled last warp, a part-filled
# second vector, several vectors a thread, and rows wider than the 16
# vectors a thread keeps in registers (the re-read tail)
RMSNORM_LAYOUT_CASES = [
    (4, 768), (4, 1536), (4, 2048), (2048, 768), (2048, 1536), (2048, 2048),
    (3, 776), (2049, 776), (600, 12288), (300, 12296), (5, 40000), (4, 72),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RMSNORM_LAYOUT_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_matches_plain_at_each_block_size(cuda, shape, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, generator=g, device=cuda).to(dt)
    w = torch.randn(shape[-1:], generator=g, device=cuda)
    before = trn_ops.rmsnorm.launches
    out = trn_ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert trn_ops.rmsnorm.launches == before + 1
    # against the fp32 result: fp32 differs only in summation order, and a
    # bf16 output is that value rounded, within half a bf16 ulp (2^-8
    # relative) of it, whatever its magnitude
    exp = trn_ref.rmsnorm_ref(x.float(), w)
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -8 + 1e-5
    torch.testing.assert_close(out.float(), exp, atol=1e-5, rtol=rtol)


# (rows, D) of the backward: the train shape of internlm2-1.8b (batch 4 x
# 512), odd row counts (one row, fewer rows than warps, a grid whose warps
# end on different row counts), part-filled warps, several vectors a
# thread, the widest D the repo's configs have, groups of 4 to 16 warps a
# row, rows too wide for the ring in fp32 (the stripe route), and the LM
# workflow's D 128 at more rows than groups (two ring stages a group)
RMSNORM_BWD_CASES = [
    (2048, 2048), (1, 2048), (3, 2048), (257, 96), (2049, 776), (8, 128),
    (5, 8), (600, 8192), (33, 12288), (1000, 2056), (257, 2048), (4096, 128),
]


def _bwd_close(got, want, tol):
    """max |got - want| / max(1, max |want|) <= tol: dx and dw hold values
    far from 1 (dw sums one term a row), so the error is taken relative to
    their scale; a bf16 dx may round one ulp (2^-8 of it) apart."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    return err <= tol * max(1.0, float(want.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RMSNORM_BWD_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_bwd_kernel_matches_plain(cuda, shape, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(shape, generator=g, device=cuda).to(dt)
    dy = torch.randn(shape, generator=g, device=cuda).to(dt)
    w = torch.randn(shape[-1:], generator=g, device=cuda)
    before = trn_ops.rmsnorm_bwd.launches
    dx, dw = trn_ops.rmsnorm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert trn_ops.rmsnorm_bwd.launches == before + 1
    assert dx.dtype == dt and dx.shape == x.shape
    assert dw.dtype == torch.float32 and dw.shape == w.shape
    dx_ref, dw_ref = trn_ref.rmsnorm_bwd_ref(x, w, dy)
    ok, err = _bwd_close(dx, dx_ref, FLASH_TOL[dtype])
    assert ok, ("dx", err)
    ok, err = _bwd_close(dw, dw_ref, FLASH_TOL["float32"])
    assert ok, ("dw", err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_bwd_dw_is_the_same_bits_on_every_run(cuda, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(3)
    x, dy = (torch.randn(2048, 2048, generator=g, device=cuda).to(dt)
             for _ in range(2))
    w = torch.randn(2048, generator=g, device=cuda)
    runs = [trn_ops.rmsnorm_bwd(x, w, dy) for _ in range(3)]
    for dx, dw in runs[1:]:
        assert torch.equal(dw, runs[0][1]) and torch.equal(dx, runs[0][0])


def _bwd_inputs(shape, dtype, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x, dy = (torch.randn(shape, generator=g, device=dev).to(dtype)
             for _ in range(2))
    return x, torch.randn(shape[-1:], generator=g, device=dev), dy


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 2048), (4096, 128), (600, 8192),
                                   (4, 32768)], ids=str)
def test_rmsnorm_bwd_replays_in_a_cuda_graph(cuda, shape):
    """The cooperative launch captured in a CUDA graph and replayed on new
    inputs: the same bits as an eager call on them, on the ring (groups of
    2, 1 and 8 warps) and the stripe route."""
    x, w, dy = _bwd_inputs(shape, torch.bfloat16, 5, cuda)
    trn_ops.rmsnorm_bwd(x, w, dy)           # plans the shape outside capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        trn_ops.rmsnorm_bwd(x, w, dy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dx, dw = trn_ops.rmsnorm_bwd(x, w, dy)
    x2, w2, dy2 = _bwd_inputs(shape, torch.bfloat16, 6, cuda)
    for t, new in ((x, x2), (w, w2), (dy, dy2)):
        t.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    dx_eager, dw_eager = trn_ops.rmsnorm_bwd(x2, w2, dy2)
    assert torch.equal(dx, dx_eager) and torch.equal(dw, dw_eager)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 2048), (512, 128)], ids=str)
def test_rmsnorm_bwd_runs_one_kernel_a_call_at_the_train_shapes(cuda, shape):
    """One device kernel a call on the ring route, and no fill, at the
    train shape of internlm2-1.8b and the LM workflow's."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    x, w, dy = _bwd_inputs(shape, torch.bfloat16, 7, cuda)
    assert trn_ops.plan_bwd(*shape, 2, 132).route == "ring"
    trn_ops.rmsnorm_bwd(x, w, dy)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trn_ops.rmsnorm_bwd(x, w, dy)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    assert sum(kernels.values()) == 1, kernels


@pytest.mark.cuda
def test_rmsnorm_bwd_rejects_what_it_does_not_take(cuda):
    x = torch.randn(4, 64, device=cuda)
    w = torch.randn(64, device=cuda)
    with pytest.raises(ValueError, match="dy"):
        trn_ops.rmsnorm_bwd(x, w, torch.randn(4, 64, device=cuda).bfloat16())
    with pytest.raises(ValueError, match="dy"):
        trn_ops.rmsnorm_bwd(x, w, torch.randn(4, 32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        trn_ops.rmsnorm_bwd(x, w, torch.randn(64, 4, device=cuda).T)
    with pytest.raises(ValueError, match="wider"):
        trn_ops.rmsnorm_bwd(torch.randn(2, 16392, device=cuda),
                            torch.randn(16392, device=cuda),
                            torch.randn(2, 16392, device=cuda))


def _plain_rmsnorm(x, w, eps=1e-5):
    return trn_ref.rmsnorm_ref(x, w, eps)


@pytest.mark.cuda
def test_train_step_norm_gradients_flow_through_the_kernels(cuda, monkeypatch):
    """A train step's gradients on the card, through RMSNormFn (forward
    and backward kernels), against the same step with every norm plain:
    the norm weights' gradients are non-zero and agree, and the counts are
    the remat arithmetic (4L + 1 forwards, 2L + 1 backwards)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import layers
    from repro_torch.train import steps
    cfg = dataclasses.replace(configs.reduced(configs.get("internlm2-1.8b")),
                              num_layers=3)
    state = steps.init_train_state(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    trn_ops.rmsnorm.launches = trn_ops.rmsnorm_bwd.launches = 0
    metrics, grads = steps.value_and_grad(cfg, state.params, {"tokens": tokens})
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert (trn_ops.rmsnorm.launches, trn_ops.rmsnorm_bwd.launches) == (
        4 * L + 1, 2 * L + 1)
    monkeypatch.setattr(layers, "rmsnorm", _plain_rmsnorm)
    plain_metrics, plain = steps.value_and_grad(cfg, state.params,
                                                {"tokens": tokens})
    assert trn_ops.rmsnorm.launches == 4 * L + 1    # the plain path ran none
    assert abs(float(metrics["loss"]) - float(plain_metrics["loss"])) < 1e-2
    for got, want in ((grads["final_norm"], plain["final_norm"]),
                      (grads["blocks"]["ln1"], plain["blocks"]["ln1"]),
                      (grads["blocks"]["ln2"], plain["blocks"]["ln2"])):
        assert float(got.abs().max()) > 0
        ok, err = _bwd_close(got, want, 2e-2)
        assert ok, err


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
    # the bf16 kernel's tiles are 64 query rows x 64 keys: Sq and Sk on
    # either side of one and two tiles, GQA groups 1/2/4/8, D 32/64/128
    (2, 63, 63, 4, 2, 64, True, 0, 0),
    (2, 64, 64, 8, 1, 128, True, 0, 0),
    (2, 65, 65, 4, 1, 32, True, 0, 0),
    (1, 127, 129, 4, 4, 128, True, 0, 2),
    (1, 128, 127, 4, 2, 64, False, 0, 0),
    (2, 129, 128, 2, 1, 32, True, 0, 0),
    (1, 65, 129, 8, 2, 128, True, 0, 64),
    # a window narrower than one kv tile, and one spanning two
    (2, 200, 200, 4, 2, 64, True, 40, 0),
    (2, 200, 260, 4, 2, 128, True, 100, 30),
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
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_per_row_offsets_in_different_tiles(cuda, dtype):
    """Batch rows whose offsets put their queries in different kv tile
    ranges (0, 70, 150, 236 against Sk = 300), causal and windowed."""
    g = torch.Generator(device=cuda).manual_seed(3)
    dt = getattr(torch, dtype)
    q = torch.randn(4, 64, 4, 128, generator=g, device=cuda).to(dt)
    k = torch.randn(4, 300, 2, 128, generator=g, device=cuda).to(dt)
    v = torch.randn(4, 300, 2, 128, generator=g, device=cuda).to(dt)
    off = torch.tensor([0, 70, 150, 236], dtype=torch.int32, device=cuda)
    for window in (0, 50):
        out = tfa_ops.flash_attention(q, k, v, off, causal=True, window=window)
        exp = tfa_ref.attention_ref(q, k, v, off, causal=True, window=window)
        torch.testing.assert_close(out.float(), exp.float(),
                                   atol=FLASH_TOL[dtype], rtol=0)


@pytest.mark.cuda
def test_flash_bf16_runs_on_the_tensor_core_kernel_and_fp32_does_not(cuda):
    q = torch.randn(1, 64, 2, 64, device=cuda)
    before, before_tc = (tfa_ops.flash_attention.launches,
                         tfa_ops.flash_attention.launches_tc)
    tfa_ops.flash_attention(q, q, q)
    assert (tfa_ops.flash_attention.launches,
            tfa_ops.flash_attention.launches_tc) == (before + 1, before_tc)
    tfa_ops.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    torch.cuda.synchronize()
    assert (tfa_ops.flash_attention.launches,
            tfa_ops.flash_attention.launches_tc) == (before + 2, before_tc + 1)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.ones(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfa_ops.flash_attention(q, q, q)
    q = torch.ones(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tfa_ops.flash_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2), q)
    with pytest.raises(ValueError, match="dtypes"):
        tfa_ops.flash_attention(q.half(), q.half(), q.half())


SSD_CUDA_CASES = [
    # b, S, H, P, N, chunk: tests/test_kernels.py's cases, the reduced
    # mamba2 config, jamba's SSMCfg, then the mamba2-130m serving shape
    (2, 64, 3, 16, 32, 16),
    (1, 128, 4, 32, 16, 32),
    (2, 48, 2, 16, 8, 16),
    (1, 96, 8, 8, 8, 32),
    (2, 16, 16, 16, 16, 8),
    (1, 256, 4, 64, 16, 128),
    (4, 512, 24, 64, 128, 128),
]


def _ssd_inputs(case, dtype, g, dev):
    """x, dt, a, B, C as the model makes them: dt = softplus(N(0, 0.55²)),
    a = -e (the reference init's a_log = 1), so a 128-long chunk decays
    to cs ~ -240 and exp(cs_i - cs_j) overflows for j > i."""
    b, S, H, P, N, _ = case
    dt_ = getattr(torch, dtype)
    x = torch.randn(b, S, H, P, generator=g, device=dev).to(dt_)
    dt = torch.nn.functional.softplus(
        0.55 * torch.randn(b, S, H, generator=g, device=dev))
    a = torch.full((H,), -2.718281828, device=dev)
    Bm = (0.5 * torch.randn(b, S, N, generator=g, device=dev)).to(dt_)
    Cm = (0.5 * torch.randn(b, S, N, generator=g, device=dev)).to(dt_)
    return x, dt, a, Bm, Cm


def _assert_ssd_close(y, h, y_exp, h_exp):
    y_exp, h_exp = y_exp.float(), h_exp.float()
    torch.testing.assert_close(y, y_exp, rtol=0,
                               atol=1e-4 * float(y_exp.abs().max()))
    torch.testing.assert_close(h, h_exp, rtol=0,
                               atol=1e-4 * max(float(h_exp.abs().max()), 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CUDA_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_matches_plain(cuda, case, dtype):
    b, S, H, P, N, L = case
    g = torch.Generator(device=cuda).manual_seed(0)
    x, dt, a, Bm, Cm = _ssd_inputs(case, dtype, g, cuda)
    cs = torch.cumsum((dt * a).reshape(b, S // L, L, H), 2).reshape(b, S, H)
    before = tssd_ops.ssd.launches
    y, st = tssd_ops.ssd_chunk(x, dt, cs, Bm, Cm, chunk=L)
    torch.cuda.synchronize()
    assert tssd_ops.ssd.launches == before + 1
    assert y.dtype == st.dtype == torch.float32
    assert st.shape == (b, S // L, H, N, P)
    _assert_ssd_close(y, st, *tssd_ref.ssd_chunk_ref(x, dt, cs, Bm, Cm, chunk=L))


# shapes only the tensor-core kernel's padding and head groups reach:
# N and P padded to 64 or 128 (48, 32, 80), L = 64 with P = 128, and head
# groups that leave a ragged last group (10 heads in groups of 3) or take
# 5 heads a block
SSD_TC_CASES = [
    (2, 256, 7, 32, 48, 128),
    (1, 128, 5, 128, 64, 64),
    (4, 1024, 10, 64, 128, 128),
    (8, 1024, 5, 128, 32, 64),
    (2, 128, 3, 80, 96, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_TC_CASES)
def test_ssd_tensor_core_kernel_matches_plain_padded_and_grouped(cuda, case):
    b, S, H, P, N, L = case
    assert tssd_ops.route(torch.bfloat16, L, N, P) == "tc"
    g = torch.Generator(device=cuda).manual_seed(4)
    x, dt, a, Bm, Cm = _ssd_inputs(case, "bfloat16", g, cuda)
    cs = torch.cumsum((dt * a).reshape(b, S // L, L, H), 2).reshape(b, S, H)
    before = tssd_ops.ssd.launches_tc
    y, st = tssd_ops.ssd_chunk(x, dt, cs, Bm, Cm, chunk=L)
    torch.cuda.synchronize()
    assert tssd_ops.ssd.launches_tc == before + 1
    _assert_ssd_close(y, st, *tssd_ref.ssd_chunk_ref(x, dt, cs, Bm, Cm, chunk=L))


@pytest.mark.cuda
def test_ssd_serving_and_jamba_shapes_run_on_the_tensor_core_kernel(cuda):
    """bf16 at the mamba2 serving shape and at jamba's (N = 16) takes the
    tensor-core kernel; fp32 at the serving shape does not."""
    g = torch.Generator(device=cuda).manual_seed(5)
    for case, dtype, tc in [((4, 512, 24, 64, 128, 128), "bfloat16", True),
                            ((1, 256, 4, 64, 16, 128), "bfloat16", True),
                            ((4, 512, 24, 64, 128, 128), "float32", False)]:
        b, S, H, P, N, L = case
        x, dt, a, Bm, Cm = _ssd_inputs(case, dtype, g, cuda)
        cs = torch.cumsum((dt * a).reshape(b, S // L, L, H), 2).reshape(b, S, H)
        before = (tssd_ops.ssd.launches, tssd_ops.ssd.launches_tc)
        tssd_ops.ssd_chunk(x, dt, cs, Bm, Cm, chunk=L)
        torch.cuda.synchronize()
        assert (tssd_ops.ssd.launches, tssd_ops.ssd.launches_tc) == (
            before[0] + 1, before[1] + int(tc)), (case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_never_exponentiates_the_masked_half(cuda, dtype):
    """a = -8 and dt ~ 1.5: cs falls by ~1,500 over a chunk, so
    exp(cs_i - cs_j) is +inf for every j > i far from the diagonal; a
    kernel that formed it and multiplied by the causal 0 would give NaN."""
    case = (2, 256, 6, 64, 128, 128)
    b, S, H, P, N, L = case
    g = torch.Generator(device=cuda).manual_seed(6)
    x, dt, _, Bm, Cm = _ssd_inputs(case, dtype, g, cuda)
    dt = dt + 1.0
    a = torch.full((H,), -8.0, device=cuda)
    cs = torch.cumsum((dt * a).reshape(b, S // L, L, H), 2).reshape(b, S, H)
    assert float(cs.reshape(b, S // L, L, H)[:, :, -1].max()) < -1000
    y, st = tssd_ops.ssd_chunk(x, dt, cs, Bm, Cm, chunk=L)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    _assert_ssd_close(y, st, *tssd_ref.ssd_chunk_ref(x, dt, cs, Bm, Cm, chunk=L))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_wrapper_matches_sequential_oracle_ragged_with_h0(cuda, dtype):
    """S = 500 at the serving widths (the pad path), from a non-zero h0."""
    case = (2, 500, 24, 64, 128, 128)
    g = torch.Generator(device=cuda).manual_seed(1)
    x, dt, a, Bm, Cm = _ssd_inputs(case, dtype, g, cuda)
    h0 = torch.randn(2, 24, 64, 128, generator=g, device=cuda)
    y, h = tssd_ops.ssd(x, dt, a, Bm, Cm, chunk=128, h0=h0)
    torch.cuda.synchronize()
    _assert_ssd_close(y, h, *tssd_ref.ssd_ref(x, dt, a, Bm, Cm, h0=h0))


@pytest.mark.cuda
def test_ssd_kernel_rejects_what_it_does_not_take(cuda):
    x, dt, a, Bm, Cm = _ssd_inputs((1, 32, 2, 16, 16, 16), "float32",
                                   torch.Generator(device=cuda).manual_seed(2),
                                   cuda)
    cs = torch.cumsum(dt * a, 1)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssd_ops.ssd_chunk(x, dt, cs, Bm, Cm, chunk=12)
    with pytest.raises(ValueError, match="contiguous"):
        tssd_ops.ssd_chunk(x.transpose(2, 3).contiguous().transpose(2, 3),
                           dt, cs, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="dtype"):
        tssd_ops.ssd_chunk(x.half(), dt, cs, Bm.half(), Cm.half(), chunk=16)
    with pytest.raises(ValueError, match="devices"):
        tssd_ops.ssd_chunk(x, dt, cs, Bm.cpu(), Cm, chunk=16)
    with pytest.raises(ValueError, match="device"):
        tssd_ops.ssd(x, dt, a.cpu(), Bm, Cm, chunk=16)


# -- the Helix core on CUDA tensors -------------------------------------------------

@pytest.mark.cuda
def test_block_makes_compute_cost_count_device_time(cuda, tmp_path):
    """A node that only queues a long matmul loop returns at once on the
    host; the executor's ``_block`` waits for the device, so the node's
    measured C(n) is at least the loop's device time (CUDA events)."""
    from repro_torch.core import dag, executor, omp, store
    x = torch.randn(2048, 2048, device=cuda)

    def loop():
        y = x
        for _ in range(200):
            y = torch.tanh(y @ x)
        return y

    loop()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    loop()
    end.record()
    torch.cuda.synchronize()
    device_s = start.elapsed_time(end) / 1e3
    d = dag.DAG([dag.Node("mm", loop, is_output=True)])
    report = executor.execute(
        d, {"mm": "sig-mm"}, {"mm": dag.State.COMPUTE},
        store.Store(str(tmp_path / "s")), omp.Materializer(policy=omp.Policy.NEVER))
    assert report.runtime["mm"] >= 0.9 * device_s > 0


@pytest.mark.cuda
def test_cuda_entry_offloads_to_pinned_host_and_places_back(cuda, tmp_path):
    """A value loaded from disk onto the card is admitted to the memory
    tier as device tensors: a hit before the offload lands hands those
    tensors back as they are; the writer thread's offload swaps in pinned
    host tensors; a hit after it is placed back on ``cuda`` bitwise equal
    to the saved value."""
    from repro_torch.core.store import Store
    g = torch.Generator(device=cuda).manual_seed(0)
    value = {"w": torch.randn(512, 256, generator=g, device=cuda).bfloat16(),
             "i": torch.arange(1000, device=cuda, dtype=torch.int32),
             "host": torch.ones(3), "pos": 7}
    Store(str(tmp_path / "s")).save("ab12", "n", value)
    place = lambda i, shape, dtype: cuda  # noqa: E731
    store = Store(str(tmp_path / "s"), mem_budget_bytes=64e6)
    offload = store._mem._offload
    store._mem._offload = None          # hold the offload back for now
    first, _ = store.load("ab12", sharding_for_leaf=place)     # disk → card
    assert first["w"].is_cuda and first["host"].is_cuda
    ent = store._mem.peek("ab12")
    assert ent is not None and ent.has_device
    hit, _ = store.load("ab12", sharding_for_leaf=place)       # before it
    assert all(hit[k] is first[k] for k in ("w", "i", "host"))
    store._mem._offload = offload
    offload("ab12")
    store.writer_drain()
    ent = store._mem.peek("ab12")
    assert not ent.has_device
    assert all(t.device.type == "cpu" and t.is_pinned()
               for t in (ent.value["w"], ent.value["i"], ent.value["host"]))
    assert store.tier_status()["memory"]["offload_bytes"] > 0
    got, _ = store.load("ab12", sharding_for_leaf=place)       # after it
    for k in ("w", "i", "host"):
        assert got[k].is_cuda and got[k].dtype == value[k].dtype
        assert torch.equal(got[k].reshape(-1).view(torch.uint8).cpu(),
                           value[k].reshape(-1).view(torch.uint8).cpu())
    assert got["pos"] == 7


@pytest.mark.cuda
def test_session_without_placement_keeps_loaded_values_on_the_card(cuda,
                                                                   tmp_path):
    """A session run without ``load_shardings`` hands every loaded value
    back on ``cuda``, the device it was computed on: from the memory
    tier (which holds the pinned host snapshot the save took), after a
    restart from the disk tier, and from ``Store.load`` once the writer
    has drained."""
    from repro_torch.core import (EngineConfig, IterativeSession, Policy,
                                  Store, StoreConfig, Workflow)
    from repro_torch.core.tree import tree_leaves
    seen = []

    def value():
        g = torch.Generator(device=cuda).manual_seed(0)
        return {"w": torch.randn(256, 256, generator=g,
                                 device=cuda).bfloat16(),
                "b": torch.arange(256, device=cuda, dtype=torch.int32)}

    def make_x():
        time.sleep(0.5)     # dearer than any load: the planner loads x
        return value()

    def f(x, k):
        return x["w"].float() @ x["w"].float() * k + x["b"]

    def build(k):
        wf = Workflow("w")
        x = wf.source("x", make_x, config=0)

        def y(x):
            seen.extend(t.device for t in tree_leaves(x))
            return f(x, k)
        wf.output(wf.extractor("y", y, [x], config=k))
        return wf

    engine = EngineConfig(policy=Policy.ALWAYS)
    storage = StoreConfig(mem_budget_bytes=64e6)
    sess = IterativeSession(str(tmp_path / "w"), engine=engine,
                            storage=storage)
    sess.run(build(1))
    for k, restart in ((2, False), (3, True)):
        if restart:
            sess = IterativeSession(str(tmp_path / "w"), engine=engine,
                                    storage=storage)
        seen.clear()
        report = sess.run(build(k))
        assert report.execution.states["x"].name == "LOAD", k
        assert seen and all(d.type == "cuda" for d in seen), (k, seen)
        assert torch.allclose(report.outputs["y"], f(value(), k))
    sess.store.writer_drain()
    store = Store(str(tmp_path / "w" / "store"))
    for sig in store.entries():
        value, _ = store.load(sig)
        assert all(t.is_cuda for t in tree_leaves(value)
                   if isinstance(t, torch.Tensor)), sig


# The paper workflows' learners (repro_torch.workflows): Helix loads a
# deterministic node's stored value in place of recomputing it, so each
# learner must give the same bits on every run on the card; and it must
# agree with the same call on the CPU as it does with its JAX twin
# (tests/test_torch_workflows.py: 1e-5 of max(1, max |CPU|), int32
# assignments equal). Shapes are the workflows' defaults where they are
# cheap on the CPU, cut where the CPU side would take long.
LEARNER_TOL = 1e-5


def _learner_cases():
    import numpy as np
    from repro_torch import workflows as tw
    from repro_torch.data import synth as tsynth
    rng = np.random.default_rng(0)
    X = (rng.random((24_000, 286)) < 0.05).astype(np.float32)
    y = (X[:, :40].sum(1) + rng.normal(0, 1, 24_000) > 2).astype(np.int32)
    docs = tsynth.documents(11, 600, 160, 4000)
    pts = rng.normal(size=(400, 64)).astype(np.float32)
    imgs, labels = tsynth.images(5, 4000)
    W = rng.normal(size=(28 * 28, 512)).astype(np.float32)
    Z = np.cos(imgs.reshape(4000, -1) @ W)
    return {
        "train_logreg": lambda dev: tw.train_logreg(X, y, 0.1, device=dev),
        "train_embeddings": lambda dev: tw.train_embeddings(
            docs, 4000, 64, 12, device=dev),
        "kmeans": lambda dev: tw.kmeans(pts, 16, device=dev),
        "train_softmax": lambda dev: tw.train_softmax(Z, labels, 1e-3, 60,
                                                      device=dev),
        "encoder_parse": lambda dev: tw.encoder_parse(docs[:300, :96], 4000,
                                                      device=dev),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("learner", ["train_logreg", "train_embeddings",
                                     "kmeans", "train_softmax",
                                     "encoder_parse"])
def test_workflow_learner_is_deterministic_on_the_card(cuda, learner):
    import numpy as np
    fn = _learner_cases()[learner]
    first, second, cpu = fn(cuda), fn(cuda), fn("cpu")
    if learner != "kmeans":
        first, second, cpu = (first,), (second,), (cpu,)
    for a, b, c in zip(first, second, cpu):
        assert isinstance(a, np.ndarray) and a.dtype == c.dtype
        assert a.shape == c.shape and a.tobytes() == b.tobytes()
        if a.dtype == np.int32:
            np.testing.assert_array_equal(a, c)
        else:
            assert np.abs(a - c).max() <= LEARNER_TOL * max(1.0, np.abs(c).max())


# The serving layer on the card (repro_torch.serve): a job summary's
# outputs keep their shape and dtype when they are CUDA tensors, and a
# model workflow the server hosts keeps its values on the card.
@pytest.mark.cuda
def test_jsonable_of_a_cuda_bf16_tensor(cuda):
    from repro_torch.serve.protocol import jsonable
    g = torch.Generator(device=cuda).manual_seed(0)
    small = torch.randn(2, 5, generator=g, device=cuda).bfloat16()
    small.requires_grad_()
    big = torch.randn(4, 40, generator=g, device=cuda).bfloat16()
    got = jsonable({"small": small, "big": big,
                    "zero_d": small[0, 0].detach()})
    assert got["small"] == {"__ndarray__": True, "shape": [2, 5],
                            "dtype": "bfloat16",
                            "data": small.detach().float().cpu().tolist()}
    assert got["big"] == {"__ndarray__": True, "shape": [4, 40],
                          "dtype": "bfloat16", "data": None}
    assert got["zero_d"]["shape"] == [] and isinstance(
        got["zero_d"]["data"], float)
    assert got == jsonable({"small": small.detach().cpu(),
                            "big": big.cpu(),
                            "zero_d": small[0, 0].detach().cpu()})


@pytest.mark.cuda
def test_server_hosts_a_model_on_the_card(cuda, tmp_path):
    """Two jobs of a 2-layer dense serving workflow (flash and RMSNorm
    kernels in prefill, RMSNorm in decode) run at once in one server on
    ``cuda``: each job's tokens and last logits are bitwise those of an
    isolated session, its outputs and every stored entry stay on the
    card, and the shared prefix (params, prompts, prefill) is computed
    once."""
    import dataclasses
    import os
    import sys

    sys.path.insert(0, os.path.abspath(os.path.join(
        os.path.dirname(__file__), os.pardir)))
    import chip_smoke
    from repro_torch import configs
    from repro_torch.core import IterativeSession, Store
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import registry
    from repro_torch.serve import InProcessClient, SessionServer

    cfg = dataclasses.replace(configs.reduced(configs.get("internlm2-1.8b")),
                              num_layers=2, attn_impl="flash")

    def serve(gen_tokens=4):
        return chip_smoke.serve_workflow(
            cfg, lambda: registry.init(
                cfg, torch.Generator(device=cuda).manual_seed(0), cuda),
            int(gen_tokens), device=cuda, batch=2, prompt=16, max_len=24)

    server = SessionServer(str(tmp_path / "srv"), registry={"serve": serve},
                           n_sessions=2, poll_interval=0.01)
    before = fa_ops.flash_attention.launches
    try:
        client = InProcessClient(server)
        jobs = {g: client.submit("serve", {"gen_tokens": g}) for g in (4, 6)}
        summaries = {g: client.wait(j, detail=True) for g, j in jobs.items()}
        reports = {g: server._jobs[j].report for g, j in jobs.items()}
        server.store.writer_drain()
    finally:
        server.shutdown()
    assert fa_ops.flash_attention.launches - before == cfg.num_layers
    blind = [s for g in summaries
             for s in summaries[g]["execution"]["blind_computed_sigs"]]
    assert len(blind) == len(set(blind))
    for g, summary in summaries.items():
        assert summary["outputs"]["decode"]["tokens"]["shape"] == [2, g]
        got = reports[g].outputs["decode"]
        assert got["tokens"].is_cuda and got["last_logits"].is_cuda
        want = IterativeSession(str(tmp_path / f"iso{g}")).run(
            serve(g)).outputs["decode"]
        for key in ("tokens", "last_logits"):
            assert torch.equal(got[key].view(torch.uint8),
                               want[key].view(torch.uint8)), (g, key)
    store = Store(str(tmp_path / "srv" / "store"))
    assert store.entries()
    for sig in store.entries():
        value, _ = store.load(sig)
        assert all(t.is_cuda for t in tree_leaves(value)
                   if isinstance(t, torch.Tensor)), sig
