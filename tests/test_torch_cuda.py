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
# gemma3-4b's decode rows (4, 1, 2560) here; its prefill rows (6144, 2560)
# in RMSNORM_LAYOUT_CASES, held at half a bf16 ulp of the fp32 result: over
# 15.7 M outputs some reach |y| >= 4, where one bf16 ulp (0.03125) exceeds
# the absolute RMSNORM_TOL, and the kernel's fp32 sum, taken in another
# order than the plain version's, rounds a few of them the other way
@pytest.mark.parametrize("shape", RMSNORM_SHAPES + [
    (2048, 2048), (4, 1, 2048), (4, 1, 2560)])
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
# vector) and prefill (2,048 rows, 6,144 for gemma3's D 2560: a thread per
# two vectors); then shapes that leave each branch ragged: a part-filled
# last warp, a part-filled second vector, several vectors a thread, and
# rows wider than the 16 vectors a thread keeps in registers (the re-read
# tail)
RMSNORM_LAYOUT_CASES = [
    (4, 768), (4, 1536), (4, 2048), (4, 2560),
    (2048, 768), (2048, 1536), (2048, 2048), (6144, 2560),
    # qwen2-vl-7b (D 3584), jamba's norms (D 4096) and its gated norm over
    # d_inner (D 8192, fp32 on the serving path)
    (4, 3584), (2048, 3584), (4, 4096), (2048, 4096), (4, 8192), (2048, 8192),
    # whisper-medium (D 1024): its encoder's 4 x 1,500 frames and its
    # decoder prefill's 4 x 128 tokens
    (6000, 1024), (512, 1024),
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
    train shape of internlm2-1.8b and the LM workflow's (read from a
    profiled window that holds its marker kernel: a window that recorded
    no CUDA activity is profiled again, not read as no launch)."""
    from repro_torch.launch.profile_serve import profiled
    x, w, dy = _bwd_inputs(shape, torch.bfloat16, 7, cuda)
    assert trn_ops.plan_bwd(*shape, 2, 132).route == "ring"
    trn_ops.rmsnorm_bwd(x, w, dy)
    torch.cuda.synchronize()
    _, kernels, _ = profiled(lambda: trn_ops.rmsnorm_bwd(x, w, dy))
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
    # head_dim 256 (gemma3: GQA 2): Sq and Sk on either side of one and two
    # tiles, a q_offset, non-causal, a window narrower than one kv tile and
    # one spanning several, then gemma3-4b's local and global prefill
    (2, 63, 65, 8, 4, 256, True, 0, 0),
    (1, 127, 129, 4, 2, 256, True, 0, 2),
    (2, 129, 128, 2, 1, 256, True, 0, 0),
    (1, 65, 129, 8, 4, 256, True, 0, 64),
    (1, 128, 127, 4, 2, 256, False, 0, 0),
    (2, 200, 200, 4, 2, 256, True, 40, 0),
    (2, 300, 330, 8, 4, 256, True, 150, 30),
    (4, 1536, 1536, 8, 4, 256, True, 1024, 0),
    (4, 1536, 1568, 8, 4, 256, True, 0, 0),
    # qwen2-vl-7b's GQA group of 7 (28 query heads over 4): ragged Sq and
    # Sk with an offset, then its prefill; jamba's prefill (32 over 8)
    (2, 65, 129, 7, 1, 128, True, 0, 64),
    (1, 127, 131, 14, 2, 128, True, 0, 4),
    (4, 512, 544, 28, 4, 128, True, 0, 0),
    (4, 512, 544, 32, 8, 128, True, 0, 0),
    # whisper-medium: non-causal over 1,500 keys, ragged past 23 kv tiles
    # (1,500 = 23 x 64 + 28; zero-filled keys past Sk must get no weight),
    # then its encoder (non-causal, 1,500 frames) and decoder prefill
    (1, 1500, 1500, 2, 2, 64, False, 0, 0),
    (4, 1500, 1500, 16, 16, 64, False, 0, 0),
    (4, 128, 160, 16, 16, 64, True, 0, 0),
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
    for d in (64, 256):
        q = torch.randn(1, 64, 2, d, device=cuda)
        before, before_tc = (tfa_ops.flash_attention.launches,
                             tfa_ops.flash_attention.launches_tc)
        tfa_ops.flash_attention(q, q, q)
        assert (tfa_ops.flash_attention.launches,
                tfa_ops.flash_attention.launches_tc) == (before + 1, before_tc)
        tfa_ops.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
        torch.cuda.synchronize()
        assert (tfa_ops.flash_attention.launches,
                tfa_ops.flash_attention.launches_tc) == (before + 2,
                                                         before_tc + 1)


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


@pytest.mark.cuda
@pytest.mark.parametrize("s, pos", [(1, 13), (6, 0), (8, 0), (20, 0), (3, 5)])
def test_ring_update_on_the_card_is_bitwise_the_cpu(cuda, s, pos):
    """The ring write (a wrapping decode slot, S < W with its phantom
    slots, S == W, S > W, a write at an offset) gives the same bits on
    ``cuda`` as on the CPU, in place on either."""
    from repro_torch.models import layers
    g = torch.Generator().manual_seed(s)
    kc, vc = (torch.randn(2, 8, 2, 256, generator=g).bfloat16()
              for _ in range(2))
    kp = torch.randint(-5, 3, (2, 8), generator=g, dtype=torch.int32)
    kp[:, ::3] = -(1 << 30)
    k, v = (torch.randn(2, s, 2, 256, generator=g).bfloat16() for _ in range(2))
    cpu = layers.ring_update(kc.clone(), vc.clone(), kp.clone(), k, v, pos)
    ring = tuple(t.to(cuda) for t in (kc, vc, kp))
    card = layers.ring_update(*ring, k.to(cuda), v.to(cuda), pos)
    torch.cuda.synchronize()
    for a, b, r in zip(cpu, card, ring):
        assert b is r and torch.equal(a, b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [32, 256])
def test_windowed_forward_on_the_card_matches_the_cpu(cuda, head_dim):
    """A reduced gemma3 (ring caches, window 8) served on the card, prefill
    through the flash kernel, against the same weights and tokens on the
    CPU (the plain versions): prefill of 20 tokens and 8 teacher-forced
    decode steps (the ring wraps), each step's logits within 3e-2 of the
    CPU's max |logit|, the ring's positions equal."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.models.params import tree_map
    from repro_torch.train import steps
    cfg = dataclasses.replace(
        configs.reduced(configs.get("gemma3-4b")), attn_impl="flash",
        **({} if head_dim == 32 else
           {"num_heads": 2, "num_kv_heads": 1, "head_dim": 256}))
    params = registry.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 28),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        before = tfa_ops.flash_attention.launches_tc
        with torch.inference_mode():
            logits, cache = steps.prefill_step(
                cfg, p, {"tokens": toks[:, :20].to(dev)}, max_len=28)
            got = [logits.float().cpu()]
            for i in range(20, 28):
                logits, cache = steps.decode_step(
                    cfg, p, toks[:, i:i + 1].to(dev), cache)
                got.append(logits.float().cpu())
        launched = tfa_ops.flash_attention.launches_tc - before
        assert launched == (cfg.num_layers if dev == "cuda" else 0)
        out[dev] = (got, cache["kpl"].cpu())
    (cpu, kp_cpu), (card, kp_card) = out["cpu"], out["cuda"]
    assert torch.equal(kp_cpu, kp_card)
    for step, (a, b) in enumerate(zip(cpu, card)):
        err = float((a - b).abs().max() / a.abs().max())
        assert err < 3e-2, (step, err)


def _moe_inputs(e, k, shared, b, s, d=256, f=128, cf=1.25):
    """A MoE block's config, weights and bf16 input from a seeded CPU
    generator: bf16 experts, an fp32 router wider than the init's 0.02
    (routing clear of rounding), optional shared experts."""
    from repro_torch.models.config import MoECfg
    g = torch.Generator().manual_seed(e * 100 + k)

    def w(*shape, scale=0.05, dtype=torch.bfloat16):
        return (scale * torch.randn(shape, generator=g)).to(dtype)

    mcfg = MoECfg(num_experts=e, top_k=k, expert_d_ff=f, num_shared=shared,
                  shared_d_ff=4 * f if shared else 0, capacity_factor=cf)
    p = {"router": w(d, e, scale=0.5, dtype=torch.float32),
         "w_gate": w(e, d, f), "w_up": w(e, d, f), "w_down": w(e, f, d)}
    if shared:
        p["shared"] = {"w_gate": w(d, 4 * f), "w_up": w(d, 4 * f),
                       "w_down": w(4 * f, d)}
        p["shared_gate"] = w(d, 1, dtype=torch.float32)
    x = torch.randn(b, s, d, generator=g).to(torch.bfloat16)
    return mcfg, p, x


# (experts, top-k, shared, B, S): granite's and qwen2-moe's routing at a
# prefill of 64 tokens and at a decode step of batch 4 (capacity 1)
MOE_CUDA_CASES = [(32, 8, 0, 2, 32), (60, 4, 4, 2, 32), (32, 8, 0, 4, 1),
                  (60, 4, 4, 4, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MOE_CUDA_CASES, ids=str)
def test_moe_block_on_the_card_matches_the_cpu(cuda, case):
    """The same weights and input on the card and the CPU: every routing
    integer equal, the output within 3e-2 of the CPU's max |out|."""
    from repro_torch.models import moe
    from repro_torch.models.params import tree_map
    mcfg, p, x = _moe_inputs(*case)
    out = {}
    for dev in ("cpu", "cuda"):
        pd, xd = tree_map(lambda t: t.to(dev), p), x.to(dev)
        rt = moe.route(mcfg, pd["router"], xd.reshape(-1, x.shape[-1]))
        y, aux = moe.moe_block(mcfg, pd, xd)
        out[dev] = (rt, y.float().cpu(), float(aux))
    (rc, yc, ac), (rg, yg, ag) = out["cpu"], out["cuda"]
    for key in ("expert_idx", "order", "keep", "flat_slot", "token_for_slot",
                "filled"):
        assert torch.equal(getattr(rc, key), getattr(rg, key).cpu()), key
    assert rc.cap == rg.cap
    assert float((yc - yg).abs().max() / yc.abs().max()) < 3e-2
    assert abs(ac - ag) < 1e-5 * max(abs(ac), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", MOE_CUDA_CASES, ids=str)
def test_moe_block_is_the_same_bits_on_every_card_run(cuda, case,
                                                      monkeypatch):
    """Two card runs give the same bits, under
    ``torch.use_deterministic_algorithms(True)``, which raises for an op
    that has no deterministic card implementation: the block has none.
    The mode asks cuBLAS for a fixed workspace (its documented setting,
    ``CUBLAS_WORKSPACE_CONFIG``), or it raises at the experts' matmuls."""
    from repro_torch.models import moe
    from repro_torch.models.params import tree_map
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    mcfg, p, x = _moe_inputs(*case)
    p, x = tree_map(lambda t: t.to(cuda), p), x.to(cuda)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        (a, aux_a), (b, aux_b) = (moe.moe_block(mcfg, p, x) for _ in range(2))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(aux_a, aux_b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "qwen2-moe-a2.7b",
                                  "jamba-v0.1-52b"])
def test_moe_forward_on_the_card_matches_the_cpu(cuda, name, monkeypatch):
    """A reduced config with MoE layers (capacity factor 1.25, so decode at
    batch 2 runs at capacity 1) served on the card, prefill through the
    flash kernel (and, for jamba's Mamba-2 layers, the SSD kernel),
    against the same weights and tokens on the CPU: prefill of 16 tokens
    and 6 teacher-forced decode steps. Routing flips where two experts
    nearly tie and the card's bf16 hidden state rounds one ulp apart, so
    the card first routes on its own (its picks must agree with the CPU's
    on at least 90% of the (token, layer) rows), then takes the CPU's
    picks, and every step's logits must be within 3e-2 of the CPU's max
    |logit|."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import moe, registry
    from repro_torch.models.params import tree_map
    from repro_torch.train import steps
    cfg = configs.reduced(configs.get(name))
    cfg = dataclasses.replace(cfg, attn_impl="flash", moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))
    params = registry.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 22),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    real = moe.top_k

    def run(dev, forced=None):
        picks = []

        def top_k(probs, k):
            idx = (real(probs, k)[1] if forced is None
                   else forced[len(picks)].to(probs.device))
            picks.append(idx.cpu())
            return probs.gather(1, idx), idx

        monkeypatch.setattr(moe, "top_k", top_k)
        p = tree_map(lambda t: t.to(dev), params)
        before = tfa_ops.flash_attention.launches_tc
        with torch.inference_mode():
            logits, cache = steps.prefill_step(
                cfg, p, {"tokens": toks[:, :16].to(dev)}, max_len=22)
            got = [logits.float().cpu()]
            for i in range(16, 22):
                logits, cache = steps.decode_step(
                    cfg, p, toks[:, i:i + 1].to(dev), cache)
                got.append(logits.float().cpu())
        launched = tfa_ops.flash_attention.launches_tc - before
        assert launched == (n_attn if dev == "cuda" else 0)
        return got, picks

    n_attn = sum(cfg.layer_is_attn(i) for i in range(cfg.num_layers))
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    cpu, cpu_picks = run("cpu")
    _, own = run("cuda")
    rows = sum(len(a) for a in cpu_picks)
    agree = sum(int((a == b).all(1).sum()) for a, b in zip(cpu_picks, own))
    assert len(own) == len(cpu_picks) == 7 * n_moe
    assert agree >= 0.9 * rows, (agree, rows)
    card, _ = run("cuda", cpu_picks)
    for step, (a, b) in enumerate(zip(cpu, card)):
        err = float((a - b).abs().max() / a.abs().max())
        assert err < 3e-2, (step, err)


@pytest.mark.cuda
@pytest.mark.parametrize("case", MOE_CUDA_CASES, ids=str)
def test_moe_block_gradients_repeat_bitwise_on_the_card(cuda, case):
    """The block's backward twice on the card, with the deterministic mode
    off (its default): the gradients of x, the router and every expert
    tensor (the shared expert and its gate too) are the same bits. The
    two row reads' backwards are gathers (``models/moe.py``), so no float
    atomic orders a sum."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import moe
    from repro_torch.models.params import tree_map
    mcfg, p, x = _moe_inputs(*case)
    p, x = tree_map(lambda t: t.to(cuda), p), x.to(cuda)
    g = torch.randn(x.shape, generator=torch.Generator(device=cuda)
                    .manual_seed(2), device=cuda).to(x.dtype)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        runs = []
        for _ in range(2):
            params = tree_map(lambda t: t.detach().requires_grad_(), p)
            xl = x.detach().requires_grad_()
            out, aux = moe.moe_block(mcfg, params, xl)
            loss = (out.float() * g.float()).sum() + 0.5 * aux
            runs.append(torch.autograd.grad(loss, [xl] + tree_leaves(params)))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was)
    for a, b in zip(*runs):
        assert bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0
        assert torch.equal(a, b)


def _named(tree, prefix=""):
    """{path: leaf} over nested dicts and lists ("groups.1.moe.router")."""
    if not isinstance(tree, (dict, list)):
        return {prefix: tree}
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        out.update(_named(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "jamba-v0.1-52b"])
def test_moe_and_hybrid_gradients_on_the_card_match_the_cpu(cuda, name,
                                                            monkeypatch):
    """``value_and_grad`` of a reduced config with MoE layers (capacity
    factor 1.25: drops) under ``remat="block"`` on the card, through the
    RMSNorm kernels (and jamba's SSD kernels), against the plain path: the
    same weights and tokens on the CPU, where each wrapper takes its plain
    version. The card routes on its own first, and a recompute must route
    as its forward did; the CPU takes the card's picks, call by call (both
    run the same calls in the same order). Loss within 1e-2 relative, every
    leaf's gradient within 6e-2 of its max |g| (``chip_smoke.py``'s
    GRAD_REL_TOL); the card's counts are the remat arithmetic; a second
    card run gives the same bits, leaf for leaf."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import moe, registry
    from repro_torch.models.params import tree_map
    from repro_torch.train import steps
    cfg = configs.reduced(configs.get(name))
    cfg = dataclasses.replace(cfg, grad_accum=1, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))
    params = registry.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    real_route = moe.route

    def run(dev, forced=None):
        seen = []      # (the router's address: its layer, the top-k picks)

        def route(mcfg, router, xt):
            rt = real_route(mcfg, router, xt)
            seen.append((router.data_ptr(), rt.expert_idx.cpu()))
            return rt

        def top_k(probs, k):
            idx = forced[len(seen)].to(probs.device)
            return probs.gather(1, idx), idx

        monkeypatch.setattr(moe, "route", route)
        if forced is not None:
            monkeypatch.setattr(moe, "top_k", top_k)
        for w, attr in ((trn_ops.rmsnorm, "launches"),
                        (trn_ops.rmsnorm_bwd, "launches"),
                        (tssd_ops.ssd, "launches"),
                        (tssd_ops.ssd, "launches_bwd")):
            setattr(w, attr, 0)
        metrics, grads = steps.value_and_grad(
            cfg, tree_map(lambda t: t.to(dev), params),
            {"tokens": toks.to(dev)})
        counts = (trn_ops.rmsnorm.launches, trn_ops.rmsnorm_bwd.launches,
                  tssd_ops.ssd.launches, tssd_ops.ssd.launches_bwd)
        return float(metrics["loss"]), _named(grads), seen, counts

    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    if cfg.family == "hybrid":   # ln1, ln2 a layer, the gated norm a mixer
        n_ssm = cfg.num_layers - cfg.num_layers // cfg.attn_every
        norms, ssd_calls = 2 * cfg.num_layers + n_ssm, n_ssm
    else:
        norms, ssd_calls = 2 * cfg.num_layers, 0
    loss, grads, seen, counts = run("cuda")
    assert counts == (2 * norms + 1, norms + 1, 2 * ssd_calls, ssd_calls)
    by_layer = {}
    for ptr, idx in seen:
        by_layer.setdefault(ptr, []).append(idx)
    # each MoE layer routes twice: in the forward and in its recompute
    assert len(by_layer) == n_moe and len(seen) == 2 * n_moe
    assert all(len(v) == 2 and torch.equal(*v) for v in by_layer.values())
    picks = [idx for _, idx in seen]
    loss2, grads2, _, _ = run("cuda", picks)
    assert loss2 == loss
    for key, g in grads.items():
        assert torch.equal(g, grads2[key]), key
    cpu_loss, cpu_grads, _, _ = run("cpu", picks)
    assert abs(loss - cpu_loss) < 1e-2 * cpu_loss
    for key, g in cpu_grads.items():
        k = grads[key].float().cpu()
        assert bool(torch.isfinite(k).all()), key
        err = float((k - g.float()).abs().max() / g.float().abs().max())
        assert err < 6e-2, (key, err)


@pytest.mark.cuda
def test_vlm_forward_on_the_card_matches_the_cpu(cuda):
    """The reduced qwen2-vl served on the card (flash in prefill, RMSNorm
    everywhere) with a 9-patch vision prefix and three different M-RoPE
    streams (a 3 x 3 grid at t = 0, h = row, w = col, text from 3), against
    the same weights and inputs on the CPU: prefill of 16 tokens and 6
    teacher-forced decode steps, each step's logits within 3e-2 of the
    CPU's max |logit|."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.models.params import tree_map
    from repro_torch.train import steps
    cfg = dataclasses.replace(configs.reduced(configs.get("qwen2-vl-7b")),
                              attn_impl="flash")
    params = registry.init(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 22), generator=g,
                         dtype=torch.int32)
    vision = torch.randn(2, 9, cfg.d_model, generator=g).bfloat16()
    r = torch.arange(9)
    pos = torch.cat([torch.stack([torch.zeros(9, dtype=torch.long),
                                  r // 3, r % 3]),
                     (3 + torch.arange(7)).expand(3, 7)], 1)
    pos = pos[:, None].expand(3, 2, 16).to(torch.int32)

    def run(dev):
        p = tree_map(lambda t: t.to(dev), params)
        before = tfa_ops.flash_attention.launches_tc
        with torch.inference_mode():
            logits, cache = steps.prefill_step(
                cfg, p, {"tokens": toks[:, :16].to(dev),
                         "vision_embeds": vision.to(dev),
                         "mrope_positions": pos.to(dev)}, max_len=22)
            got = [logits.float().cpu()]
            for i in range(16, 22):
                logits, cache = steps.decode_step(
                    cfg, p, toks[:, i:i + 1].to(dev), cache)
                got.append(logits.float().cpu())
        launched = tfa_ops.flash_attention.launches_tc - before
        assert launched == (cfg.num_layers if dev == "cuda" else 0)
        return got

    for step, (a, b) in enumerate(zip(run("cpu"), run("cuda"))):
        err = float((a - b).abs().max() / a.abs().max())
        assert err < 3e-2, (step, err)


def _audio_model():
    """The reduced whisper (2 + 2 layers, d 128) with random weights on the
    CPU, seeded frames (2 x 16, its ``cross_len``) and tokens."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import registry
    cfg = dataclasses.replace(configs.reduced(configs.get("whisper-medium")),
                              attn_impl="flash")
    params = registry.init(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 22), generator=g,
                         dtype=torch.int32)
    frames = torch.randn(2, cfg.encdec.cross_len, cfg.d_model,
                         generator=g).bfloat16()
    return cfg, params, toks, frames


@pytest.mark.cuda
def test_audio_forward_on_the_card_matches_the_cpu(cuda):
    """The reduced whisper served on the card (flash in the encoder, non-
    causal, and in decoder prefill; RMSNorm everywhere) against the same
    weights and inputs on the CPU: prefill of 16 tokens and 6
    teacher-forced decode steps, each step's logits within 3e-2 of the
    CPU's max |logit|, and the encoder states the cache carries."""
    from repro_torch.models.params import tree_map
    from repro_torch.train import steps
    cfg, params, toks, frames = _audio_model()

    def run(dev):
        p = tree_map(lambda t: t.to(dev), params)
        before = tfa_ops.flash_attention.launches_tc
        with torch.inference_mode():
            logits, cache = steps.prefill_step(
                cfg, p, {"tokens": toks[:, :16].to(dev),
                         "frames": frames.to(dev)}, max_len=22)
            got = [logits.float().cpu()]
            for i in range(16, 22):
                logits, cache = steps.decode_step(
                    cfg, p, toks[:, i:i + 1].to(dev), cache)
                got.append(logits.float().cpu())
        launched = tfa_ops.flash_attention.launches_tc - before
        n = cfg.encdec.enc_layers + cfg.encdec.dec_layers
        assert launched == (n if dev == "cuda" else 0)
        return got, cache["enc_out"].float().cpu()

    (cpu, cpu_enc), (card, card_enc) = run("cpu"), run("cuda")
    assert float((cpu_enc - card_enc).abs().max() / cpu_enc.abs().max()) < 3e-2
    for step, (a, b) in enumerate(zip(cpu, card)):
        err = float((a - b).abs().max() / a.abs().max())
        assert err < 3e-2, (step, err)


@pytest.mark.cuda
def test_audio_train_step_on_the_card_matches_the_cpu(cuda):
    """One ``train_step`` of the reduced whisper (plain chunked attention,
    RMSNormFn's kernels) on the card against the CPU: loss at 1e-2 and
    grad norm at 2e-2 relative; the norms' counts are the remat
    arithmetic (each encoder layer's two norms and each decoder layer's
    three run twice, ``enc_norm`` and the final norm once)."""
    import dataclasses
    from repro_torch.models.params import tree_map
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    cfg, params, toks, frames = _audio_model()
    cfg = dataclasses.replace(cfg, attn_impl="chunked")
    le, ld = cfg.encdec.enc_layers, cfg.encdec.dec_layers
    batch = {"tokens": toks, "frames": frames}
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        state = steps.TrainState(params=p, opt=adamw.init(p))
        trn_ops.rmsnorm.launches = trn_ops.rmsnorm_bwd.launches = 0
        _, metrics = steps.train_step(
            cfg, state, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = {k: float(v) for k, v in metrics.items()}
        if dev == "cuda":
            assert (trn_ops.rmsnorm.launches, trn_ops.rmsnorm_bwd.launches) == (
                4 * le + 6 * ld + 2, 2 * le + 3 * ld + 2)
    assert abs(out["cuda"]["loss"] - out["cpu"]["loss"]) < 1e-2 * out["cpu"]["loss"]
    assert abs(out["cuda"]["grad_norm"] - out["cpu"]["grad_norm"]) < \
        2e-2 * out["cpu"]["grad_norm"]


SSD_CUDA_CASES = [
    # b, S, H, P, N, chunk: tests/test_kernels.py's cases, the reduced
    # mamba2 config, jamba's SSMCfg, the mamba2-130m serving shape, then
    # jamba's serving shape (128 heads: blocks of 8 heads)
    (2, 64, 3, 16, 32, 16),
    (1, 128, 4, 32, 16, 32),
    (2, 48, 2, 16, 8, 16),
    (1, 96, 8, 8, 8, 32),
    (2, 16, 16, 16, 16, 8),
    (1, 256, 4, 64, 16, 128),
    (4, 512, 24, 64, 128, 128),
    (4, 512, 128, 64, 16, 128),      # jamba's prefill at full width
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
    """bf16 at the mamba2 serving shape and at jamba's (N = 16; its serving
    shape with 128 heads in blocks of 8) takes the tensor-core kernel; fp32
    at the serving shape does not."""
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if n_sms == 132:
        assert tssd_ops.head_group(4, 4, 128, n_sms) == 8
    g = torch.Generator(device=cuda).manual_seed(5)
    for case, dtype, tc in [((4, 512, 24, 64, 128, 128), "bfloat16", True),
                            ((1, 256, 4, 64, 16, 128), "bfloat16", True),
                            ((4, 512, 128, 64, 16, 128), "bfloat16", True),
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


def _ssd_bwd_inputs(case, dtype, g, dev):
    """The backward's inputs: x, dt, cs, B, C as ``_ssd_inputs`` makes
    them, and random cotangents of y_intra and of the states."""
    b, S, H, P, N, L = case
    x, dt, a, Bm, Cm = _ssd_inputs(case, dtype, g, dev)
    cs = torch.cumsum((dt * a).reshape(b, S // L, L, H), 2).reshape(b, S, H)
    dy = torch.randn(b, S, H, P, generator=g, device=dev)
    dst = torch.randn(b, S // L, H, N, P, generator=g, device=dev)
    return x, dt, cs, Bm, Cm, dy, dst


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CUDA_CASES + SSD_TC_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_bwd_kernel_matches_plain_and_repeats_bitwise(cuda, case, dtype):
    """``ssd_chunk_bwd`` against ``ssd_chunk_bwd_ref`` at the forward's
    CUDA-core and tensor-core shapes: every output fp32, held at 1e-4 of
    its max |ref| (the forward's bound; the kernel computes in fp32 from
    either input type), finite, one count a call; a second call gives the
    same bits (the head sums run in a fixed order, with no atomics)."""
    L = case[-1]
    args = _ssd_bwd_inputs(case, dtype, torch.Generator(device=cuda).manual_seed(9),
                           cuda)
    shape = (getattr(torch, dtype), L, case[4], case[3])
    tc = tssd_ops.bwd_route(*shape) == "tc"
    # every case the forward sends to the tensor cores sends its backward
    # there too (none has a head wider than 64 at chunk 128)
    assert tc == (tssd_ops.route(*shape) == "tc")
    before = (tssd_ops.ssd.launches_bwd, tssd_ops.ssd.launches_bwd_tc)
    got = tssd_ops.ssd_chunk_bwd(*args, chunk=L)
    again = tssd_ops.ssd_chunk_bwd(*args, chunk=L)
    torch.cuda.synchronize()
    assert (tssd_ops.ssd.launches_bwd, tssd_ops.ssd.launches_bwd_tc) == (
        before[0] + 2, before[1] + 2 * tc)
    want = tssd_ref.ssd_chunk_bwd_ref(*args, chunk=L)
    for name, o, w, o2 in zip(("dx", "ddt", "dcs", "dB", "dC"), got, want, again):
        assert o.dtype == torch.float32 and o.shape == w.shape, name
        assert bool(torch.isfinite(o).all()), name
        torch.testing.assert_close(o, w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()), msg=name)
        assert torch.equal(o, o2), name


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["x", "B", "C"])
def test_ssd_bwd_tensor_core_kernel_raises_on_a_misaligned_operand(cuda, operand):
    """A bf16 operand 2 bytes off a 16-byte boundary (a view one element
    into its storage): the tensor-core backward, whose TMA maps need the
    alignment, raises rather than taking the CUDA-core kernels."""
    case = (1, 256, 4, 64, 16, 128)
    args = list(_ssd_bwd_inputs(case, "bfloat16",
                                torch.Generator(device=cuda).manual_seed(11), cuda))
    k = {"x": 0, "B": 3, "C": 4}[operand]
    t = args[k]
    off = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:].view(t.shape)
    off.copy_(t)
    assert off.is_contiguous() and off.data_ptr() % 16
    args[k] = off
    assert tssd_ops.bwd_route(torch.bfloat16, 128, 16, 64) == "tc"
    before = (tssd_ops.ssd.launches_bwd, tssd_ops.ssd.launches_bwd_tc)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tssd_ops.ssd_chunk_bwd(*args, chunk=128)
    assert (tssd_ops.ssd.launches_bwd, tssd_ops.ssd.launches_bwd_tc) == before


@pytest.mark.cuda
def test_ssd_gradients_on_the_card_flow_through_the_backward_kernel(cuda):
    """``ops.ssd`` under autograd on the card (ragged S, from h0): one
    forward and one backward launch, and every gradient against the same
    on the CPU (the plain versions): the fp32 ones within 1e-4 of their
    max, the bf16 ones (x, B, C, rounded from fp32 on either side) within
    one bf16 ulp (2^-8) of their max."""
    case = (2, 300, 24, 64, 128, 128)
    g = torch.Generator(device=cuda).manual_seed(10)
    x, dt, a, Bm, Cm = _ssd_inputs(case, "bfloat16", g, cuda)
    h0 = torch.randn(2, 24, 64, 128, generator=g, device=cuda)
    gy = torch.randn(2, 300, 24, 64, generator=g, device=cuda)
    gh = torch.randn(2, 24, 64, 128, generator=g, device=cuda)
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.detach().to(dev).requires_grad_()
                  for t in (x, dt, a, Bm, Cm, h0)]
        before = (tssd_ops.ssd.launches, tssd_ops.ssd.launches_bwd,
                  tssd_ops.ssd.launches_bwd_tc)
        y, h = tssd_ops.ssd(*leaves[:5], chunk=128, h0=leaves[5])
        grads[dev] = torch.autograd.grad((y, h), leaves, (gy.to(dev), gh.to(dev)))
        if dev == "cuda":   # the backward on the tensor cores (bf16, chunk 128)
            assert (tssd_ops.ssd.launches, tssd_ops.ssd.launches_bwd,
                    tssd_ops.ssd.launches_bwd_tc) == (
                before[0] + 1, before[1] + 1, before[2] + 1)
    for name, c, k in zip(("x", "dt", "a", "B", "C", "h0"), grads["cpu"],
                          grads["cuda"]):
        assert c.dtype == k.dtype, name
        tol = 1e-4 if c.dtype == torch.float32 else 2.0 ** -8
        k = k.float().cpu()
        assert bool(torch.isfinite(k).all()), name
        torch.testing.assert_close(k, c.float(), rtol=0,
                                   atol=tol * float(c.float().abs().max()),
                                   msg=name)


@pytest.mark.cuda
def test_mamba2_train_step_on_the_card_matches_the_cpu(cuda):
    """One ``train_step`` of the reduced mamba2 (chunk 8: the SSD's
    CUDA-core forward and the backward kernel) on the card against the
    CPU: loss at 1e-2 and grad norm at 2e-2 relative; the counts are the
    remat arithmetic (each layer's SSD and two norms run twice, one
    backward each)."""
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.models.params import tree_map
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    cfg = configs.reduced(configs.get("mamba2-130m"))
    L = cfg.num_layers
    params = registry.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 40),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        state = steps.TrainState(params=p, opt=adamw.init(p))
        counts = (trn_ops.rmsnorm, trn_ops.rmsnorm_bwd)
        for w in counts:
            w.launches = 0
        tssd_ops.ssd.launches = tssd_ops.ssd.launches_bwd = 0
        _, metrics = steps.train_step(cfg, state, {"tokens": tokens.to(dev)})
        out[dev] = {k: float(v) for k, v in metrics.items()}
        if dev == "cuda":
            assert (trn_ops.rmsnorm.launches, trn_ops.rmsnorm_bwd.launches,
                    tssd_ops.ssd.launches, tssd_ops.ssd.launches_bwd) == (
                4 * L + 1, 2 * L + 1, 2 * L, L)
    assert all(torch.isfinite(torch.tensor(list(m.values()))).all()
               for m in out.values())
    assert abs(out["cuda"]["loss"] - out["cpu"]["loss"]) < 1e-2 * out["cpu"]["loss"]
    assert abs(out["cuda"]["grad_norm"] - out["cpu"]["grad_norm"]) < \
        2e-2 * out["cpu"]["grad_norm"]


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


@pytest.mark.cuda
def test_local_mesh_on_the_card_is_one_nccl_device_reused(cuda):
    """``make_local_mesh("cuda")`` twice: a (1, 1) mesh named ("data",
    "model") on the card, one nccl group of world size 1, the second call
    reusing it; the group is destroyed at the block's end."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    if dist.is_initialized():
        dist.destroy_process_group()
    with tmesh.local_mesh("cuda") as first:
        group = dist.group.WORLD
        second = tmesh.make_local_mesh("cuda")
        assert dist.group.WORLD is group and first == second
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        assert tuple(first.shape) == (1, 1)
        assert first.mesh_dim_names == ("data", "model")
        assert first.device_type == "cuda"
    assert not dist.is_initialized()


@pytest.mark.cuda
def test_place_aliases_storage_on_the_card(cuda):
    """The reduced internlm2's train state placed under TRAIN_2D on the
    card's mesh: every DTensor's local tensor shares the storage of the
    tensor it was made from, and a train step of the local tensors is
    bitwise one of the tensors themselves."""
    import torch.distributed as dist
    from repro_torch import configs as tconfigs
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import mesh as tmesh, train as ttrain
    from repro_torch.models import params as tparams
    from repro_torch.train import steps as tsteps
    if dist.is_initialized():
        dist.destroy_process_group()
    cfg = tconfigs.reduced(tconfigs.get("internlm2-1.8b"))
    state = tsteps.init_train_state(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=torch.Generator().manual_seed(1),
                                     dtype=torch.int32).to(cuda)}
    with tmesh.local_mesh("cuda") as mesh:
        placed = tparams.place(state, ttrain.state_shardings(cfg, mesh))
        back = tparams.local(placed)
        for t, d, b in zip(tree_leaves(state), tree_leaves(placed),
                           tree_leaves(back)):
            ptr = t.untyped_storage().data_ptr()
            assert d.to_local().untyped_storage().data_ptr() == ptr
            assert b.untyped_storage().data_ptr() == ptr and b.is_cuda
        got, gm = tsteps.train_step(cfg, back, batch)
    want, wm = tsteps.train_step(cfg, state, batch)
    assert float(gm["loss"]) == float(wm["loss"])
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
