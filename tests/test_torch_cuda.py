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
