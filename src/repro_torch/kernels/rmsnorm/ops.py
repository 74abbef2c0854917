"""RMSNorm wrappers: the CUDA kernels on a CUDA tensor, the plain versions
on a CPU tensor.

Twin of the JAX package's ``kernels/rmsnorm/ops.py``. There is no off-tile
fallback: the kernels take any number of rows and any ``D % 8 == 0`` (the
backward up to D 16384 in fp32 and 32768 in bf16), and anything else on a
CUDA tensor raises.

``rmsnorm`` is differentiable: where grad mode is on and ``x`` or ``w``
requires grad it goes through :class:`RMSNormFn`, whose forward is the
forward kernel and whose backward is ``rmsnorm_bwd`` (one cooperative
launch of ``rmsnorm.cu``, its geometry from :func:`plan_bwd`). Otherwise
(serving, ``no_grad``, ``inference_mode``) it launches the forward kernel
directly and records no graph.

The wrapper runs 49 times a forward in both served models, and at decode
the host, not the card, sets the pace, so its own cost is kept low: the
launch function is bound once, the stream is read through the raw-stream
call PyTorch's generated code uses, both pointers' alignment is tested in
one expression, and the block size (the backward's plan) is cached per
shape.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from .. import _build
from .ref import rmsnorm_bwd_ref, rmsnorm_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_THREADS = 512     # a row's block at most (rmsnorm.cu)
MAX_BWD_VECS = 8      # stripe route: 16-byte vectors of a row a thread holds
RING_VECS = 4         # ring route: 16-byte vectors of a row a lane holds at most
RING_WARPS = 16       # ring route: warps a block at most
RING_MAX_STAGES = 2   # ring route: rows a group has staged at most
RING_GROUP_ROWS = 4   # ring route: rows a group walks, at most about
RING_ROW_BYTES = 2048  # ring route: a group walks a row per 2 KB of x and dy
SMEM_MAX = 232448     # shared memory a block can opt into on Hopper (227 KB)
ROUTES = {"ring": 0, "stripe": 1}   # rmsnorm.cu kRouteRing, kRouteStripe


def plan(n_rows: int, d: int, elem_bytes: int, n_sms: int) -> int:
    """Threads of the block that normalises one row of ``d`` elements of
    ``elem_bytes`` bytes, for ``n_rows`` rows on a card of ``n_sms`` SMs.

    Fewer rows than two per SM (decode): one thread per 16-byte vector of
    the row, so each block finishes in one round trip to memory. More
    (prefill): one thread per two vectors, so more rows fit on an SM at
    once. Both rounded up to whole warps, at most ``MAX_THREADS``. At the
    serving shapes this is the fastest of the mappings
    ``launch/rmsnorm_layouts.py`` times (``PERF.md``).
    """
    vecs = d * elem_bytes // 16
    per_thread = 1 if n_rows < 2 * n_sms else 2
    return min(MAX_THREADS, -(-vecs // (32 * per_thread)) * 32)


class BwdPlan(NamedTuple):
    """The backward's launch geometry (``rmsnorm.cu``)."""
    route: str      # "ring" (rows staged in shared memory) or "stripe"
    threads: int    # a block
    nv: int         # 16-byte vectors of a row a thread holds (a power of two)
    group: int      # warps that own a row (stripe: the block's)
    stages: int     # ring: rows of x and dy a group has in flight; stripe: 0
    smem: int       # dynamic shared memory a block, bytes
    grid: int       # blocks: all resident at once (the dw sum syncs the grid)


def _pow2(n: int) -> int:
    """The least power of two ≥ n (n ≥ 1)."""
    return 1 << (n - 1).bit_length()


def _ring_smem(groups: int, group: int, stages: int, d: int,
               elem_bytes: int) -> int:
    """Dynamic shared memory of a ring block (``rmsnorm.cu``
    ``rmsnorm_bwd_ring``): each group's slots (a row of x and one of dy a
    stage), a full and an empty mbarrier a slot, and each warp's row sums
    (2 parities × 2 fp32)."""
    slots = groups * stages
    return slots * 2 * d * elem_bytes + 16 * slots + 16 * groups * group


def plan_bwd(n_rows: int, d: int, elem_bytes: int, n_sms: int) -> BwdPlan:
    """The backward's geometry for ``n_rows`` rows of ``d`` elements of
    ``elem_bytes`` bytes on a card of ``n_sms`` SMs, before the occupancy
    query (which can only lower ``grid``).

    Ring, where a row fits ``RING_WARPS`` warps of ``RING_VECS`` vectors a
    lane: a group of ``group`` warps a row (the fewest, a power of two);
    enough groups a block (a power of two, at most ``RING_WARPS`` warps,
    halved while one stage of each overflows ``SMEM_MAX``) that each walks
    one row per ``RING_ROW_BYTES`` of a row's x and dy, 1 to
    ``RING_GROUP_ROWS`` rows; one block an SM at most and no more blocks
    than rows need; and as many stages a group (at most
    ``RING_MAX_STAGES``) as it has rows and the shared memory holds. At
    (2048, 2048) bf16 that is 4 groups of 2 warps with 2 stages, and at
    the LM workflow's (512, 128) 4 one-warp groups of 1 stage: the fastest
    of the geometries ``launch/rmsnorm_bwd_layouts.py`` times on the H100
    (``PERF.md``). Large rows gain from a group walking a few in turn
    (more rows in flight at once finish together and leave the SM's
    compute to the end); small ones from more groups. Stripe, for wider
    rows: a block a row, ``MAX_THREADS`` threads of ``MAX_BWD_VECS``
    vectors, two blocks an SM at most and no more than rows. Raises for a
    row too wide for both."""
    vecs = d * elem_bytes // 16
    group = _pow2(-(-vecs // (32 * RING_VECS)))
    if group <= RING_WARPS:
        nv = _pow2(-(-vecs // (32 * group)))
        per_group = max(1, min(RING_GROUP_ROWS,
                               2 * d * elem_bytes // RING_ROW_BYTES))
        per_sm = -(-n_rows // n_sms)
        groups = min(RING_WARPS // group, _pow2(-(-per_sm // per_group)))
        while groups > 1 and _ring_smem(groups, group, 1, d, elem_bytes) > SMEM_MAX:
            groups //= 2
        grid = min(n_sms, -(-n_rows // groups))
        stages = min(RING_MAX_STAGES, -(-n_rows // (grid * groups)))
        while stages > 1 and _ring_smem(groups, group, stages, d,
                                        elem_bytes) > SMEM_MAX:
            stages -= 1
        return BwdPlan("ring", 32 * groups * group, nv, group, stages,
                       _ring_smem(groups, group, stages, d, elem_bytes), grid)
    if vecs > MAX_THREADS * MAX_BWD_VECS:
        raise ValueError(f"rmsnorm_bwd: D={d} is wider than "
                         f"{MAX_THREADS * MAX_BWD_VECS} vectors of 16 bytes")
    return BwdPlan("stripe", MAX_THREADS, MAX_BWD_VECS, MAX_THREADS // 32, 0,
                   0, min(2 * n_sms, n_rows))


@functools.lru_cache(maxsize=256)
def _bwd_plan(n_rows: int, d: int, elem_bytes: int, device: int) -> BwdPlan:
    """``plan_bwd`` on this card, its grid cut to the blocks the occupancy
    query lets be resident at once; cached per shape and device."""
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    p = plan_bwd(n_rows, d, elem_bytes, n_sms)
    with torch.cuda.device(device):
        per_sm = _bwd_occupancy()(int(elem_bytes == 2), ROUTES[p.route], p.nv,
                                  p.threads, p.smem)
    if per_sm < 0:
        _build.check(_build.load(SOURCE), -per_sm, "rmsnorm_bwd occupancy")
    if per_sm == 0:
        raise RuntimeError(f"rmsnorm_bwd: no block of {p} fits an SM")
    return p._replace(grid=min(p.grid, per_sm * n_sms))


@functools.lru_cache(maxsize=256)
def _threads(n_rows: int, d: int, elem_bytes: int, device: int) -> int:
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    return plan(n_rows, d, elem_bytes, n_sms)


@functools.cache
def _fwd():
    """The library's launch function, bound once."""
    lib = _build.load(SOURCE)
    fn = lib.rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd():
    """The library's backward launch function, bound once."""
    lib = _build.load(SOURCE)
    fn = lib.rmsnorm_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_occupancy():
    """The library's occupancy query for the backward, bound once."""
    fn = _build.load(SOURCE).rmsnorm_bwd_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMSNorm over the last dim: fp32 math, result in ``x.dtype``.

    x: (..., D) fp32 or bf16; w: (D,) fp32. Differentiable (through
    :class:`RMSNormFn`) where grad mode is on and x or w requires grad.
    """
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNormFn.apply(x, w, eps)
    dev = x.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return rmsnorm_ref(x, w, eps)
        raise ValueError(f"rmsnorm: unsupported device {dev}")
    d = x.shape[-1]
    is_bf16 = _DTYPES.get(x.dtype)
    if is_bf16 is None:
        raise ValueError(f"rmsnorm: x dtype {x.dtype} not in {list(_DTYPES)}")
    if w.dtype != torch.float32 or w.shape != (d,) or w.device != dev:
        raise ValueError(f"rmsnorm: w must be fp32 ({d},) on {dev}, "
                         f"got {w.dtype} {tuple(w.shape)} on {w.device}")
    if d % 8:
        raise ValueError(f"rmsnorm: D={d} is not a multiple of 8")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    xp, wp = x.data_ptr(), w.data_ptr()
    if (xp | wp) & 15:
        raise ValueError("rmsnorm: x and w must be 16-byte aligned")
    n = x.numel() // d
    out = torch.empty_like(x)
    if n == 0:
        return out
    idx = dev.index
    code = _fwd()(xp, wp, out.data_ptr(), n, d, eps, is_bf16,
                  _threads(n, d, x.element_size(), idx),
                  torch._C._cuda_getCurrentRawStream(idx))
    if code:
        _build.check(_build.load(SOURCE), code, "rmsnorm_fwd")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0   # kernel launches since the caller last set it to 0


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradient of :func:`rmsnorm` for the output gradient ``dy``: returns
    (dx in x's dtype and shape, dw (D,) fp32). r is recomputed from x.

    x, dy: (..., D) fp32 or bf16, the same dtype and shape; w: (D,) fp32.
    dw is the same bits on every run on one card (rmsnorm.cu sums its
    per-block partials in a fixed order).
    """
    dev = x.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return rmsnorm_bwd_ref(x, w, dy, eps)
        raise ValueError(f"rmsnorm_bwd: unsupported device {dev}")
    d = x.shape[-1]
    is_bf16 = _DTYPES.get(x.dtype)
    if is_bf16 is None:
        raise ValueError(f"rmsnorm_bwd: x dtype {x.dtype} not in {list(_DTYPES)}")
    if w.dtype != torch.float32 or w.shape != (d,) or w.device != dev:
        raise ValueError(f"rmsnorm_bwd: w must be fp32 ({d},) on {dev}, "
                         f"got {w.dtype} {tuple(w.shape)} on {w.device}")
    if dy.dtype != x.dtype or dy.shape != x.shape or dy.device != dev:
        raise ValueError(f"rmsnorm_bwd: dy must be {x.dtype} "
                         f"{tuple(x.shape)} on {dev}, got {dy.dtype} "
                         f"{tuple(dy.shape)} on {dy.device}")
    if d % 8:
        raise ValueError(f"rmsnorm_bwd: D={d} is not a multiple of 8")
    if not (x.is_contiguous() and w.is_contiguous() and dy.is_contiguous()):
        raise ValueError("rmsnorm_bwd: x, w and dy must be contiguous")
    if (x.data_ptr() | w.data_ptr() | dy.data_ptr()) & 15:
        raise ValueError("rmsnorm_bwd: x, w and dy must be 16-byte aligned")
    n = x.numel() // d
    dx = torch.empty_like(x)
    if n == 0:
        return dx, torch.zeros(d, dtype=torch.float32, device=dev)
    idx = dev.index
    p = _bwd_plan(n, d, x.element_size(), idx)
    dw = torch.empty(d, dtype=torch.float32, device=dev)   # every column written
    partial = torch.empty((p.grid, d), dtype=torch.float32, device=dev)
    code = _bwd()(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                  partial.data_ptr(), dw.data_ptr(), n, d, eps, is_bf16,
                  ROUTES[p.route], p.nv, p.threads, p.group, p.stages, p.smem,
                  p.grid,
                  torch._C._cuda_getCurrentRawStream(idx))
    if code:
        _build.check(_build.load(SOURCE), code, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx, dw


rmsnorm_bwd.launches = 0   # launches (one a call) since the caller set it to 0


class RMSNormFn(torch.autograd.Function):
    """RMSNorm with a hand-written backward: the forward kernel, then
    ``rmsnorm_bwd``. Both take their plain versions for CPU tensors only,
    so on the CPU this runs ``rmsnorm_bwd_ref``'s formula. Saves x and w;
    the backward recomputes r from x."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps)      # grad mode is off in here: a launch

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy.contiguous(), ctx.eps)
        need_x, need_w, _ = ctx.needs_input_grad
        return (dx if need_x else None), (dw if need_w else None), None
