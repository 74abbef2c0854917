"""RMSNorm wrappers: the CUDA kernels on a CUDA tensor, the plain versions
on a CPU tensor.

Twin of the JAX package's ``kernels/rmsnorm/ops.py``. There is no off-tile
fallback: the kernels take any number of rows and any ``D % 8 == 0`` (the
backward a row of at most 8 16-byte vectors a thread, D ≤ 16384 in fp32
and 32768 in bf16), and anything else on a CUDA tensor raises.

``rmsnorm`` is differentiable: where grad mode is on and ``x`` or ``w``
requires grad it goes through :class:`RMSNormFn`, whose forward is the
forward kernel and whose backward is ``rmsnorm_bwd`` (a kernel pair in
``rmsnorm.cu``). Otherwise (serving, ``no_grad``, ``inference_mode``) it
launches the forward kernel directly and records no graph.

The wrapper runs 49 times a forward in both served models, and at decode
the host, not the card, sets the pace, so its own cost is kept low: the
launch function is bound once, the stream is read through the raw-stream
call PyTorch's generated code uses, both pointers' alignment is tested in
one expression, and the block size is cached per shape.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import _build
from .ref import rmsnorm_bwd_ref, rmsnorm_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_THREADS = 512     # a row's block at most (rmsnorm.cu)
MAX_BWD_VECS = 8      # 16-byte vectors of a row a backward thread holds


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


def plan_bwd(n_rows: int, d: int, elem_bytes: int, n_sms: int
             ) -> tuple[int, int]:
    """(threads, rows a block) of the backward for ``n_rows`` rows of ``d``
    elements: a thread per 16-byte vector of the row (whole warps, at most
    ``MAX_THREADS``, then up to ``MAX_BWD_VECS`` vectors a thread), and
    each block a stripe of rows such that about two blocks run on each SM.
    The stripes also set how many fp32 partial rows of dw the reduction
    sums. Raises for a row too wide for the kernel."""
    vecs = d * elem_bytes // 16
    threads = min(MAX_THREADS, -(-vecs // 32) * 32)
    if -(-vecs // threads) > MAX_BWD_VECS:
        raise ValueError(f"rmsnorm_bwd: D={d} is wider than "
                         f"{MAX_THREADS * MAX_BWD_VECS} vectors of 16 bytes")
    return threads, max(1, -(-n_rows // (2 * n_sms)))


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
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
    dw = torch.zeros(d, dtype=torch.float32, device=dev)
    if n == 0:
        return dx, dw
    idx = dev.index
    n_sms = torch.cuda.get_device_properties(idx).multi_processor_count
    threads, rows_per_block = plan_bwd(n, d, x.element_size(), n_sms)
    partial = torch.empty((-(-n // rows_per_block), d), dtype=torch.float32,
                          device=dev)
    code = _bwd()(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                  partial.data_ptr(), dw.data_ptr(), n, d, eps, is_bf16,
                  threads, rows_per_block,
                  torch._C._cuda_getCurrentRawStream(idx))
    if code:
        _build.check(_build.load(SOURCE), code, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx, dw


rmsnorm_bwd.launches = 0   # calls that launched the pair (row kernel, dw sum)


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
