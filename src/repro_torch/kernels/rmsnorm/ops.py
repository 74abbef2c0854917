"""RMSNorm wrapper: the CUDA kernel on a CUDA tensor, the plain version on
a CPU tensor.

Twin of the JAX package's ``kernels/rmsnorm/ops.py``. There is no off-tile
fallback: the kernel takes any number of rows and any ``D % 8 == 0``, and
anything else on a CUDA tensor raises.

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
from .ref import rmsnorm_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_THREADS = 512     # a row's block at most (rmsnorm.cu)


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


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMSNorm over the last dim: fp32 math, result in ``x.dtype``.

    x: (..., D) fp32 or bf16; w: (D,) fp32.
    """
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
