"""RMSNorm wrapper: the CUDA kernel on a CUDA tensor, the plain version on
a CPU tensor.

Twin of the JAX package's ``kernels/rmsnorm/ops.py``. There is no off-tile
fallback: the kernel takes any number of rows and any ``D % 8 == 0``, and
anything else on a CUDA tensor raises.
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


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.rmsnorm_fwd.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.rmsnorm_fwd.restype = ctypes.c_int
    return lib


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMSNorm over the last dim: fp32 math, result in ``x.dtype``.

    x: (..., D) fp32 or bf16; w: (D,) fp32.
    """
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm: x dtype {x.dtype} not in {list(_DTYPES)}")
    if w.dtype != torch.float32 or w.shape != (d,) or w.device != x.device:
        raise ValueError(f"rmsnorm: w must be fp32 ({d},) on {x.device}, "
                         f"got {w.dtype} {tuple(w.shape)} on {w.device}")
    if d % 8:
        raise ValueError(f"rmsnorm: D={d} is not a multiple of 8")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("rmsnorm: x and w must be 16-byte aligned")
    n = x.numel() // d
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.rmsnorm_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, d,
                           float(eps), _DTYPES[x.dtype], stream)
    _build.check(lib, code, "rmsnorm_fwd")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0   # kernel launches since the caller last set it to 0
