"""FlashAttention-forward wrapper: the CUDA kernels on CUDA tensors, the
plain version on CPU tensors.

On the card the input type picks the kernel: bf16 runs the tensor-core
kernel (wgmma fed by TMA), fp32 the CUDA-core kernel, whose fp32 products
hold the fp32 tolerance that bf16 tensor-core products cannot. Both live
in ``csrc/flash_attention.cu``.

Twin of the JAX package's ``kernels/flash_attention/ops.py``, with two
differences: ``q_offset`` is per batch row, (B,) int32, because that is
what the model path passes; and there is no off-tile fallback — the kernel
masks ragged Sq/Sk edges itself, and what it does not take raises.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import _build
from .ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# A "very large" window meaning global attention (the JAX package's
# ``models.layers.GLOBAL_WINDOW``); ``models.layers`` takes it from here.
GLOBAL_WINDOW = 1 << 30
HEAD_DIMS = (32, 64, 128, 256)  # instantiated in the kernel
# input type -> the library's launch function for it
_ENTRY = {torch.bfloat16: "flash_attention_fwd_bf16",
          torch.float32: "flash_attention_fwd_fp32"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: torch.Tensor | int | None = None, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D); q_offset: (B,) int32, an int,
    or None (0). Query row i of batch b sits at position q_offset[b] + i.

    window: 0 or >= GLOBAL_WINDOW → global attention.
    Returns (B, Sq, H, D) in q.dtype.
    """
    if window >= GLOBAL_WINDOW:
        window = 0
    if q_offset is None:
        q_offset = 0
    if q.device.type == "cpu":
        return attention_ref(q, k, v, q_offset, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")

    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q/k/v dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; want one of {list(_ENTRY)}")
    if k.shape != (b, sk, kvh, d) or v.shape != k.shape or h % kvh:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if not isinstance(q_offset, torch.Tensor):
        q_offset = torch.full((b,), int(q_offset), dtype=torch.int32,
                              device=q.device)
    if q_offset.shape != (b,) or q_offset.dtype != torch.int32:
        raise ValueError(f"flash_attention: q_offset must be ({b},) int32, got "
                         f"{q_offset.dtype} {tuple(q_offset.shape)}")
    tensors = (q, k, v, q_offset)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention: q, k, v, q_offset on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention: q, k, v, q_offset must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")

    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    entry = _ENTRY[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_offset.data_ptr(),
        out.data_ptr(), b, sq, sk, h, kvh, d, int(causal), int(window),
        float(d ** -0.5), stream)
    _build.check(lib, code, entry)
    flash_attention.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention.launches_tc += 1
    return out


flash_attention.launches = 0      # kernel launches since last set to 0
flash_attention.launches_tc = 0   # of those, the bf16 tensor-core kernel's
