"""SSD wrapper: the CUDA chunk kernel on CUDA tensors, the plain version on
CPU tensors, and the inter-chunk scan in plain torch.

Twin of the JAX package's ``kernels/ssd/ops.py``: ``ssd`` pads S to a
multiple of the chunk, takes the within-chunk cumsum of dt·a, runs the
intra-chunk kernel (``ssd_chunk``, the twin of ``ssd_chunk_pallas``), then
scans the chunk boundary states and adds the inter-chunk output. There is
no off-shape fallback: on a CUDA tensor ``ssd_chunk`` launches a kernel or
raises.

``csrc/ssd.cu`` holds two forward kernels, and ``route`` picks one by
dtype and shape: bf16 at the tensor-core shapes runs the tensor-core
kernel (C Bᵀ once per block of ``head_group`` heads, products as
split-bf16 wgmma); fp32, and every other shape, the CUDA-core kernel. It
also holds the backward (``ssd_chunk_bwd``), which the TPU package does
not have, with the same two routes (``bwd_route``): bf16 at the
tensor-core shapes (head_dim at most 64 at chunk 128) on the tensor cores,
everything else on the CUDA cores. ``SSDChunkFn`` pairs it with the
forward, so that gradients flow through the chunk kernel, and ``ssd``
calls it. The cumsum, the padding and the inter-chunk scan around it are
plain torch, which autograd differentiates.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F

from .. import _build
from .ref import ssd_chunk_bwd_ref, ssd_chunk_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
MAX_DIM = 128     # L, N and P each at most this, and a multiple of 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TC_CHUNKS = (64, 128)   # the tensor-core kernel's chunk lengths
MAX_GROUP = 8           # heads a tensor-core block takes at most
# route -> the library's launch function
_ENTRY = {"tc": "ssd_chunk_fwd_tc", "simt": "ssd_chunk_fwd"}
# bwd_route -> the library's backward function
_BWD_ENTRY = {"tc": "ssd_chunk_bwd_tc", "simt": "ssd_chunk_bwd"}


def route(dtype: torch.dtype, chunk: int, d_state: int, head_dim: int) -> str:
    """Which kernel takes a call: ``"tc"``, the tensor-core kernel, for bf16
    at ``chunk`` 64 or 128 with ``d_state`` and ``head_dim`` multiples of
    16 (the serving shape (128, 128, 64) and jamba's (128, 16, 64));
    ``"simt"``, the CUDA-core kernel, for everything else. The tensor cores
    cannot hold the 1e-4 tolerance from fp32 input without 3xTF32."""
    if (dtype == torch.bfloat16 and chunk in TC_CHUNKS
            and d_state % 16 == 0 and head_dim % 16 == 0):
        return "tc"
    return "simt"


def bwd_route(dtype: torch.dtype, chunk: int, d_state: int,
              head_dim: int) -> str:
    """Which backward takes a call: ``"tc"``, the tensor-core kernels,
    where ``route`` sends the forward to the tensor cores and the head's
    operands fit one block's shared memory (``head_dim`` at most 64 at
    chunk 128, at most 128 at chunk 64); ``"simt"``, the CUDA-core
    kernels, for everything else (fp32 among it: the split-bf16 products
    cannot hold 1e-4 from fp32 x, B, C)."""
    if route(dtype, chunk, d_state, head_dim) == "tc" and (
            chunk == 64 or head_dim <= 64):
        return "tc"
    return "simt"


def head_group(batch: int, n_chunks: int, heads: int, n_sms: int) -> int:
    """Heads per tensor-core block, which computes C Bᵀ once for all of
    them: the fewest that keep the grid of ``batch · n_chunks ·
    ceil(heads / group)`` blocks within one wave of ``n_sms`` (one block
    per SM), at most ``MAX_GROUP``. Serving (4, 4, 24) on 132 SMs: 3."""
    per_cell = max(1, min(heads, n_sms // max(1, batch * n_chunks)))
    return min(MAX_GROUP, -(-heads // per_cell))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (this source's library, or a copy of it built from an
    edited source) with its launch functions' argument types set."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name, n_ptr in ((_BWD_ENTRY["simt"], 14), (_BWD_ENTRY["tc"], 13)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return typed(_build.load(SOURCE))


@functools.cache
def _n_sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(what: str, x, dt, cs, B, C, chunk: int) -> None:
    """What both kernels take: CUDA tensors on one device, x/B/C fp32 or
    bf16 alike, dt/cs fp32, matching shapes, S a multiple of the chunk,
    L, N and P multiples of 4 up to ``MAX_DIM``, all contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    bsz, S, H, P = x.shape
    N = B.shape[-1]
    L = chunk
    tensors = (x, dt, cs, B, C)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{what}: x, dt, cs, B, C on different devices")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"{what}: x/B/C dtypes {x.dtype}/{B.dtype}/"
                         f"{C.dtype}; want one of {list(_DTYPES)}, all alike")
    if dt.dtype != torch.float32 or cs.dtype != torch.float32:
        raise ValueError(f"{what}: dt/cs must be fp32, got {dt.dtype}/"
                         f"{cs.dtype}")
    if (dt.shape != (bsz, S, H) or cs.shape != dt.shape
            or B.shape != (bsz, S, N) or C.shape != B.shape):
        raise ValueError(f"{what}: shapes x{tuple(x.shape)} dt"
                         f"{tuple(dt.shape)} cs{tuple(cs.shape)} "
                         f"B{tuple(B.shape)} C{tuple(C.shape)}")
    if L <= 0 or S % L:
        raise ValueError(f"{what}: S={S} is not a multiple of the chunk {L}")
    for name, v in (("chunk", L), ("d_state", N), ("head_dim", P)):
        if v % 4 or not 4 <= v <= MAX_DIM:
            raise ValueError(f"{what}: {name}={v} is not a multiple of 4 "
                             f"in [4, {MAX_DIM}]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: x, dt, cs, B, C must be contiguous")


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, cs: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, *, chunk: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD.

    x: (b,S,H,P); dt, cs: (b,S,H) fp32; B, C: (b,S,N); S % chunk == 0.
    Returns (y_intra (b,S,H,P) fp32, states (b,nc,H,N,P) fp32).
    """
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, dt, cs, B, C, chunk=chunk)
    _check("ssd_chunk", x, dt, cs, B, C, chunk)
    bsz, S, H, P = x.shape
    N = B.shape[-1]
    L = chunk
    y = torch.empty((bsz, S, H, P), dtype=torch.float32, device=x.device)
    states = torch.empty((bsz, S // L, H, N, P), dtype=torch.float32,
                         device=x.device)
    if y.numel() == 0:
        return y, states
    kind = route(x.dtype, L, N, P)
    if kind == "tc":   # the last int: heads per block
        if any(t.data_ptr() % 16 for t in (x, B, C)):
            raise ValueError("ssd_chunk: x, B, C must be 16-byte aligned")
        last_arg = head_group(bsz, S // L, H, _n_sms(x.device.index))
    else:              # the last int: is_bf16
        last_arg = _DTYPES[x.dtype]
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = getattr(lib, _ENTRY[kind])(
        x.data_ptr(), dt.data_ptr(), cs.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), states.data_ptr(), bsz, S, H, P, N, L,
        last_arg, stream)
    _build.check(lib, code, _ENTRY[kind])
    ssd.launches += 1
    if kind == "tc":
        ssd.launches_tc += 1
    return y, states


def ssd_chunk_bwd(x: torch.Tensor, dt: torch.Tensor, cs: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                  dstates: torch.Tensor, *, chunk: int
                  ) -> tuple[torch.Tensor, ...]:
    """The backward of ``ssd_chunk``: the cotangents ``dy`` of y_intra
    (b,S,H,P) and ``dstates`` of the states (b,nc,H,N,P) to (dx (b,S,H,P),
    ddt, dcs (b,S,H), dB, dC (b,S,N)), all fp32 (``ssd_chunk_bwd_ref``).
    On a CUDA tensor one call is two launches of the kernel ``bwd_route``
    names, each summing dB and dC over the heads in a fixed order with no
    atomics (two calls give the same bits). ``"tc"``: a block per group of
    ``head_group`` heads, chunk and batch row writes dx, ddt, dcs and the
    group's partial dB and dC (a workspace of b·nc·groups·L·N·2 floats),
    then a second launch sums the groups. ``"simt"``: a block per (head,
    chunk, batch row) writes each head's share of dcb and of dB's state
    term (b·nc·H·L·(L + N) floats), then a block per rows of a chunk sums
    them."""
    if x.device.type == "cpu":
        return ssd_chunk_bwd_ref(x, dt, cs, B, C, dy, dstates, chunk=chunk)
    _check("ssd_chunk_bwd", x, dt, cs, B, C, chunk)
    bsz, S, H, P = x.shape
    N = B.shape[-1]
    L = chunk
    nc = S // L
    if dy.shape != x.shape or dstates.shape != (bsz, nc, H, N, P):
        raise ValueError(f"ssd_chunk_bwd: dy{tuple(dy.shape)} and dstates"
                         f"{tuple(dstates.shape)} do not match x"
                         f"{tuple(x.shape)} at d_state {N}")
    if dy.device != x.device or dstates.device != x.device:
        raise ValueError("ssd_chunk_bwd: dy, dstates not on x's device")
    dy = dy.float().contiguous()
    dstates = dstates.float().contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((bsz, S, H, P), **f32)
    ddt = torch.empty((bsz, S, H), **f32)
    dcs = torch.empty((bsz, S, H), **f32)
    dB = torch.empty((bsz, S, N), **f32)
    dC = torch.empty((bsz, S, N), **f32)
    if dx.numel() == 0:
        return dx, ddt, dcs, dB.zero_(), dC.zero_()
    kind = bwd_route(x.dtype, L, N, P)
    if kind == "tc":
        if any(t.data_ptr() % 16 for t in (x, B, C, dy, dstates)):
            raise ValueError("ssd_chunk_bwd: x, B, C, dy, dstates must be "
                             "16-byte aligned")
        group = head_group(bsz, nc, H, _n_sms(x.device.index))
        # each group's partial dB and dC (L x N a chunk each)
        ws = (torch.empty((2, bsz, nc, -(-H // group), L, N), **f32),)
        tail = (group,)
    else:
        # each head's share of dcb (L x L a cell, the causal half written)
        # and of dB's state term (L x N a cell)
        ws = (torch.empty((bsz, nc, H, L, L), **f32),
              torch.empty((bsz, nc, H, L, N), **f32))
        tail = (_DTYPES[x.dtype],)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = getattr(lib, _BWD_ENTRY[kind])(
        x.data_ptr(), dt.data_ptr(), cs.data_ptr(), B.data_ptr(),
        C.data_ptr(), dy.data_ptr(), dstates.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dcs.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        *(w.data_ptr() for w in ws), bsz, S, H, P, N, L, *tail, stream)
    _build.check(lib, code, _BWD_ENTRY[kind])
    ssd.launches_bwd += 1
    if kind == "tc":
        ssd.launches_bwd_tc += 1
    return dx, ddt, dcs, dB, dC


class SSDChunkFn(torch.autograd.Function):
    """``ssd_chunk`` with ``ssd_chunk_bwd`` as its backward: the kernels on
    CUDA tensors, their plain versions on CPU tensors. Returns (y_intra,
    states) as ``ssd_chunk`` does; the gradients of x, B and C come back in
    their dtype, those of dt and cs in fp32."""

    @staticmethod
    def forward(ctx, x, dt, cs, B, C, chunk):
        ctx.save_for_backward(x, dt, cs, B, C)
        ctx.chunk = chunk
        return ssd_chunk(x, dt, cs, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dstates):
        x, dt, cs, B, C = ctx.saved_tensors
        dx, ddt, dcs, dB, dC = ssd_chunk_bwd(x, dt, cs, B, C, dy, dstates,
                                             chunk=ctx.chunk)
        return (dx.to(x.dtype), ddt, dcs, dB.to(B.dtype), dC.to(C.dtype),
                None)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, *, chunk: int = 128, h0: torch.Tensor | None = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full SSD with the quadratic part in the chunk kernel
    (``SSDChunkFn``: differentiable through the backward kernel).

    x: (b,S,H,P); dt: (b,S,H) fp32 (post-softplus); a: (H,) fp32 (negative);
    B, C: (b,S,N); h0: optional (b,H,P,N) initial state.
    Returns (y (b,S,H,P) fp32, h_final (b,H,P,N) fp32).
    """
    bsz, S, H, P = x.shape
    N = B.shape[-1]
    L = chunk
    if any(t is not None and t.device != x.device for t in (a, h0)):
        raise ValueError("ssd: a and h0 must lie on x's device")
    S_orig = S
    if S % L:
        # dt = 0 on the pad: no decay (exp(0) = 1) and no state update
        pad = L - S % L
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        S += pad
    nc = S // L

    cs = torch.cumsum((dt * a).reshape(bsz, nc, L, H), dim=2)     # within-chunk
    y_intra, states = SSDChunkFn.apply(x, dt, cs.reshape(bsz, S, H), B, C, L)

    # inter-chunk scan over boundary states, (b,nc,H,N,P) → (b,nc,H,P,N)
    seg = torch.exp(cs[:, :, -1, :])                              # (b,nc,H)
    states = states.transpose(-1, -2)
    h = (torch.zeros((bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * seg[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, 1)                               # (b,nc,H,P,N)

    # inter-chunk output: y_inter[t] = exp(cs_t) · C_t · h_prev(chunk(t))
    Cc = C.reshape(bsz, nc, L, N).float()
    y_inter = torch.einsum("bcln,bchpn->bclhp", Cc, h_prev) \
        * torch.exp(cs)[..., None]
    y = y_intra + y_inter.reshape(bsz, S, H, P)
    return y[:, :S_orig], h


ssd.launches = 0      # chunk-kernel launches (in ssd_chunk) since last set to 0
ssd.launches_tc = 0   # of those, the bf16 tensor-core kernel's
ssd.launches_bwd = 0  # ssd_chunk_bwd calls (two launches each) on CUDA tensors
ssd.launches_bwd_tc = 0   # of those, the bf16 tensor-core backward's
