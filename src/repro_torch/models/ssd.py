"""Mamba-2 layer via State-Space Duality (SSD, arXiv:2405.21060); twin of the
JAX package's ``models/ssd.py``.

Plain functions over the reference's dict parameter tree, with the same
dtypes at every step:

  * within a chunk of length L, the quadratic form
    Y_intra = ((C Bᵀ) ∘ decay-mask) · (dt ∘ X), and the chunk boundary
    states S_c = (B ∘ dt ∘ decay-to-end)ᵀ · X;
  * across chunks, a short sequential scan over the boundary states and
    the inter-chunk output Y_inter = C · S_prev ∘ decay-from-start;
  * decode (S == 1 with a state) is the O(1) recurrence
    h ← h·exp(dt·A) + dt·(B ⊗ x), in plain torch: the reference has no
    kernel there.

``ssm_block`` keeps the reference's ``use_kernel`` switch and both its
branches: ``kernels.ssd.ops.ssd`` (the CUDA chunk kernel on CUDA tensors)
or ``ssd_scan_reference`` (plain torch, chunked). Unlike the reference,
whose switch defaults to off and whose stack never turns it on, the port
defaults to the kernel, and ``lm._ssm_stack`` passes ``use_kernel=True``,
so prefill and training go through it (``ops.ssd`` is differentiable:
its chunk kernel has a hand-written backward); ``use_kernel=False`` is
for parity tests against the reference's plain branch. The gated norm
inside the block goes through the RMSNorm kernel's wrapper, as every norm
of the port does.

One stated divergence: ``ssd_scan_reference`` masks the decay's exponent
before the ``exp`` where the reference masks after it. The forward is the
same bits; the reference's gradient is NaN at mamba2-130m's chunk of 128
(the masked half overflows), the port's is finite.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd import ops as ssd_ops
from ..sharding.activation import grad_laid_out, splittable
from .config import SSMCfg
from .layers import _to_residual, rmsnorm
from .params import P


def ssm_defs(d_model: int, scfg: SSMCfg) -> dict:
    d_in = scfg.expand * d_model
    nheads = d_in // scfg.head_dim
    ns = scfg.d_state
    # in_proj emits [z (d_in), x (d_in), B (ns), C (ns), dt (nheads)]
    zxbcdt = 2 * d_in + 2 * ns + nheads
    return {
        "in_proj": P((d_model, zxbcdt), ("embed", "ssm_inner")),
        "conv_w": P((scfg.d_conv, d_in + 2 * ns), (None, "ssm_inner")),
        "conv_b": P((d_in + 2 * ns,), ("ssm_inner",), init="zeros"),
        "a_log": P((nheads,), (None,), init="ones", dtype=torch.float32),
        "dt_bias": P((nheads,), (None,), init="zeros", dtype=torch.float32),
        "d_skip": P((nheads,), (None,), init="ones", dtype=torch.float32),
        "norm_w": P((d_in,), ("ssm_inner",), init="ones", dtype=torch.float32),
        "out_proj": P((d_in, d_model), ("ssm_inner", "embed")),
    }


def _split_proj(scfg: SSMCfg, d_model: int, zxbcdt: torch.Tensor):
    d_in = scfg.expand * d_model
    ns = scfg.d_state
    nheads = d_in // scfg.head_dim
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * ns, nheads], dim=-1)
    return z, xbc, dt, d_in, ns, nheads


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv, window d_conv. xbc: (B, S, C); w: (K, C).

    Returns (out, new_state) where state is the last K-1 inputs (for decode).
    """
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                           # (B, S+K-1, C)
    out = sum(xp[:, i:i + xbc.shape[1], :] * w[i] for i in range(k)) + b
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return F.silu(out), new_state


def ssd_scan_reference(x, dt, a, B, C, chunk: int, h0=None):
    """Chunked SSD in plain torch. Shapes:
      x: (batch, S, H, P)   — P = head_dim
      dt: (batch, S, H)     — positive step sizes (post-softplus)
      a:  (H,)              — negative decay rates (−exp(a_log))
      B, C: (batch, S, N)   — shared across heads (n_groups=1)
      h0: optional initial state (batch, H, P, N)
    Returns (y (batch,S,H,P) in x.dtype, h_final (batch,H,P,N) fp32).
    """
    bsz, S, H, Pd = x.shape
    N = B.shape[-1]
    L = chunk
    S_orig = S
    if S % L:
        # Zero-pad to a chunk multiple: dt=0 ⇒ no decay (exp(0)=1) and no
        # state update, so the final state and the first S outputs are exact.
        pad = L - S % L
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        S = S + pad
    nc = S // L
    xc = x.reshape(bsz, nc, L, H, Pd)
    dtc = dt.reshape(bsz, nc, L, H)
    Bc = B.reshape(bsz, nc, L, N)
    Cc = C.reshape(bsz, nc, L, N)

    da = dtc * a                                   # (b, nc, L, H) negative
    cs = torch.cumsum(da, dim=2)                   # within-chunk cumulative
    seg_end = cs[:, :, -1:, :]                     # total decay per chunk

    # --- intra-chunk (quadratic in L, matmul form) ---------------------------
    # decay(i←j) = exp(cs_i − cs_j) for i ≥ j. The reference takes the exp
    # of every entry and selects after it; above the diagonal that
    # overflows at a long chunk (mamba2's 128), and the gradient of the
    # select is inf · 0 = NaN. Masking the exponent to −inf first gives
    # the same forward bits and a finite gradient.
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]      # (b,nc,L,L,H)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                                  float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)            # (b,nc,L,L)
    w = cb[..., None] * decay * dtc[:, :, None, :, :]       # (b,nc,L,L,H)
    y = torch.einsum("bcijh,bcjhp->bcihp", w.to(x.dtype), xc)

    # --- chunk states -----------------------------------------------------------
    decay_to_end = torch.exp(seg_end - cs)                  # (b,nc,L,H)
    xdt = xc * (dtc * decay_to_end)[..., None].to(x.dtype)
    states = torch.einsum("bcln,bclhp->bchpn", Bc, xdt)     # (b,nc,H,P,N)

    # --- inter-chunk scan ---------------------------------------------------------
    seg = torch.exp(seg_end[:, :, 0, :])                    # (b,nc,H)
    h = (torch.zeros((bsz,) + states.shape[2:], dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    states = states.float()
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * seg[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, 1)                         # (b,nc,H,P,N)

    # --- inter-chunk contribution ---------------------------------------------------
    cdec = torch.exp(cs)                                    # decay from chunk start
    y_inter = torch.einsum("bcln,bchpn->bclhp",
                           Cc.to(h_prev.dtype), h_prev) * cdec[..., None]
    y = y + y_inter.to(y.dtype)
    return y.reshape(bsz, S, H, Pd)[:, :S_orig], h


def ssd_decode_step(x, dt, a, B, C, h):
    """Single-token recurrence. x:(b,H,P) dt:(b,H) B,C:(b,N) h:(b,H,P,N)."""
    g = torch.exp(dt * a)                                   # (b,H)
    upd = (dt[..., None] * x.float())[..., None] \
        * B[:, None, None, :]                               # (b,H,P,N)
    h_new = h * g[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, C.to(h_new.dtype))
    return y.to(x.dtype), h_new


def ssm_block(cfg, scfg: SSMCfg, p: dict, x: torch.Tensor,
              state: tuple | None = None, use_kernel: bool = True):
    """Full Mamba-2 mixer. x: (B, S, D).

    state: None for training/prefill-from-scratch, else
    (conv_state (B, K-1, C), h (B, H, P, N)) for decode (S == 1 uses the
    recurrent path).
    Returns (out (B,S,D), new_state).
    """
    bsz, S, d_model = x.shape
    # on a mesh of several devices, the projection's gradient comes back
    # in its own layout, which the backward of the product can fold
    zxbcdt = grad_laid_out(x @ p["in_proj"])
    z, xbc, dt_raw, d_in, ns, nheads = _split_proj(scfg, d_model, zxbcdt)
    a = -torch.exp(p["a_log"])                              # (H,) negative
    dt = F.softplus(dt_raw.float() + p["dt_bias"])

    if state is not None and S == 1:
        conv_state, h = state
        # shift conv state, apply conv at the last position
        cat = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
        w, b = p["conv_w"], p["conv_b"]
        k = w.shape[0]
        conv_out = sum(cat[:, i:i + 1, :] * w[i] for i in range(k)) + b
        conv_out = F.silu(conv_out)[:, 0]
        new_conv_state = cat[:, -(k - 1):, :]
        xs, B, C = torch.split(conv_out, [d_in, ns, ns], dim=-1)
        # on a mesh of several devices, channel shards that the split into
        # heads (or its backward) would cut unevenly are gathered
        xh = splittable(xs, None, nheads).reshape(bsz, nheads, scfg.head_dim)
        y, h_new = ssd_decode_step(xh, dt[:, 0], a, B, C, h)
        y = y + xh.float() * p["d_skip"][:, None]
        y = splittable(y.reshape(bsz, 1, d_in), None, None, nheads)
        new_state = (new_conv_state, h_new)
    else:
        conv_state = state[0] if state is not None else None
        h0 = state[1] if state is not None else None
        conv_out, new_conv_state = _causal_conv(
            xbc, p["conv_w"], p["conv_b"], conv_state)
        xs, B, C = torch.split(conv_out, [d_in, ns, ns], dim=-1)
        # on a mesh of several devices, channel shards that the split into
        # heads (or its backward) would cut unevenly are gathered
        xh = splittable(xs, None, None, nheads).reshape(
            bsz, S, nheads, scfg.head_dim)
        if use_kernel:
            # the kernel takes contiguous tensors; the split leaves views
            y, h_new = ssd_ops.ssd(xh.contiguous(), dt, a, B.contiguous(),
                                   C.contiguous(), chunk=scfg.chunk, h0=h0)
        else:
            y, h_new = ssd_scan_reference(xh, dt, a, B, C, scfg.chunk, h0=h0)
        y = y + (xh.float() * p["d_skip"][None, None, :, None]).to(y.dtype)
        y = splittable(y.reshape(bsz, S, d_in), None, None, nheads)
        new_state = (new_conv_state, h_new)

    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm_w"])
    # on a mesh of several devices the product over the sharded channels
    # is reduced into the residual's layout, as the attention and MLP
    # blocks' outputs are
    return _to_residual((y.to(x.dtype) @ p["out_proj"]).to(x.dtype)), \
        new_state


def init_ssm_state(cfg, scfg: SSMCfg, batch: int,
                   device: torch.device | str = "cpu"):
    d_in = scfg.expand * cfg.d_model
    nheads = d_in // scfg.head_dim
    conv = torch.zeros((batch, scfg.d_conv - 1, d_in + 2 * scfg.d_state),
                       dtype=torch.bfloat16, device=device)
    h = torch.zeros((batch, nheads, scfg.head_dim, scfg.d_state),
                    dtype=torch.float32, device=device)
    return (conv, h)
