"""Plain PyTorch SSD: the sequential oracle and the chunk kernel's plain
version.

``ssd_ref`` transcribes the JAX package's ``kernels/ssd/ref.py``: the naive
recurrence, independent of the chunked formulation,

    h_t = h_{t-1} · exp(dt_t·a) + dt_t · (B_t ⊗ x_t),    y_t = C_t · h_t.

``ssd_chunk_ref`` computes exactly what the CUDA kernel (and the TPU kernel
``kernels/ssd/ssd.py:_kernel`` it replaces) computes for every (batch,
chunk, head) cell: the intra-chunk output and the chunk's boundary state.
``ssd_chunk_bwd_ref`` is its backward, derived by hand: what the backward
kernel computes (the TPU package has none; the reference differentiates
its plain chunked scan by autodiff). The tests and ``chip_smoke.py`` hold
the kernels against them, and the wrapper takes them for CPU tensors.

Both form the decay as ``exp(where(causal, cs_i − cs_j, −inf))``: the
exponent of the masked half (j > i), which overflows fp32 at a long chunk,
is never taken. The forward gives the same bits as selecting after the
``exp``; the gradient is finite where that one is ``inf · 0 = NaN``.
"""
from __future__ import annotations

import torch

from ...sharding import activation


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, h0: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b,S,H,P); dt: (b,S,H); a: (H,); B,C: (b,S,N).
    Returns (y (b,S,H,P) fp32, h_final (b,H,P,N) fp32)."""
    bsz, S, H, P = x.shape
    N = B.shape[-1]
    xf, dt, a = x.float(), dt.float(), a.float()
    Bf, Cf = B.float(), C.float()
    h = (torch.zeros((bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        g = torch.exp(dt[:, t] * a)                                # (b,H)
        upd = (dt[:, t, :, None] * xf[:, t])[..., None] * Bf[:, t, None, None, :]
        h = h * g[..., None, None] + upd
        ys.append(activation.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, 1), h


def _causal_decay(cs: torch.Tensor) -> torch.Tensor:
    """exp(cs_i − cs_j) for i ≥ j and 0 above the diagonal, over the chunk
    axis 2 of ``cs`` (b, nc, L, H): (b, nc, L_i, L_j, H). The masked
    exponents, which overflow for j > i, become −inf before the exp."""
    L = cs.shape[2]
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    causal = torch.ones((L, L), dtype=torch.bool, device=cs.device).tril()
    return torch.exp(torch.where(causal[:, :, None], diff, float("-inf")))


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, cs: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, *, chunk: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD, in fp32.

    x: (b,S,H,P); dt, cs: (b,S,H) fp32 (cs = within-chunk cumsum of dt·a);
    B, C: (b,S,N); S % chunk == 0.
    Returns (y_intra (b,S,H,P) fp32, states (b,nc,H,N,P) fp32), where for
    each cell y_intra = ((C Bᵀ) ∘ causal exp(cs_i − cs_j) ∘ dt_j) X and
    state = Bᵀ (X ∘ dt ∘ exp(cs_end − cs)).
    """
    bsz, S, H, P = x.shape
    N = B.shape[-1]
    L = chunk
    assert S % L == 0, (S, L)
    nc = S // L
    xc = x.float().reshape(bsz, nc, L, H, P)
    dtc = dt.float().reshape(bsz, nc, L, H)
    csc = cs.float().reshape(bsz, nc, L, H)
    Bc = B.float().reshape(bsz, nc, L, N)
    Cc = C.float().reshape(bsz, nc, L, N)

    decay = _causal_decay(csc)                                      # (b,nc,i,j,H)
    cb = activation.einsum("bcin,bcjn->bcij", Cc, Bc)
    w = cb[..., None] * decay * dtc[:, :, None, :, :]               # (b,nc,i,j,H)
    y = activation.einsum("bcijh,bcjhp->bcihp", w, xc).reshape(bsz, S, H, P)

    dte = dtc * torch.exp(csc[:, :, -1:, :] - csc)                  # (b,nc,L,H)
    states = activation.einsum("bcln,bclhp->bchnp", Bc, xc * dte[..., None])
    return y, states


def ssd_chunk_bwd_ref(x: torch.Tensor, dt: torch.Tensor, cs: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                      dstates: torch.Tensor, *, chunk: int
                      ) -> tuple[torch.Tensor, ...]:
    """The backward of ``ssd_chunk_ref``, in fp32.

    dy: (b,S,H,P), the cotangent of y_intra; dstates: (b,nc,H,N,P), that of
    the states. Returns (dx (b,S,H,P), ddt, dcs (b,S,H), dB, dC (b,S,N)),
    all fp32. For each cell, with E_ij = exp(cs_i − cs_j) (i ≥ j, else 0),
    cb = C Bᵀ, w = cb ∘ E ∘ dt_j, seg_l = exp(cs_end − cs_l) and
    dte = dt ∘ seg:

      dx   = wᵀ dy + dte ∘ (B dst)
      dW   = dy xᵀ on i ≥ j, q = dW ∘ cb ∘ E
      ddt_j = Σ_i q_ij + ddte_j · seg_j,  ddte_l = x_l · (B dst)_l
      dcs_i = Σ_j q_ij dt_j − dt_i Σ_k q_ki − ddte_i dte_i
              (+ Σ_l ddte_l dte_l at i = L − 1, the chunk's end)
      dC = dcb B, dB = dcbᵀ C + Σ_h (x ∘ dte) dstᵀ, dcb = Σ_h dW ∘ E ∘ dt_j

    dB and dC sum over the heads, which share B and C (n_groups = 1).
    """
    bsz, S, H, P = x.shape
    N = B.shape[-1]
    L = chunk
    assert S % L == 0, (S, L)
    nc = S // L
    xc = x.float().reshape(bsz, nc, L, H, P)
    dtc = dt.float().reshape(bsz, nc, L, H)
    csc = cs.float().reshape(bsz, nc, L, H)
    Bc = B.float().reshape(bsz, nc, L, N)
    Cc = C.float().reshape(bsz, nc, L, N)
    dyc = dy.float().reshape(bsz, nc, L, H, P)
    dst = dstates.float()                                         # (b,nc,H,N,P)

    E = _causal_decay(csc)                                        # (b,nc,i,j,H)
    cbE = activation.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None] * E
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    dW = activation.einsum("bcihp,bcjhp->bcijh", dyc, xc) * causal[:, :, None]
    q = dW * cbE
    dx = activation.einsum("bcijh,bcihp->bcjhp", cbE * dtc[:, :, None], dyc)

    seg = torch.exp(csc[:, :, -1:, :] - csc)                       # (b,nc,L,H)
    dte = dtc * seg
    bdst = activation.einsum("bcln,bchnp->bclhp", Bc, dst)
    dx = dx + dte[..., None] * bdst
    ddte = (xc * bdst).sum(-1)                                    # (b,nc,L,H)

    q_col = q.sum(2)                                              # over i
    ddt = q_col + ddte * seg
    dcs = (q * dtc[:, :, None]).sum(3) - dtc * q_col - ddte * dte
    dcs[:, :, -1] += (ddte * dte).sum(2)

    dcb = (dW * E * dtc[:, :, None]).sum(-1)                      # (b,nc,i,j)
    dC = activation.einsum("bcij,bcjn->bcin", dcb, Bc)
    dB = (activation.einsum("bcij,bcin->bcjn", dcb, Cc)
          + activation.einsum("bclhp,bchnp->bcln", xc * dte[..., None], dst))
    return (dx.reshape(bsz, S, H, P), ddt.reshape(bsz, S, H),
            dcs.reshape(bsz, S, H), dB.reshape(bsz, S, N),
            dC.reshape(bsz, S, N))
