"""Plain PyTorch SSD: the sequential oracle and the chunk kernel's plain
version.

``ssd_ref`` transcribes the JAX package's ``kernels/ssd/ref.py``: the naive
recurrence, independent of the chunked formulation,

    h_t = h_{t-1} · exp(dt_t·a) + dt_t · (B_t ⊗ x_t),    y_t = C_t · h_t.

``ssd_chunk_ref`` computes exactly what the CUDA kernel (and the TPU kernel
``kernels/ssd/ssd.py:_kernel`` it replaces) computes for every (batch,
chunk, head) cell: the intra-chunk output and the chunk's boundary state.
The tests and ``chip_smoke.py`` hold the kernel against it, and the
wrapper takes it for CPU tensors.
"""
from __future__ import annotations

import torch


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
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, 1), h


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

    # exp(cs_i − cs_j) overflows for j > i; torch.where selects it away
    diff = csc[:, :, :, None, :] - csc[:, :, None, :, :]          # (b,nc,i,j,H)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(causal[:, :, None], torch.exp(diff), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    w = cb[..., None] * decay * dtc[:, :, None, :, :]               # (b,nc,i,j,H)
    y = torch.einsum("bcijh,bcjhp->bcihp", w, xc).reshape(bsz, S, H, P)

    dte = dtc * torch.exp(csc[:, :, -1:, :] - csc)                  # (b,nc,L,H)
    states = torch.einsum("bcln,bclhp->bchnp", Bc, xc * dte[..., None])
    return y, states
