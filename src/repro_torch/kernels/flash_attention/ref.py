"""Plain PyTorch attention: the flash kernel's oracle (transcribes the JAX
package's ``kernels/flash_attention/ref.py``; no blocking, fp32 softmax).

The one difference: ``q_offset`` may also be a (B,) tensor, one offset per
batch row, because that is what the model path passes.
"""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset=0, *, causal: bool = True,
                  window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D). window <= 0 → global."""
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * d ** -0.5
    off = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1)  # (B|1, 1)
    q_pos = off + torch.arange(sq, device=q.device)[None, :]         # (B|1, Sq)
    rel = q_pos[:, :, None] - torch.arange(sk, device=q.device)      # (B|1, Sq, Sk)
    mask = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        mask &= rel >= 0
    if window > 0:
        mask &= rel < window
    s = torch.where(mask[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)
