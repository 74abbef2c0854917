"""Plain PyTorch RMSNorm and its gradient: the kernels' oracles.

``rmsnorm_ref`` transcribes the JAX package's ``kernels/rmsnorm/ref.py``.
``rmsnorm_bwd_ref`` is the gradient the JAX package gets by autodiff of
the jnp ``rmsnorm`` (``src/repro/models/layers.py:27``), written out. Both
compute in fp32, or in fp64 for fp64 inputs (``gradcheck``).
"""
import torch


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
                ) -> torch.Tensor:
    ct = _compute_dtype(x)
    xf = x.to(ct)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(ct)).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``rmsnorm_ref`` for the output gradient ``dy``: with
    r = rsqrt(mean(x²) + eps) and g = dy·w, dx = r·(g − x·r²·mean(g·x)) in
    x's dtype and dw = Σ_rows dy·x·r in fp32 (w's dtype)."""
    ct = _compute_dtype(x)
    xf, df = x.to(ct), dy.to(ct)
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    g = df * w.to(ct)
    dx = r * (g - xf * r.square() * (g * xf).mean(-1, keepdim=True))
    dw = (df * (xf * r)).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)
