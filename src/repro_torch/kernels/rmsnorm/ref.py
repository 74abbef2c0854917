"""Plain PyTorch RMSNorm: the kernel's oracle (transcribes the JAX
package's ``kernels/rmsnorm/ref.py``)."""
import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
                ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
