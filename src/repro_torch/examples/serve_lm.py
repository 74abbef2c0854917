"""Serve a small model with batched requests: prefill + greedy decode
(twin of the JAX package's ``examples/serve_lm.py``, a thin wrapper over
``launch.serve``, whose flags it takes; ``--device`` defaults to
``cuda``). Prefill runs the flash kernel, every forward the RMSNorm
kernel, and mamba2's prefill the SSD chunk kernel. Returns the
``ServeResult``.

    python -m repro_torch.examples.serve_lm --arch internlm2-1.8b
    python -m repro_torch.examples.serve_lm --arch mamba2-130m  # SSM cache
    python -m repro_torch.examples.serve_lm --device cpu
"""
from __future__ import annotations

from ..launch import serve as serve_mod


def main(argv: list[str] | None = None) -> serve_mod.ServeResult:
    return serve_mod.main(argv)


if __name__ == "__main__":
    main()
