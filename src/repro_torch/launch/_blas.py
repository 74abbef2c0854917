"""The engine benches' BLAS pin (the JAX package's ``benchmarks/run.py:76-78``).

The speedup bench measures the engine's branch parallelism, which is
counted twice if BLAS also fans every product out over the cores. So the
bench CLIs set these variables to 1 before numpy (and torch, which reads
``OMP_NUM_THREADS`` for its intra-op pool) is first imported. This module
imports only ``os``, so a CLI can call :func:`pin` above its numpy import.
"""
from __future__ import annotations

import os

VARS = ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS")


def pin() -> None:
    """Set each variable of ``VARS`` to 1 unless the caller set it."""
    for var in VARS:
        os.environ.setdefault(var, "1")


def threads() -> dict:
    """The BLAS variables as this process sees them, and torch's intra-op
    thread count (the counts a bench ran with)."""
    import torch
    return {**{var: os.environ.get(var) for var in VARS},
            "torch_threads": torch.get_num_threads()}
