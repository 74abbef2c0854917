"""PyTorch + CUDA port of the ``repro`` model zoo, laid out module for
module like ``src/repro/`` so every port module has one twin to be held
against.

The package imports ``torch`` and numpy only — never ``jax``, ``ml_dtypes``
or anything of ``repro``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` (see :mod:`repro_torch.device`). The hand-written
Hopper kernels live under :mod:`repro_torch.kernels`; on a CPU tensor each
wrapper takes its kernel's plain PyTorch version instead.
"""
