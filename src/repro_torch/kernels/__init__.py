"""Hand-written Hopper kernels (CUDA C++ for sm_90a, built by ``_build``).

Each subpackage: ``csrc/<name>.cu`` (the kernel with a plain C launch
function), ``ops.py`` (the wrapper: checks, launch, launch counter; the
plain version on CPU tensors) and ``ref.py`` (the plain PyTorch version
that the tests and ``chip_smoke.py`` hold the kernel against). The JAX
package's TPU-only ``kernels/compat.py`` has no twin.
"""
