"""Time the RMSNorm backward at each ring geometry, and its phases, at the
train paths' shapes: the evidence behind ``kernels/rmsnorm/ops.py``
``plan_bwd``.

    PYTHONPATH=src python -m repro_torch.launch.rmsnorm_bwd_layouts

For each shape, every ring geometry (groups a block, stages a group) that
fits the shared memory is launched through the library's geometry
arguments, checked against the plain version and timed with a cold L2 as
``rmsnorm_layouts.py`` times the forward. Then the plan's geometry runs
with phases cut out of a copy of ``rmsnorm.cu`` (built into
``build/torch_kernels/phases/``): the walk alone (no dw), the walk and
the partial rows (no grid sync), and all but the partial rows' sum; and
an empty kernel at the plan's geometry, the timer's floor. Successive
differences are what each phase adds. Last, the whole kernel with every
slot's first row fetched at once instead of each when the slot before it
lands. Card only.
"""
from __future__ import annotations

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.device import resolve
from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm import ops, ref
from repro_torch.launch.rmsnorm_layouts import _cold_ms

SHAPES = [((2048, 2048), torch.bfloat16), ((2048, 2048), torch.float32),
          ((512, 128), torch.bfloat16), ((4096, 128), torch.bfloat16)]

# the ring kernel's tail, and the cuts of it that leave one phase out
_SYNC = "  cg::this_grid().sync();\n"
_SUM = "  sum_partials(a.partial, a.dw, d);\n"
_SHARE = "  // The group's dw share into its slots"
# the staggered first fetches, and what puts every slot's first row out at once
_FIRST = "    if (first < n_rows) fetch(0, first);\n"
_NEXT = ("    if (leader && it + 1 < S && row + stride < n_rows) "
         "fetch(it + 1, row + stride);\n")
_ALL = ("    for (int s = 0; s < S && first + s * stride < n_rows; ++s)\n"
        "      fetch(s, first + s * stride);\n")
_EMPTY = '''
__global__ void rmsnorm_bwd_nothing(BwdArgs) {}
}  // namespace
extern "C" int rmsnorm_bwd_empty(int threads, int smem, int grid, void* stream) {
  BwdArgs a{};
  void* args[] = {&a};
  cudaFuncSetAttribute(rmsnorm_bwd_nothing,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(rmsnorm_bwd_nothing), dim3(grid),
      dim3(threads), args, smem, static_cast<cudaStream_t>(stream)));
}
namespace {
'''


def _phase_sources() -> dict[str, str]:
    """The ring kernel's source with phases cut out of its tail, and with
    every slot's first row fetched at once instead of staggered."""
    src = Path(ops.SOURCE).read_text()
    start = src.index("rmsnorm_bwd_ring(BwdArgs a) {")
    end = src.index("// The stripe route")
    ring = src[start:end]
    tail = ring.index(_SHARE)
    assert ring.count(_SYNC + _SUM) == 1, "rmsnorm.cu's ring tail moved"
    assert ring.count(_FIRST) == ring.count(_NEXT) == 1, "first fetches moved"
    cuts = {"walk": ring[:tail] + "}\n\n",
            "walk+partials": ring.replace(_SYNC + _SUM, ""),
            "walk+partials+sync": ring.replace(_SUM, ""),
            "first rows all at once": ring.replace(_FIRST, _ALL).replace(
                _NEXT, "")}
    out = {}
    for name, body in cuts.items():
        text = src[:start] + body + src[end:]
        out[name] = text.replace("}  // namespace\n", _EMPTY + "}  // namespace\n", 1)
    return out


@functools.cache
def _phase_libs() -> dict[str, ctypes.CDLL]:
    """Each cut built with the library's flags (one nvcc each, together)."""
    root = _build.BUILD_DIR / "phases"
    (root / "include").mkdir(parents=True, exist_ok=True)
    (root / "rmsnorm" / "csrc").mkdir(parents=True, exist_ok=True)
    for header in _build.headers():
        shutil.copy(header, root / "include" / header.name)
    procs = {}
    for name, text in _phase_sources().items():
        stem = name.replace("+", "_").replace(" ", "_")
        src = root / "rmsnorm" / "csrc" / f"{stem}.cu"
        src.write_text(text)
        procs[name] = (src.with_suffix(".so"), subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(src.with_suffix(".so")),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} cut:\n{err}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _bind(lib: ctypes.CDLL):
    """(rmsnorm_bwd, rmsnorm_bwd_blocks_per_sm) of a library, typed as the
    wrapper types its own."""
    fn = lib.rmsnorm_bwd
    fn.argtypes = ops._bwd().argtypes
    fn.restype = ctypes.c_int
    occ = lib.rmsnorm_bwd_blocks_per_sm
    occ.argtypes = [ctypes.c_int] * 5
    occ.restype = ctypes.c_int
    return fn, occ


def main() -> None:
    dev = resolve(None)
    flush = torch.ones(32 << 20, dtype=torch.float32, device=dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    full = _bind(_build.load(ops.SOURCE))
    phases = {k: _bind(v) for k, v in _phase_libs().items()}
    empty = _phase_libs()["walk"].rmsnorm_bwd_empty
    empty.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    print(torch.cuda.get_device_name(dev))
    for (n, d), dt in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        x, dy = (torch.randn(n, d, generator=g, device=dev).to(dt)
                 for _ in range(2))
        w = torch.randn(d, generator=g, device=dev)
        e = x.element_size()
        dx_ref, dw_ref = ref.rmsnorm_bwd_ref(x, w, dy)
        plan = ops._bwd_plan(n, d, e, torch.cuda.current_device())
        print(f"({n}, {d}) {dt}: plan {plan}; wrapper "
              f"{_cold_ms(lambda: ops.rmsnorm_bwd(x, w, dy), flush, 20):.5f} ms")
        dx, dw = torch.empty_like(x), torch.empty(d, device=dev)

        def launch(fn, groups, stages, grid):
            p = torch.empty((grid, d), device=dev)
            smem = ops._ring_smem(groups, plan.group, stages, d, e)
            return lambda: fn(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                              dx.data_ptr(), p.data_ptr(), dw.data_ptr(), n, d,
                              1e-5, int(e == 2), ops.ROUTES["ring"], plan.nv,
                              32 * groups * plan.group, plan.group, stages,
                              smem, grid, stream)

        groups_max = ops.RING_WARPS // plan.group
        for groups in (1 << i for i in range(groups_max.bit_length())):
            for stages in range(1, 5):
                smem = ops._ring_smem(groups, plan.group, stages, d, e)
                grid = min(n_sms, -(-n // groups))
                if smem > ops.SMEM_MAX or full[1](
                        int(e == 2), ops.ROUTES["ring"], plan.nv,
                        32 * groups * plan.group, smem) < 1:
                    continue
                call = launch(full[0], groups, stages, grid)
                if call():
                    raise RuntimeError("launch failed")
                torch.cuda.synchronize()
                err = max(float((dx.float() - dx_ref.float()).abs().max()),
                          float((dw - dw_ref).abs().max()))
                mark = " <- plan" if (32 * groups * plan.group, stages) == (
                    plan.threads, plan.stages) else ""
                print(f"  {groups} groups x {plan.group} warps, {stages} "
                      f"stages, grid {grid}: {_cold_ms(call, flush, 20):.5f} "
                      f"ms (max abs err {err:.3g}){mark}")
        groups = plan.threads // 32 // plan.group
        for name, (fn, occ) in phases.items():
            occ(int(e == 2), ops.ROUTES["ring"], plan.nv, plan.threads,
                plan.smem)
            call = launch(fn, groups, plan.stages, plan.grid)
            print(f"  plan's geometry, {name}: "
                  f"{_cold_ms(call, flush, 20):.5f} ms")
        nothing = lambda: empty(plan.threads, plan.smem, plan.grid, stream)  # noqa: E731
        print(f"  plan's geometry, empty kernel (the timer's floor): "
              f"{_cold_ms(nothing, flush, 20):.5f} ms")


if __name__ == "__main__":
    main()
