"""Time the SSD backward's tensor-core kernel with parts of it cut out, at
mamba2-130m's train shape and jamba's prefill shape: where its time goes.

    PYTHONPATH=src python -m repro_torch.launch.ssd_bwd_parts

Each cut is a copy of ``kernels/ssd/csrc/ssd.cu`` with one part of
``tcb::ssd_bwd_tc`` (or its second launch, the group sum) taken out,
built with the library's flags into ``build/torch_kernels/ssd_parts/``
(one nvcc each, all at once) and called through ``ops.ssd_chunk_bwd``; a
cut's outputs are wrong by design. Every time is the cold-L2 ms that
``chip_smoke.py`` takes, the whole kernel first and last, and each cut's
difference from the whole is what that part costs where nothing else
overlaps it. Card only.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path
from unittest import mock

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.kernels import _build
from repro_torch.kernels.ssd import ops
from repro_torch.launch.rmsnorm_layouts import _cold_ms

# (b, S, H, P, N, chunk): mamba2-130m's train shape, jamba's prefill shape
SHAPES = {"mamba2 train": (4, 512, 24, 64, 128, 128),
          "jamba prefill": (4, 512, 128, 64, 16, 128)}

# name: [(text of ssd.cu, its replacement)], each text found exactly once
CUTS = {
    "dy and dst loaded for the first head only": [
        ("    split_two<L, NB, PB, G::kThreads>(",
         "    if (g == 0) split_two<L, NB, PB, G::kThreads>(")],
    "no exp on the tiles": [
        ("const float e = __expf(arg);", "const float e = arg;")],
    "no column-sum shuffles": [
        ("for (int m = 4; m < 32; m *= 2) {", "for (int m = 32; m < 32; m *= 2) {")],
    "no ddt and dcs stores": [
        ("for (int l = tid; l < L; l += G::kThreads) {\n      float cols = 0.f;",
         "for (int l = tid; l < 0; l += G::kThreads) {\n      float cols = 0.f;")],
    "no state-term products": [
        ("      wgmma_ss<NB, 0, 0>(sa, da, make_desc(sDstHi + d_off, 16, 1024, 1), ks > 0);\n"
         "      wgmma_ss<NB, 0, 0>(sa, da, make_desc(sDstLo + d_off, 16, 1024, 1), 1);\n", "")],
    "no dx += w^T dy products": [
        ("        wgmma_rs<PB>(dxa, w_hi[kk], dh);\n"
         "        wgmma_rs<PB>(dxa, w_hi[kk], dl);\n"
         "        wgmma_rs<PB>(dxa, w_lo[kk], dh);\n", "")],
    "no causal tiles (dW^T, the fragments, w^T dy)": [
        ("for (int it = wg; it < kWG; ++it) {\n      float dw[32];",
         "for (int it = wg; it < 0; ++it) {\n      float dw[32];")],
    "no group sum (the second launch)": [
        ("ssd_bwd_tc_sum<<<blocks, 256, 0, stream>>>(",
         "if (0) ssd_bwd_tc_sum<<<blocks, 256, 0, stream>>>(")],
}


def _cut_sources() -> dict[str, str]:
    """``ssd.cu`` with each cut made."""
    src = Path(ops.SOURCE).read_text()
    out = {}
    for name, edits in CUTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"ssd.cu moved: the {name!r} cut's text "
                                   f"appears {text.count(old)} times")
            text = text.replace(old, new)
        out[name] = text
    return out


def _cut_libs() -> dict[str, ctypes.CDLL]:
    """The whole library and each cut, the cuts built together."""
    root = _build.BUILD_DIR / "ssd_parts"
    (root / "include").mkdir(parents=True, exist_ok=True)
    (root / "ssd" / "csrc").mkdir(parents=True, exist_ok=True)
    for header in _build.headers():
        shutil.copy(header, root / "include" / header.name)
    procs = {}
    for i, (name, text) in enumerate(_cut_sources().items()):
        path = root / "ssd" / "csrc" / f"cut{i}.cu"
        path.write_text(text)
        so = path.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {"whole": _build.load(ops.SOURCE)}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name!r} cut:\n{err}")
        lib = ctypes.CDLL(str(so))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return {name: ops.typed(lib) for name, lib in libs.items()}


def _inputs(case, dev):
    """The backward's inputs as ``chip_smoke.py`` draws them, in bf16."""
    b, s, h, p, n, chunk = case
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(b, s, h, p, generator=g, device=dev).bfloat16()
    dt = F.softplus(0.55 * torch.randn(b, s, h, generator=g, device=dev))
    cs = torch.cumsum((dt * -2.718281828).reshape(b, s // chunk, chunk, h),
                      2).reshape(b, s, h)
    bm, cm = (0.5 * torch.randn(b, s, n, generator=g, device=dev).bfloat16()
              for _ in range(2))
    dy = torch.randn(b, s, h, p, generator=g, device=dev)
    dst = torch.randn(b, s // chunk, h, n, p, generator=g, device=dev)
    return x, dt, cs, bm, cm, dy, dst


def main() -> None:
    dev = resolve(None)
    flush = torch.ones(32 << 20, dtype=torch.float32, device=dev)
    libs = _cut_libs()
    order = ["whole", *CUTS, "whole"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    for label, case in SHAPES.items():
        args = _inputs(case, dev)
        if ops.bwd_route(torch.bfloat16, case[-1], case[4], case[3]) != "tc":
            raise RuntimeError(f"{label} does not take the tensor-core backward")
        times = {}
        for name in order:
            with mock.patch.object(ops, "_lib", lambda lib=libs[name]: lib):
                ms = _cold_ms(lambda: ops.ssd_chunk_bwd(*args, chunk=case[-1]),
                              flush, 20)
            times.setdefault(name, []).append(ms)
        whole = sum(times["whole"]) / 2
        print(f"{label} {case}: whole {times['whole'][0]:.5f} ms, again "
              f"{times['whole'][1]:.5f} ms")
        for name in CUTS:
            ms = times[name][0]
            print(f"  {name}: {ms:.5f} ms ({whole - ms:+.5f} ms from the whole)")


if __name__ == "__main__":
    main()
