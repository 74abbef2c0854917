"""Time the RMSNorm kernel at each block size it takes, beside
``F.rms_norm`` and the wrapper, at the serving paths' shapes: the evidence
behind ``kernels/rmsnorm/ops.py`` ``plan``.

    PYTHONPATH=src python -m repro_torch.launch.rmsnorm_layouts
    PYTHONPATH=src python src/repro_torch/launch/rmsnorm_layouts.py --host

For each shape, every block size from 32 to 512 threads a row (up to one
thread per 16-byte vector) is launched through the library's ``threads``
argument, checked against the plain version, and timed with a cold L2 (a
128 MB read before each launch, then a spin on the card so the host has
queued the timed launch behind it), after a few untimed rounds that bring
the card's clocks up.

``--host`` instead prints the wrapper's host µs per call at the decode
shape (4, 1, 2048) bf16 beside ``F.rms_norm``'s, on the host clock over
many calls in a row.

The imports are absolute: run as a file with another tree's ``src`` on
``PYTHONPATH``, either mode measures that tree's wrapper (a tree whose
kernel takes no block size gets only the wrapper and ``F.rms_norm``
timed), so a parent and a change can be compared in one call. Card only.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.kernels.rmsnorm import ops, ref

SHAPES = [((4, 2048), torch.bfloat16), ((2048, 2048), torch.bfloat16),
          ((4, 1536), torch.float32), ((2048, 1536), torch.float32),
          ((4, 768), torch.bfloat16), ((2048, 768), torch.bfloat16),
          ((2048, 1536), torch.bfloat16), ((8192, 2048), torch.bfloat16),
          ((32768, 2048), torch.bfloat16)]


def _cold_ms(fn, flush: torch.Tensor, n: int, warmup: int = 5) -> float:
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(warmup + n)]
    for start, end in pairs:
        flush.sum()
        torch.cuda._sleep(200_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs[warmup:]) / n


def _block_sizes(d: int, elem_bytes: int) -> list[int]:
    """Every block size worth timing: whole warps up to a thread a vector."""
    fit = min(ops.MAX_THREADS, -(-d * elem_bytes // 16 // 32) * 32)
    return [t for t in (32, 64, 96, 128, 192, 256, 384, 512) if t < fit] + [fit]


def host_us(fn, n: int = 3000) -> float:
    """Host µs per call of ``fn`` over ``n`` calls in a row with no
    synchronisation inside the loop (the card keeps up at this shape)."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=30, help="timed launches")
    ap.add_argument("--host", action="store_true",
                    help="only the wrapper's host µs per call at decode")
    args = ap.parse_args(argv)
    dev = resolve("cuda")
    if args.host:
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(4, 1, 2048, generator=g, device=dev).bfloat16()
        w = torch.randn(2048, generator=g, device=dev)
        w_lib = w.bfloat16()
        print(f"{torch.cuda.get_device_name(dev)}; rmsnorm (4, 1, 2048) bf16 "
              f"host µs per call: wrapper {host_us(lambda: ops.rmsnorm(x, w)):.3f}, "
              f"F.rms_norm {host_us(lambda: F.rms_norm(x, (2048,), w_lib, 1e-5)):.3f}"
              f" ({ops.__file__})")
        return
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.ones(32 << 20, dtype=torch.float32, device=dev)
    sweep = hasattr(ops, "plan")          # this tree's kernel takes `threads`
    fwd = ops._fwd() if sweep else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    print(f"{torch.cuda.get_device_name(dev)}; times in ms, cold L2")
    for (n_rows, d), dtype in SHAPES:
        x = torch.randn(n_rows, d, generator=g, device=dev).to(dtype)
        w = torch.randn(d, generator=g, device=dev)
        want = ref.rmsnorm_ref(x, w).float()
        out = torch.empty_like(x)
        bf16 = int(dtype == torch.bfloat16)

        def launch(threads: int) -> None:
            code = fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(), n_rows, d,
                       1e-5, bf16, threads, stream)
            if code:
                raise RuntimeError(f"rmsnorm_fwd: CUDA error {code}")

        w_lib = w.to(dtype)
        row = {"F.rms_norm": _cold_ms(
            lambda: F.rms_norm(x, (d,), w_lib, 1e-5), flush, args.n),
               "wrapper": _cold_ms(lambda: ops.rmsnorm(x, w), flush, args.n)}
        if not sweep:
            print(f"({n_rows}, {d}) {str(dtype)[6:]}: "
                  + ", ".join(f"{k} {v:.5f}" for k, v in row.items()))
            continue
        for threads in _block_sizes(d, x.element_size()):
            launch(threads)
            torch.cuda.synchronize()
            err = float((out.float() - want).abs().max())
            if err > 2e-2 + 2.0 ** -8 * float(want.abs().max()):
                raise RuntimeError(f"{threads} threads at {(n_rows, d)}: "
                                   f"max_abs_err {err}")
            row[f"block{threads}"] = _cold_ms(lambda: launch(threads), flush,
                                              args.n)
        plan = ops.plan(n_rows, d, x.element_size(), n_sms)
        best = min((k for k in row if k.startswith("block")), key=row.get)
        print(f"({n_rows}, {d}) {str(dtype)[6:]}: plan block{plan}, fastest "
              f"{best}; "
              + ", ".join(f"{k} {v:.5f}" for k, v in row.items()))


if __name__ == "__main__":
    main()
