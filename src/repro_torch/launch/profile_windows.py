"""How often a ``torch.profiler`` window on the card loses a kernel.

    PYTHONPATH=src python -m repro_torch.launch.profile_windows --windows 300

Runs the profiled calls of ``chip_smoke.py``'s phase 3 (one
``rmsnorm_bwd`` call at internlm2's train shape (2048, 2048), one at the
LM workflow's (512, 128), bf16; each one cooperative launch) and, beside
them, the RMSNorm forward at the same shapes (a plain launch), each call
in ``--windows`` windows of its own with a trailing marker kernel.
Counts, per call, the windows that hold no marker (no CUDA activity
recorded) and those that hold the marker but not the call's kernel (a
kernel that ran and was not recorded). Then the backward calls again
through ``profile_serve.profiled``, which starts each window with a
leading marker and profiles such a window again after a pause: its count
of windows profiled again is the rate of losses there, and every call
should read one kernel. Prints one JSON line, with the raw windows that
lost something in order (the losses come in bursts). Card only.
"""
from __future__ import annotations

import argparse
import collections
import json

import torch
from torch.profiler import ProfilerActivity, profile

from ..device import resolve
from ..kernels.rmsnorm import ops
from .profile_serve import MARKER, _kernel_times, profiled

SHAPES = ((2048, 2048), (512, 128))


def raw_window(fn) -> collections.Counter:
    """{kernel name: launches} of ``fn`` and one marker launch, read from
    one plain profiler window (no retry)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    return _kernel_times(prof)[1]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    calls = {}
    for shape in SHAPES:
        x, dy = (torch.randn(shape, generator=g, device=dev).bfloat16()
                 for _ in range(2))
        w = torch.randn(shape[-1:], generator=g, device=dev)
        calls[f"rmsnorm_bwd {shape}"] = (
            lambda x=x, w=w, dy=dy: ops.rmsnorm_bwd(x, w, dy))
        calls[f"rmsnorm {shape}"] = lambda x=x, w=w: ops.rmsnorm(x, w)
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()

    raw = {name: collections.Counter() for name in calls}
    lost = []        # (window number, call, what was lost), in window order
    window = 0
    for i in range(args.windows):
        for name, fn in calls.items():
            kernels = raw_window(fn)
            marker = sum(n for k, n in kernels.items() if MARKER in k)
            launches = sum(kernels.values()) - marker
            raw[name]["marker_missing"] += not marker
            raw[name]["kernel_missing_marker_present"] += (
                bool(marker) and launches == 0)
            raw[name][f"launches={launches}"] += 1
            if not marker or launches == 0:
                lost.append((window, name, "all" if not marker else "kernel"))
            window += 1
    checked = collections.Counter()
    profiled.again = 0
    for i in range(args.windows):
        for name, fn in calls.items():
            if name.startswith("rmsnorm_bwd"):
                try:
                    _, kernels, _ = profiled(fn)
                except RuntimeError:   # no CUDA activity in every window
                    checked["no_activity_in_every_window"] += 1
                    continue
                checked[f"launches={sum(kernels.values())}"] += 1
    out = {"device": torch.cuda.get_device_name(dev), "torch": torch.__version__,
           "windows_per_call": args.windows,
           "raw": {k: dict(v) for k, v in raw.items()}, "raw_lost": lost,
           "profiled": dict(checked), "profiled_again": profiled.again}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
