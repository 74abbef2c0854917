"""Where the serving time goes on the card: ``torch.profiler`` over
``serve.run`` at full width.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch mamba2-130m

After a warm-up run, one run without the profiler gives the wall times;
then a prefill-only run (one generated token) and a full run (prefill plus
``gen_tokens - 1`` decode steps) are profiled, and the decode loop's
kernels are their difference. Prints, for prefill and for decode: wall ms, device
kernel ms, the device's busy share of the wall time, kernel launches, and
the kernels that take the most device time. Card only: the numbers are
device times, and a run that sees no device time fails.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import configs
from ..data import synth
from ..device import resolve
from ..models import registry
from . import serve


def _kernel_times(prof) -> tuple[collections.Counter, collections.Counter]:
    """({kernel name: device µs}, {kernel name: launches}) of one profile."""
    out = collections.Counter()
    calls = collections.Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:   # kernels, not the ops launching them
            out[e.key] += e.self_device_time_total
            calls[e.key] += e.count
    return out, calls


# the kernel ``torch.cuda._sleep`` launches: the markers of a profiled window
MARKER = "spin_kernel"
# windows a call may take; the losses come in bursts of consecutive
# windows, so each retry waits longer first
PROFILE_TRIES = 4
RETRY_PAUSE_S = 0.25
# the leading marker's length (~0.1 ms): the call's first kernel starts
# that far inside the window
LEAD_CYCLES = 200_000


def profiled(fn, *, activities=(ProfilerActivity.CUDA,), setup=None):
    """``fn()`` (``fn(setup())`` with ``setup``, which runs outside the
    window) under ``torch.profiler``, between two marker kernels
    (``torch.cuda._sleep``): a leading one of ``LEAD_CYCLES``, so that
    ``fn``'s first kernel does not start at the window's edge, and a short
    trailing one. Returns (``_kernel_times`` without the markers, what
    ``fn`` returned).

    The profiler on the card now and then loses a kernel's record: a
    window can come back without a marker (no CUDA activity recorded at
    all), or with one and nothing of ``fn`` (a kernel that ran but was not
    recorded). Either window is logged and profiled again from the start,
    after a pause of ``RETRY_PAUSE_S`` times the windows tried, up to
    ``PROFILE_TRIES`` windows (``profiled.again`` counts them), so that
    only a kernel missing from every window reads as one that did not
    run. A last window without a marker raises."""
    for attempt in range(1, PROFILE_TRIES + 1):
        if attempt > 1:
            time.sleep(RETRY_PAUSE_S * (attempt - 1))
        arg = setup() if setup is not None else None
        torch.cuda.synchronize()
        with profile(activities=list(activities)) as prof:
            torch.cuda._sleep(LEAD_CYCLES)
            out = fn(arg) if setup is not None else fn()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        times, calls = _kernel_times(prof)
        marker = [k for k in calls if MARKER in k]
        for key in marker:   # no profiled call launches the marker itself
            del calls[key], times[key]
        if marker and (calls or attempt == PROFILE_TRIES):
            return times, calls, out
        what = ("its markers and nothing else" if marker else
                f"no marker kernel ({len(calls)} kernel names)")
        print(f"[profiler] window {attempt} of {PROFILE_TRIES} holds {what}",
              file=sys.stderr, flush=True)
        if attempt < PROFILE_TRIES:
            profiled.again += 1
    raise RuntimeError(f"torch.profiler recorded no CUDA activity in "
                       f"{PROFILE_TRIES} windows, each with a marker kernel")


profiled.again = 0   # windows profiled again since last set to 0


def _report(label, wall_s, steps, times, calls, top):
    dev_ms = sum(times.values()) / 1e3
    launches = sum(calls.values())
    print(f"{label}: wall {wall_s * 1e3:.3f} ms, device {dev_ms:.3f} ms "
          f"(busy {dev_ms / (wall_s * 1e3):.1%}), {launches} launches "
          f"over {steps} step(s)")
    for name, us in times.most_common(top):
        print(f"  {us / 1e3:9.3f} ms {us / 1e3 / dev_ms:6.1%} "
              f"{calls[name]:6d}x  {name[:110]}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)

    dev = resolve("cuda")
    cfg = dataclasses.replace(configs.get(args.arch), attn_impl="flash")
    params = registry.init(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    toks = synth.lm_tokens(args.seed, args.batch * args.prompt_len + 1,
                           cfg.vocab_size)
    prompts = toks[:args.batch * args.prompt_len].reshape(
        args.batch, args.prompt_len)
    serve.run(cfg, params, prompts, args.gen_tokens, device=dev)   # warm-up
    timed = serve.run(cfg, params, prompts, args.gen_tokens, device=dev)

    acts = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
    t_pre, c_pre, _ = profiled(
        lambda: serve.run(cfg, params, prompts, 1, device=dev), activities=acts)
    t_all, c_all, _ = profiled(
        lambda: serve.run(cfg, params, prompts, args.gen_tokens, device=dev),
        activities=acts)
    if not t_pre or not t_all:
        raise RuntimeError("torch.profiler recorded no device time")
    print(f"{torch.cuda.get_device_name(dev)}; {cfg.name} batch {args.batch} "
          f"prompt {args.prompt_len} gen {args.gen_tokens}")
    _report("prefill", timed.prefill_s, 1, t_pre, c_pre, args.top)
    _report("decode", timed.decode_s, args.gen_tokens - 1,
            t_all - t_pre, c_all - c_pre, args.top)


if __name__ == "__main__":
    main()
