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

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof_pre:
        serve.run(cfg, params, prompts, 1, device=dev)
    with profile(activities=acts) as prof_all:
        serve.run(cfg, params, prompts, args.gen_tokens, device=dev)
    t_pre, c_pre = _kernel_times(prof_pre)
    t_all, c_all = _kernel_times(prof_all)
    if not t_pre or not t_all:
        raise RuntimeError("torch.profiler recorded no device time")
    print(f"{torch.cuda.get_device_name(dev)}; {cfg.name} batch {args.batch} "
          f"prompt {args.prompt_len} gen {args.gen_tokens}")
    _report("prefill", timed.prefill_s, 1, t_pre, c_pre, args.top)
    _report("decode", timed.decode_s, args.gen_tokens - 1,
            t_all - t_pre, c_all - c_pre, args.top)


if __name__ == "__main__":
    main()
