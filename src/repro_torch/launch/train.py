"""The trainer on one card (twin of the JAX package's
``launch/train.py``).

Fault-tolerance model: training is segmented; every segment boundary
asynchronously materializes the ``TrainState`` into the content-addressed
store (``checkpoint.CheckpointManager``). A restarted job (``--resume``)
restores the newest checkpoint onto the device and the deterministic
batcher (a pure function of (seed, step)) replays the exact data stream.
A per-step watchdog flags stragglers via z-score on step time.

The reference's flags, plus ``--device`` (default ``cuda``; asking for it
without a card raises) and ``--full`` (the published config, which is also
the default, as in the reference; ``--reduced`` runs the same code path at
smoke size). There is no mesh: ``--production-mesh`` raises until the
distributed substrate is ported.

    python -m repro_torch.launch.train --device cpu --reduced --steps 20
    python -m repro_torch.launch.train --arch internlm2-1.8b --full --batch 4 --seq 512

``train`` is the library entry point: it runs steps ``[start, stop)`` of a
run from a given state and is what ``main`` and ``chip_smoke.py`` call.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch

from .. import configs
from ..checkpoint import CheckpointManager
from ..core.store import Store
from ..data import synth
from ..data.pipeline import TokenBatcher, batch_to
from ..device import resolve
from ..models.config import ArchConfig
from ..train import steps


class Watchdog:
    """Straggler/step-time anomaly detection."""

    def __init__(self, z_thresh: float = 4.0):
        self.times: list[float] = []
        self.z = z_thresh

    def observe(self, dt: float) -> str | None:
        self.times.append(dt)
        if len(self.times) < 10:
            return None
        mu = float(np.mean(self.times[-50:-1]))
        sd = float(np.std(self.times[-50:-1])) + 1e-9
        if (dt - mu) / sd > self.z:
            return (f"straggler suspected: step took {dt:.3f}s "
                    f"(mean {mu:.3f}s, z={(dt - mu) / sd:.1f})")
        return None


@dataclasses.dataclass
class TrainResult:
    state: Any                   # the TrainState after the last step
    losses: list[float]          # per step run
    metrics: list[dict]          # per step run: each metric as a float
    step_s: list[float]          # per step run: host seconds, ending in a sync
    start_step: int


def train(cfg: ArchConfig, state: steps.TrainState, batcher: TokenBatcher,
          start: int, stop: int, *, lr: float, total_steps: int,
          device: torch.device, ckpt: CheckpointManager | None = None,
          segment_steps: int = 50, log_every: int = 10) -> TrainResult:
    """Steps ``start .. stop - 1`` of a run from ``state``: batch ``i`` is
    ``batcher.batch_at(i)``, the schedule warms up over 20 steps and decays
    to ``total_steps``; with ``ckpt``, the state after every
    ``segment_steps``-th step is saved asynchronously."""
    dog = Watchdog()
    losses, history, times = [], [], []
    for step in range(start, stop):
        batch = batch_to(batcher.batch_at(step), device)
        t0 = time.perf_counter()
        state, metrics = steps.train_step(cfg, state, batch, peak_lr=lr,
                                          warmup_steps=20,
                                          total_steps=total_steps)
        metrics = {k: float(v) for k, v in metrics.items()}   # syncs
        dt = time.perf_counter() - t0
        loss = metrics["loss"]
        losses.append(loss)
        history.append(metrics)
        times.append(dt)
        warn = dog.observe(dt)
        if warn:
            print(f"[watchdog] {warn}")
        if step % log_every == 0 or step == stop - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {metrics['lr']:.2e} "
                  f"gnorm {metrics['grad_norm']:.2f} "
                  f"{dt:.3f}s/step", flush=True)
        if ckpt is not None and (step + 1) % segment_steps == 0:
            ckpt.save(step + 1, state)       # async materialization
    return TrainResult(state=state, losses=losses, metrics=history,
                       step_s=times, start_step=start)


def main(argv: list[str] | None = None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="helix100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the published config (the default)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--segment-steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default="results/train")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (requires 256 devices)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh comes with the distributed substrate "
            "(ROADMAP queue 1 item 9)")
    dev = resolve(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"mesh=none devices=1 device={dev}")

    tokens = synth.lm_tokens(args.seed, max(2_000_000,
                                            args.batch * (args.seq + 1) * 4),
                             cfg.vocab_size)
    batcher = TokenBatcher(tokens, args.batch, args.seq, seed=args.seed)

    store = Store(os.path.join(args.workdir, "store"))
    ckpt = CheckpointManager(store, run_name=f"{cfg.name}-s{args.seed}")

    start_step = 0
    if args.resume:
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(latest,
                                 sharding_for_leaf=lambda i, shape, dtype: dev)
            start_step = latest
            print(f"resumed from step {latest} (restored onto {dev})")
    if start_step == 0:
        state = steps.init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)

    res = train(cfg, state, batcher, start_step, args.steps, lr=args.lr,
                total_steps=args.steps, device=dev, ckpt=ckpt,
                segment_steps=args.segment_steps, log_every=args.log_every)
    ckpt.wait()
    if res.losses:
        print(f"done: loss {res.losses[0]:.3f} → {res.losses[-1]:.3f} "
              f"({args.steps - start_step} steps)")
    return res


if __name__ == "__main__":
    main()
