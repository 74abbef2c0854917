"""Host-clock seconds of internlm2-1.8b's train step on the card at full
width (batch 4 x 512, the config's remat "block" and chunked attention:
``chip_smoke.py`` phases 6 and 6f), through the trainer's loop
(``launch.train.train``, each step ending in a sync), from one init:
first with no mesh, then with the state placed on the one-card mesh
(``make_local_mesh``, ``place``) inside ``use_mesh``. The first step of
each run is a warm-up; the median of the rest is the step's time.

    python -m repro_torch.launch.step_times --steps 6
    PYTHONPATH=<another tree>/src python <this file> --label parent

The imports are absolute, so the same file times another tree of the
port (an earlier commit unpacked beside this one) when that tree's
``src`` comes first on the path. Prints one JSON line: the label, the
card and its power limit, and the seconds of every step of both runs.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

ARCH, BATCH, SEQ, SEED, LR, TOTAL = "internlm2-1.8b", 4, 512, 0, 3e-4, 100


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import synth
    from repro_torch.data.pipeline import TokenBatcher
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib, train
    from repro_torch.models import params as params_lib
    from repro_torch.sharding.activation import use_mesh
    from repro_torch.train import steps

    if not torch.cuda.is_available():
        raise SystemExit("step_times: needs an NVIDIA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cfg = configs.get(ARCH)
    tokens = synth.lm_tokens(SEED, max(2_000_000, BATCH * (SEQ + 1) * 4),
                             cfg.vocab_size)
    batcher = TokenBatcher(tokens, BATCH, SEQ, seed=SEED)

    def run(state):
        res = train.train(cfg, state, batcher, 0, args.steps, lr=LR,
                          total_steps=TOTAL, device=dev,
                          log_every=args.steps)
        return res.step_s, res.losses

    def init():
        return steps.init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(SEED), dev)

    plain_s, plain_loss = run(init())
    torch.cuda.empty_cache()
    mesh = mesh_lib.make_local_mesh(dev)
    try:
        placed = params_lib.place(init(), train.state_shardings(cfg, mesh))
        with use_mesh(mesh):
            mesh_s, mesh_loss = run(placed)
        del placed
    finally:
        dist.destroy_process_group()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"label": args.label, "card": smi, "torch": torch.__version__,
           "arch": ARCH, "batch": BATCH, "seq": SEQ,
           "plain_step_s": plain_s, "mesh_step_s": mesh_s,
           "plain_median_s": statistics.median(plain_s[1:]),
           "mesh_median_s": statistics.median(mesh_s[1:]),
           "same_losses": plain_loss == mesh_loss}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
