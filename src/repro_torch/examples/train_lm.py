"""End-to-end driver: train a ~100M-parameter LM with segment
checkpointing (twin of the JAX package's ``examples/train_lm.py``, a thin
wrapper over ``launch.train`` with the reference's arguments; ``--device``
and any other trainer flag pass through, and ``--device`` defaults to
``cuda``). Returns the ``TrainResult``.

    # the published ~100M model:
    python -m repro_torch.examples.train_lm --steps 300

    # the reduced config of the same code path (~15M params):
    python -m repro_torch.examples.train_lm --small --steps 200

Interrupt it and re-run with --resume: training continues from the last
materialized segment on the exact same data stream.
"""
from __future__ import annotations

import argparse

from ..launch import train as train_mod


def trainer_argv(argv: list[str] | None = None) -> list[str]:
    """The trainer's arguments for this example's ``argv``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="the reduced model instead of the full ~100M")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--resume", action="store_true")
    args, rest = ap.parse_known_args(argv)

    out = ["--arch", "helix100m", "--steps", str(args.steps),
           "--workdir", "results/train_lm", "--segment-steps", "25",
           "--batch", "8", "--seq", "128", "--lr", "3e-3"]
    if args.small:
        out += ["--reduced", "--batch", "16"]
    if args.resume:
        out += ["--resume"]
    return out + rest


def main(argv: list[str] | None = None) -> train_mod.TrainResult:
    return train_mod.main(trainer_argv(argv))


if __name__ == "__main__":
    main()
