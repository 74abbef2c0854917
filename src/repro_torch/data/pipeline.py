"""Deterministic batch pipeline (twin of the JAX package's
``data/pipeline.py``).

Determinism contract (fault tolerance): batch ``i`` of run ``seed`` is a
pure function of ``(seed, i)``: any restarted job reproduces the exact
token stream, so a restored checkpoint continues on the *same* data order.
``TokenBatcher`` is the reference's, copied (pure numpy); ``batch_to``
stands in for ``device_put_batch`` on one device. Sharded placement of a
batch across a mesh is ROADMAP queue 1 item 9d.
"""
from __future__ import annotations

import numpy as np
import torch


class TokenBatcher:
    def __init__(self, tokens: np.ndarray, batch: int, seq: int, seed: int = 0):
        self.tokens = tokens
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.n_windows = len(tokens) // (seq + 1)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        idx = rng.integers(0, self.n_windows, self.batch)
        starts = idx * (self.seq + 1)
        rows = np.stack([self.tokens[s:s + self.seq + 1] for s in starts])
        return {"tokens": rows[:, :-1].astype(np.int32)}


def batch_to(batch: dict, device: torch.device | str) -> dict:
    """Each array of ``batch`` as a tensor on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
