"""Checkpointing as Helix materialization (twin of the JAX package's
``checkpoint/ckpt.py``).

A training run *is* a Helix workflow whose segment nodes are N-step chunks;
this manager is a thin convenience layer for the launcher: it keys train
state by (run_name, step) signatures in the same content-addressed store
(``repro_torch.core.store.Store``), saves asynchronously off the critical
path (a card's tensors are snapshotted into pinned host memory before
``save`` returns, the disk write runs on the store's writer thread), and
restores each leaf onto its home device or where ``sharding_for_leaf``
puts it.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable

from ..core.store import Store


def _sig(run_name: str, step: int) -> str:
    return hashlib.sha256(f"ckpt:{run_name}:{step}".encode()).hexdigest()


class CheckpointManager:
    def __init__(self, store: Store, run_name: str):
        self.store = store
        self.run_name = run_name
        self._pending = []

    def save(self, step: int, state: Any, async_: bool = True) -> None:
        sig = _sig(self.run_name, step)
        name = f"{self.run_name}/step{step}"
        if async_:
            self._pending.append(self.store.save_async(sig, name, state))
        else:
            self.store.save(sig, name, state)

    def wait(self) -> None:
        for pending in self._pending:
            pending.result()          # raises if the write failed
        self._pending.clear()

    def latest_step(self) -> int | None:
        steps = [int(m["name"].rsplit("step", 1)[1])
                 for m in self.store.entries().values()
                 if m["name"].startswith(self.run_name + "/step")]
        return max(steps) if steps else None

    def restore(self, step: int,
                sharding_for_leaf: Callable | None = None) -> Any:
        value, _ = self.store.load(_sig(self.run_name, step),
                                   sharding_for_leaf=sharding_for_leaf)
        return value
