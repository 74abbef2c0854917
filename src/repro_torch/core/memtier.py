"""Memory tier of the TierStack (memory → disk → remote).

The store's two durable tiers (disk, remote) round-trip every value
through ``.npy`` — serialization that caps iteration latency exactly
where the paper's sub-second feedback loop matters. This module adds the
tier that was missing: a bounded host-RAM cache of materialized values
held as **zero-copy pytrees** (``np.ndarray`` / ``torch.Tensor`` leaves
are referenced, never serialized), sitting in front of the disk tier behind
the same signature-keyed API.

Semantics:

* **Read-through promotion** — every disk/remote load publishes its
  value here, so the next same-process load of that signature is a
  dictionary lookup: no ``.npy`` read, no unpickle, no host copy.
* **Write-through** — a publish to disk admits its (already snapshotted)
  host pytree here for free; ``save_enqueue`` admits *before* the disk
  write lands (state ``"queued"``), so in-process reuse never waits on
  the writer thread.
* **Demote-not-delete eviction** — the budget is enforced by *demotion*,
  ranked by :func:`~repro_torch.core.eviction.ranked_mem`: an entry the disk
  tier already holds (``"durable"``/``"queued"``) demotes by dropping
  the RAM reference (the value survives one tier down at one disk-reload
  of cost); a ``"dirty"`` entry (memory-only, write-back mode) is first
  *spilled* to disk through the owning store's spill hook — which runs
  the ``memtier:before_spill`` / ``memtier:after_spill`` crash points —
  and only then dropped.
* **Async device offload** — values admitted with CUDA tensor leaves
  (loads placed on the card) are handed to the store's writer-queue
  machinery to be snapshotted into **pinned** host tensors off the
  critical path (so placing them back on the card can be
  ``non_blocking``). Each entry records the device every tensor leaf was
  admitted from (``MemEntry.devices``), so the store puts a hit back
  there whichever copy the entry holds at that moment: the device
  tensors themselves before the offload lands (zero-copy), the pinned
  snapshot copied back after it.

Hits hand out the stored tensors themselves: operators must not mutate
their inputs (see workflow.py).

Entry states:

``"durable"``
    A committed disk copy exists; demotion is a drop.
``"queued"``
    The disk write is owned by the store's writer queue (which holds its
    own reference to the host pytree); dropping here loses nothing.
``"dirty"``
    Memory-only (write-back mode). Demotion must spill first; a crash
    before the spill loses the entry — recovery is a clean recompute
    (the signature was never visible to any other process).

The per-tier ledger invariant mirrors the disk tier's ``ledger == disk``:
:attr:`MemTier.bytes_held` (maintained transactionally with every
admit/drop) always equals :meth:`MemTier.recount` (the ground-truth sum
over resident entries). ``tier_status()`` surfaces both via the unified
per-tier record (name, bytes, budget, entries, leases, hits, misses).

The tier is deliberately **process-local**: cross-process coherence is
the disk tier's job (entry locks, leases, the fleet ledger). Because
entries are content-addressed by signature, a resident value can never
be *stale* — at worst it is a copy of something another process deleted,
which is a budget question, not a correctness one (``Store.delete``
drops the resident copy anyway, so tiers never disagree for long).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable

import torch

from .eviction import ranked_mem
from .tree import tree_leaves

# Distinguishes "miss" from a legitimately-None cached value.
MISS = object()


def leaf_devices(value: Any) -> tuple:
    """The device of each leaf of ``value`` in flatten order, as a string
    (``"cuda:0"``, ``"cpu"``) for a tensor and None for any other leaf."""
    return tuple(str(leaf.device) if isinstance(leaf, torch.Tensor) else None
                 for leaf in tree_leaves(value))


class MemEntry:
    """One resident value (slots: this sits on the hot hit path).
    ``devices`` is the home device of each leaf (see :func:`leaf_devices`)
    — where the value's tensors lived when it was admitted, which the
    value itself stops telling once the offload has moved them."""

    __slots__ = ("value", "nbytes", "name", "meta", "state", "loads",
                 "last_load", "created", "has_device", "devices")

    def __init__(self, value: Any, nbytes: int, name: str, meta: dict,
                 state: str, devices: tuple | None = None):
        self.value = value
        self.nbytes = int(nbytes)
        self.name = name
        self.meta = dict(meta)
        self.state = state              # "durable" | "queued" | "dirty"
        self.loads = 0
        self.last_load = 0.0
        self.created = time.time()
        self.has_device = any(
            isinstance(leaf, torch.Tensor) and leaf.is_cuda
            for leaf in tree_leaves(value))
        self.devices = (leaf_devices(value) if devices is None
                        else tuple(devices))


class MemTier:
    """Bounded host-RAM tier of one :class:`~repro_torch.core.store.Store`.

    ``spill(sig, entry)`` persists a dirty entry to the disk tier (the
    store wires its own lock-safe save path, with crash points);
    ``offload(sig)`` schedules an async device→host snapshot of a
    resident entry on the store's writer queue; ``writeback=True`` makes
    the store's saves land here *instead of* disk (demotion becomes the
    write-back point). All three are optional — a bare tier is a plain
    bounded promotion cache.
    """

    def __init__(self, budget_bytes: float, *, writeback: bool = False,
                 spill: Callable[[str, MemEntry], None] | None = None,
                 offload: Callable[[str], None] | None = None,
                 est_disk_load: Callable[[float], float] | None = None):
        self.budget_bytes = float(budget_bytes)
        self.writeback = bool(writeback)
        self._spill = spill
        self._offload = offload
        self._est_disk_load = est_disk_load or (lambda nb: nb / 500e6 + 1e-4)
        self._lock = threading.Lock()
        self._entries: dict[str, MemEntry] = {}
        self._bytes = 0                 # the per-tier ledger
        # Observability (tier_status schema: hits/misses + tier actions).
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.demotions = 0              # durable/queued drops under pressure
        self.spills = 0                 # dirty entries written back to disk
        self.offloads = 0               # async device→host snapshots run
        self.offload_bytes = 0          # bytes those snapshots copied
        self.offload_seconds = 0.0      # writer-thread seconds they took

    # -- admission / demotion ----------------------------------------------
    def put(self, sig: str, value: Any, nbytes: int, *, name: str = "",
            meta: dict | None = None, state: str = "durable",
            devices: tuple | None = None) -> bool:
        """Admit (or replace) ``sig``; demote the cheapest residents to
        fit the budget. Returns False when the value alone exceeds the
        whole budget (nothing is admitted or demoted then). The new
        entry ranks with everything else — admitting it may immediately
        demote it if it is the least valuable resident. ``devices`` names
        each leaf's home device when ``value`` is a host snapshot of it
        (default: where ``value``'s own leaves are)."""
        nbytes = int(nbytes)
        if nbytes > self.budget_bytes or self.budget_bytes <= 0:
            return False
        victims: list[tuple[str, MemEntry]] = []
        with self._lock:
            old = self._entries.pop(sig, None)
            if old is not None:
                self._bytes -= old.nbytes
            ent = MemEntry(value, nbytes, name, meta or {}, state, devices)
            if old is not None:
                # Same signature ⇒ same value: carry the reuse evidence
                # (and never let a re-admit weaken durability to the
                # point of forgetting an existing disk copy).
                ent.loads, ent.last_load = old.loads, old.last_load
                if old.state == "durable" and state == "queued":
                    ent.state = "durable"
            self._entries[sig] = ent
            self._bytes += nbytes
            if self._bytes > self.budget_bytes:
                victims = self._pick_victims_locked(
                    self._bytes - self.budget_bytes)
        for vsig, vent in victims:
            self._demote(vsig, vent)
        if ent.has_device and self._offload is not None:
            self._offload(sig)
        with self._lock:
            return sig in self._entries

    def _pick_victims_locked(self, deficit: float
                             ) -> list[tuple[str, MemEntry]]:
        """Remove (and return) the cheapest-to-demote entries covering
        ``deficit`` bytes. Runs under the tier lock; the actual demotion
        work (spills do store I/O) happens outside it."""
        snapshot = {
            sig: {"nbytes": e.nbytes, "loads": e.loads,
                  "last_load": e.last_load, "created": e.created,
                  "dirty": e.state == "dirty",
                  "compute_s": float(e.meta.get("compute_s", 0.0) or 0.0)}
            for sig, e in self._entries.items()}
        victims: list[tuple[str, MemEntry]] = []
        for sig in ranked_mem(snapshot, self._est_disk_load):
            if deficit <= 0:
                break
            ent = self._entries.pop(sig)
            self._bytes -= ent.nbytes
            deficit -= ent.nbytes
            victims.append((sig, ent))
        return victims

    def _demote(self, sig: str, ent: MemEntry) -> None:
        """Demote one already-removed entry: spill if dirty, else drop
        (the cheap action — a durable/queued entry survives one tier
        down). A spill crash (InjectedCrash) propagates: the simulated
        participant died mid-demotion."""
        if ent.state == "dirty" and self._spill is not None:
            self.spills += 1
            self._spill(sig, ent)
        else:
            self.demotions += 1

    # -- lookups -----------------------------------------------------------
    def get(self, sig: str) -> MemEntry | None:
        """Hit path: the resident entry (bumping reuse evidence and hit
        counters) or None. Zero-copy — the caller gets the stored pytree
        itself, under the store-wide convention that materialized values
        are immutable."""
        with self._lock:
            ent = self._entries.get(sig)
            if ent is None:
                self.misses += 1
                return None
            ent.loads += 1
            ent.last_load = time.time()
            self.hits += 1
            self.hit_bytes += ent.nbytes
            return ent

    def peek(self, sig: str) -> MemEntry | None:
        """Lookup without touching hit/reuse counters (bookkeeping)."""
        with self._lock:
            return self._entries.get(sig)

    def has(self, sig: str) -> bool:
        """Is ``sig`` resident (any state)?"""
        with self._lock:
            return sig in self._entries

    def drop(self, sig: str) -> bool:
        """Remove ``sig`` without demotion (e.g. the store deleted the
        entry fleet-wide). Returns True when something was resident."""
        with self._lock:
            ent = self._entries.pop(sig, None)
            if ent is not None:
                self._bytes -= ent.nbytes
            return ent is not None

    def clear(self) -> None:
        """Drop everything (tests / benchmarks isolating the disk tier)."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def mark_durable(self, sig: str) -> None:
        """Record that a committed disk copy now exists for ``sig``."""
        with self._lock:
            ent = self._entries.get(sig)
            if ent is not None:
                ent.state = "durable"

    def replace_value(self, sig: str, value: Any, expect: Any,
                      seconds: float = 0.0) -> bool:
        """Swap a resident entry's value (the async device→host offload
        landing, which took ``seconds``) — only if the entry still holds
        exactly the pytree the offload snapshotted (``expect``), so a
        racing re-admit wins."""
        with self._lock:
            ent = self._entries.get(sig)
            if ent is None or ent.value is not expect:
                return False
            ent.value = value
            ent.has_device = False
            self.offloads += 1
            self.offload_bytes += ent.nbytes
            self.offload_seconds += float(seconds)
        return True

    def flush(self) -> int:
        """Write-back barrier: spill every dirty entry to disk (keeping
        it resident as ``"durable"``). Returns the number spilled."""
        with self._lock:
            dirty = [(sig, ent) for sig, ent in self._entries.items()
                     if ent.state == "dirty"]
        n = 0
        for sig, ent in dirty:
            if self._spill is not None:
                self.spills += 1
                self._spill(sig, ent)
            self.mark_durable(sig)
            n += 1
        return n

    def dirty_sigs(self) -> list[str]:
        """Signatures resident only in memory (write-back entries)."""
        with self._lock:
            return [sig for sig, ent in self._entries.items()
                    if ent.state == "dirty"]

    # -- ledger / observability --------------------------------------------
    @property
    def bytes_held(self) -> int:
        """The tier ledger: bytes admitted minus bytes demoted/dropped."""
        with self._lock:
            return self._bytes

    def recount(self) -> int:
        """Ground truth for the ledger invariant: sum over residents."""
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def status(self) -> dict:
        """Unified per-tier record (same schema as the disk/remote tiers
        in ``Store.tier_status``: name, bytes, budget, entries, leases,
        hits, misses — plus this tier's demotion/spill/offload counts)."""
        with self._lock:
            n_dirty = sum(1 for e in self._entries.values()
                          if e.state == "dirty")
            return {
                "name": "memory",
                "bytes": self._bytes,
                "budget": self.budget_bytes,
                "entries": len(self._entries),
                # Memory is process-local: nothing fleet-visible to lease.
                "leases": {"compute": 0, "pins": 0, "waiters": 0},
                "hits": self.hits,
                "misses": self.misses,
                "hit_bytes": self.hit_bytes,
                "dirty": n_dirty,
                "demotions": self.demotions,
                "spills": self.spills,
                "offloads": self.offloads,
                "offload_bytes": self.offload_bytes,
                "offload_seconds": self.offload_seconds,
            }
