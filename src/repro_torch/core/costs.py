"""Operator cost statistics (paper §5.1 "Operator Metrics").

``c_i`` (compute seconds) is measured at execution and keyed by the node's
*signature*: if a node has been run before under the same signature, the
recorded statistic is exact, which is the paper's assumption ("we would have
run the exact same operator before and recorded accurate c_i and l_i").

Beyond-paper: for *never-seen* nodes the paper has a cold-start problem (it
must compute them anyway by Constraint 1, but OMP and downstream planning
still want estimates). We allow a ``cost_hint`` (e.g. derived from a compiled
dry-run's roofline terms: max(flops/peak, bytes/bw)) as a prior.

Statistics persist to JSON so sessions survive process restarts — that is
what turns checkpoint/restart into plain Helix reuse.

Fleet mode: many sessions may share one ``costs.json`` (one workdir, N
concurrent sweep variants or processes). ``save()`` is therefore a
*merge-on-flush* transaction — under the file lock it re-reads the on-disk
blob, EWMA-blends statistics **this session actually measured** into it
(they are keyed by signature, so both sides measured the same operator;
blending smooths machine noise), unions the rest, and publishes
atomically. Values merely read from disk at init are NOT re-merged — that
would let a stale historical number partially revert a sibling's fresher
measurement. Sessions refine a shared model instead of clobbering each
other's flushes.

Observed reuse: every time a signature's value is *reused* (a planned LOAD
or an in-flight dedupe hit) the model counts it. ``reuse_count`` feeds
OMP's amortized materialization threshold (see omp.py ``multiplicity``):
a signature the fleet has historically loaded seven times is worth
materializing even when no sibling is live right now. Reuse counts are
merged additively on flush (each session contributes the events it
witnessed; they are disjoint by construction).
"""
from __future__ import annotations

import threading

from .locking import read_json, update_json

# Weight of THIS session's fresh measurement when the signature also has
# an on-disk value: recency dominates (a large gap means the environment
# changed), the old value just damps noise.
_MERGE_NEW = 0.7


class CostModel:
    """Per-signature operator statistics (compute seconds, output bytes,
    seen-set for change tracking, observed reuse counts), persisted to one
    JSON file with fleet-safe merge-on-flush semantics."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        blob = read_json(path, {})
        self.compute_s: dict[str, float] = blob.get("compute_s", {})
        self.nbytes: dict[str, float] = blob.get("nbytes", {})
        self.seen: set[str] = set(blob.get("seen", []))
        self.reuse: dict[str, float] = blob.get("reuse", {})
        # signatures recorded by THIS session since the last flush — the
        # only ones whose values save() pushes into the shared file
        self._dirty: set[str] = set()
        # reuse events witnessed here since the last flush (merged
        # additively: sessions witness disjoint events)
        self._reuse_delta: dict[str, float] = {}

    def _merge_stat(self, disk: dict[str, float], mine: dict[str, float]
                    ) -> dict[str, float]:
        out = dict(disk)
        for sig, v in mine.items():
            if sig in self._dirty:
                cur = out.get(sig)
                out[sig] = (v if cur is None
                            else (1 - _MERGE_NEW) * float(cur)
                            + _MERGE_NEW * v)
            elif sig not in out:
                # not measured here and gone from disk: keep the knowledge
                out[sig] = v
        return out

    def save(self) -> None:
        """Flush this session's fresh statistics into the shared file
        (merge-on-flush; see the module docstring) and adopt the merged
        fleet view."""
        with self._lock:
            def txn(blob):
                reuse = dict(blob.get("reuse", {}))
                for sig, delta in self._reuse_delta.items():
                    reuse[sig] = float(reuse.get(sig, 0.0)) + delta
                for sig, v in self.reuse.items():
                    reuse.setdefault(sig, v)   # keep knowledge from init
                return {
                    "compute_s": self._merge_stat(
                        blob.get("compute_s", {}), self.compute_s),
                    "nbytes": self._merge_stat(
                        blob.get("nbytes", {}), self.nbytes),
                    "seen": sorted(set(blob.get("seen", [])) | self.seen),
                    "reuse": reuse,
                }

            merged = update_json(self.path, txn, {})
            # Adopt the merged view: other sessions' statistics become
            # available to this session's next planning pass.
            self.compute_s = dict(merged["compute_s"])
            self.nbytes = dict(merged["nbytes"])
            self.seen = set(merged["seen"])
            self.reuse = dict(merged["reuse"])
            self._dirty.clear()
            self._reuse_delta.clear()

    # -- recording -------------------------------------------------------------
    def record(self, sig: str, compute_seconds: float | None = None,
               nbytes: float | None = None, reused: bool = False) -> None:
        """Record an execution observation for ``sig``. ``reused`` marks a
        reuse event (the value was loaded instead of computed).

        Holds the model lock for the whole update: the session server
        shares one CostModel across concurrent job threads, so a record
        must never interleave with a sibling's ``save()`` (whose merge
        iterates these dicts and then clears the dirty set — an unlocked
        record in that window would be silently dropped)."""
        with self._lock:
            if compute_seconds is not None:
                self.compute_s[sig] = compute_seconds
                self._dirty.add(sig)
            if nbytes is not None:
                self.nbytes[sig] = nbytes
                self._dirty.add(sig)
            if reused:
                self.reuse[sig] = self.reuse.get(sig, 0.0) + 1.0
                self._reuse_delta[sig] = \
                    self._reuse_delta.get(sig, 0.0) + 1.0
            self.seen.add(sig)

    # -- queries ---------------------------------------------------------------
    def compute_cost(self, sig: str, hint: float | None = None,
                     default: float = 1.0) -> float:
        """Estimated compute seconds for ``sig``: measured if known, else
        the caller's ``hint`` (e.g. a roofline dry-run), else ``default``."""
        if sig in self.compute_s:
            return self.compute_s[sig]
        if hint is not None:
            return hint
        return default

    def is_original(self, sig: str) -> bool:
        """Paper §4.2: has this signature never been executed before?"""
        return sig not in self.seen

    def reuse_count(self, sig: str) -> float:
        """Observed lifetime reuse events for ``sig`` (fleet-merged)."""
        return float(self.reuse.get(sig, 0.0))

    def reuse_counts(self) -> dict[str, float]:
        """One consistent snapshot of every signature's observed reuse
        count (fleet-merged at the last flush plus events witnessed here
        since). The evictor ranks a whole store against this, so it wants
        one locked copy rather than a per-signature race with a
        concurrent ``save()``'s dict swap."""
        with self._lock:
            return {sig: float(v) for sig, v in self.reuse.items()}


class TierBandwidth:
    """Per-tier EWMA load bandwidths over one store's ``.fleet/bw.json``.

    The paper's ``l_i`` was a single per-store number; with the TierStack
    (memory → disk → remote) each tier gets its own measured bandwidth
    and fixed per-access latency floor, so OMP's ``(1+1/h)·l_i < C(n_i)``
    rule can price the *cheapest reachable tier* of a signature rather
    than assuming every hit pays a disk read.

    Wraps the store's existing :class:`~repro_torch.core.locking.SharedEwma`
    (fleet merge-on-flush). The disk tier keeps the legacy ``read`` /
    ``write`` keys — old ``bw.json`` files stay valid and the no-``sig``
    estimate is numerically identical to the pre-tier formula
    (``nbytes / (read|write|500e6) + 1e-4``). Memory and remote add
    ``mem_*`` / ``remote_*`` keys beside them in the same file.

    Floors are deliberately conservative static priors, not tuning
    knobs: ~8 GB/s for a host-RAM pointer handoff (the measured EWMA
    takes over after the first hit), 500 MB/s local disk (the historical
    default), 100 MB/s + 1 ms for an object store round-trip.
    """

    _KEYS = {"memory": ("mem_read", "mem_write"),
             "local": ("read", "write"),
             "remote": ("remote_read", "remote_write")}
    _FLOOR_BW = {"memory": 8e9, "local": 500e6, "remote": 100e6}
    _LATENCY = {"memory": 1e-6, "local": 1e-4, "remote": 1e-3}

    def __init__(self, ewma):
        self._ewma = ewma

    def observe(self, tier: str, kind: str, nbytes: float,
                seconds: float) -> None:
        """Record one measured transfer (``kind`` is "read"/"write")."""
        if nbytes <= 0 or seconds <= 0:
            return
        rk, wk = self._KEYS[tier]
        self._ewma.update(rk if kind == "read" else wk,
                          float(nbytes) / float(seconds))

    def bandwidth(self, tier: str) -> float:
        """Best available bytes/s estimate for ``tier``: measured reads,
        else measured writes, else the tier's static floor."""
        rk, wk = self._KEYS[tier]
        bw = self._ewma.get(rk) or self._ewma.get(wk)
        return float(bw) if bw else self._FLOOR_BW[tier]

    def est_load_seconds(self, tier: str, nbytes: float) -> float:
        """Estimated seconds to serve ``nbytes`` from ``tier``."""
        return float(nbytes) / self.bandwidth(tier) + self._LATENCY[tier]
