"""Benefit-weighted fleet eviction (the paper's storage-budget story,
closed at fleet scale).

OPT-MAT-PLAN's budget S makes materialization a Knapsack (Appendix C):
Algorithm 2 decides *what to write*, but once S is exhausted the old
behavior was refuse-on-exhausted — a high-benefit intermediate (large
C(n)/l_i, many live readers) was rejected while a stale low-benefit entry
squatted in the store forever. :class:`Evictor` converts the store into a
real cache: when a reservation does not fit, it deletes the lowest-benefit
*unleased* entries until it does (evict-to-admit).

Benefit density per entry (the Knapsack value-per-byte, following Li et
al. 2019's observation that *observed* pipeline reuse dominates tuning
workloads)::

    density(e) = (C(n_e) / l_e) · (1 + reuse(e))

* ``C(n_e)`` — cost-to-recompute (cumulative runtime, Def. 6), persisted
  by the executor at save time (``meta.json``/index key ``compute_s``).
  Entries from before this metadata existed score 0 and go first — they
  are exactly the stale squatters.
* ``l_e`` — the load-cost estimate (``load_s_est`` at save time, else
  bytes / measured store bandwidth). Since l_e scales with bytes,
  ``C/l`` is already a per-byte density: recompute-seconds saved per
  byte of budget held.
* ``reuse(e)`` — observed future-load evidence: the entry's recorded
  load count (``Store._note_load``) or the cost model's fleet-merged
  historical reuse count for its signature, whichever is larger.

Two hard vetoes keep eviction safe under concurrency:

* **Live multiplicity** — signatures the session server's live
  cross-client map says queued/running clients still want are never
  candidates (the server passes ``PrefixScheduler.is_live``).
* **Leases** — deletion goes through :meth:`Store.delete`'s
  lease-respecting path, so entries pinned for a planned LOAD or being
  computed right now are skipped atomically (the lease is *held* for the
  removal, not probed).

Every freed byte is credited to the shared :class:`StorageLedger`
atomically (via the caller's ``credit`` callback —
``Materializer.credit_foreign``), so N concurrent sessions see one
consistent budget. The evictor itself is policy + a loop; it owns no
budget state and can be shared by every session of a server (its stats
then aggregate fleet-wide).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable


def benefit_density(compute_s: float, load_s: float,
                    expected_uses: float) -> float:
    """``(C/l) · (1 + expected future uses)`` — the one formula every
    site shares: the evictor's ranking (``expected_uses`` = observed
    reuse), OMP's admission limit (= effective horizon − 1), and the
    in-flight dedupe's force-persist (= waiting sessions). One body, so
    the evict-vs-admit comparison can never become apples-to-oranges."""
    return (float(compute_s) / max(float(load_s), 1e-9)) \
        * (1.0 + max(float(expected_uses), 0.0))


def ranked_mem(entries: dict[str, dict],
               est_disk_load: Callable[[float], float]) -> list[str]:
    """Rank memory-tier entries cheapest-to-demote first.

    The per-tier analog of :meth:`Evictor.ranked`, sharing
    :func:`benefit_density` so the memory tier's demote-vs-keep and the
    disk tier's evict-vs-admit can never use different value scales.
    Demotion — not deletion — is the action being priced:

    * A **clean** entry (a committed disk copy exists, or the writer
      queue owns one in flight) demotes by dropping the RAM reference;
      losing it costs one disk reload, so ``cost_s = l_disk`` and its
      density reduces to ``1 + loads`` — pure observed-reuse ranking.
    * A **dirty** entry (memory-only, write-back mode) must be spilled
      before it can be dropped, and until the spill lands losing it
      costs a full recompute: ``cost_s = max(C(n), l_disk)``.

    ``entries`` maps sig → ``{nbytes, loads, last_load, created, dirty,
    compute_s}``; ``est_disk_load`` prices the next tier down. Returns
    signatures ascending by density, ties broken least-recently-used
    (then oldest) — identical tie-breaking to the disk evictor.
    """
    scored = []
    for sig, e in entries.items():
        l_disk = max(float(est_disk_load(float(e.get("nbytes", 0) or 1))),
                     1e-9)
        if e.get("dirty"):
            cost_s = max(float(e.get("compute_s", 0.0) or 0.0), l_disk)
        else:
            cost_s = l_disk
        density = benefit_density(cost_s, l_disk,
                                  float(e.get("loads", 0) or 0))
        scored.append((density,
                       e.get("last_load") or e.get("created", 0.0),
                       sig))
    scored.sort()
    return [sig for _, _, sig in scored]


@dataclasses.dataclass
class EvictionStats:
    """Counters for one evictor's lifetime (fleet-wide when shared)."""

    n_calls: int = 0            # evict_to_fit invocations that found a deficit
    n_evicted: int = 0          # entries actually deleted
    bytes_evicted: int = 0      # their recorded on-disk bytes
    n_vetoed_live: int = 0      # candidates protected by live multiplicity
    n_skipped_leased: int = 0   # candidates whose lease (pin/compute) held
    n_unsatisfied: int = 0      # calls that could not free the full deficit

    def snapshot(self) -> dict:
        """JSON-safe copy (server status / benchmark reporting)."""
        return dataclasses.asdict(self)


class Evictor:
    """Evict-to-admit under the shared storage budget.

    ``live_multiplicity`` is the veto callable (``sig -> bool``); the
    session server passes a view over its live cross-client multiplicity
    map. ``cost_model`` supplies historical reuse counts
    (:meth:`CostModel.reuse_counts`); both are optional — a standalone
    session still gets cost-metadata-ranked LRU-tie-broken eviction.
    ``on_evict`` is an audit observer called as ``on_evict(sig, entry,
    freed_bytes)`` after each successful eviction — the multi-tenant
    server records these so the isolation harness can *prove* no live
    or leased entry was ever evicted (observer exceptions are swallowed;
    auditing must not break admission).
    """

    def __init__(self, store, cost_model=None,
                 live_multiplicity: Callable[[str], bool] | None = None,
                 on_evict: Callable[[str, dict, float], None] | None = None):
        self.store = store
        self.cost_model = cost_model
        self.live_multiplicity = live_multiplicity
        self.on_evict = on_evict
        self.stats = EvictionStats()
        # Serializes rankings within this process; cross-process safety
        # comes from Store.delete's lease+lock path and the ledger's
        # transactional credit, not from this lock.
        self._lock = threading.Lock()

    # -- ranking -----------------------------------------------------------
    def _density(self, sig: str, ent: dict,
                 reuse_hist: dict[str, float]) -> float:
        # A chunked manifest is priced (and evicted) as manifest+chunks:
        # deleting it cascades to its unshared chunk entries, so its
        # footprint for ranking is the whole partitioned value.
        nbytes = max(float(ent.get("nbytes", 0) or 0)
                     + float(ent.get("chunk_bytes", 0) or 0), 1.0)
        load_s = ent.get("load_s_est")
        if not load_s or load_s <= 0:
            load_s = self.store.est_load_seconds(nbytes)
        load_s = max(float(load_s), 1e-9)
        cost_s = float(ent.get("compute_s", 0.0) or 0.0)
        reuse = max(float(ent.get("loads", 0) or 0),
                    reuse_hist.get(sig, 0.0))
        if cost_s <= 0:
            # No save-time cost metadata (pre-metadata entry). Fall back
            # to the cost model's measured compute seconds; failing that,
            # an entry with *observed loads* is floored at its own load
            # cost — sessions keep choosing LOAD for it, so recomputing
            # is worth at least one load, and the (1+reuse) protection
            # must not be nullified by a missing key (a hot shared
            # prefix would otherwise rank below cold junk).
            if self.cost_model is not None:
                cost_s = float(self.cost_model.compute_cost(sig,
                                                            default=0.0))
            if cost_s <= 0 and reuse > 0:
                cost_s = load_s
        remote = getattr(self.store, "remote", None)
        if remote is not None and remote.exists(sig):
            # Multi-tier: a remotely-committed entry is recoverable by a
            # refetch, never a recompute — its local copy is worth at
            # most one load no matter how expensive the original compute
            # was. Remote-backed entries therefore yield the local cache
            # first, which is exactly the tiering you want: the local
            # disk holds what only it can cheaply restore.
            cost_s = min(cost_s, load_s)
        return benefit_density(cost_s, load_s, reuse)

    def ranked(self) -> list[tuple[str, dict, float]]:
        """Store entries as ``(sig, entry, density)``, ranked
        cheapest-to-evict first: ascending benefit density, ties broken
        least-recently-used (then oldest)."""
        reuse_hist = (self.cost_model.reuse_counts()
                      if self.cost_model is not None else {})
        # Chunk entries never rank on their own: chunks ride with (and
        # fall with) the manifests that reference them — the manifest is
        # the eviction unit, and its delete cascade frees the chunks.
        scored = [(sig, ent, self._density(sig, ent, reuse_hist))
                  for sig, ent in self.store.entries().items()
                  if not ent.get("is_chunk")]
        scored.sort(key=lambda it: (it[2], it[1].get("last_load")
                                    or it[1].get("created", 0.0)))
        return scored

    # -- the evict-to-admit loop -------------------------------------------
    def evict_to_fit(self, need_bytes: float, budget: float,
                     used: Callable[[], float],
                     credit: Callable[[float], None],
                     limit_density: float | None = None) -> int:
        """Free store bytes until ``used() + need_bytes <= budget``.

        ``used`` reads the current budget occupancy (the shared ledger in
        fleet mode); ``credit`` receives each eviction's freed bytes for
        atomic crediting (``Materializer.credit_foreign``).
        ``limit_density`` is the *incoming* write's own benefit density:
        candidates at or above it are never evicted — admitting a
        barely-qualifying value by deleting strictly more valuable
        entries is a net fleet loss (None = no limit, e.g. mandatory
        outputs, which must persist regardless).

        Returns the bytes actually freed — possibly short of the deficit
        when every remaining entry is leased, live, or too valuable (the
        caller's reservation then simply fails, exactly the old
        refuse-on-exhausted behavior). A reservation that cannot fit
        even into an *empty* store (``need_bytes > budget``) is refused
        up front rather than wiping the cache and failing anyway.
        """
        with self._lock:
            if float(need_bytes) > float(budget):
                self.stats.n_calls += 1
                self.stats.n_unsatisfied += 1
                return 0
            freed_total = 0
            # Two passes: concurrent sessions admit/evict under us, so a
            # still-short first pass re-reads the ledger and the index
            # once before giving up.
            for attempt in range(2):
                deficit = used() + float(need_bytes) - float(budget)
                if deficit <= 0:
                    return freed_total
                if attempt == 0:
                    self.stats.n_calls += 1
                progressed = False
                for sig, ent, density in self.ranked():
                    if deficit <= 0:
                        break
                    if (limit_density is not None
                            and density >= limit_density):
                        # Ascending order: every remaining candidate is
                        # at least this valuable — stop, don't evict
                        # better entries to admit a worse one.
                        break
                    if (self.live_multiplicity is not None
                            and self.live_multiplicity(sig)):
                        if attempt == 0:   # count each entry once per call
                            self.stats.n_vetoed_live += 1
                        continue
                    freed = self.store.delete(sig)  # lease-respecting
                    if freed <= 0:
                        # delete returns 0 both for a held lease and for
                        # an entry a concurrent session already removed;
                        # only the former is a lease *protection*.
                        if attempt == 0 and self.store.has(sig):
                            self.stats.n_skipped_leased += 1
                        continue
                    credit(freed)
                    if self.on_evict is not None:
                        try:
                            self.on_evict(sig, ent, freed)
                        except Exception:
                            pass
                    self.stats.n_evicted += 1
                    self.stats.bytes_evicted += freed
                    freed_total += freed
                    deficit -= freed
                    progressed = True
                if deficit <= 0:
                    return freed_total
                if not progressed:
                    break  # nothing evictable: don't spin on the index
            self.stats.n_unsatisfied += 1
            return freed_total
