"""Globally shared-prefix-aware scheduling (Li et al. 2019 applied fleet-
wide).

The lease-only sweep relied on *lease contention* for cross-session coordination:
all K variants start at once, and siblings that need an in-flight shared
signature block on its compute lease — correct (each shared signature is
computed exactly once) but wasteful, because a blocked sibling occupies a
session slot doing nothing. The session server knows every live
submission's signature set, so it can do better than contention:

* **Multiplicity map** — for every signature, how many live (queued or
  running) submissions need it. This is the observed analogue of the
  sweep pre-pass's shared-signature set, maintained incrementally as
  clients come and go, and it doubles as OMP's amortization input
  (``Materializer.multiplicity``).
* **Shared-prefix-first order** — among dispatchable submissions, run the
  one whose *not-yet-materialized* signatures carry the largest shared
  weight (multiplicity − 1, scaled by the cost model's estimated compute
  seconds). Expensive widely-shared prefixes start as early as possible,
  so they are already hot when sibling workflows reach the front.
* **Sibling deferral** — a submission whose needed signatures are being
  computed by a running submission is outranked by *independent* queued
  work: the independent job gets the slot (it makes full-speed progress
  where the sibling would intermittently block on compute leases).
  Deferral reorders but never idles: when only blocked submissions are
  queued, the one with the *smallest cost-weighted overlap* with
  in-flight work is dispatched anyway — it lease-follows the leader the
  shortest time before diverging into independent compute (prefer a
  different model family over the running arm's twin), which is strictly
  better than an empty slot. The lease protocol underneath remains the
  correctness backstop; the scheduler only spends slots where they buy
  wall-clock.

The scheduler is pure policy: it owns no locks and mutates nothing but
its multiplicity map. The server drives it under the server lock.

Multi-tenant fairness (``schedule="fair"``) layers
:class:`TenantScheduler` *on top of* this order: a weighted-fair pass
picks which tenant's turn it is (deficit/virtual-time round-robin over
served compute seconds), then :class:`PrefixScheduler` picks
shared-prefix-first *within* that tenant's queue. Cross-tenant fairness
and intra-tenant reuse compose instead of competing.
"""
from __future__ import annotations

from typing import Iterable, Mapping, Protocol, Sequence


class _SchedJob(Protocol):
    """What the scheduler needs to know about a submission."""

    seq: int                    # arrival order (FIFO tiebreak)
    sigs: frozenset             # the submission's full signature set
    priority: int               # dispatch class (higher first; default 0)


class PrefixScheduler:
    """Shared-prefix-first dispatch order over live submissions."""

    def __init__(self, store, cost_model, mode: str = "prefix"):
        if mode not in ("prefix", "fifo"):
            raise ValueError(f"unknown schedule mode: {mode!r}")
        self.store = store
        self.cost_model = cost_model
        self.mode = mode
        self._mult: dict[str, int] = {}

    # -- multiplicity map --------------------------------------------------
    def add(self, job: _SchedJob) -> None:
        """Track a newly submitted job's signatures."""
        for sig in job.sigs:
            self._mult[sig] = self._mult.get(sig, 0) + 1

    def remove(self, job: _SchedJob) -> None:
        """Drop a finished job's signatures from the live map."""
        for sig in job.sigs:
            cur = self._mult.get(sig, 0) - 1
            if cur <= 0:
                self._mult.pop(sig, None)
            else:
                self._mult[sig] = cur

    def multiplicity(self, sig: str) -> int:
        """Live submissions (queued or running) that need ``sig``."""
        return self._mult.get(sig, 0)

    def is_live(self, sig: str) -> bool:
        """Eviction veto: does any live (queued or running) submission
        still plan to use ``sig``? The server hands this to the fleet
        evictor so entries live clients want are never candidates —
        evicting them would force the exact recompute the store exists
        to avoid."""
        return self._mult.get(str(sig), 0) > 0

    # -- dispatch policy ---------------------------------------------------
    def shared_weight(self, job: _SchedJob, has=None) -> float:
        """Cost-weighted shared work this job would *newly* compute.

        Sums ``(multiplicity - 1) · est_compute_seconds`` over the job's
        signatures that are shared with other live submissions and not in
        the store yet. Jobs whose shared prefix is already materialized
        score 0 (they are cheap loads and can run any time). ``has``
        optionally overrides ``store.has`` (pick() passes a memo so one
        dispatch decision stats each signature at most once).
        """
        has = has or self.store.has
        total = 0.0
        for sig in job.sigs:
            m = self._mult.get(sig, 0)
            if m >= 2 and not has(sig):
                total += (m - 1) * self.cost_model.compute_cost(sig)
        return total

    def blocked(self, job: _SchedJob, inflight: Iterable[str],
                has=None) -> bool:
        """Would dispatching ``job`` now just block on a compute lease?

        True iff a signature the job needs is assigned to a running
        submission and has not been materialized yet.
        """
        has = has or self.store.has
        for sig in inflight:
            if sig in job.sigs and not has(sig):
                return True
        return False

    def overlap_weight(self, job: _SchedJob, inflight: set,
                       has=None) -> float:
        """Cost-weighted overlap between ``job`` and in-flight work.

        Estimated compute seconds of the job's signatures a running
        submission is (presumably) about to produce. Among blocked jobs
        the scheduler dispatches the one with the *smallest* overlap: it
        spends the least time lease-following before diverging into
        independent compute — e.g. prefer the arm from a different model
        family over the running arm's twin.
        """
        has = has or self.store.has
        return sum(self.cost_model.compute_cost(sig)
                   for sig in job.sigs
                   if sig in inflight and not has(sig))

    def pick(self, queued: Sequence[_SchedJob],
             inflight: Iterable[str]) -> _SchedJob | None:
        """Choose the next submission to dispatch (None iff queue empty).

        ``queued`` is the live queue in arrival order; ``inflight`` is the
        union of running submissions' signatures. Within a priority class
        (``priority`` descending — the search driver marks promoted rungs
        so survivors outrank fresh exploratory arms), unblocked
        submissions are ranked by shared weight (descending) then
        arrival; blocked ones (they would lease-wait on a running
        sibling) are considered only when no unblocked submission exists
        — a lease-following sibling still beats an idle slot.
        """
        if not queued:
            return None
        if self.mode == "fifo":
            # Priority classes apply in fifo mode too (arrival order
            # within a class); all-default-priority queues reduce to
            # queued[0], so the lease-only baseline is byte-identical.
            return min(queued,
                       key=lambda j: (-getattr(j, "priority", 0), j.seq))
        inflight = set(inflight)
        # One store stat per signature per decision: queued siblings
        # largely share signatures, and this may run under the server
        # lock on a slow filesystem.
        memo: dict[str, bool] = {}

        def has(sig: str) -> bool:
            v = memo.get(sig)
            if v is None:
                v = memo[sig] = self.store.has(sig)
            return v

        best: _SchedJob | None = None
        best_key: tuple | None = None
        for job in queued:
            is_blocked = self.blocked(job, inflight, has)
            key = (is_blocked, -getattr(job, "priority", 0),
                   self.overlap_weight(job, inflight, has)
                   if is_blocked else 0.0,
                   -self.shared_weight(job, has), job.seq)
            if best_key is None or key < best_key:
                best, best_key = job, key
        return best


class TenantScheduler:
    """Weighted fair share across tenants, prefix-first within each.

    A virtual-time variant of deficit round robin: every tenant carries
    a meter of compute seconds served (plus a provisional charge for its
    jobs currently in flight), and each dispatch goes to the backlogged
    tenant with the smallest ``meter / weight`` — so over any interval
    in which a set of tenants stays backlogged, their served
    compute-seconds converge to the ratio of their weights, and a
    zero-backlog tenant's unused share redistributes instead of idling
    a slot (work-conserving). *Within* the chosen tenant's queue the
    wrapped :class:`PrefixScheduler` keeps the shared-prefix-first
    order, so fairness costs none of the reuse scheduling.

    Charging protocol (driven by the server under its lock):
    ``note_dispatch(job)`` adds a provisional estimate when a job leaves
    the queue — without it, K concurrent slots could all go to the
    lowest-meter tenant before any job finishes — and
    ``note_finish(job, seconds)`` replaces the estimate with the
    measured compute seconds. The provisional estimate is an EWMA of
    completed job durations (tenant-agnostic; it only needs to be the
    same order of magnitude as real jobs to keep concurrent dispatch
    honest).

    The multiplicity surface (``add`` / ``remove`` / ``multiplicity`` /
    ``is_live``) delegates to the wrapped scheduler unchanged: OMP
    amortization and eviction vetoes stay fleet-wide — reuse across
    tenants is the point of sharing the substrate; only *dispatch* is
    divided fairly.
    """

    mode = "fair"

    def __init__(self, inner: PrefixScheduler,
                 weights: Mapping[str, float] | None = None):
        """Wrap ``inner``; ``weights`` maps tenant id → fair-share
        weight (missing tenants use the ``"*"`` entry, then 1.0)."""
        self.inner = inner
        self.store = inner.store
        self.cost_model = inner.cost_model
        self.weights = dict(weights or {})
        self._served: dict[str, float] = {}
        self._inflight: dict[int, tuple[str, float]] = {}
        self._avg_s = 1.0        # EWMA of measured job compute seconds
        self._n_done = 0

    # -- multiplicity surface (delegated; fleet-wide on purpose) -----------
    def add(self, job) -> None:
        """Track a newly submitted job's signatures (fleet-wide map)."""
        self.inner.add(job)

    def remove(self, job) -> None:
        """Drop a finished job's signatures from the live map."""
        self.inner.remove(job)

    def multiplicity(self, sig: str) -> int:
        """Live submissions that need ``sig`` — across all tenants."""
        return self.inner.multiplicity(sig)

    def is_live(self, sig: str) -> bool:
        """Eviction veto, tenant-agnostic: any live submission counts."""
        return self.inner.is_live(sig)

    # -- fair-share accounting ---------------------------------------------
    def weight_of(self, tenant: str) -> float:
        """Fair-share weight for ``tenant`` (``"*"`` default, else 1)."""
        w = self.weights.get(tenant)
        if w is None:
            w = self.weights.get("*", 1.0)
        return max(float(w), 1e-9)

    def virtual_time(self, tenant: str) -> float:
        """``(served + provisional in-flight) / weight`` — the fair
        queueing clock this scheduler equalizes across tenants."""
        meter = self._served.get(tenant, 0.0)
        meter += sum(est for t, est in self._inflight.values()
                     if t == tenant)
        return meter / self.weight_of(tenant)

    def served_seconds(self, tenant: str) -> float:
        """Measured compute seconds served to ``tenant`` so far."""
        return self._served.get(tenant, 0.0)

    def note_dispatch(self, job, est_s: float | None = None) -> None:
        """Charge a provisional estimate while ``job`` runs."""
        tenant = getattr(job, "tenant", "default")
        est = float(est_s) if est_s and est_s > 0 else self._avg_s
        self._inflight[job.id] = (tenant, est)

    def note_finish(self, job, seconds: float) -> None:
        """Replace ``job``'s provisional charge with measured seconds."""
        ent = self._inflight.pop(job.id, None)
        tenant = ent[0] if ent else getattr(job, "tenant", "default")
        seconds = max(float(seconds), 0.0)
        self._served[tenant] = self._served.get(tenant, 0.0) + seconds
        if seconds > 0:
            self._n_done += 1
            alpha = 0.3 if self._n_done > 3 else 1.0 / self._n_done
            self._avg_s += alpha * (seconds - self._avg_s)

    def snapshot(self) -> dict:
        """Per-tenant fairness state for ``status()`` (JSON-safe)."""
        tenants = set(self._served) | {t for t, _ in
                                       self._inflight.values()}
        return {t: {"served_s": self._served.get(t, 0.0),
                    "weight": self.weight_of(t),
                    "virtual_time": self.virtual_time(t)}
                for t in sorted(tenants)}

    # -- dispatch policy ---------------------------------------------------
    def pick(self, queued: Sequence, inflight: Iterable[str]):
        """Pick the lowest-virtual-time backlogged tenant's best job.

        Ties break by tenant id so replays are deterministic. Returns
        None iff ``queued`` is empty.
        """
        if not queued:
            return None
        by_tenant: dict[str, list] = {}
        for job in queued:
            by_tenant.setdefault(getattr(job, "tenant", "default"),
                                 []).append(job)
        tenant = min(by_tenant, key=lambda t: (self.virtual_time(t), t))
        return self.inner.pick(by_tenant[tenant], inflight)
