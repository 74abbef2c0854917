"""OPT-MAT-PLAN (paper §5.3) — what to materialize while executing.

The exact problem is NP-hard (Knapsack reduction, Appendix C). Helix uses a
streaming heuristic (Algorithm 2): when a node goes *out of scope* (all
children computed/loaded; Constraint 3), materialize it iff

    2 · l_i  <  C(n_i)

where C(n_i) is the *cumulative runtime* (Def. 6): the node's own runtime
under its execution state plus the runtime of all its ancestors. Intuition:
materializing now (≈ l_i) plus loading later (≈ l_i) must beat recomputing
the chain.

We add the paper's storage budget S and two baseline policies used in the
paper's evaluation (§6.6): ALWAYS (≈ DeepDive) and NEVER (≈ KeystoneML).
A reservation that exceeds S is either refused (the old behavior) or —
with an :class:`~repro_torch.core.eviction.Evictor` attached — admitted by
evicting the lowest-benefit-density unleased store entries first
(evict-to-admit; see eviction.py).

Beyond-paper option: amortization over expected reuse (the paper explicitly
defers this model to future work). Two sources feed it:

``horizon`` (static)
    A session-wide prior: the expected number of *future loads* of any
    materialized value. The threshold becomes (1 + 1/horizon)·l_i < C(n_i),
    so horizon=1 is exactly the paper's 2·l_i < C(n_i) (materialize now,
    load once later) and horizon→∞ approaches l_i < C(n_i). The sweep
    driver used to set horizon≈K ("every sibling variant will probably load this"),
    a *guess* made once for the whole sweep.

``multiplicity`` (observed, per signature)
    A callable ``sig -> expected future loads`` supplied by a driver with
    global knowledge — the session server's live cross-client
    signature-multiplicity map plus the cost model's historical reuse
    counts. When provided, the effective horizon for a node is
    ``max(horizon, multiplicity(sig))``: a signature three live clients are
    waiting on is amortized over three loads *because they are really
    there*, not because a static K said so. This supersedes the horizon≈K
    heuristic; ``horizon`` remains the floor/prior for signatures nobody
    else currently wants.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Callable, Mapping

from .dag import DAG, State
from .eviction import Evictor, benefit_density
from .locking import StorageLedger


class Policy(enum.Enum):
    """Materialization policy (§6.6): Algorithm 2 vs. the baselines."""

    OPT = "opt"        # Algorithm 2
    ALWAYS = "always"  # Helix AM
    NEVER = "never"    # Helix NM


@dataclasses.dataclass
class MatDecision:
    """One node's materialization verdict plus a human-readable reason."""

    materialize: bool
    reason: str
    # C(n_i) as evaluated for this decision (Def. 6). The executor
    # persists it with the entry (``meta.json``/index ``compute_s``) so
    # fleet eviction can rank the entry's benefit density later.
    cum_runtime: float = 0.0
    # The verdict was "materialize" but the reservation did not fit and
    # the caller asked for eviction to be deferred (``evict_inline=False``
    # — the executor decides under its scheduler lock, where eviction's
    # store I/O must not run). The caller should evict+reserve off its
    # hot path and persist on success.
    needs_eviction: bool = False
    # The node's own benefit density (eviction.py ``benefit_density``) —
    # the eviction limit for admitting it: entries at least this valuable
    # are never displaced for it. None for mandatory outputs (they must
    # persist regardless).
    benefit_density: float | None = None


def delta_fraction(plan, store) -> float:
    """Fraction of a chunked node's work an execution will actually run.

    For a node with a :class:`~repro_torch.core.chunks.ChunkPlan`, the executor
    recomputes only the chunks whose signatures are not in the store, so
    the expected compute cost on this iteration is not the historical
    whole-value cost c_i but

        c_i^Δ  =  c_i · (missing chunks / total chunks)

    (uniform-chunk approximation; chunks are same-sized appends in the
    daily-retrain scenario). Planning with c_i^Δ is what lets OEP choose
    COMPUTE-and-splice over loading a stale whole-value entry, and makes
    OMP's (1 + 1/h)·l_i < C(n_i) price the *delta* on the cost side —
    the paper's inequality unchanged, evaluated against incremental
    reality. Returns 1.0 for an empty plan (degenerate, never emitted by
    ``compute_chunk_plans``) so a bad plan can only over-estimate cost.
    """
    if plan.n_chunks == 0:
        return 1.0
    missing = sum(1 for cs in plan.chunk_sigs if not store.has_local(cs))
    return missing / plan.n_chunks


def cumulative_runtime(dag: DAG, name: str,
                       states: Mapping[str, State],
                       runtime: Mapping[str, float]) -> float:
    """C(n_i) per Def. 6: t(n_i) + Σ_{ancestors} t(n_j), where t() is the
    realized runtime of the node under its state (0 for pruned)."""
    total = runtime.get(name, 0.0)
    for anc in dag.ancestors(name):
        total += runtime.get(anc, 0.0)
    return total


@dataclasses.dataclass
class Materializer:
    """Streaming materialization decisions under a storage budget.

    Budget accounting is atomic: the pipelined executor may reach decisions
    from several worker threads (it serializes the *order* of decisions, but
    concurrent sessions can share one Materializer), so reserve/release on
    ``used_bytes`` happens under a lock.

    Fleet mode: pass a :class:`StorageLedger` and the budget is enforced
    against the *shared on-disk* used-bytes counter instead of this
    instance's private tally — N concurrent sessions then split one
    storage budget S rather than each assuming it owns all of S. With a
    ledger, ``used_bytes`` is strictly this instance's *own outstanding
    reservations* (bytes freed by purging/evicting entries some other
    session paid for go through :meth:`credit_foreign`, which credits the
    ledger only); without one it is the whole-store tally the session
    seeds from ``store.total_bytes()``.

    Evict-to-admit: attach an :class:`~repro_torch.core.eviction.Evictor` and a
    reservation that does not fit triggers benefit-weighted eviction of
    unleased store entries before failing (see eviction.py). ``None``
    keeps the old refuse-on-exhausted behavior.
    """

    policy: Policy = Policy.OPT
    storage_budget_bytes: float = float("inf")
    used_bytes: float = 0.0
    horizon: float = 1.0  # static prior: expected future loads (paper: 1)
    ledger: StorageLedger | None = None
    # Sweeps with pinned signature nonces make nondeterministic operators
    # equivalent across sibling variants — then they *are* reusable and
    # Algorithm 2's nondeterminism veto must be lifted.
    nondet_reusable: bool = False
    # Observed per-signature reuse (module docstring): maps a signature to
    # the expected number of future loads; the effective horizon for that
    # node is max(horizon, multiplicity(sig)). Installed by drivers with
    # global knowledge (the session server); None keeps the static prior.
    multiplicity: Callable[[str], float] | None = None
    # Evict-to-admit hook: benefit-weighted eviction of unleased store
    # entries when a reservation does not fit (None = refuse-on-exhausted).
    evictor: Evictor | None = None

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def effective_horizon(self, sig: str | None) -> float:
        """Amortization count for one node: the static ``horizon`` prior,
        lifted by the observed ``multiplicity`` of its signature."""
        h = self.horizon
        if self.multiplicity is not None and sig is not None:
            h = max(h, float(self.multiplicity(sig)))
        return max(h, 1e-9)

    def decide(self, dag: DAG, name: str,
               states: Mapping[str, State],
               runtime: Mapping[str, float],
               est_load_seconds: float,
               est_bytes: float,
               sig: str | None = None,
               evict_inline: bool = True) -> MatDecision:
        """Decide whether to materialize ``name`` as it goes out of scope
        (Algorithm 2 under the configured policy, budget, and — when
        ``sig`` is given — the observed-multiplicity amortization).

        ``evict_inline=False`` makes an over-budget verdict come back
        with ``needs_eviction`` set instead of running the evictor's
        store I/O here — for callers deciding under a hot lock (the
        pipelined executor), which then evict+reserve off that lock."""
        node = dag.nodes[name]
        # C(n_i) is only evaluated on paths that persist it (the O(ancestors)
        # walk is wasted on NEVER/nondeterministic early-outs, whose
        # decisions never reach a save).
        if node.is_output:
            # Mandatory outputs are always persisted (HML ``is_output``)
            # — no eviction limit: they may displace whatever fits.
            return self._budgeted(
                est_bytes, "mandatory output",
                cumulative_runtime(dag, name, states, runtime),
                evict_inline, density=None)
        if self.policy is Policy.NEVER:
            return MatDecision(False, "policy NM")
        if self.policy is Policy.ALWAYS:
            # Paper's DeepDive-style AM: materializes *everything*, even
            # never-reusable nondeterministic outputs (§6.6 — the wasted
            # writes are exactly why AM loses on MNIST/NLP).
            c_cum = cumulative_runtime(dag, name, states, runtime)
            return self._budgeted(
                est_bytes, "policy AM", c_cum, evict_inline,
                density=benefit_density(
                    c_cum, est_load_seconds,
                    self.effective_horizon(sig) - 1.0))
        if not node.deterministic and not self.nondet_reusable:
            return MatDecision(False, "nondeterministic: never reusable")
        # Algorithm 2 with amortization (horizon=1, no multiplicity == paper).
        c_cum = cumulative_runtime(dag, name, states, runtime)
        h = self.effective_horizon(sig)
        mult = 1.0 + 1.0 / h
        threshold = mult * est_load_seconds
        # Report the *true* threshold: the paper's 2·l only holds at an
        # effective horizon of 1 — under amortization the multiplier is
        # (1+1/h), and a debuggable ExecutionReport must say which h won.
        tag = f"{mult:.3g}·l={threshold:.3g}"
        if abs(h - 1.0) > 1e-12:
            tag += f" (h={h:.3g})"
        if threshold < c_cum:
            return self._budgeted(
                est_bytes, f"{tag} < C={c_cum:.3g}", c_cum, evict_inline,
                density=benefit_density(c_cum, est_load_seconds, h - 1.0))
        return MatDecision(False, f"{tag} >= C={c_cum:.3g}",
                           cum_runtime=c_cum)

    def _budgeted(self, est_bytes: float, reason: str,
                  cum_runtime: float = 0.0,
                  evict_inline: bool = True,
                  density: float | None = None) -> MatDecision:
        if self.try_reserve(est_bytes, evict=evict_inline,
                            benefit_density=density):
            return MatDecision(True, reason, cum_runtime=cum_runtime,
                               benefit_density=density)
        if not evict_inline and self.evictor is not None:
            # Don't run eviction's store I/O here (the caller holds a hot
            # lock): hand the verdict back with the *base* reason so the
            # caller can evict+reserve+persist off the lock.
            return MatDecision(False, reason, cum_runtime=cum_runtime,
                               needs_eviction=True,
                               benefit_density=density)
        return MatDecision(False, f"{reason}; storage budget exhausted",
                           cum_runtime=cum_runtime, benefit_density=density)

    def try_reserve(self, est_bytes: float, evict: bool = True,
                    benefit_density: float | None = None) -> bool:
        """Reserve budget for a write; also used directly by the executor's
        in-flight dedupe when it force-persists a value other sessions are
        waiting on (that save bypasses Algorithm 2 but not the budget).

        With an :attr:`evictor` attached, a reservation that does not fit
        triggers benefit-weighted eviction of unleased store entries
        (evict-to-admit) and is retried once; without one — or with
        ``evict=False`` (callers on a hot lock) — exhausted means
        refused. ``benefit_density`` is the incoming write's own density
        (see eviction.py): entries at least that valuable are never
        evicted for it (None = evict whatever fits, e.g. mandatory
        outputs)."""
        if self._reserve_once(est_bytes):
            return True
        if not evict or self.evictor is None:
            return False
        scope_exhausted = getattr(self.ledger, "scope_exhausted", None)
        if scope_exhausted is not None and scope_exhausted(est_bytes):
            # Tenant-scoped ledger refused on the tenant's *own* quota:
            # eviction frees fleet bytes, never quota room, so evicting
            # (other tenants') entries could not make this reservation
            # succeed. Refuse without touching the store — a
            # quota-exhausted tenant degrades to not-materializing, it
            # never displaces a neighbor's cache.
            return False
        used = (self.ledger.used if self.ledger is not None
                else lambda: self.used_bytes)
        self.evictor.evict_to_fit(est_bytes, self.storage_budget_bytes,
                                  used, self.credit_foreign,
                                  limit_density=benefit_density)
        return self._reserve_once(est_bytes)

    def _reserve_once(self, est_bytes: float) -> bool:
        if self.ledger is not None:
            if not self.ledger.try_reserve(est_bytes,
                                           self.storage_budget_bytes):
                return False
            with self._lock:
                self.used_bytes += est_bytes
            return True
        with self._lock:
            if self.used_bytes + est_bytes > self.storage_budget_bytes:
                return False
            self.used_bytes += est_bytes
        return True

    def release(self, nbytes: float) -> None:
        """Credit back bytes *this instance reserved* (a failed or
        overwriting save undoing its own reservation). For bytes freed
        that were never reserved here — purging or evicting entries a
        previous session paid for — use :meth:`credit_foreign`, or the
        local reserved-by-me mirror silently clamps at 0 and goes stale
        against the ledger."""
        if self.ledger is not None:
            self.ledger.release(nbytes)
        with self._lock:
            self.used_bytes = max(0.0, self.used_bytes - nbytes)

    def credit_foreign(self, nbytes: float) -> None:
        """Credit bytes freed from the store that this instance never
        reserved (§6.6 purges of a previous session's entries, fleet
        evictions). Ledger mode: ledger-only — ``used_bytes`` tracks this
        instance's own reservations and must not absorb foreign credits.
        Without a ledger, ``used_bytes`` *is* the whole-store tally, so
        the credit lands there. A tenant-scoped ledger distinguishes the
        two credits itself (``credit_foreign`` lands fleet-side only —
        the tenant's quota meter must not absorb bytes another tenant
        reserved); a plain :class:`StorageLedger` has no such method and
        takes the credit as a release."""
        if self.ledger is not None:
            foreign = getattr(self.ledger, "credit_foreign", None)
            if foreign is not None:
                foreign(nbytes)
            else:
                self.ledger.release(nbytes)
            return
        # No ledger: used_bytes is the whole-store tally, same as release.
        self.release(nbytes)

    def reconcile(self, est_bytes: float, actual_bytes: float) -> None:
        """Adjust a reservation made from the pre-save host-array estimate
        to the actual on-disk size once the write lands (npy/pickle
        overhead, ``os.path.getsize`` reality). Without this the shared
        ledger drifts from ``.fleet`` reality over long sweeps. The top-up
        direction is unconditional — the bytes are already on disk."""
        delta = float(actual_bytes) - float(est_bytes)
        if delta == 0:
            return
        if self.ledger is not None:
            self.ledger.adjust(delta)
        with self._lock:
            self.used_bytes = max(0.0, self.used_bytes + delta)
