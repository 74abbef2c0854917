"""Fixed-batch hyperparameter sweeps as session-server submissions.

Helix (the paper) optimizes *one* developer's iteration loop. This driver
turns the same machinery into fleet-scale reuse, following "Exploiting
Reuse in Pipeline-Aware Hyperparameter Tuning" (Li et al., 2019) and
"Accelerating Human-in-the-loop Machine Learning" (Xin et al., 2018): run
K workflow *variants* (a knob grid or random search) concurrently against
one shared materialization store.

This module is the *thin, fixed-schedule baseline driver*:
the user picks the K arms up front, they are submitted as one held batch,
and every arm runs to completion. Its deliberately static shape is what
makes it the reproducible baseline for multi-host and fifo-vs-prefix
comparisons. The *adaptive* driver — dynamic arm choice under a budget,
reuse-aware frontier ordering via the server's ``estimate`` RPC,
successive-halving early stopping, mutation search — is
:class:`repro_torch.core.search.SearchDriver`, which talks to the same server
through the client protocol instead of holding a batch.

A sweep is literally K submissions to an in-process
:class:`~repro_torch.serve.server.SessionServer` (submitted as one held batch so
the global scheduler sees all multiplicities up front). The server brings:

* **shared-prefix-first scheduling** — variants that would newly compute a
  widely shared prefix dispatch first; siblings of an in-flight shared
  computation yield their slot to independent arms (they would mostly
  block on its compute lease), lease-following the leader only when
  nothing independent remains. ``schedule="fifo"`` restores the
  lease-contention-only ordering.
* **observed amortization** — the live signature-multiplicity map feeds
  OMP (see omp.py ``multiplicity``), superseding the static horizon≈K
  guess. ``horizon`` remains available as an explicit floor.
* **one elastic worker pool** — all K sessions draw executor workers from
  one process-wide pool instead of pooling independently.

The lease protocol's correctness properties are unchanged (they live in the store's
lease protocol, not the scheduler): each shared signature is computed at
most once fleet-wide, the storage budget is enforced through the shared
ledger, the §6.6 stale-purge is disabled (sibling variants' same-name
entries are not stale), and with ``share_nondet=True`` (default) one
pinned nonce map makes identical unseeded operators sweep-equivalent —
morally "fix the seed for this sweep".

Concurrency is thread-based (CUDA is fork-hostile); the store machinery
underneath is ``flock``-based, so independent OS processes pointed at the
same workdir compose the same way — this driver is just the convenient
in-process harness.

**Multi-host mode** (``n_hosts > 1``): the K submissions are spread
round-robin over M session servers, each owning its *own* workdir-local
store — the deployment shape of one server per host. With ``remote`` set
(a shared object-store tier, see remote.py) the hosts share
materializations through it: cross-host in-flight dedupe via TTL lease
objects, write-through uploads, read-through fetches. Without ``remote``
the hosts fall back to sharing one workdir (the N-process path —
only meaningful when ``workdir`` is a shared filesystem). In-process
"hosts" are a faithful harness for the real thing because nothing they
share goes through process memory except the ObjectStore handle, which
is itself just files.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
import time
from typing import Any, Callable, Mapping, Sequence

from .config import (UNSET, EngineConfig, ResilienceConfig, StoreConfig,
                     resolve)
from .session import IterationReport
from .workflow import Workflow


@dataclasses.dataclass(frozen=True)
class SweepVariant:
    """One arm of the sweep: a label plus a zero-arg Workflow factory."""

    name: str
    build: Callable[[], Workflow]
    knobs: Any = None  # the knob value(s) this arm represents, for reports
    seed: int | None = None  # the RNG seed that drew this arm, for replay


def grid(base: Any, axes: Mapping[str, Sequence[Any]],
         build: Callable[[Any], Workflow],
         name: str = "variant") -> list[SweepVariant]:
    """Cartesian-product knob grid over a frozen knob dataclass.

    ``axes`` maps field names to candidate values; each combination yields
    a :class:`SweepVariant` whose factory builds the workflow from
    ``dataclasses.replace(base, **combo)``.
    """
    keys = list(axes)
    out = []
    for combo in itertools.product(*(axes[k] for k in keys)):
        knobs = dataclasses.replace(base, **dict(zip(keys, combo)))
        label = name + "".join(f"_{k}={v}" for k, v in zip(keys, combo))
        out.append(SweepVariant(name=label,
                                build=(lambda kn=knobs: build(kn)),
                                knobs=knobs))
    return out


def random_search(base: Any, mutate: Callable[[Any, Any], Any], n: int,
                  rng: Any = None, build: Callable[[Any], Workflow] = None,
                  name: str = "rand", *,
                  seed: int | None = None) -> list[SweepVariant]:
    """N variants drawn by repeatedly applying ``mutate(knobs, rng)``.

    Prefer ``seed`` over passing a pre-built ``rng``: the draw sequence
    is then a pure function of ``(base, mutate, n, seed)`` and the seed
    is recorded on every variant (``SweepVariant.seed``, visible in
    sweep reports via ``result.variant.seed``), so a tuning run can be
    replayed bit-identically. An explicit ``rng`` still wins when given
    (its state is the caller's business); ``seed`` is then recorded for
    provenance only.
    """
    if build is None:
        raise TypeError("random_search requires build=")
    if rng is None:
        import numpy as np
        rng = np.random.default_rng(seed)
    out, cur = [], base
    for i in range(n):
        out.append(SweepVariant(name=f"{name}{i}",
                                build=(lambda kn=cur: build(kn)),
                                knobs=cur, seed=seed))
        cur = mutate(cur, rng)
    return out


@dataclasses.dataclass
class VariantResult:
    """One arm's outcome: its report (or the error that stopped it) and
    its run seconds (queue wait excluded)."""

    variant: SweepVariant
    report: IterationReport | None
    seconds: float
    error: BaseException | None = None

    @property
    def outputs(self) -> dict[str, Any]:
        """The arm's workflow outputs ({} when it errored)."""
        return {} if self.report is None else self.report.outputs


@dataclasses.dataclass
class SweepReport:
    """Fleet-level outcome of :func:`run_sweep` over all variants."""

    results: list[VariantResult]
    wall_seconds: float
    store_bytes: int
    # Fleet evictor stats over the whole sweep (empty when eviction off;
    # summed across hosts in multi-host mode).
    evictions: dict = dataclasses.field(default_factory=dict)
    # Remote-tier stats (uploads/fetches/evictions/vetoes — see
    # remote.RemoteStats), summed across hosts; empty without a tier.
    remote: dict = dataclasses.field(default_factory=dict)

    @property
    def outputs(self) -> dict[str, dict[str, Any]]:
        """Outputs keyed by variant name."""
        return {r.variant.name: r.outputs for r in self.results}

    def fleet_computes(self) -> dict[str, int]:
        """How many variants actually *computed* each signature (planned
        COMPUTE and not turned into a load by the in-flight dedupe).

        A count > 1 is either a deliberate planner choice (the value was
        loadable but recomputing was cheaper — see
        :meth:`wasted_recomputes`) or a coordination failure."""
        from .dag import State
        counts: dict[str, int] = {}
        for r in self.results:
            if r.report is None:
                continue
            ex = r.report.execution
            for n, s in ex.states.items():
                if s is State.COMPUTE and n not in ex.deduped:
                    sig = r.report.sigs[n]
                    counts[sig] = counts.get(sig, 0) + 1
        return counts

    def wasted_recomputes(self) -> int:
        """Shared signatures computed more than once where reuse was
        actually on the table — true coordination failures.

        A duplicate compute is *not* wasted when the later variant's
        max-flow planner saw the loadable entry and still chose COMPUTE
        because loading was costlier (``ExecutionReport.chose_compute``) —
        that is reuse economics working, e.g. a sub-millisecond extractor
        is cheaper to rerun than to read back. The acceptance bar for the
        fleet engines is that this method returns 0: no variant ever
        recomputes a shared value because coordination lost it."""
        from .dag import State
        # Per signature: computes that were NOT a deliberate
        # cheaper-to-recompute choice. One such compute per signature is
        # the unavoidable cold start; a second one means two sessions
        # each believed nobody had the value — a coordination failure.
        blind: dict[str, int] = {}
        for r in self.results:
            if r.report is None:
                continue
            ex = r.report.execution
            for n, s in ex.states.items():
                if (s is State.COMPUTE and n not in ex.deduped
                        and n not in ex.chose_compute):
                    sig = r.report.sigs[n]
                    blind[sig] = blind.get(sig, 0) + 1
        return sum(1 for c in blind.values() if c > 1)

    def raise_errors(self) -> None:
        """Re-raise the first variant error, if any arm failed."""
        for r in self.results:
            if r.error is not None:
                raise r.error


def run_sweep(workdir: str,
              variants: Sequence[SweepVariant],
              *,
              n_concurrent: Any = UNSET,
              policy: Any = UNSET,
              storage_budget_bytes: Any = UNSET,
              max_workers: Any = UNSET,
              prefetch_depth: Any = UNSET,
              async_materialization: Any = UNSET,
              share_nondet: Any = UNSET,
              dedupe_inflight: Any = UNSET,
              dedupe_wait_seconds: Any = UNSET,
              horizon: Any = UNSET,
              schedule: Any = UNSET,
              pool_workers: Any = UNSET,
              evict_to_admit: Any = UNSET,
              n_hosts: int = 1,
              remote: Any = UNSET,
              engine: EngineConfig | None = None,
              storage: StoreConfig | None = None,
              resilience: ResilienceConfig | None = None) -> SweepReport:
    """Run every variant against one shared store in ``workdir``.

    Configuration comes as the layered dataclasses ``engine=`` /
    ``storage=`` / ``resilience=`` (see :mod:`repro_torch.core.config`);
    ``n_concurrent`` maps to ``EngineConfig.n_sessions`` (default: all
    variants at once). The loose keyword arguments are a deprecated
    shim kept for existing call sites — each warns once per process and
    overrides the corresponding config field. ``n_hosts`` stays a real
    parameter: it is sweep *topology*, not engine configuration.

    Spins up an in-process :class:`~repro_torch.serve.server.SessionServer`
    over ``workdir``, submits the K variants as one held batch (so the
    global scheduler sees every shared signature's multiplicity before
    ordering), waits for all of them, and shuts the server down. Each
    variant runs in its own session over the same store / cost statistics
    / budget ledger, with in-flight dedupe on and stale-purging off.

    ``n_concurrent`` bounds how many variants run at once (default: all);
    ``max_workers`` / ``prefetch_depth`` / ``async_materialization`` are
    forwarded to each session's pipelined executor, whose workers come
    from one shared pool of ``pool_workers`` (default: enough for every
    concurrent session).

    ``schedule`` picks the dispatch policy: ``"prefix"`` (default) is the
    server's shared-prefix-first order with sibling deferral;  ``"fifo"``
    reproduces the arrival-order dispatch where siblings coordinate
    through lease contention alone.

    ``horizon`` is now only an explicit static floor for OMP's
    amortization: by default the server's live signature-multiplicity map
    tells OMP *exactly* how many siblings want each value (superseding
    the old horizon≈K guess). ``dedupe_wait_seconds`` (default 1 h) must
    exceed the longest shared node's compute time, or waiters time out
    and duplicate it — it is only the escape hatch that keeps a
    crashed-but-lease-holding-via-NFS style pathology from stalling the
    sweep forever.

    ``evict_to_admit`` (default True) gives the fleet benefit-weighted
    eviction under the shared budget: a materialization that does not
    fit evicts the lowest-benefit unleased entries (never ones a live
    variant still wants — the server's multiplicity map vetoes those)
    instead of being refused. ``SweepReport.evictions`` carries the
    fleet evictor's stats.

    ``n_hosts`` > 1 turns on multi-host mode (module docstring): the
    submissions spread round-robin over that many session servers, each
    with its own local store under ``workdir/host<i>`` — sharing work
    through the ``remote`` tier when one is given (a
    :class:`~repro_torch.core.remote.RemoteStore`, an ObjectStore backend, or
    a filesystem path), else through one common ``workdir``. Session
    slots split evenly across hosts. ``remote`` also works with a
    single host (write-through warm-up of a fleet tier).
    """
    from ..serve.server import (SessionServer,     # local: avoids
                                SharedNonces)      # an import cycle

    variants = list(variants)
    if not variants:
        return SweepReport(results=[], wall_seconds=0.0, store_bytes=0)
    eng = resolve(
        "run_sweep", EngineConfig, engine,
        site_defaults=dict(share_nondet=True, dedupe_inflight=True),
        legacy=dict(
            n_concurrent=("n_sessions", n_concurrent),
            policy=("policy", policy),
            max_workers=("max_workers", max_workers),
            prefetch_depth=("prefetch_depth", prefetch_depth),
            async_materialization=("async_materialization",
                                   async_materialization),
            share_nondet=("share_nondet", share_nondet),
            dedupe_inflight=("dedupe_inflight", dedupe_inflight),
            horizon=("horizon", horizon),
            schedule=("schedule", schedule),
            pool_workers=("pool_workers", pool_workers)))
    sto = resolve(
        "run_sweep", StoreConfig, storage,
        site_defaults=dict(shared_budget=True, purge_stale=False),
        legacy=dict(
            storage_budget_bytes=("budget_bytes", storage_budget_bytes),
            evict_to_admit=("evict_to_admit", evict_to_admit),
            remote=("remote", remote)))
    res = resolve(
        "run_sweep", ResilienceConfig, resilience,
        site_defaults=dict(dedupe_wait_seconds=3600.0),
        legacy=dict(
            dedupe_wait_seconds=("dedupe_wait_seconds",
                                 dedupe_wait_seconds)))
    n_concurrent = len(variants) if eng.n_sessions is None \
        else max(1, int(eng.n_sessions))
    if eng.schedule == "fifo" and eng.horizon is None:
        # The fifo baseline must be the lease-only sweep end-to-end: no observed
        # multiplicity (the server already withholds it in fifo mode),
        # and its static horizon≈K amortization default.
        eng = dataclasses.replace(eng, horizon=float(len(variants)))
    n_hosts = max(1, min(int(n_hosts), len(variants)))
    slots_per_host = max(1, math.ceil(n_concurrent / n_hosts))
    # One nonce map for the whole fleet: nondeterministic operators stay
    # sweep-equivalent across hosts, exactly as within one server.
    fleet_nonces = SharedNonces() if eng.share_nondet and n_hosts > 1 \
        else None

    servers = [
        SessionServer(
            # Per-host workdirs only when a remote tier connects them;
            # without one, "hosts" share the workdir itself (the
            # N-process path) — private workdirs with no tier would
            # silently lose all cross-host reuse.
            workdir if n_hosts == 1 or sto.remote is None
            else os.path.join(workdir, f"host{h}"),
            engine=dataclasses.replace(eng, n_sessions=slots_per_host),
            storage=sto, resilience=res,
            nonces=fleet_nonces)
        for h in range(n_hosts)]
    t_start = time.perf_counter()
    jobs: list = []
    try:
        # One held batch per server: every variant's signatures enter
        # each host's multiplicity map before its first dispatch
        # decision. (Multiplicity maps are per-host; cross-host sharing
        # flows through the remote tier's leases, not the scheduler.)
        with contextlib.ExitStack() as stack:
            for server in servers:
                stack.enter_context(server.hold_dispatch())
            for i, v in enumerate(variants):
                try:
                    jobs.append(servers[i % n_hosts].submit(v.build,
                                                            name=v.name))
                except BaseException as e:  # a broken factory is one arm's
                    jobs.append(e)          # failure, not the sweep's
            if n_hosts > 1:
                # Cross-host share set: a signature two *hosts* need
                # must be force-persisted (and uploaded before the
                # lease releases) by whichever host computes it — each
                # server's own multiplicity map only sees its local
                # arms, so without this a one-arm-per-host fleet would
                # persist nothing and every host would recompute the
                # common prefix.
                per_host: list[set] = [set() for _ in servers]
                for i, j in enumerate(jobs):
                    if not isinstance(j, BaseException):
                        per_host[i % n_hosts] |= set(j.sigs)
                counts: dict[str, int] = {}
                for sigs in per_host:
                    for sig in sigs:
                        counts[sig] = counts.get(sig, 0) + 1
                fleet_shared = {s for s, c in counts.items() if c >= 2}
                for server in servers:
                    server.share_across(fleet_shared)
        for h, server in enumerate(servers):
            server.wait_all([j for i, j in enumerate(jobs)
                             if i % n_hosts == h
                             and not isinstance(j, BaseException)])
    finally:
        for server in servers:
            server.shutdown()
    wall = time.perf_counter() - t_start
    evictions: dict = {}
    remote_stats: dict = {}
    seen_remotes: set[int] = set()
    for server in servers:
        if server.evictor is not None:
            for k, n in server.evictor.stats.snapshot().items():
                evictions[k] = evictions.get(k, 0) + n
        tier = server.store.remote
        if tier is not None and id(tier) not in seen_remotes:
            seen_remotes.add(id(tier))   # a shared injected instance
            for k, n in tier.stats.snapshot().items():  # counts once
                remote_stats[k] = remote_stats.get(k, 0) + n

    results = [
        VariantResult(variant=v, report=None, seconds=0.0, error=j)
        if isinstance(j, BaseException) else
        VariantResult(variant=v, report=j.report,
                      seconds=j.run_seconds, error=j.error)
        for v, j in zip(variants, jobs)]
    store_bytes = 0
    for r in results:
        if r.report is not None:
            store_bytes = max(store_bytes, r.report.store_bytes)
    return SweepReport(results=results, wall_seconds=wall,
                       store_bytes=store_bytes, evictions=evictions,
                       remote=remote_stats)
