"""IterativeSession — the workflow lifecycle driver (paper §2.2, Fig. 2).

    W_t ──compile──▶ DAG ──slice──▶ sliced DAG
        ──signatures/diff──▶ original set + equivalent materializations
        ──OEP (max-flow)──▶ states {compute, load, prune}
        ──execute + OMP──▶ results, selective materialization
        ──record stats──▶ cost model (persisted)

Because signatures, cost statistics, and the store all persist on disk, a
*process restart* is indistinguishable from the next iteration of the same
workflow: completed work is equivalent → loaded; in-flight work is original →
recomputed. That is the fault-tolerance story at pod scale, and Theorem 1
gives its correctness argument.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Callable, Mapping

from .config import (UNSET, EngineConfig, ResilienceConfig, StoreConfig,
                     resolve)
from .costs import CostModel
from .dag import State
from .eviction import Evictor
from .executor import ExecutionReport, execute
from .locking import StorageLedger
from .chunks import protected_chunk_sigs
from .omp import Materializer, Policy, delta_fraction
from .oep import plan
from .pruning import slice_from_outputs, stale_variants
from .remote import ObjectStore, RemoteStore, as_remote_store
from .signature import compute_chunk_signatures, compute_signatures
from .store import Store
from .workflow import Workflow


@dataclasses.dataclass
class IterationReport:
    """Everything one :meth:`IterativeSession.run` produced: the execution
    report, the signature map, the original/sliced sets, and store
    accounting."""

    execution: ExecutionReport
    sigs: dict[str, str]
    original: set[str]
    sliced_away: set[str]
    store_bytes: int
    purged_bytes: int
    # Evictor-stat deltas over this run (empty when no evictor is wired,
    # fleet-wide deltas when the evictor is shared by a session server).
    evictions: dict = dataclasses.field(default_factory=dict)
    # The planner's inputs (§5.1): each node's compute cost and its load
    # cost from the cheapest tier holding it (None when not stored).
    compute_cost: dict[str, float] = dataclasses.field(default_factory=dict)
    load_cost: dict[str, float | None] = dataclasses.field(
        default_factory=dict)

    @property
    def outputs(self) -> dict[str, Any]:
        """Values of the workflow's mandatory output nodes."""
        return self.execution.outputs

    @property
    def total_seconds(self) -> float:
        """Wall clock of the execution phase."""
        return self.execution.total_seconds

    @property
    def deduped(self) -> dict[str, str]:
        """COMPUTE-planned nodes another session's compute turned into
        loads (in-flight dedupe)."""
        return self.execution.deduped


class IterativeSession:
    """Drives iterations of one workflow.

    Configuration comes in three layered frozen dataclasses (see
    ``repro_torch.core.config``): ``engine=`` (:class:`EngineConfig` — policy,
    executor width, prefetch, async materialization, horizon, dedupe),
    ``storage=`` (:class:`StoreConfig` — budget, eviction, remote tier,
    ledger sharing, stale purging) and ``resilience=``
    (:class:`ResilienceConfig` — dedupe lease waits, remote
    retry/backoff, fault injection). The loose keyword arguments below
    are the pre-config API; they still work, override the dataclasses,
    and emit one :class:`DeprecationWarning` per kwarg name. The fully
    resolved groups are exposed as ``self.engine_config`` /
    ``self.store_config`` / ``self.resilience_config``.

    Execution-engine knobs (see ``executor.py`` for the scheduler model):

    ``max_workers``
        Width of the executor's worker pool. 1 (default) is the paper's
        strictly sequential engine; >1 runs independent DAG branches
        concurrently and overlaps LOAD I/O with compute. Outputs and
        materialization decisions are identical for any value on
        deterministic workflows.
    ``prefetch_depth``
        Maximum number of LOAD values resident in host memory before a
        consumer has used them (bounds prefetch memory; ≥1 enables
        prefetching when ``max_workers > 1``).
    ``async_materialization``
        Route materialization writes through the store's dedicated writer
        queue instead of blocking the executing worker; write wall time is
        still accounted in ``ExecutionReport.mat_seconds``.

    Fleet knobs (many sessions, one workdir — see sweep.py and serve/):

    ``dedupe_inflight``
        Compute-once protocol: COMPUTE nodes take the store's fleet-wide
        per-signature lease; sessions needing a signature someone else is
        computing wait and load the published result instead.
    ``dedupe_wait_seconds``
        Upper bound on waiting for another session's lease before
        falling back to computing locally (the deadlock escape hatch).
        Must exceed the longest shared node's compute time or waiters
        duplicate it; sweeps default this to an hour.
    ``shared_budget``
        Enforce ``storage_budget_bytes`` against the store's shared
        on-disk ledger, so N concurrent sessions split one budget.
    ``evict_to_admit``
        When the budget is finite, attach a benefit-weighted
        :class:`~repro_torch.core.eviction.Evictor`: a materialization that
        does not fit evicts the lowest-benefit-density unleased store
        entries (C(n)/l_i × observed reuse; see eviction.py) instead of
        being refused. Planned LOADs are pinned by read leases and never
        evicted. Default True; False restores refuse-on-exhausted.
    ``evictor`` / ``live_sigs``
        Injected by the session server: one shared evictor (fleet-wide
        stats) and the live-multiplicity veto (``sig -> bool`` — entries
        live clients still want are never eviction candidates).
    ``purge_stale``
        The paper's §6.6 purge of prior materializations of *original*
        operators. Must be disabled for concurrent sweeps: sibling
        variants legitimately hold same-name/different-signature entries
        that are not stale. (Deletes always respect other sessions' live
        leases regardless.)

    Server knobs (one long-running process hosting many sessions — see
    ``repro_torch.serve``):

    ``remote``
        Attach a fleet-shared remote materialization tier (see
        remote.py): a :class:`~repro_torch.core.remote.RemoteStore`, a raw
        :class:`~repro_torch.core.remote.ObjectStore` backend, or a
        filesystem path (the shared-mount reference deployment). The
        local store then write-through/read-through caches it —
        materializations upload asynchronously, local misses fetch, and
        compute leases extend across hosts via TTL lease objects.
        Ignored when ``store`` is injected (the store's own tier wins).
    ``store`` / ``cost_model``
        Injected shared instances. The session server opens one
        :class:`Store` (one writer queue, one heal pass, one bandwidth
        EWMA) and one :class:`CostModel` per workdir and hands them to
        every session it hosts; standalone sessions construct their own.
    ``worker_pool``
        A serving-layer ``SharedWorkerPool``: executor workers beyond the
        session's own thread are borrowed from one process-wide pool
        instead of each session pooling independently.
    ``multiplicity``
        ``sig -> expected future loads`` fed to OMP's amortized
        materialization threshold (the server's live cross-client
        signature-multiplicity map; see omp.py).
    """

    def __init__(self, workdir: str,
                 policy: Policy = UNSET,
                 storage_budget_bytes: float = UNSET,
                 async_materialization: bool = UNSET,
                 horizon: float = UNSET,
                 max_workers: int = UNSET,
                 prefetch_depth: int = UNSET,
                 dedupe_inflight: bool = UNSET,
                 dedupe_wait_seconds: float = UNSET,
                 shared_budget: bool = UNSET,
                 purge_stale: bool = UNSET,
                 nondet_reusable: bool = UNSET,
                 remote: RemoteStore | ObjectStore | str | None = UNSET,
                 store: Store | None = None,
                 cost_model: CostModel | None = None,
                 worker_pool=None,
                 multiplicity: Callable[[str], float] | None = None,
                 evict_to_admit: bool = UNSET,
                 evictor: Evictor | None = None,
                 live_sigs: Callable[[str], bool] | None = None,
                 ledger=None,
                 *,
                 engine: EngineConfig | None = None,
                 storage: StoreConfig | None = None,
                 resilience: ResilienceConfig | None = None):
        eng = resolve(
            "IterativeSession", EngineConfig, engine,
            site_defaults=dict(share_nondet=False, dedupe_inflight=False),
            legacy=dict(
                policy=("policy", policy),
                async_materialization=("async_materialization",
                                       async_materialization),
                horizon=("horizon", horizon),
                max_workers=("max_workers", max_workers),
                prefetch_depth=("prefetch_depth", prefetch_depth),
                dedupe_inflight=("dedupe_inflight", dedupe_inflight),
                nondet_reusable=("share_nondet", nondet_reusable)))
        sto = resolve(
            "IterativeSession", StoreConfig, storage,
            site_defaults=dict(shared_budget=False, purge_stale=True),
            legacy=dict(
                storage_budget_bytes=("budget_bytes", storage_budget_bytes),
                shared_budget=("shared_budget", shared_budget),
                purge_stale=("purge_stale", purge_stale),
                evict_to_admit=("evict_to_admit", evict_to_admit),
                remote=("remote", remote)))
        res = resolve(
            "IterativeSession", ResilienceConfig, resilience,
            site_defaults=dict(dedupe_wait_seconds=600.0),
            legacy=dict(
                dedupe_wait_seconds=("dedupe_wait_seconds",
                                     dedupe_wait_seconds)))
        self.engine_config, self.store_config, self.resilience_config = \
            eng, sto, res
        os.makedirs(workdir, exist_ok=True)
        self.workdir = workdir
        self.store = store if store is not None \
            else Store(os.path.join(workdir, "store"),
                       remote=as_remote_store(
                           sto.remote,
                           max_retries=res.remote_max_retries,
                           retry_backoff=res.remote_retry_backoff,
                           faults=res.faults),
                       mem_budget_bytes=sto.mem_budget_bytes,
                       mem_writeback=sto.mem_writeback)
        self.cost_model = cost_model if cost_model is not None \
            else CostModel(os.path.join(workdir, "costs.json"))
        # ``ledger=`` injects a pre-built budget ledger — the tenant
        # server passes a ScopedLedger so this session's reservations
        # also debit its tenant's quota; default is the plain fleet
        # StorageLedger whenever the budget is shared.
        if ledger is None and sto.shared_budget:
            ledger = StorageLedger(self.store.ledger_path)
            ledger.ensure(float(self.store.total_bytes()))
        self.evictor = evictor
        if (self.evictor is None and sto.evict_to_admit
                and sto.budget_bytes != float("inf")):
            self.evictor = Evictor(self.store, cost_model=self.cost_model,
                                   live_multiplicity=live_sigs)
        self.materializer = Materializer(
            policy=eng.policy, storage_budget_bytes=sto.budget_bytes,
            horizon=1.0 if eng.horizon is None else eng.horizon,
            ledger=ledger,
            nondet_reusable=eng.share_nondet,
            multiplicity=multiplicity,
            evictor=self.evictor)
        if ledger is None:
            self.materializer.used_bytes = float(self.store.total_bytes())
        self.async_materialization = eng.async_materialization
        self.max_workers = eng.max_workers
        self.prefetch_depth = eng.prefetch_depth
        self.dedupe_inflight = eng.dedupe_inflight
        self.dedupe_wait_seconds = res.dedupe_wait_seconds
        self.purge_stale = sto.purge_stale
        self.worker_pool = worker_pool
        self.iteration = 0

    # ------------------------------------------------------------------------------
    def run(self, workflow: Workflow,
            load_shardings: Mapping[str, Callable] | None = None,
            nonces: Mapping[str, str] | None = None,
            share_sigs: frozenset | set | None = None,
            cancel: "threading.Event | None" = None) -> IterationReport:
        """Run one iteration. ``nonces`` optionally pins the signature
        nonces of nondeterministic nodes — the sweep driver passes one
        shared nonce map so identical unseeded operators across concurrent
        variants become equivalent (computed once, loaded by the rest).
        ``share_sigs`` marks signatures sibling sessions also need (the
        executor force-persists those on lease-compute). ``cancel``
        forwards a cooperative cancel flag to the executor (checked
        between nodes; the run raises
        :class:`~repro_torch.core.executor.JobCancelled` after settling)."""
        dag = workflow.build()
        sigs = compute_signatures(dag, nonces=nonces)
        ev_before = (self.evictor.stats.snapshot()
                     if self.evictor is not None else {})

        # §5.4 program slicing.
        keep = slice_from_outputs(dag)
        sliced = dag.subgraph(keep)

        # Chunk-granular refinement (chunks.py): per-chunk signatures for
        # every node they can flow to. Incrementally maintainable nodes
        # execute per-chunk, splicing cached chunks; everything else
        # keeps the paper's whole-value semantics.
        chunk_plans = compute_chunk_signatures(sliced, sigs)

        # One store stat per node per planning pass (shared NFS-style
        # workdirs make metadata I/O expensive; the two uses below must
        # also agree on one snapshot).
        in_store = {n: self.store.has(sigs[n]) for n in sliced.topological()}

        # §4.2 change tracking: original ⇔ signature never seen before.
        # The store is consulted too: an equivalent materialization on disk
        # (Def. 3) proves some session computed this signature even if the
        # shared cost statistics have not flushed yet — without this, a
        # session dispatched the moment a sibling's shared prefix lands
        # (the server's prefix-first schedule does exactly that) would
        # force-COMPUTE a value it could load.
        original = {n for n in sliced.topological()
                    if self.cost_model.is_original(sigs[n])
                    and not in_store[n]}

        # §5.1 operator metrics.
        compute_cost: dict[str, float] = {}
        load_cost: dict[str, float | None] = {}
        for n in sliced.topological():
            node = sliced.nodes[n]
            compute_cost[n] = self.cost_model.compute_cost(
                sigs[n], hint=node.cost_hint)
            if n in chunk_plans:
                # Incremental pricing: the executor will recompute only
                # the store-missing chunks, so the expected cost this
                # iteration is the historical whole-value cost scaled by
                # the missing fraction (omp.delta_fraction). After an
                # append this is what makes OEP prefer compute-and-splice
                # over loading a stale whole-value entry.
                compute_cost[n] *= delta_fraction(chunk_plans[n],
                                                  self.store)
            if in_store[n]:
                meta = self.store.meta(sigs[n])
                # A chunked manifest's own nbytes is metadata-sized; the
                # load cost that matters is manifest + referenced chunks.
                nb = (meta["nbytes"]
                      + meta.get("chunked", {}).get("chunk_bytes", 0))
                # Per-tier l_i: a memory-resident value prices at RAM
                # bandwidth, a remote-only one at fetch bandwidth — the
                # cheapest tier that can actually serve the signature.
                load_cost[n] = self.store.est_load_seconds(nb, sig=sigs[n])
            else:
                load_cost[n] = None

        # §5.2 OEP via max-flow. Planned LOADs are pinned with read
        # leases so a concurrent session's eviction cannot yank them
        # during execution; an entry that vanished in the plan→pin window
        # (another session's purge won that race) forces a replan with
        # its load marked unavailable — the executor's LOAD path has no
        # compute fallback, so it must never start with a dead plan.
        for _ in range(len(sliced) + 1):
            states = plan(sliced, compute_cost, load_cost, original)
            read_leases = [lease for n, s in states.items()
                           if s is State.LOAD
                           for lease in [self.store.acquire_read(sigs[n])]
                           if lease is not None]
            vanished = [n for n, s in states.items()
                        if s is State.LOAD and not self.store.has(sigs[n])]
            if not vanished:
                break
            for lease in read_leases:
                lease.release()
            for n in vanished:
                load_cost[n] = None
        try:
            # Purge stale materializations of original operators (§6.6:
            # "Helix purges any previous materialization of original
            # operators prior to execution"). Skipped in sweep mode, where
            # sibling variants' same-name entries are not stale.
            purged = 0
            if self.purge_stale:
                # keep_chunks: a stale chunked manifest (pre-append
                # variant of a node this iteration re-derives) shares its
                # prefix chunks with the manifest about to be spliced —
                # the manifest goes, the still-valid chunks stay.
                protected = protected_chunk_sigs(chunk_plans)
                by_name = self.store.sigs_by_name()
                for old_sig in stale_variants(by_name, original, sigs):
                    purged += self.store.delete(old_sig,
                                                keep_chunks=protected)
                # Foreign credit: the purged entries may have been paid
                # for by a previous session — this instance never
                # reserved those bytes, so the credit must not shrink
                # its reserved-by-me mirror (ledger-only in fleet mode).
                self.materializer.credit_foreign(purged)

            report = execute(
                sliced, sigs, states, self.store, self.materializer,
                load_shardings=load_shardings,
                async_materialization=self.async_materialization,
                max_workers=self.max_workers,
                prefetch_depth=self.prefetch_depth,
                dedupe_inflight=self.dedupe_inflight,
                dedupe_wait_seconds=self.dedupe_wait_seconds,
                share_sigs=share_sigs,
                worker_pool=self.worker_pool,
                cancel=cancel,
                chunk_plans=chunk_plans,
                # Planner chose COMPUTE although a load existed — loading
                # is costlier there; the dedupe shortcut must not undo it.
                dedupe_skip={n for n, s in states.items()
                             if s is State.COMPUTE
                             and load_cost.get(n) is not None})
        finally:
            for lease in read_leases:
                lease.release()

        # Record statistics for future iterations. Nodes the in-flight
        # dedupe turned into loads did not yield a compute measurement;
        # loads (planned or deduped) count as reuse events, which feed
        # OMP's amortization (see costs.py / omp.py multiplicity).
        for n, secs in report.runtime.items():
            if states[n] is State.COMPUTE and n not in report.deduped:
                self.cost_model.record(sigs[n], compute_seconds=secs)
            else:
                self.cost_model.record(sigs[n], reused=True)
        self.cost_model.save()
        self.iteration += 1

        evictions = {}
        if self.evictor is not None:
            after = self.evictor.stats.snapshot()
            evictions = {k: after[k] - ev_before.get(k, 0) for k in after}
        return IterationReport(
            execution=report, sigs=sigs, original=original,
            sliced_away=set(dag.nodes) - keep,
            store_bytes=self.store.total_bytes(), purged_bytes=purged,
            evictions=evictions, compute_cost=compute_cost,
            load_cost=load_cost)
