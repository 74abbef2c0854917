"""Long-running per-host session server: many clients, one store, global
scheduling.

Helix (the paper) accelerates one developer's loop; the lease-only sweep let K
variants share one store through lease contention. :class:`SessionServer`
is the ROADMAP's next step: a service that *owns* the workdir and
multiplexes every submission — local calls, unix-socket or TCP clients —
onto one shared :class:`~repro_torch.core.store.Store`, one
:class:`~repro_torch.core.costs.CostModel`, one storage-budget ledger, and one
process-wide executor worker pool, scheduling across submissions with
global knowledge (see scheduler.py):

* submissions are compiled at submit time; their signature sets feed a
  live cross-client **multiplicity map**;
* runnable work is ordered **shared-prefix-first**; siblings of an
  in-flight shared computation yield their slot to independent work (they
  would mostly block on the lease) and, when nothing independent remains,
  lease-follow the leader one node behind;
* the multiplicity map feeds OMP as observed amortization
  (``Materializer.multiplicity``), superseding the static horizon≈K
  heuristic of the lease-only sweeps;
* all sessions draw executor workers from one
  :class:`~repro_torch.serve.pool.SharedWorkerPool` instead of pooling
  independently.

``run_sweep`` is now a thin client of this server: a sweep is just K
submissions (see ``repro_torch.core.sweep``).

Because callables cannot cross a wire, remote clients submit workflows *by
registry name* plus JSON params; in-process callers may submit
:class:`~repro_torch.core.workflow.Workflow` objects (or zero-arg factories)
directly. See protocol.py for the frame format and message schema.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Mapping

from ..core.config import (UNSET, EngineConfig, ResilienceConfig,
                           StoreConfig, resolve)
from ..core.costs import CostModel
from ..core.dag import State
from ..core.eviction import Evictor
from ..core.executor import JobCancelled
from ..core.locking import StorageLedger
from ..core.omp import Policy, delta_fraction
from ..core.pruning import slice_from_outputs
from ..core.remote import ObjectStore, RemoteStore, as_remote_store
from ..core.session import IterationReport, IterativeSession
from ..core.signature import compute_chunk_signatures, compute_signatures
from ..core.store import Store
from ..core.workflow import Workflow
from .pool import SharedWorkerPool
from .protocol import (QuotaExceeded, ServerBusy, jsonable, recv_msg,
                       send_msg)
from .scheduler import PrefixScheduler, TenantScheduler
from .tenancy import (ScopedLedger, TenantQuota, TenantSpec,
                      resolve_tenant, validate_params)


class SharedNonces:
    """Server-wide nonce map for nondeterministic nodes.

    First access per node name draws the nonce; every later compilation
    reuses it, so identical unseeded operators across clients become
    equivalent (computed once fleet-wide) — morally "fix the seed for this
    server". Signatures still differ across submissions whose node
    *versions* differ.
    """

    def __init__(self) -> None:
        self._nonces: dict[str, str] = {}
        self._lock = threading.Lock()

    def get(self, name: str, default: str | None = None) -> str:
        """Return the pinned nonce for ``name``, drawing it on first use."""
        with self._lock:
            if name not in self._nonces:
                self._nonces[name] = uuid.uuid4().hex
            return self._nonces[name]


class _LiveShareView:
    """Live ``share_sigs`` view over the scheduler's multiplicity map.

    The executor force-persists lease-computed values whose signature is
    ``in`` this set; backing it by the live map (instead of a frozen
    pre-pass snapshot) means a client that arrives *mid-computation* of a
    prefix still gets it persisted. ``extra`` is the server's
    cross-host share set (:meth:`SessionServer.share_across`): the
    multiplicity map only sees *this host's* submissions, so a
    multi-host driver must say which signatures sibling hosts also want
    — otherwise a host running one arm would persist nothing for the
    fleet and every other host would recompute its prefix."""

    def __init__(self, scheduler: PrefixScheduler, extra: set):
        self._scheduler = scheduler
        self._extra = extra

    def __contains__(self, sig: object) -> bool:
        return (self._scheduler.multiplicity(str(sig)) >= 2
                or str(sig) in self._extra)


@dataclasses.dataclass
class Job:
    """One submitted workflow: lifecycle, timings, and result."""

    id: str
    name: str
    workflow: Workflow
    sigs: frozenset
    seq: int
    submitted_at: float
    status: str = "queued"   # queued | running | done | error | cancelled
    dispatched_at: float | None = None
    finished_at: float | None = None
    run_seconds: float = 0.0
    report: IterationReport | None = None
    error: BaseException | None = None
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    # Per-job running-time bound (None = server default). On expiry the
    # cancel flag below fires and the job finishes as ``cancelled``.
    timeout: float | None = None
    # Cooperative cancel flag, threaded through the session into the
    # executor (checked between nodes and inside lease waits). Set by
    # SessionServer.cancel, the job-timeout timer, and non-drain
    # shutdown.
    cancel_event: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    # Dispatch class: higher dispatches first within the scheduler's
    # blocked/unblocked tiers. The search driver marks promoted rungs so
    # survivors outrank fresh exploratory arms.
    priority: int = 0
    # Submitting tenant (the wire frame's ``tenant`` field). Drives
    # fair-share accounting, quota ledgers, and the tenant-scoped
    # storage budget; "default" when tenancy is not configured.
    tenant: str = "default"

    @property
    def queued_seconds(self) -> float:
        """Time spent waiting for a session slot."""
        end = self.dispatched_at if self.dispatched_at is not None \
            else time.perf_counter()
        return max(0.0, end - self.submitted_at)


class SessionServer:
    """Multiplex many workflow submissions onto one shared store.

    Configuration comes as the three layered dataclasses of
    ``repro_torch.core.config`` — ``engine=`` (:class:`EngineConfig`),
    ``storage=`` (:class:`StoreConfig`), ``resilience=``
    (:class:`ResilienceConfig`) — forwarded to each per-submission
    session. The loose keyword arguments below are the pre-config API:
    they still work, override the dataclasses, and warn once per kwarg
    name (DeprecationWarning). Resolved groups are exposed as
    ``self.engine_config`` / ``self.store_config`` /
    ``self.resilience_config``. Server-level knobs:

    ``registry``
        ``{name: factory}`` of workflows remote clients may submit;
        ``factory(**params)`` runs server-side and returns a ``Workflow``.
    ``n_sessions``
        Session slots: how many submissions run concurrently.
    ``pool_workers``
        Size of the process-wide :class:`SharedWorkerPool` all sessions'
        executors draw from (default: ``max(n_sessions, max_workers)``).
    ``schedule``
        ``"prefix"`` (shared-prefix-first with sibling deferral — the
        point of this server), ``"fifo"`` (arrival order, the
        lease-contention-only behavior, kept as the benchmark
        baseline), or ``"fair"`` (weighted fair share across tenants
        with prefix-first order *within* each tenant's turn — see
        :class:`~repro_torch.serve.scheduler.TenantScheduler`; weights come
        from ``tenants``).
    ``tenants``
        ``{tenant id: TenantSpec}`` enabling multi-tenant isolation:
        per-tenant fair-share weights, storage/compute quotas, and
        workflow allowlists (``"*"`` is the catch-all spec; without it,
        unknown tenants are refused). Usage is metered in a
        transactional per-tenant ledger (``tenants.json`` next to the
        store ledger) and each job's materializations run against a
        :class:`~repro_torch.serve.tenancy.ScopedLedger`, so a
        quota-exhausted tenant is refused cleanly — never satisfied by
        evicting another tenant's entries. ``None`` (default) disables
        tenancy: every submission is the ``"default"`` tenant,
        unmetered.
    ``param_schemas``
        ``{workflow name: {param: constraint}}`` submission-time
        validation (see :func:`~repro_torch.serve.tenancy.validate_params`):
        a schema is an allowlist — named params are checked against
        their type/range/choices constraint, unnamed ones are rejected
        before the registry factory runs. Workflows without a schema
        accept any params (opt-in per workflow).
    ``share_nondet``
        Pin one nonce map server-wide so identical nondeterministic
        operators are shared across clients (see :class:`SharedNonces`).
    ``nonces``
        Inject a :class:`SharedNonces` instance instead of creating one
        — the multi-host sweep passes one map to all its servers so
        nondeterministic operators stay sweep-equivalent *across*
        hosts.
    ``horizon``
        Static amortization floor forwarded to OMP. ``None`` (default)
        means 1.0 — under ``schedule="prefix"`` the live multiplicity map
        supersedes the old horizon≈K guess, so no static K is needed.
        (``schedule="fifo"`` keeps amortization purely static, exactly
        the lease-only sweep's behavior — pass ``horizon=K`` to reproduce it.)
    ``max_finished_jobs``
        Finished jobs retained for late ``wait``/``job`` queries (their
        reports pin workflow outputs in memory). Oldest beyond this are
        evicted; clients can also release one eagerly with the
        ``forget`` op.
    ``evict_to_admit``
        Attach one fleet :class:`~repro_torch.core.eviction.Evictor` shared by
        every hosted session: materializations that do not fit the
        shared budget evict the lowest-benefit-density unleased entries
        (C(n)/l_i × observed reuse), with the scheduler's live
        multiplicity map as a hard veto — entries live clients still
        want are never candidates. Stats surface in ``status()`` and job
        summaries. False restores refuse-on-exhausted. This governs the
        *local* cache tier; the remote tier budgets itself (below).
    ``remote``
        Attach the fleet-shared remote materialization tier (remote.py):
        a :class:`~repro_torch.core.remote.RemoteStore`, an
        :class:`~repro_torch.core.remote.ObjectStore` backend, or a filesystem
        path (shared-mount reference deployment). The deployment shape
        is one server per host, N servers per remote tier: each server's
        local store write-through/read-through caches the shared tier,
        compute leases extend across hosts via TTL lease objects, and
        ``status()`` reports both tiers. A server that *constructed* its
        RemoteStore (str/ObjectStore input) closes it on shutdown; an
        injected instance belongs to the caller.
    ``max_queue``
        Bounded admission: queued (not-yet-running) submissions beyond
        this raise :class:`~repro_torch.serve.protocol.ServerBusy` (the wire
        ``busy`` response, carrying ``busy_retry_after``) instead of
        growing the queue without limit. ``None`` (default) keeps the
        queue unbounded.
    ``job_timeout``
        Default per-job running-time bound in seconds: a job running
        longer has its cancel flag fired and finishes with status
        ``cancelled``. ``None`` (default) means unbounded; a per-submit
        ``timeout`` overrides it.
    ``gc_interval`` / ``gc_min_age``
        Remote-tier hygiene: with a remote attached, a maintenance
        thread runs ``remote.gc_orphans(min_age_seconds=gc_min_age)``
        every ``gc_interval`` seconds, reclaiming data objects whose
        publisher crashed before the commit marker landed.
        ``gc_interval=None`` (default) means 900 s when a remote is
        attached; pass ``0`` to disable. ``gc_min_age`` (default
        3600 s) is the safety age gate — it must comfortably exceed any
        plausible upload duration (see ``gc_orphans``).
    """

    def __init__(self, workdir: str, *,
                 registry: Mapping[str, Callable[..., Workflow]]
                 | None = None,
                 n_sessions: int = UNSET,
                 pool_workers: int | None = UNSET,
                 schedule: str = UNSET,
                 policy: Policy = UNSET,
                 storage_budget_bytes: float = UNSET,
                 max_workers: int = UNSET,
                 prefetch_depth: int = UNSET,
                 async_materialization: bool = UNSET,
                 share_nondet: bool = UNSET,
                 dedupe_inflight: bool = UNSET,
                 dedupe_wait_seconds: float = UNSET,
                 purge_stale: bool = UNSET,
                 horizon: float | None = UNSET,
                 poll_interval: float = 0.05,
                 max_finished_jobs: int = 1024,
                 evict_to_admit: bool = UNSET,
                 remote: RemoteStore | ObjectStore | str | None = UNSET,
                 nonces: SharedNonces | None = None,
                 tenants: Mapping[str, TenantSpec] | None = None,
                 param_schemas: Mapping[str, Mapping[str, Any]]
                 | None = None,
                 max_queue: int | None = UNSET,
                 busy_retry_after: float = UNSET,
                 job_timeout: float | None = UNSET,
                 gc_interval: float | None = UNSET,
                 gc_min_age: float = UNSET,
                 engine: EngineConfig | None = None,
                 storage: StoreConfig | None = None,
                 resilience: ResilienceConfig | None = None):
        eng = resolve(
            "SessionServer", EngineConfig, engine,
            site_defaults=dict(share_nondet=True, dedupe_inflight=True,
                               n_sessions=4),
            legacy=dict(
                n_sessions=("n_sessions", n_sessions),
                pool_workers=("pool_workers", pool_workers),
                schedule=("schedule", schedule),
                policy=("policy", policy),
                max_workers=("max_workers", max_workers),
                prefetch_depth=("prefetch_depth", prefetch_depth),
                async_materialization=("async_materialization",
                                       async_materialization),
                share_nondet=("share_nondet", share_nondet),
                dedupe_inflight=("dedupe_inflight", dedupe_inflight),
                horizon=("horizon", horizon)))
        sto = resolve(
            "SessionServer", StoreConfig, storage,
            site_defaults=dict(shared_budget=True, purge_stale=False),
            legacy=dict(
                storage_budget_bytes=("budget_bytes", storage_budget_bytes),
                purge_stale=("purge_stale", purge_stale),
                evict_to_admit=("evict_to_admit", evict_to_admit),
                remote=("remote", remote),
                gc_interval=("gc_interval", gc_interval),
                gc_min_age=("gc_min_age", gc_min_age)))
        res = resolve(
            "SessionServer", ResilienceConfig, resilience,
            site_defaults=dict(dedupe_wait_seconds=3600.0),
            legacy=dict(
                dedupe_wait_seconds=("dedupe_wait_seconds",
                                     dedupe_wait_seconds),
                max_queue=("max_queue", max_queue),
                busy_retry_after=("busy_retry_after", busy_retry_after),
                job_timeout=("job_timeout", job_timeout)))
        self.engine_config, self.store_config, self.resilience_config = \
            eng, sto, res
        os.makedirs(workdir, exist_ok=True)
        self.workdir = workdir
        self.registry = dict(registry or {})
        self.n_sessions = max(1, int(eng.n_sessions))
        self.policy = eng.policy
        self.storage_budget_bytes = sto.budget_bytes
        self.max_workers = max(1, int(eng.max_workers))
        self.prefetch_depth = eng.prefetch_depth
        self.async_materialization = eng.async_materialization
        self.share_nondet = eng.share_nondet
        self.dedupe_inflight = eng.dedupe_inflight
        self.dedupe_wait_seconds = res.dedupe_wait_seconds
        self.purge_stale = sto.purge_stale
        self.horizon = 1.0 if eng.horizon is None else float(eng.horizon)
        self.poll_interval = poll_interval
        self.max_queue = None if res.max_queue is None \
            else max(1, int(res.max_queue))
        self.busy_retry_after = float(res.busy_retry_after)
        self.job_timeout = res.job_timeout

        # One store / cost model / ledger / worker pool for every session
        # this server hosts. Reconcile the shared budget ledger with disk
        # unless another process's fleet is mid-run on this workdir (its
        # live reservations must not be erased).
        self._owns_remote = not isinstance(sto.remote, RemoteStore)
        self.store = Store(os.path.join(workdir, "store"),
                           remote=as_remote_store(
                               sto.remote,
                               max_retries=res.remote_max_retries,
                               retry_backoff=res.remote_retry_backoff,
                               faults=res.faults),
                           mem_budget_bytes=sto.mem_budget_bytes,
                           mem_writeback=sto.mem_writeback)
        self.cost_model = CostModel(os.path.join(workdir, "costs.json"))
        if not self.store.any_live_lease():
            StorageLedger(self.store.ledger_path).reset(
                float(self.store.total_bytes()))
        self.pool = SharedWorkerPool(
            eng.pool_workers if eng.pool_workers is not None
            else max(self.n_sessions, self.max_workers))
        self.nonces: SharedNonces | None = \
            nonces if nonces is not None \
            else (SharedNonces() if eng.share_nondet else None)
        # Tenancy: spec table, transactional usage ledger, per-workflow
        # param schemas, and the eviction audit log the isolation
        # harness asserts over. All None/empty when tenancy is off.
        self.tenants: dict[str, TenantSpec] | None = \
            dict(tenants) if tenants is not None else None
        self.param_schemas = dict(param_schemas or {})
        self.quota: TenantQuota | None = None
        if self.tenants is not None:
            self.quota = TenantQuota(os.path.join(workdir, "store",
                                                  "tenants.json"))
        self.eviction_log: list[dict] = []
        # "fair" wraps the prefix scheduler: cross-tenant weighted fair
        # share outside, shared-prefix-first inside each tenant's turn.
        inner_mode = "prefix" if eng.schedule == "fair" else eng.schedule
        inner_sched = PrefixScheduler(self.store, self.cost_model,
                                      mode=inner_mode)
        if eng.schedule == "fair":
            weights = {t: s.weight for t, s in (self.tenants or {}).items()}
            self.scheduler = TenantScheduler(inner_sched, weights)
        else:
            self.scheduler = inner_sched
        # Signatures sibling *hosts* also want (multi-host drivers feed
        # this via share_across; the live multiplicity map below only
        # covers this host's own submissions).
        self.share_extra: set[str] = set()
        self._share_view = _LiveShareView(self.scheduler,
                                          self.share_extra)
        # One fleet evictor shared by every hosted session (stats then
        # aggregate server-wide). The scheduler's live multiplicity map
        # is the veto: entries queued/running clients still want are
        # never eviction candidates.
        self.evict_to_admit = bool(sto.evict_to_admit)
        self.evictor: Evictor | None = None
        if self.evict_to_admit and sto.budget_bytes != float("inf"):
            # Same gate as IterativeSession: an unbounded budget can
            # never trigger eviction, and reports should carry the
            # documented "empty when eviction off" shape.
            self.evictor = Evictor(self.store, cost_model=self.cost_model,
                                   live_multiplicity=self.scheduler.is_live,
                                   on_evict=self._note_eviction)

        self._cv = threading.Condition()
        self._jobs: dict[str, Job] = {}
        self._queue: list[Job] = []
        self._running: dict[str, Job] = {}
        self.max_finished_jobs = max(0, int(max_finished_jobs))
        self._finished_order: list[str] = []   # eviction ring (FIFO)
        self._seq = 0
        self._accepting = True
        self._stop = False
        self._held = 0
        self._shutdown_started = False
        self.dispatch_log: list[str] = []

        self._job_pool = ThreadPoolExecutor(
            max_workers=self.n_sessions, thread_name_prefix="helix-serve")
        self._listeners: list[socket.socket] = []
        self._conns: set[socket.socket] = set()
        self._threads: list[threading.Thread] = []
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="helix-serve-dispatch",
            daemon=True)
        self._dispatcher.start()

        # Remote-tier hygiene: the server owning the workdir is the
        # natural place to reclaim crash orphans (entry data whose
        # publisher died before the commit marker) — clients come and
        # go, the server persists. Age-gated (gc_min_age) so an
        # in-flight slow upload is never mistaken for a crash.
        self.gc_min_age = float(sto.gc_min_age)
        self.gc_interval = (sto.gc_interval if sto.gc_interval is not None
                            else (900.0 if self.store.remote is not None
                                  else 0.0))
        self.gc_stats = {"runs": 0, "reclaimed": 0}
        self._maint_stop = threading.Event()
        self._maintenance: threading.Thread | None = None
        if self.gc_interval and self.store.remote is not None:
            self._maintenance = threading.Thread(
                target=self._maintenance_loop, name="helix-serve-maint",
                daemon=True)
            self._maintenance.start()

    def _maintenance_loop(self) -> None:
        """Periodic remote-tier orphan GC (see ``gc_interval``)."""
        while not self._maint_stop.wait(self.gc_interval):
            try:
                n = self.store.remote.gc_orphans(
                    min_age_seconds=self.gc_min_age)
            except Exception:
                continue  # degraded/unreachable tier: try again next tick
            with self._cv:
                self.gc_stats["runs"] += 1
                self.gc_stats["reclaimed"] += int(n)

    def _note_eviction(self, sig: str, ent: dict, freed: float) -> None:
        """Eviction audit observer (``Evictor(on_evict=...)``).

        Records every successful eviction together with the evicted
        signature's *live* state at eviction time — the tenant-isolation
        harness asserts this log never contains a live entry (and the
        store's lease-respecting delete already makes pinned/computing
        entries unevictable), turning "no cross-tenant eviction of
        live/pinned entries" from a claim into a checked invariant.
        """
        self.eviction_log.append({
            "sig": str(sig), "nbytes": float(freed),
            "live": bool(self.scheduler.is_live(sig)),
        })

    # -- submission --------------------------------------------------------
    def submit(self, workflow: Workflow | Callable[[], Workflow], *,
               name: str | None = None,
               timeout: float | None = None,
               priority: int = 0,
               tenant: str = "default") -> Job:
        """Submit a workflow (or a zero-arg factory) for execution.

        Compiles it immediately — under the server's shared nonce map —
        to learn its signature set, registers those signatures in the
        cross-client multiplicity map, and enqueues the job for the
        global scheduler. Returns the :class:`Job` handle; use
        :meth:`wait` for the result. ``timeout`` bounds the job's
        *running* time (default: the server's ``job_timeout``);
        ``priority`` sets the dispatch class (higher dispatches first —
        the search driver marks promoted rungs so survivors outrank
        fresh exploratory arms). Raises
        :class:`~repro_torch.serve.protocol.ServerBusy` when the bounded
        admission queue (``max_queue``) is full — the submission had no
        effect and is safe to retry.

        With tenancy configured, ``tenant`` names the submitting tenant
        (resolved against the ``tenants`` table; unknown tenants raise
        :class:`PermissionError`) and an exhausted compute-seconds quota
        raises :class:`~repro_torch.serve.protocol.QuotaExceeded` here, at
        admission — a clean refusal with no effect, never a hang.
        """
        spec: TenantSpec | None = None
        if self.tenants is not None:
            spec = resolve_tenant(self.tenants, tenant)
            self.quota.check_compute(tenant, spec)
        wf = workflow if isinstance(workflow, Workflow) else workflow()
        dag = wf.build()
        sigs = frozenset(
            compute_signatures(dag, nonces=self.nonces).values())
        with self._cv:
            if not self._accepting:
                raise RuntimeError("server is draining / shut down")
            if (self.max_queue is not None
                    and len(self._queue) >= self.max_queue):
                raise ServerBusy(self.busy_retry_after)
            self._seq += 1
            job = Job(id=f"j{self._seq}-{uuid.uuid4().hex[:8]}",
                      name=name or wf.name or f"job{self._seq}",
                      workflow=wf, sigs=sigs, seq=self._seq,
                      submitted_at=time.perf_counter(),
                      timeout=timeout if timeout is not None
                      else self.job_timeout,
                      priority=int(priority),
                      tenant=str(tenant))
            self._jobs[job.id] = job
            self._queue.append(job)
            self.scheduler.add(job)
            self._cv.notify_all()
        return job

    def submit_named(self, workflow: str, params: Mapping[str, Any]
                     | None = None, *, name: str | None = None,
                     timeout: float | None = None,
                     priority: int = 0,
                     tenant: str = "default") -> Job:
        """Submit a registered workflow by name (the RPC path).

        Submission-time gates, all *before* the registry factory runs:
        the tenant's workflow allowlist (``TenantSpec.workflows``,
        :class:`~repro_torch.serve.protocol.QuotaExceeded` with resource
        ``"workflow"`` on refusal), the workflow's param schema
        (:func:`~repro_torch.serve.tenancy.validate_params`, ``ValueError``
        on violation), then :meth:`submit`'s compute-quota gate.
        """
        if workflow not in self.registry:
            known = ", ".join(sorted(self.registry)) or "none"
            raise KeyError(
                f"unknown workflow {workflow!r}; registered: {known}")
        if self.tenants is not None:
            spec = resolve_tenant(self.tenants, tenant)
            if (spec.workflows is not None
                    and workflow not in spec.workflows):
                raise QuotaExceeded(
                    tenant, "workflow",
                    detail=f"tenant {tenant!r} is not allowed to submit "
                           f"workflow {workflow!r} (allowed: "
                           f"{', '.join(spec.workflows) or 'none'})")
        schema = self.param_schemas.get(workflow)
        if schema is not None:
            validate_params(workflow, dict(params or {}), schema)
        factory = self.registry[workflow]
        wf = factory(**dict(params or {}))
        return self.submit(wf, name=name or workflow, timeout=timeout,
                           priority=priority, tenant=tenant)

    def _materialize_workflow(self, workflow: str | Workflow
                              | Callable[[], Workflow],
                              params: Mapping[str, Any] | None) -> Workflow:
        """Resolve a registry name / instance / factory to a Workflow."""
        if isinstance(workflow, str):
            if workflow not in self.registry:
                known = ", ".join(sorted(self.registry)) or "none"
                raise KeyError(
                    f"unknown workflow {workflow!r}; registered: {known}")
            return self.registry[workflow](**dict(params or {}))
        return workflow if isinstance(workflow, Workflow) else workflow()

    def estimate_marginal_cost(self, workflow: str | Workflow
                               | Callable[[], Workflow],
                               params: Mapping[str, Any] | None = None
                               ) -> dict:
        """Estimate the *marginal* compute a submission would add now.

        Compiles the candidate under the server's shared nonce map,
        slices it to its outputs, and walks the unique signatures of the
        sliced DAG, pricing each with the shared cost model (unseen
        signatures get the 1.0 s prior):

        * already materialized in the store → ``hit_s`` (free at the
          margin);
        * live in a *running* submission's signature set → ``follow_s``
          (a leader is producing it; a submission would lease-follow
          rather than recompute — ``n_live_leases`` counts how many of
          those are under an exclusive compute lease *right now*);
        * wanted by other *queued* submissions → ``queued_shared_s``
          (still marginal, but will be shared if co-scheduled);
        * otherwise pure marginal compute.

        ``marginal_s = total_s − hit_s − follow_s``. This is the search
        driver's frontier-ordering signal (the ``estimate`` RPC): pick
        the candidate with the least marginal compute, tie-breaking
        toward the largest ``follow_s`` so followers draft behind live
        leaders while the shared frontier is still hot. The estimate is
        advisory — racing submissions can change it — and never mutates
        server state (the candidate is *not* enqueued and its
        signatures do not enter the multiplicity map).

        Chunk-granular pricing: a node with a chunk plan (chunks.py) is
        priced at its *delta* — the historical whole-value cost scaled
        by the fraction of its chunks missing from the store
        (``omp.delta_fraction``), exactly how the session will execute
        it. A daily-retrain submission whose source gained one chunk
        therefore estimates near the appended batch's cost, not a cold
        retrain; ``n_chunked`` counts delta-priced nodes and
        ``chunk_hit_s`` the per-chunk savings folded into ``hit_s``.

        Tier-aware hit pricing: ``hit_load_s`` is what the hits will
        actually cost to *serve*, each priced at the cheapest tier that
        holds it (``Store.est_load_seconds(nbytes, sig=...)`` — a
        memory-resident signature is near-free, a remote-only one pays
        fetch bandwidth), and ``n_hit_mem`` counts the hits resident in
        the memory tier. ``marginal_s`` deliberately ignores this load
        cost (hits stay free at the margin, as before) — the fields let
        the search driver tie-break toward candidates whose hits are
        already hot in RAM.
        """
        wf = self._materialize_workflow(workflow, params)
        dag = wf.build()
        sigs = compute_signatures(dag, nonces=self.nonces)
        sliced = dag.subgraph(slice_from_outputs(dag))
        chunk_plans = compute_chunk_signatures(sliced, sigs)
        with self._cv:
            inflight = self._inflight_sigs_locked()
        total = hit = follow = queued_shared = chunk_hit = 0.0
        hit_load = 0.0
        n_hit = n_follow = n_queued = n_lease = n_chunked = 0
        n_hit_mem = 0
        seen: set[str] = set()
        for n in sliced.topological():
            sig = sigs[n]
            if sig in seen:
                continue
            seen.add(sig)
            c = self.cost_model.compute_cost(
                sig, hint=sliced.nodes[n].cost_hint)
            total += c
            if self.store.has(sig):
                hit += c
                n_hit += 1
                if self.store.mem_has(sig):
                    n_hit_mem += 1
                try:
                    m = self.store.meta(sig)
                    nb = (int(m.get("nbytes", 0) or 0)
                          + int(m.get("chunked", {})
                                .get("chunk_bytes", 0) or 0))
                except (OSError, ValueError):
                    nb = 0   # raced a delete — price it as gone
                else:
                    hit_load += self.store.est_load_seconds(nb, sig=sig)
            elif sig in inflight:
                follow += c
                n_follow += 1
                if self.store.computing(sig):
                    n_lease += 1
            else:
                if self.scheduler.multiplicity(sig) > 0:
                    queued_shared += c
                    n_queued += 1
                if n in chunk_plans:
                    # Compute-and-splice: only the missing chunks run.
                    frac = delta_fraction(chunk_plans[n], self.store)
                    if frac < 1.0:
                        saved = c * (1.0 - frac)
                        hit += saved
                        chunk_hit += saved
                        n_chunked += 1
        return {
            "workflow": wf.name, "n_nodes": len(seen),
            "total_s": total, "marginal_s": total - hit - follow,
            "hit_s": hit, "follow_s": follow,
            "queued_shared_s": queued_shared,
            "n_hit": n_hit, "n_follow": n_follow,
            "n_queued_shared": n_queued, "n_live_leases": n_lease,
            "n_chunked": n_chunked, "chunk_hit_s": chunk_hit,
            "hit_load_s": hit_load, "n_hit_mem": n_hit_mem,
        }

    def cancel(self, job: Job | str,
               reason: str = "cancelled by request") -> bool:
        """Stop a queued or running job.

        Queued jobs leave the queue immediately and finish as
        ``cancelled``. Running jobs get their cancel flag set: the
        executor stops between nodes, releases leases/pins/reservations
        through the normal settle path, and the job finishes as
        ``cancelled`` shortly after. Returns False when the job is
        unknown or already finished (idempotent)."""
        job_id = job.id if isinstance(job, Job) else str(job)
        with self._cv:
            j = self._jobs.get(job_id)
            if j is None or j.done.is_set():
                return False
            try:
                self._queue.remove(j)
            except ValueError:
                pass  # dispatched (or dispatching): flag it instead
            else:
                j.status = "cancelled"
                j.error = JobCancelled(reason)
                j.dispatched_at = time.perf_counter()
                j.finished_at = j.dispatched_at
                self.scheduler.remove(j)
                self._retain_finished_locked(j)
                self._cv.notify_all()
                j.done.set()
                return True
            j.cancel_event.set()
            return True

    def share_across(self, sigs) -> None:
        """Mark signatures sibling *hosts* also need (multi-host mode).

        The executor then force-persists them on lease-compute and
        uploads synchronously before the lease releases — without this,
        a host whose own submissions share nothing would persist nothing
        and every other host would recompute the common prefix. The
        multi-host ``run_sweep`` computes the cross-host shared set from
        the submitted jobs' signatures and feeds it here."""
        with self._cv:
            self.share_extra.update(str(s) for s in sigs)

    @contextlib.contextmanager
    def hold_dispatch(self):
        """Pause dispatching while a batch is submitted, so the scheduler
        sees the whole batch's multiplicities before ordering it."""
        with self._cv:
            self._held += 1
        try:
            yield self
        finally:
            with self._cv:
                self._held -= 1
                self._cv.notify_all()

    # -- waiting / inspection ----------------------------------------------
    def wait(self, job: Job | str, timeout: float | None = None) -> Job:
        """Block until ``job`` (handle or id) finishes; returns the Job."""
        j = job if isinstance(job, Job) else self._jobs[job]
        if not j.done.wait(timeout):
            raise TimeoutError(f"job {j.id} still {j.status}")
        return j

    def wait_all(self, jobs: list[Job] | None = None,
                 timeout: float | None = None) -> list[Job]:
        """Wait for the given jobs (default: every submitted job)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        targets = list(jobs) if jobs is not None else list(
            self._jobs.values())
        for j in targets:
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            self.wait(j, timeout=left)
        return targets

    def multiplicity(self, sig: str) -> int:
        """Live submissions (queued or running) needing ``sig``."""
        return self.scheduler.multiplicity(sig)

    def status(self) -> dict:
        """JSON-safe snapshot of server state (the ``status`` RPC)."""
        with self._cv:
            snapshot = {
                "workdir": self.workdir,
                "schedule": self.scheduler.mode,
                "accepting": self._accepting,
                "n_sessions": self.n_sessions,
                "queued": len(self._queue),
                "running": len(self._running),
                "total_jobs": len(self._jobs),
                "cancelled": sum(1 for j in self._jobs.values()
                                 if j.status == "cancelled"),
                "max_queue": self.max_queue,
                "gc": dict(self.gc_stats),
                "pool": self.pool.stats(),
                "eviction": (self.evictor.stats.snapshot()
                             if self.evictor is not None else None),
            }
            if self.tenants is not None:
                snapshot["tenants"] = {
                    "usage": self.quota.snapshot(),
                    "fair": (self.scheduler.snapshot()
                             if isinstance(self.scheduler,
                                           TenantScheduler) else None),
                    "n_evictions": len(self.eviction_log),
                    "n_evictions_live": sum(
                        1 for e in self.eviction_log if e["live"]),
                }
        # Store I/O stays outside the dispatch lock: an index read must
        # never stall submits/completions behind a slow filesystem.
        # Per-tier report (used bytes, entry counts, live lease census
        # for local AND remote) — the observability surface the
        # operations guide's troubleshooting table points at;
        # ``store_bytes`` (local tier) is kept for older clients.
        snapshot["tiers"] = self.store.tier_status()
        snapshot["store_bytes"] = snapshot["tiers"]["local"]["bytes"]
        return snapshot

    def job_summary(self, job: Job | str, detail: bool = False) -> dict:
        """JSON-safe summary of one job (the ``job``/``wait`` RPCs).

        ``detail=True`` additionally lists the signatures the job
        actually computed (planned COMPUTE and not deduped into a load)
        and the subset of those that were *blind* computes (not the
        planner's deliberate recompute-cheaper-than-load choice) — the
        raw material for transport-agnostic fleet duplicate-compute
        accounting (see ``SearchReport.wasted_recomputes``)."""
        j = job if isinstance(job, Job) else self._jobs[job]
        out: dict[str, Any] = {
            "job": j.id, "name": j.name, "status": j.status,
            "queued_seconds": round(j.queued_seconds, 6),
            "run_seconds": round(j.run_seconds, 6),
        }
        if j.error is not None:
            out["error"] = f"{type(j.error).__name__}: {j.error}"
        if j.report is not None:
            ex = j.report.execution
            out["execution"] = {
                "n_computed": ex.n_computed, "n_loaded": ex.n_loaded,
                "n_pruned": ex.n_pruned, "n_deduped": len(ex.deduped),
                "total_seconds": round(ex.total_seconds, 6),
                "mat_seconds": round(ex.mat_seconds, 6),
            }
            if detail:
                computed = [n for n, s in ex.states.items()
                            if s is State.COMPUTE and n not in ex.deduped]
                out["execution"]["computed_sigs"] = sorted(
                    j.report.sigs[n] for n in computed)
                out["execution"]["blind_computed_sigs"] = sorted(
                    j.report.sigs[n] for n in computed
                    if n not in ex.chose_compute)
            if j.report.evictions:
                # Fleet evictor-stat deltas over this job's run window
                # (the evictor is shared, so concurrent jobs' windows
                # overlap — these attribute fleet activity, not blame).
                out["execution"]["evictions"] = dict(j.report.evictions)
            out["outputs"] = jsonable(j.report.outputs)
        return out

    # -- scheduling --------------------------------------------------------
    def _inflight_sigs_locked(self) -> set[str]:
        out: set[str] = set()
        for job in self._running.values():
            out |= job.sigs
        return out

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                job = None
                while not self._stop:
                    if (not self._held and self._queue
                            and len(self._running) < self.n_sessions):
                        # pick() always returns a job for a non-empty
                        # queue: blocked siblings are dispatched (they
                        # lease-follow the leader) when nothing
                        # independent is available — never an idle slot.
                        job = self.scheduler.pick(
                            self._queue, self._inflight_sigs_locked())
                        break
                    # Sleep until a submit / completion / hold-release
                    # notifies (the timeout is only a lost-notify guard).
                    self._cv.wait(timeout=1.0)
                if self._stop:
                    return
                self._queue.remove(job)
                job.status = "running"
                job.dispatched_at = time.perf_counter()
                self._running[job.id] = job
                self.dispatch_log.append(job.name)
                if isinstance(self.scheduler, TenantScheduler):
                    # Provisional fair-share charge while the job runs
                    # (replaced by measured seconds at completion) — K
                    # free slots must not all go to one tenant just
                    # because none of its jobs finished yet.
                    self.scheduler.note_dispatch(job)
            self._job_pool.submit(self._run_job, job)

    def _omp_multiplicity(self, sig: str) -> float:
        """Expected future loads of ``sig``: live siblings now, or the
        fleet's historically observed reuse (capped — history should tilt
        the threshold, not nuke it)."""
        live_others = max(0, self.scheduler.multiplicity(sig) - 1)
        hist = self.cost_model.reuse_count(sig)
        return float(max(live_others, min(hist, 64.0)))

    def _job_ledger(self, job: Job) -> ScopedLedger | None:
        """Build the tenant-scoped budget ledger for one job's session.

        None without tenancy (the session constructs the plain fleet
        ledger itself). With it, the job's materializations debit both
        the fleet ledger and its tenant's quota meter, and a tenant-side
        refusal short-circuits evict-to-admit (see
        :class:`~repro_torch.serve.tenancy.ScopedLedger`).
        """
        if self.tenants is None:
            return None
        spec = resolve_tenant(self.tenants, job.tenant)
        fleet = StorageLedger(self.store.ledger_path)
        fleet.ensure(float(self.store.total_bytes()))
        return ScopedLedger(fleet, self.quota, job.tenant,
                            quota_bytes=spec.storage_bytes)

    def _run_job(self, job: Job) -> None:
        t0 = time.perf_counter()
        timer: threading.Timer | None = None
        if job.timeout is not None:
            # Per-submission running-time bound: expiry just fires the
            # same cooperative cancel flag an explicit cancel() uses.
            timer = threading.Timer(job.timeout, job.cancel_event.set)
            timer.daemon = True
            timer.start()
        try:
            sess = IterativeSession(
                self.workdir,
                engine=dataclasses.replace(
                    self.engine_config, horizon=self.horizon,
                    share_nondet=self.share_nondet,
                    dedupe_inflight=self.dedupe_inflight),
                # The session reuses this server's store instance; its
                # own remote-construction path must stay cold.
                storage=dataclasses.replace(
                    self.store_config, shared_budget=True,
                    purge_stale=self.purge_stale, remote=None,
                    evict_to_admit=self.evict_to_admit),
                resilience=self.resilience_config,
                store=self.store, cost_model=self.cost_model,
                worker_pool=self.pool,
                # One shared fleet evictor (live-multiplicity veto from
                # the scheduler); None keeps refuse-on-exhausted.
                evictor=self.evictor,
                # Tenant-scoped budget ledger (None without tenancy).
                ledger=self._job_ledger(job),
                # Observed amortization belongs to the globally-aware
                # schedules; "fifo" keeps OMP purely static so it
                # remains a faithful lease-only baseline (pass horizon=K to
                # match).
                multiplicity=(self._omp_multiplicity
                              if self.scheduler.mode in ("prefix", "fair")
                              else None))
            job.report = sess.run(job.workflow, nonces=self.nonces,
                                  share_sigs=self._share_view,
                                  cancel=job.cancel_event)
            job.status = "done"
        except JobCancelled as e:
            # Requested stop (cancel RPC / job timeout / non-drain
            # shutdown), not a failure: the executor already settled
            # leases, pins, and reservations on the way out.
            job.error = e
            job.status = "cancelled"
        except BaseException as e:
            job.error = e
            job.status = "error"
        finally:
            if timer is not None:
                timer.cancel()
            job.run_seconds = time.perf_counter() - t0
            job.finished_at = time.perf_counter()  # same base as the
            # submitted_at/dispatched_at stamps, so deltas are meaningful
            if self.quota is not None:
                # Meter served compute against the tenant's quota
                # (cancelled/errored time still occupied the slot).
                self.quota.charge_compute(job.tenant, job.run_seconds)
            with self._cv:
                if isinstance(self.scheduler, TenantScheduler):
                    self.scheduler.note_finish(job, job.run_seconds)
                self._running.pop(job.id, None)
                self.scheduler.remove(job)
                self._retain_finished_locked(job)
                self._cv.notify_all()
            job.done.set()

    def _retain_finished_locked(self, job: Job) -> None:
        """Bound the finished-job history: a long-running server must not
        pin every past submission's outputs in memory forever."""
        self._finished_order.append(job.id)
        while len(self._finished_order) > self.max_finished_jobs:
            evicted = self._finished_order.pop(0)
            self._jobs.pop(evicted, None)

    def forget(self, job: Job | str) -> bool:
        """Release a finished job's record (and its report) eagerly.

        Returns False when the job is unknown or still queued/running."""
        job_id = job.id if isinstance(job, Job) else job
        with self._cv:
            j = self._jobs.get(job_id)
            if j is None or not j.done.is_set():
                return False
            self._jobs.pop(job_id, None)
            try:
                self._finished_order.remove(job_id)
            except ValueError:
                pass
        return True

    # -- lifecycle ---------------------------------------------------------
    def drain(self, timeout: float | None = None) -> bool:
        """Stop accepting submissions and wait for all live work to finish.

        Returns True when the queue and running set emptied within
        ``timeout`` (None = wait forever). The server stays up — already
        submitted jobs complete normally; new submissions are rejected.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            self._accepting = False
            self._cv.notify_all()
            while self._queue or self._running:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cv.wait(timeout=left if left is not None
                              else self.poll_interval)
        return True

    def shutdown(self, drain: bool = True,
                 timeout: float | None = None) -> None:
        """Stop the server. ``drain=True`` (default) finishes submitted
        work first (graceful); ``drain=False`` cancels queued *and
        running* jobs — running ones stop cooperatively between nodes
        (leases/pins/reservations released) and report status
        ``cancelled``, not ``error``. Idempotent."""
        with self._cv:
            if self._shutdown_started:
                return
            self._shutdown_started = True
            self._accepting = False
        self._maint_stop.set()
        if drain:
            self.drain(timeout)
        with self._cv:
            for job in self._queue:
                job.status = "cancelled"
                job.error = JobCancelled("server shut down")
                # Freeze queued_seconds at cancellation time (it is
                # computed against "now" while dispatched_at is unset).
                job.dispatched_at = time.perf_counter()
                job.finished_at = job.dispatched_at
                self.scheduler.remove(job)
                job.done.set()
            self._queue.clear()
            if not drain:
                # Non-drain shutdown must not wait an unbounded compute
                # out: fire every running job's cancel flag; the pool
                # join below then returns as soon as each executor
                # reaches its next between-nodes check.
                for job in self._running.values():
                    job.cancel_event.set()
            self._stop = True
            self._cv.notify_all()
        self._dispatcher.join(timeout=30.0)
        self._job_pool.shutdown(wait=True)
        # Settle the write-through: queued uploads must land before the
        # remote handle (and its lease heartbeat) goes away, or a warm
        # remote tier silently misses this host's last materializations.
        if self.store.remote is not None:
            self.store.writer_drain()
            if self._owns_remote:
                self.store.remote.close()
        for sock in self._listeners:
            # close() alone does not wake a thread blocked in accept():
            # the in-progress syscall keeps the listening file
            # description alive (and accepting!) until it returns. Close,
            # then poke the address with a throwaway connection so the
            # blocked accept returns and the loop exits on the dead fd.
            family = sock.family
            try:
                addr = sock.getsockname()
            except OSError:
                addr = None
            try:
                sock.close()
            except OSError:
                pass
            if addr:
                try:
                    dummy = socket.socket(family, socket.SOCK_STREAM)
                    dummy.settimeout(0.5)
                    dummy.connect(addr)
                    dummy.close()
                except OSError:
                    pass
                if family == socket.AF_UNIX:
                    try:
                        os.unlink(addr)
                    except OSError:
                        pass
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:
                pass

    def __enter__(self) -> "SessionServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- RPC ---------------------------------------------------------------
    def serve_unix(self, path: str) -> str:
        """Listen on a unix domain socket; returns the bound path.

        A stale socket file (dead previous server) is removed; a *live*
        one is refused rather than hijacked — restarting over a
        still-draining server must fail loudly, not steal its clients.
        """
        if os.path.exists(path):
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.settimeout(0.5)
                probe.connect(path)
                probe.close()
                raise RuntimeError(
                    f"another server is live on {path}")
            except (ConnectionRefusedError, FileNotFoundError,
                    socket.timeout, TimeoutError):
                probe.close()
                os.unlink(path)   # dead leftover: safe to reclaim
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(path)
        self._start_listener(sock)
        return path

    def serve_tcp(self, host: str = "127.0.0.1",
                  port: int = 0) -> tuple[str, int]:
        """Listen on TCP; returns the bound ``(host, port)``."""
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, port))
        self._start_listener(sock)
        return sock.getsockname()

    def _start_listener(self, sock: socket.socket) -> None:
        sock.listen(16)
        self._listeners.append(sock)
        t = threading.Thread(target=self._listen_loop, args=(sock,),
                             name="helix-serve-listen", daemon=True)
        t.start()
        self._threads.append(t)

    def _listen_loop(self, sock: socket.socket) -> None:
        while True:
            try:
                conn, _ = sock.accept()
            except OSError:
                return   # listener closed by shutdown
            self._conns.add(conn)
            t = threading.Thread(target=self._conn_loop, args=(conn,),
                                 name="helix-serve-conn", daemon=True)
            t.start()
            # Prune dead handler threads so a long-running server's
            # bookkeeping stays O(live connections), not O(ever accepted).
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _conn_loop(self, conn: socket.socket) -> None:
        try:
            while True:
                try:
                    msg = recv_msg(conn)
                except Exception:
                    return
                if msg is None:
                    return
                resp = self._handle(msg)
                try:
                    send_msg(conn, resp)
                except OSError:
                    return
                if isinstance(msg, dict) and msg.get("op") == "shutdown":
                    # Reply first, then stop the server from a separate
                    # thread (shutdown joins pools this handler is not
                    # part of, but keep the reply latency minimal).
                    threading.Thread(target=self.shutdown,
                                     daemon=True).start()
                    return
        finally:
            self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, msg: Any) -> dict:
        """Serve one protocol request (shared by socket handlers and the
        in-process client — see protocol.py for the schema)."""
        if not isinstance(msg, dict):
            return {"ok": False, "error": "message must be a JSON object"}
        op = msg.get("op")
        try:
            if op == "hello":
                return {"ok": True, "server": "helix-session-server",
                        "workdir": self.workdir,
                        "schedule": self.scheduler.mode,
                        "workflows": sorted(self.registry)}
            if op == "submit":
                try:
                    job = self.submit_named(msg.get("workflow", ""),
                                            msg.get("params"),
                                            name=msg.get("name"),
                                            timeout=msg.get("timeout"),
                                            priority=int(
                                                msg.get("priority", 0)),
                                            tenant=str(
                                                msg.get("tenant",
                                                        "default")))
                except ServerBusy as e:
                    # Backpressure, not failure: the submit had no
                    # effect; the client should retry after the hint.
                    return {"ok": False, "busy": True,
                            "retry_after": e.retry_after,
                            "error": str(e)}
                except QuotaExceeded as e:
                    # Clean per-tenant refusal: no effect, not retried
                    # (the quota will not free itself) — see protocol.py.
                    return {"ok": False, "quota_exceeded": True,
                            "tenant": e.tenant, "resource": e.resource,
                            "limit": e.limit, "used": e.used,
                            "error": str(e)}
                return {"ok": True, "job": job.id, "name": job.name}
            if op == "estimate":
                return {"ok": True, **self.estimate_marginal_cost(
                    msg.get("workflow", ""), msg.get("params"))}
            if op == "cancel":
                return {"ok": True,
                        "cancelled": self.cancel(str(msg.get("job", "")))}
            if op in ("job", "wait"):
                job_id = msg.get("job")
                if job_id not in self._jobs:
                    return {"ok": False, "error": f"unknown job {job_id!r}"}
                job = self._jobs[job_id]
                if op == "wait" and not job.done.wait(msg.get("timeout")):
                    # Mirror SessionServer.wait: a timeout is an error the
                    # client can catch, never a partial summary the
                    # caller would mistake for a finished job.
                    return {"ok": False, "error":
                            f"TimeoutError: job {job_id} still "
                            f"{job.status}"}
                return {"ok": True, **self.job_summary(
                    job, detail=bool(msg.get("detail")))}
            if op == "forget":
                return {"ok": True,
                        "forgotten": self.forget(str(msg.get("job", "")))}
            if op == "status":
                return {"ok": True, **self.status()}
            if op == "multiplicity":
                sig = str(msg.get("sig", ""))
                return {"ok": True, "sig": sig,
                        "multiplicity": self.multiplicity(sig)}
            if op == "drain":
                return {"ok": True, "drained": self.drain(
                    msg.get("timeout"))}
            if op == "shutdown":
                return {"ok": True, "stopping": True}
            return {"ok": False, "error": f"unknown op {op!r}"}
        except Exception as e:
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
