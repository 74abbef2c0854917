"""Layered configuration for the Helix engines.

``IterativeSession``, ``SessionServer`` and ``run_sweep`` once each
carried 15–20 overlapping keyword arguments. This module collapses that
sprawl into three small frozen dataclasses, layered by concern:

* :class:`EngineConfig` — how work *executes*: materialization policy,
  executor width and prefetch, async materialization, OMP's amortization
  horizon, dispatch schedule, session slots, fleet dedupe.
* :class:`StoreConfig` — what is *kept*: the storage budget, eviction
  mode, the remote tier, ledger sharing, stale purging, remote GC.
* :class:`ResilienceConfig` — how failures and waits are *bounded*:
  dedupe lease waits, admission-queue bounds, job timeouts, remote
  retry/backoff, fault injection, client RPC timeouts.

Every constructor that used to take the loose kwargs now accepts
``engine=`` / ``storage=`` / ``resilience=`` instances. The old kwargs
keep working through a deprecation shim — :func:`resolve` maps them onto
the dataclasses and warns once per kwarg name per process — so no
existing call site breaks while new code writes configs.

Context-dependent defaults: a handful of knobs have *different* sane
defaults per call site (a standalone session does not dedupe in-flight
work; a server always does). Those fields default to ``None`` here,
meaning "use the call site's historical default"; passing an explicit
value always wins. Everything else has one unified default.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Mapping

from .omp import Policy


class _Unset:
    """Sentinel distinguishing "kwarg not passed" from an explicit None."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "<unset>"


#: Default value of every deprecated legacy kwarg: lets the shim tell an
#: explicitly passed value (even ``None``) from an omitted one.
UNSET = _Unset()


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """How work executes: the engine-level knobs.

    ``policy``
        OMP materialization policy (OPT / ALWAYS / NEVER).
    ``max_workers`` / ``prefetch_depth`` / ``async_materialization``
        The pipelined executor: worker-pool width, LOAD-prefetch bound,
        and whether materialization writes go through the store's async
        writer queue.
    ``horizon``
        Static amortization floor for OMP. ``None`` (default) means 1.0
        for a standalone session; under a server's ``"prefix"`` schedule
        the live multiplicity map supersedes it anyway.
    ``schedule``
        Server dispatch policy: ``"prefix"`` (shared-prefix-first),
        ``"fifo"`` (arrival order, the original baseline), or ``"fair"``
        (weighted fair share across tenants, prefix-first within each —
        requires the server's ``tenants=`` table for the weights).
    ``n_sessions``
        Concurrent session slots. ``None`` = call-site default (4 for a
        server, all variants for a sweep).
    ``pool_workers``
        Size of the process-wide shared executor pool (``None`` = sized
        from ``n_sessions``/``max_workers``).
    ``share_nondet``
        Pin one nonce map so identical nondeterministic operators are
        shared. ``None`` = call-site default (False for a standalone
        session, True for server/sweep).
    ``dedupe_inflight``
        Fleet compute-once protocol (per-signature compute leases).
        ``None`` = call-site default (False standalone, True fleet).
    """

    policy: Policy = Policy.OPT
    max_workers: int = 1
    prefetch_depth: int = 4
    async_materialization: bool = False
    horizon: float | None = None
    schedule: str = "prefix"
    n_sessions: int | None = None
    pool_workers: int | None = None
    share_nondet: bool | None = None
    dedupe_inflight: bool | None = None


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """What is kept: storage budget, eviction, and the remote tier.

    ``budget_bytes``
        Storage budget for materializations (``inf`` = unbounded).
    ``evict_to_admit``
        Benefit-weighted eviction when a materialization does not fit
        (False = refuse-on-exhausted).
    ``remote``
        Fleet-shared remote tier: a ``RemoteStore``, an ``ObjectStore``
        backend, or a filesystem path (shared-mount reference).
    ``shared_budget``
        Enforce the budget against the fleet's shared on-disk ledger.
        ``None`` = call-site default (False standalone; a server always
        shares).
    ``purge_stale``
        The paper's §6.6 purge of prior materializations of original
        operators. ``None`` = call-site default (True standalone, False
        for fleet drivers where sibling variants are not stale).
    ``gc_interval`` / ``gc_min_age``
        Remote-tier orphan GC cadence and safety age gate
        (``gc_interval=None`` = 900 s when a remote is attached).
    ``mem_budget_bytes``
        Host-RAM budget for the store's memory tier (memtier.py): a
        bounded process-local cache of materialized values served
        zero-copy in front of the disk tier. 0 disables the tier.
    ``mem_writeback``
        Write-back mode: saves land memory-only and spill to disk at
        demotion (`mem_flush` is the durability barrier). Off by
        default — write-through keeps every value crash-durable.
    """

    budget_bytes: float = float("inf")
    evict_to_admit: bool = True
    remote: Any = None
    shared_budget: bool | None = None
    purge_stale: bool | None = None
    gc_interval: float | None = None
    gc_min_age: float = 3600.0
    mem_budget_bytes: float = 256e6
    mem_writeback: bool = False


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """How failures and waits are bounded.

    ``dedupe_wait_seconds``
        Upper bound on waiting for another session's compute lease
        before falling back to computing locally. ``None`` = call-site
        default (600 s standalone, 3600 s fleet).
    ``max_queue`` / ``busy_retry_after``
        Bounded admission: queued submissions beyond ``max_queue`` get a
        ``busy`` response carrying the retry hint (``None`` =
        unbounded).
    ``job_timeout``
        Default per-job running-time bound; expiry fires the job's
        cooperative cancel flag (``None`` = unbounded).
    ``remote_max_retries`` / ``remote_retry_backoff``
        Transient remote-backend errors are retried in place with
        exponential backoff + jitter. Applied when the session/server
        *constructs* its remote tier from a path or backend (an injected
        ``RemoteStore`` keeps its own).
    ``faults``
        A :class:`~repro_torch.core.faults.FaultPlan` threaded into a remote
        tier constructed here (tests / chaos drills only).
    ``rpc_timeout`` / ``busy_retries``
        Client-side: per-RPC socket timeout (arms reconnect-on-error)
        and automatic retries of a ``busy`` submit.
    """

    dedupe_wait_seconds: float | None = None
    max_queue: int | None = None
    busy_retry_after: float = 0.5
    job_timeout: float | None = None
    remote_max_retries: int = 3
    remote_retry_backoff: float = 0.05
    faults: Any = None
    rpc_timeout: float | None = None
    busy_retries: int = 8


# Legacy kwarg names that have already warned this process: the shim
# warns once per name, not once per call, so a sweep constructing K
# sessions does not emit K identical warnings.
_WARNED: set[str] = set()


def reset_legacy_warnings() -> None:
    """Forget which deprecated kwargs have warned (test isolation)."""
    _WARNED.clear()


def _warn_once(owner: str, kwarg: str, cls: type, field: str) -> None:
    if kwarg in _WARNED:
        return
    _WARNED.add(kwarg)
    warnings.warn(
        f"{owner}({kwarg}=...) is deprecated; pass "
        f"{cls.__name__}(`{field}=...`) via the config parameters instead "
        f"(see repro_torch.core.config)",
        DeprecationWarning, stacklevel=4)


def resolve(owner: str, cls: type, config: Any,
            site_defaults: Mapping[str, Any] | None = None,
            legacy: Mapping[str, tuple[str, Any]] | None = None) -> Any:
    """Resolve one config group for one constructor call.

    ``config`` is the user-passed instance (or None → ``cls()``);
    ``site_defaults`` fills fields still at their ``None`` "call-site
    default" sentinel; ``legacy`` maps each deprecated kwarg name to
    ``(field, passed_value)`` — values that are not :data:`UNSET`
    override the config (warning once per kwarg name). Returns a fully
    resolved frozen instance.
    """
    if config is None:
        config = cls()
    elif not isinstance(config, cls):
        raise TypeError(
            f"{owner} expected {cls.__name__}, got {type(config).__name__}")
    updates: dict[str, Any] = {}
    for field, default in (site_defaults or {}).items():
        if getattr(config, field) is None:
            updates[field] = default
    for kwarg, (field, value) in (legacy or {}).items():
        if value is UNSET:
            continue
        _warn_once(owner, kwarg, cls, field)
        updates[field] = value
    return dataclasses.replace(config, **updates) if updates else config
