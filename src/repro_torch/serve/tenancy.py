"""Multi-tenancy primitives: quotas, per-tenant accounting, param schemas.

One :class:`~repro_torch.serve.server.SessionServer` multiplexes every client
onto one store and one worker pool. That is the point — shared-prefix
reuse only pays when tenants share the substrate — but sharing without
limits lets one tenant starve the rest (compute), squat the budget
(storage), or submit junk (arbitrary params). This module is the
isolation layer the server composes in when constructed with
``tenants=``:

* :class:`TenantSpec` — one tenant's contract: fair-share ``weight``,
  ``storage_bytes`` / ``compute_seconds`` quotas, and an optional
  workflow allowlist.
* :class:`TenantQuota` — the fleet-shared per-tenant usage ledger
  (bytes reserved, compute seconds served), transactional JSON under a
  file lock exactly like :class:`~repro_torch.core.locking.StorageLedger`,
  so N server processes on one workdir agree on usage.
* :class:`ScopedLedger` — the ledger a tenant's jobs hand to
  :class:`~repro_torch.core.omp.Materializer`: every reservation must fit
  *both* the fleet budget and the tenant's own storage quota, and a
  tenant-side refusal reports ``scope_exhausted`` so the Materializer
  never evicts other tenants' entries to satisfy a quota that eviction
  cannot help (a quota-exhausted tenant degrades gracefully to
  not-materializing; it never silently evicts a neighbor).
* :func:`validate_params` — per-workflow param schemas: the schema is
  an *allowlist* (unknown params are rejected) with per-param type or
  literal-value constraints, checked at submission before the factory
  runs.

Cross-tenant eviction safety is layered, not re-implemented: entries any
live submission still wants are vetoed by the scheduler's multiplicity
map, and pinned/computing entries are protected by the store's leases —
both tenant-agnostic, so no tenant's evict-to-admit can remove another
tenant's live or pinned entries. The server's eviction observer
(``Evictor(on_evict=...)``) records every eviction with its live/pin
state so the tenant-isolation harness *proves* the invariant instead of
assuming it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from ..core.locking import StorageLedger, read_json, update_json
from .protocol import QuotaExceeded


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's serving contract.

    ``weight``
        Fair-share weight for the ``"fair"`` dispatch schedule: over any
        busy interval a tenant is served compute-seconds proportional to
        its weight (see :class:`~repro_torch.serve.scheduler.TenantScheduler`).
    ``storage_bytes``
        Cap on the bytes this tenant's jobs may hold reserved in the
        shared materialization budget (``inf`` = uncapped). Exhaustion
        is graceful: further materializations are refused for this
        tenant only — never satisfied by evicting other tenants.
    ``compute_seconds``
        Cap on cumulative served compute seconds. An exhausted tenant's
        submissions are rejected with the ``quota_exceeded`` wire error
        (clean refusal at admission, not a hang).
    ``workflows``
        Allowlist of registry names this tenant may submit (``None`` =
        any registered workflow).
    """

    weight: float = 1.0
    storage_bytes: float = float("inf")
    compute_seconds: float = float("inf")
    workflows: tuple[str, ...] | None = None


def resolve_tenant(tenants: Mapping[str, TenantSpec],
                   tenant: str) -> TenantSpec:
    """Look up ``tenant``'s spec; ``"*"`` is the catch-all entry.

    Raises :class:`PermissionError` for a tenant the table does not
    know (and has no ``"*"`` default for) — with tenancy configured,
    identity is required.
    """
    spec = tenants.get(tenant)
    if spec is None:
        spec = tenants.get("*")
    if spec is None:
        known = ", ".join(sorted(k for k in tenants if k != "*")) or "none"
        raise PermissionError(
            f"unknown tenant {tenant!r}; configured: {known}")
    return spec


_TYPES = {
    "int": (int,),
    "float": (int, float),     # an int is an acceptable float
    "number": (int, float),
    "str": (str,),
    "bool": (bool,),
}


def validate_params(workflow: str, params: Mapping[str, Any],
                    schema: Mapping[str, Any]) -> None:
    """Check ``params`` against one workflow's schema (an allowlist).

    ``schema`` maps each *allowed* param name to a constraint:

    * a type name — ``"int" | "float" | "number" | "str" | "bool"``;
    * a list/tuple of allowed literal values;
    * a dict ``{"type": <name>, "min": x, "max": y}`` (bounds optional,
      numeric types only).

    Any param not named in the schema is rejected — the schema *is* the
    allowlist, so a registry factory can never be reached with a kwarg
    the operator did not declare. Raises :class:`ValueError` with the
    offending param named.
    """
    for key, value in params.items():
        if key not in schema:
            allowed = ", ".join(sorted(schema)) or "none"
            raise ValueError(
                f"workflow {workflow!r}: param {key!r} not in schema "
                f"(allowed: {allowed})")
        spec = schema[key]
        if isinstance(spec, (list, tuple)):
            if value not in spec:
                raise ValueError(
                    f"workflow {workflow!r}: param {key!r} must be one "
                    f"of {list(spec)!r}, got {value!r}")
            continue
        if isinstance(spec, Mapping):
            tname = spec.get("type", "number")
            lo, hi = spec.get("min"), spec.get("max")
        else:
            tname, lo, hi = str(spec), None, None
        types = _TYPES.get(tname)
        if types is None:
            raise ValueError(
                f"workflow {workflow!r}: param {key!r} has unknown "
                f"schema type {tname!r}")
        # bool is an int subclass; "int"/"float" must not admit it.
        if not isinstance(value, types) or (isinstance(value, bool)
                                            and tname != "bool"):
            raise ValueError(
                f"workflow {workflow!r}: param {key!r} must be {tname}, "
                f"got {type(value).__name__}")
        if lo is not None and value < lo:
            raise ValueError(
                f"workflow {workflow!r}: param {key!r} below min "
                f"{lo!r}: {value!r}")
        if hi is not None and value > hi:
            raise ValueError(
                f"workflow {workflow!r}: param {key!r} above max "
                f"{hi!r}: {value!r}")


class TenantQuota:
    """Fleet-shared per-tenant usage ledger (storage bytes + compute s).

    The on-disk truth is ``{tenant: {"used_bytes": f, "compute_s": f}}``
    updated by read-modify-write transactions under the file lock (see
    :func:`~repro_torch.core.locking.update_json`), the same discipline as
    :class:`~repro_torch.core.locking.StorageLedger` — concurrent server
    processes (or a router's shards sharing one workdir) can never
    double-spend a quota the way in-memory tallies would.
    """

    def __init__(self, path: str):
        """Bind the ledger to its JSON file (created on first write)."""
        self.path = path

    def _get(self, blob: dict, tenant: str) -> dict:
        ent = blob.get(tenant)
        if not isinstance(ent, dict):
            ent = {"used_bytes": 0.0, "compute_s": 0.0}
            blob[tenant] = ent
        return ent

    def snapshot(self) -> dict:
        """Read the whole per-tenant usage table (JSON-safe)."""
        out = read_json(self.path, {})
        return out if isinstance(out, dict) else {}

    def bytes_used(self, tenant: str) -> float:
        """Bytes ``tenant`` currently holds reserved under its quota."""
        ent = self.snapshot().get(tenant, {})
        return float(ent.get("used_bytes", 0.0))

    def compute_used(self, tenant: str) -> float:
        """Compute seconds served to ``tenant`` so far."""
        ent = self.snapshot().get(tenant, {})
        return float(ent.get("compute_s", 0.0))

    def try_reserve_bytes(self, tenant: str, nbytes: float,
                          quota: float) -> bool:
        """Reserve ``nbytes`` against ``tenant``'s storage quota.

        Returns False — with no side effect — when the reservation
        would push the tenant past ``quota``.
        """
        ok = [False]

        def txn(blob):
            ent = self._get(blob, tenant)
            if ent["used_bytes"] + nbytes > quota:
                return None
            ok[0] = True
            ent["used_bytes"] += float(nbytes)
            return blob

        update_json(self.path, txn, {})
        return ok[0]

    def adjust_bytes(self, tenant: str, delta: float) -> None:
        """Shift ``tenant``'s reserved bytes by ``delta`` (clamped ≥ 0)."""
        if delta == 0:
            return

        def txn(blob):
            ent = self._get(blob, tenant)
            ent["used_bytes"] = max(0.0, ent["used_bytes"] + float(delta))
            return blob

        update_json(self.path, txn, {})

    def charge_compute(self, tenant: str, seconds: float) -> None:
        """Add ``seconds`` of served compute to ``tenant``'s meter."""
        if seconds <= 0:
            return

        def txn(blob):
            ent = self._get(blob, tenant)
            ent["compute_s"] += float(seconds)
            return blob

        update_json(self.path, txn, {})

    def check_compute(self, tenant: str, spec: TenantSpec) -> None:
        """Admission gate: raise :class:`QuotaExceeded` when ``tenant``
        has used up its compute-seconds quota. Called at submit time so
        an exhausted tenant gets a clean wire error instead of queueing
        work that will never be paid for."""
        if spec.compute_seconds == float("inf"):
            return
        used = self.compute_used(tenant)
        if used >= spec.compute_seconds:
            raise QuotaExceeded(tenant, "compute_seconds",
                                limit=spec.compute_seconds, used=used)


class ScopedLedger:
    """A tenant-scoped view over the fleet :class:`StorageLedger`.

    Implements the ledger surface :class:`~repro_torch.core.omp.Materializer`
    consumes (``used`` / ``try_reserve`` / ``release`` / ``adjust``)
    with two-phase semantics: a reservation must clear the tenant's own
    storage quota *first*, then the fleet budget — rolling the tenant
    side back when the fleet side refuses. Two extra methods refine the
    Materializer's behavior in tenant mode:

    ``credit_foreign``
        Bytes freed by evicting/purging entries *some other tenant*
        paid for credit the fleet ledger only — this tenant's quota
        meter must not absorb them.
    ``scope_exhausted``
        True when the refusal was the tenant quota, not the fleet
        budget: eviction frees fleet bytes, never tenant-quota room, so
        the Materializer skips evict-to-admit entirely — a
        quota-exhausted tenant can never displace a neighbor's entries
        chasing space it is not allowed to use.
    """

    def __init__(self, fleet: StorageLedger, quota: TenantQuota,
                 tenant: str, quota_bytes: float = float("inf")):
        """Compose the fleet ledger with ``tenant``'s quota meter."""
        self.fleet = fleet
        self.quota = quota
        self.tenant = tenant
        self.quota_bytes = float(quota_bytes)

    def used(self) -> float:
        """Fleet-wide used bytes (the budget the evictor reasons about)."""
        return self.fleet.used()

    def scope_exhausted(self, nbytes: float) -> bool:
        """Would ``nbytes`` exceed the *tenant* quota (fleet aside)?"""
        if self.quota_bytes == float("inf"):
            return False
        return self.quota.bytes_used(self.tenant) + float(nbytes) \
            > self.quota_bytes

    def try_reserve(self, nbytes: float, budget: float) -> bool:
        """Reserve against tenant quota then fleet budget (both or
        neither)."""
        if not self.quota.try_reserve_bytes(self.tenant, nbytes,
                                            self.quota_bytes):
            return False
        if not self.fleet.try_reserve(nbytes, budget):
            self.quota.adjust_bytes(self.tenant, -float(nbytes))
            return False
        return True

    def release(self, nbytes: float) -> None:
        """Undo one of this tenant's own reservations (both ledgers)."""
        self.fleet.release(nbytes)
        self.quota.adjust_bytes(self.tenant, -float(nbytes))

    def adjust(self, delta: float) -> None:
        """Reconcile an estimate with on-disk reality (both ledgers)."""
        self.fleet.adjust(delta)
        self.quota.adjust_bytes(self.tenant, delta)

    def credit_foreign(self, nbytes: float) -> None:
        """Credit bytes this tenant never reserved (fleet ledger only)."""
        self.fleet.release(nbytes)
