"""The session-server layer: one long-running process per host multiplexes
many clients' workflow submissions onto one shared store, schedules them
with global knowledge (shared-prefix-first, live signature multiplicity
feeding OMP's amortization), and shares one elastic executor worker pool
across all hosted sessions. Multi-tenancy (tenancy.py) adds per-tenant
quotas, fair-share dispatch, and workflow allowlists; the fleet router
(router.py) shards N servers behind one Client with consistent-hash
prefix routing. See docs/architecture.md for the layer map."""
from .client import (Client, InProcessClient, ServerClient, ServerError,
                     connect, connect_tcp, connect_unix)
from .pool import SharedWorkerPool
from .protocol import (ProtocolError, QuotaExceeded, ServerBusy, jsonable,
                       recv_msg, send_msg)
from .router import FleetRouter, rendezvous
from .scheduler import PrefixScheduler, TenantScheduler
from .server import Job, SessionServer, SharedNonces
from .tenancy import ScopedLedger, TenantQuota, TenantSpec, validate_params

__all__ = [
    "Client", "InProcessClient", "ServerClient", "ServerError",
    "connect", "connect_tcp", "connect_unix",
    "SharedWorkerPool",
    "ProtocolError", "QuotaExceeded", "ServerBusy", "jsonable",
    "recv_msg", "send_msg",
    "PrefixScheduler", "TenantScheduler",
    "Job", "SessionServer", "SharedNonces",
    "FleetRouter", "rendezvous",
    "ScopedLedger", "TenantQuota", "TenantSpec", "validate_params",
]
