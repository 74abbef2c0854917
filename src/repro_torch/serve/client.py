"""Clients for the session server: socket-based and in-process.

:class:`ServerClient` speaks the length-prefixed JSON protocol over a unix
or TCP socket (see protocol.py); :class:`InProcessClient` drives a
:class:`~repro_torch.serve.server.SessionServer` in the same process through the
identical message handler, so tests exercise the real protocol semantics
without a socket. Both expose the same methods and return the same
JSON-shaped dicts.

Hardening (both clients):

* **Backpressure** — a ``busy`` submit response (bounded admission queue
  full) is retried automatically after the server's ``retry_after`` hint,
  up to ``busy_retries`` times; then :class:`ServerBusy` propagates.
* **Bounded RPCs** — ``timeout`` on the connect helpers puts a socket
  timeout on every send/recv, so a dead or wedged server can never hang a
  client forever. Long ``wait`` calls are transparently *chunked* into
  RPCs shorter than the socket timeout (a slow job is not a dead server).
* **Reconnect** — after any socket error the connection is considered
  poisoned (a late response would desynchronize the framing); when a
  reconnect factory is available (the connect helpers install one) the
  client dials a fresh connection and — only when the request provably
  never reached the server, or the op is idempotent — retries it once.
  A ``submit`` that may have been received is never resent (no double
  submissions); the error propagates instead.

Quickstart (the one entry point — :func:`connect` — picks the transport
from what you hand it)::

    from repro_torch.serve import SessionServer, connect

    server = SessionServer("/data/helix", registry={"census": build})
    path = server.serve_unix("/tmp/helix.sock")

    client = connect(path, timeout=30.0)   # or connect(server),
    job = client.submit("census", {"reg": 0.3})  # or connect((host, port))
    print(client.wait(job)["outputs"])
    client.close()

Direct construction of :class:`ServerClient` / :class:`InProcessClient`
(and the transport-specific ``connect_unix`` / ``connect_tcp`` helpers)
still works but is discouraged in new code: everything that consumes a
client — the search driver above all — is written against the
:class:`Client` protocol and should receive whatever :func:`connect`
returns.
"""
from __future__ import annotations

import socket
import time
from typing import Any, Callable, Mapping, Protocol, runtime_checkable

from .protocol import QuotaExceeded, ServerBusy, recv_msg, send_msg
from .server import SessionServer


@runtime_checkable
class Client(Protocol):
    """What every session-server client speaks, transport aside.

    The structural type returned by :func:`connect` and consumed by the
    search driver and examples: JSON-shaped dicts in and out, identical
    over a unix socket, TCP, or an in-process server. See
    :class:`_ClientBase` for the shared method semantics.
    """

    def hello(self) -> dict: ...            # noqa: D102 — protocol stubs;
    def submit(self, workflow: str,         # noqa: D102 — semantics live
               params: Mapping[str, Any] | None = None,     # on _ClientBase
               name: str | None = None, timeout: float | None = None,
               priority: int = 0) -> str: ...
    def estimate(self, workflow: str,  # noqa: D102
                 params: Mapping[str, Any] | None = None) -> dict: ...
    def wait(self, job: str, timeout: float | None = None,  # noqa: D102
             detail: bool = False) -> dict: ...
    def job(self, job: str, detail: bool = False) -> dict: ...  # noqa: D102
    def cancel(self, job: str) -> bool: ...                 # noqa: D102
    def forget(self, job: str) -> bool: ...                 # noqa: D102
    def status(self) -> dict: ...                           # noqa: D102
    def multiplicity(self, sig: str) -> int: ...            # noqa: D102
    def drain(self, timeout: float | None = None) -> bool: ...  # noqa: D102
    def shutdown(self) -> dict: ...                         # noqa: D102
    def close(self) -> None: ...                            # noqa: D102


class ServerError(RuntimeError):
    """The server answered ``ok: false``; the message is its ``error``."""


class _ClientBase:
    """Shared convenience methods over the raw ``op`` messages."""

    #: Automatic retries of a ``busy`` submit (bounded admission queue
    #: full) before :class:`ServerBusy` propagates to the caller.
    busy_retries: int = 8

    #: Tenant identity stamped on every submit frame (the server's
    #: ``tenants`` table resolves it; "default" when tenancy is off).
    tenant: str = "default"

    def _rpc(self, **msg: Any) -> dict:
        raise NotImplementedError

    @staticmethod
    def _check(resp: Any) -> dict:
        """Turn a raw response into a dict or the right exception."""
        if resp is None:
            raise ConnectionError("server closed the connection")
        if not resp.get("ok"):
            if resp.get("busy"):
                raise ServerBusy(float(resp.get("retry_after", 0.5)))
            if resp.get("quota_exceeded"):
                # Never auto-retried: unlike ``busy``, waiting cannot
                # free a quota — the refusal goes straight to the caller.
                raise QuotaExceeded(
                    str(resp.get("tenant", "?")),
                    str(resp.get("resource", "?")),
                    limit=resp.get("limit"), used=resp.get("used"),
                    detail=resp.get("error"))
            raise ServerError(resp.get("error", "unknown server error"))
        return resp

    def hello(self) -> dict:
        """Server identity, schedule mode, and registered workflows."""
        return self._rpc(op="hello")

    def submit(self, workflow: str, params: Mapping[str, Any]
               | None = None, name: str | None = None,
               timeout: float | None = None,
               priority: int = 0) -> str:
        """Submit a registered workflow by name; returns the job id.

        ``timeout`` bounds the job's server-side *running* time (expiry
        cancels it — status ``cancelled``); ``priority`` sets the
        dispatch class (higher dispatches first). A ``busy`` response
        (bounded admission queue full) is retried after the server's
        ``retry_after`` hint, ``busy_retries`` times, then raises
        :class:`~repro_torch.serve.protocol.ServerBusy`. A ``quota_exceeded``
        refusal raises :class:`~repro_torch.serve.protocol.QuotaExceeded`
        immediately (never retried — the quota will not free itself)."""
        attempts = 0
        while True:
            try:
                resp = self._rpc(op="submit", workflow=workflow,
                                 params=dict(params or {}), name=name,
                                 timeout=timeout, priority=priority,
                                 tenant=self.tenant)
                return resp["job"]
            except ServerBusy as e:
                attempts += 1
                if attempts > self.busy_retries:
                    raise
                time.sleep(e.retry_after)

    def estimate(self, workflow: str, params: Mapping[str, Any]
                 | None = None) -> dict:
        """Marginal-compute estimate for a candidate submission.

        Never enqueues anything: the server compiles the candidate under
        its shared nonce map and prices its unique signatures against
        the store, live leaders, and queued siblings — see
        ``SessionServer.estimate_marginal_cost`` for the returned
        fields (``marginal_s``, ``hit_s``, ``follow_s``, ...)."""
        return self._rpc(op="estimate", workflow=workflow,
                         params=dict(params or {}))

    def wait(self, job: str, timeout: float | None = None,
             detail: bool = False) -> dict:
        """Block until ``job`` finishes; returns its summary dict.

        ``detail=True`` adds the computed-signature lists (see
        ``SessionServer.job_summary``)."""
        return self._rpc(op="wait", job=job, timeout=timeout,
                         detail=detail)

    def job(self, job: str, detail: bool = False) -> dict:
        """Non-blocking job summary (``detail`` as in :meth:`wait`)."""
        return self._rpc(op="job", job=job, detail=detail)

    def cancel(self, job: str) -> bool:
        """Stop a queued or running job (cooperative: the executor
        settles leases/pins/reservations and the job reports status
        ``cancelled``). False when unknown or already finished."""
        return bool(self._rpc(op="cancel", job=job)["cancelled"])

    def forget(self, job: str) -> bool:
        """Release a finished job's server-side record (frees its
        outputs); False when unknown or still running."""
        return bool(self._rpc(op="forget", job=job)["forgotten"])

    def status(self) -> dict:
        """Server status snapshot (queue depth, slots, pool, store)."""
        return self._rpc(op="status")

    def multiplicity(self, sig: str) -> int:
        """Live cross-client multiplicity of one signature."""
        return int(self._rpc(op="multiplicity", sig=sig)["multiplicity"])

    def drain(self, timeout: float | None = None) -> bool:
        """Ask the server to stop accepting and finish live work."""
        return bool(self._rpc(op="drain", timeout=timeout)["drained"])

    def shutdown(self) -> dict:
        """Request server shutdown (graceful: submitted work finishes)."""
        return self._rpc(op="shutdown")


class ServerClient(_ClientBase):
    """Synchronous socket client: one request/response per call.

    One instance wraps one connection and is not thread-safe; concurrent
    clients each open their own (``submit`` returns immediately, so a
    single client can still keep many jobs in flight and ``wait`` on them
    in turn).

    ``timeout`` is the per-RPC socket timeout (applied to the wrapped
    socket); ``reconnect`` is a zero-arg factory returning a fresh
    *connected* socket, used to replace a connection after any socket
    error — see the module docstring for the resend rules. The
    ``connect_unix`` / ``connect_tcp`` helpers install both.
    """

    # Ops safe to resend after a connection died mid-RPC: each is a pure
    # query or naturally idempotent (cancel/forget/drain re-apply to the
    # same state; "wait" just re-waits; "estimate" never mutates).
    # "submit" is deliberately absent.
    _IDEMPOTENT = frozenset({"hello", "status", "job", "wait", "forget",
                             "multiplicity", "drain", "cancel",
                             "shutdown", "estimate"})

    def __init__(self, sock: socket.socket, *,
                 timeout: float | None = None,
                 reconnect: Callable[[], socket.socket] | None = None,
                 tenant: str = "default"):
        """Wrap a connected socket; see the class docstring for knobs."""
        self._sock = sock
        self.timeout = timeout
        self._reconnect = reconnect
        self.tenant = str(tenant)
        if timeout is not None:
            self._sock.settimeout(timeout)

    def _rpc(self, **msg: Any) -> dict:
        return self._check(self._roundtrip(msg))

    def _roundtrip(self, msg: dict) -> Any:
        """One send/recv, with a single reconnect-and-retry when safe.

        Any socket error poisons the connection (a late reply would
        desynchronize the frame stream), so it is always replaced; the
        request is *resent* only when it provably never reached the
        server (the send itself failed) or the op is idempotent — a
        ``submit`` that may have landed must error out, not run twice.
        """
        sent = False
        try:
            send_msg(self._sock, msg)
            sent = True
            return recv_msg(self._sock)
        except OSError:
            # socket.timeout is an OSError (and TimeoutError) — a recv
            # timeout lands here too and also poisons the connection.
            if self._reconnect is None:
                raise
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = self._reconnect()
            if self.timeout is not None:
                self._sock.settimeout(self.timeout)
            if sent and msg.get("op") not in self._IDEMPOTENT:
                raise
            send_msg(self._sock, msg)
            return recv_msg(self._sock)

    def wait(self, job: str, timeout: float | None = None,
             detail: bool = False) -> dict:
        """Block until ``job`` finishes; returns its summary dict.

        With a socket timeout configured, the wait is chunked into RPCs
        each shorter than that timeout, so waiting on a long job is
        indistinguishable from a sequence of quick queries — a slow
        *job* never trips the dead-*server* detector. The overall
        ``timeout`` (None = forever) still raises
        :class:`TimeoutError` exactly like the unchunked call."""
        if self.timeout is None:
            return super().wait(job, timeout, detail)
        chunk = max(0.05, self.timeout * 0.5)
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            step = chunk if left is None else min(chunk, left)
            try:
                return self._rpc(op="wait", job=job, timeout=step,
                                 detail=detail)
            except ServerError as e:
                if not str(e).startswith("TimeoutError"):
                    raise
                if left is not None and left <= chunk:
                    raise TimeoutError(str(e)) from None

    def close(self) -> None:
        """Close the connection (idempotent)."""
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ServerClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class InProcessClient(_ClientBase):
    """Protocol-faithful client for a server in the same process.

    Routes every call through ``SessionServer._handle`` — the same code
    path socket connections hit — so responses are byte-for-byte what the
    wire would carry, minus the framing (including the ``busy``
    backpressure shape, which surfaces as
    :class:`~repro_torch.serve.protocol.ServerBusy` with the same automatic
    submit retries). ``shutdown`` additionally joins the server (sockets
    get that for free from the connection handler).
    """

    def __init__(self, server: SessionServer, *,
                 tenant: str = "default"):
        """Wrap a live server; calls go through its ``_handle``."""
        self._server = server
        self.tenant = str(tenant)

    def _rpc(self, **msg: Any) -> dict:
        return self._check(self._server._handle(msg))

    def shutdown(self) -> dict:
        """Request shutdown and join the server before returning."""
        resp = super().shutdown()
        self._server.shutdown()
        return resp

    def close(self) -> None:
        """No-op (kept for interface parity with ServerClient)."""


def connect_unix(path: str, *, timeout: float | None = None,
                 tenant: str = "default") -> ServerClient:
    """Connect to a session server's unix domain socket.

    ``timeout`` (seconds) bounds every socket operation and arms the
    client's reconnect-on-error path; None keeps the legacy blocking
    behavior. ``tenant`` is stamped on every submit frame."""
    def dial() -> socket.socket:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if timeout is not None:
            sock.settimeout(timeout)
        sock.connect(path)
        return sock

    return ServerClient(dial(), timeout=timeout, reconnect=dial,
                        tenant=tenant)


def connect_tcp(host: str, port: int, *, timeout: float | None = None,
                tenant: str = "default") -> ServerClient:
    """Connect to a session server's TCP endpoint.

    ``timeout`` (seconds) bounds every socket operation and arms the
    client's reconnect-on-error path; None keeps the legacy blocking
    behavior. ``tenant`` is stamped on every submit frame."""
    def dial() -> socket.socket:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        if timeout is not None:
            sock.settimeout(timeout)
        sock.connect((host, port))
        return sock

    return ServerClient(dial(), timeout=timeout, reconnect=dial,
                        tenant=tenant)


def connect(target: "SessionServer | Client | str | tuple[str, int]", *,
            timeout: float | None = None,
            tenant: str = "default") -> Client:
    """One entry point for every transport; returns a :class:`Client`.

    Dispatch on ``target``:

    * a live :class:`~repro_torch.serve.server.SessionServer` → in-process
      client (the protocol handler is exercised, no socket);
    * ``(host, port)`` tuple → TCP;
    * ``"host:port"`` string → TCP;
    * any other string → unix-domain socket path;
    * an existing client — anything structurally satisfying
      :class:`Client`, including a
      :class:`~repro_torch.serve.router.FleetRouter` — → returned unchanged
      (lets APIs accept "server, address, router, or client" uniformly —
      the search driver does).

    ``timeout`` is forwarded to the socket transports (per-RPC bound +
    reconnect-on-error, see :func:`connect_unix`); it is meaningless —
    and ignored — for the in-process transport. ``tenant`` is the
    identity stamped on every submit (ignored for an existing client,
    which keeps its own).
    """
    if isinstance(target, SessionServer):
        return InProcessClient(target, tenant=tenant)
    if isinstance(target, _ClientBase):
        return target
    if isinstance(target, tuple) and len(target) == 2:
        return connect_tcp(str(target[0]), int(target[1]), timeout=timeout,
                           tenant=tenant)
    if isinstance(target, str):
        host, sep, port = target.rpartition(":")
        if sep and port.isdigit() and host and "/" not in host:
            return connect_tcp(host, int(port), timeout=timeout,
                               tenant=tenant)
        return connect_unix(target, timeout=timeout, tenant=tenant)
    if isinstance(target, Client):
        # Structural match (runtime_checkable Protocol): a FleetRouter
        # or any client-shaped object passes through unchanged.
        return target
    raise TypeError(
        f"connect() expects a SessionServer, client, address string, or "
        f"(host, port) tuple; got {type(target).__name__}")
