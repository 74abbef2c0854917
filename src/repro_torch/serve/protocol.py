"""Wire protocol of the session server: length-prefixed JSON frames.

Transport-agnostic (the same frames flow over a unix socket or TCP): each
frame is a 4-byte big-endian payload length followed by that many bytes of
UTF-8 JSON. One request frame yields exactly one response frame on the
same connection; connections are sequential (a client that wants parallel
submissions opens several connections or submits first and waits later —
``submit`` returns immediately with a job id).

Request messages (``op`` selects the operation)::

    {"op": "hello"}
    {"op": "submit", "workflow": <registry name>, "params": {...},
     "name": <optional job label>, "timeout": <optional s>,
     "priority": <optional int, default 0; higher dispatches first>,
     "tenant": <optional tenant id, default "default">}
    {"op": "estimate", "workflow": <registry name>, "params": {...}}
    {"op": "job",    "job": <job id>,                  # non-blocking status
     "detail": <optional bool>}
    {"op": "wait",   "job": <job id>, "timeout": <s>,  # blocks until done
     "detail": <optional bool>}
    {"op": "cancel", "job": <job id>}                  # stop queued/running
    {"op": "forget", "job": <job id>}                  # drop a finished job
    {"op": "status"}
    {"op": "multiplicity", "sig": <signature>}
    {"op": "drain",  "timeout": <optional s>}
    {"op": "shutdown"}

Responses always carry ``ok`` (bool); failures carry ``error`` (str).
``submit`` responds ``{"ok": true, "job": id}``; ``wait``/``job`` respond
with a job summary (status, timings, execution counts, JSON-coerced
outputs — see :func:`jsonable`); with ``detail: true`` the summary's
``execution`` block also lists ``computed_sigs`` /
``blind_computed_sigs`` for fleet duplicate-compute accounting. A
``wait`` that times out responds ``ok: false`` with a ``TimeoutError:``
message. The server retains the last ``max_finished_jobs`` summaries;
``forget`` releases one eagerly.

``estimate`` prices a *candidate* submission without enqueueing it:
the response carries ``total_s`` / ``marginal_s`` / ``hit_s`` /
``follow_s`` / ``queued_shared_s`` plus node counts (see
``SessionServer.estimate_marginal_cost``). The search driver orders its
frontier with this op.

Backpressure: when the server's admission queue is full (``max_queue``),
``submit`` responds ``{"ok": false, "busy": true, "retry_after": <s>,
"error": ...}`` — the request had no effect and should be retried after
``retry_after`` seconds. :class:`ServerClient` does this automatically
(bounded by its ``busy_retries``); in-process callers see
:class:`ServerBusy` raised instead. ``submit``'s optional ``timeout``
bounds the job's *running* time server-side: on expiry the job's cancel
flag fires, the executor stops between nodes, and the job reports status
``cancelled``. ``cancel`` requests the same stop explicitly for a queued
or running job (``{"ok": true, "cancelled": <bool>}``; False when the
job is unknown or already finished).

Tenancy: a server constructed with ``tenants={id: TenantSpec}`` reads
the frame's ``tenant`` field as the caller's identity (clients stamp it
on every submit; see ``connect(..., tenant=)``). A submit that an
exhausted compute quota or a workflow allowlist refuses responds
``{"ok": false, "quota_exceeded": true, "tenant": <id>,
"resource": <"compute_seconds"|"workflow">, "limit": <x>, "used": <y>,
"error": ...}`` — a clean refusal with no effect, surfaced to callers
as :class:`QuotaExceeded`. Unlike ``busy`` it is *not* retried
automatically: the quota will not free itself.

Workflows cross the wire *by registry name*: the server is constructed
with ``registry={name: factory}`` and the client submits ``(name,
params)``; the factory runs server-side. Arbitrary callables never cross
the boundary. In-process callers (tests, ``run_sweep``) can submit real
:class:`~repro_torch.core.workflow.Workflow` objects through
``SessionServer.submit`` directly.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Any

# A frame larger than this is a protocol error, not a big result: outputs
# are summarized by jsonable() before they are framed.
MAX_FRAME_BYTES = 64 * 1024 * 1024

# Array leaves up to this many elements are inlined into result summaries;
# larger ones are reported as shape/dtype stubs.
_INLINE_ARRAY_ELEMS = 64


class ProtocolError(RuntimeError):
    """A malformed or oversized frame was received."""


class ServerBusy(RuntimeError):
    """The server's bounded admission queue is full.

    The submit had no effect; retry after :attr:`retry_after` seconds.
    Raised by ``SessionServer.submit`` (and the in-process client); on
    the wire it travels as the ``busy`` response shape documented in the
    module docstring, and :class:`~repro_torch.serve.client.ServerClient`
    re-raises it once its automatic retries are exhausted.
    """

    def __init__(self, retry_after: float = 0.5):
        super().__init__(
            f"admission queue full; retry in {retry_after:g}s")
        self.retry_after = float(retry_after)


class QuotaExceeded(RuntimeError):
    """A tenant's quota (or workflow allowlist) refused a submission.

    The submit had no effect. Carries the tenant, the exhausted
    ``resource`` (``"compute_seconds"`` or ``"workflow"``), and — for
    metered resources — the ``limit``/``used`` pair. On the wire it
    travels as the ``quota_exceeded`` response shape documented in the
    module docstring; clients re-raise it and never auto-retry (unlike
    ``busy``, waiting cannot help).
    """

    def __init__(self, tenant: str, resource: str,
                 limit: float | None = None, used: float | None = None,
                 detail: str | None = None):
        msg = detail or (
            f"tenant {tenant!r} exceeded {resource} quota"
            + (f" (limit {limit:g}, used {used:g})"
               if limit is not None and used is not None else ""))
        super().__init__(msg)
        self.tenant = tenant
        self.resource = resource
        self.limit = limit
        self.used = used


def send_msg(sock: socket.socket, obj: Any) -> None:
    """Serialize ``obj`` to JSON and write one length-prefixed frame."""
    data = json.dumps(obj).encode("utf-8")
    if len(data) > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame too large: {len(data)} bytes")
    sock.sendall(struct.pack(">I", len(data)) + data)


def recv_msg(sock: socket.socket) -> Any | None:
    """Read one frame; returns the decoded object, or None on clean EOF."""
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame too large: {length} bytes")
    data = _recv_exact(sock, length)
    if data is None:
        raise ProtocolError("connection closed mid-frame")
    return json.loads(data.decode("utf-8"))


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """Read exactly ``n`` bytes. None on clean EOF at a frame boundary;
    :class:`ProtocolError` if the peer vanishes mid-frame."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                return None
            raise ProtocolError("connection closed mid-frame")
        buf += chunk
    return buf


def _tensor_to_numpy(t) -> Any:
    """A torch tensor as a host numpy array of the same values: detached,
    on the CPU, bf16 carried through its bits into exact fp32 values
    (numpy has no bf16)."""
    import numpy as np
    import torch

    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return (bits.astype(np.uint32) << 16).view(np.float32)
    return t.numpy()


def jsonable(value: Any) -> Any:
    """Best-effort JSON coercion of a workflow output for the wire.

    Scalars pass through; numpy scalars become Python numbers; small
    arrays are inlined as nested lists; large arrays (and anything else
    unserializable) become descriptive stubs. The authoritative values
    stay server-side in the store — the wire carries a *summary*.

    A torch tensor — on any device, bf16 or grad-carrying included — is
    summarized as the numpy array of the same values would be, with the
    dtype written by its numpy name (``"bfloat16"``, ``"float32"``).
    """
    import numpy as np
    import torch

    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, dict):
        return {str(k): jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [jsonable(v) for v in value]
    if isinstance(value, torch.Tensor):
        dtype = str(value.dtype).removeprefix("torch.")
        data = None
        if value.numel() <= _INLINE_ARRAY_ELEMS:
            data = _tensor_to_numpy(value).tolist()
        return {"__ndarray__": True, "shape": list(value.shape),
                "dtype": dtype, "data": data}
    if isinstance(value, np.ndarray):
        if value.size <= _INLINE_ARRAY_ELEMS:
            return {"__ndarray__": True, "shape": list(value.shape),
                    "dtype": str(value.dtype), "data": value.tolist()}
        return {"__ndarray__": True, "shape": list(value.shape),
                "dtype": str(value.dtype), "data": None}
    try:  # other array-likes
        arr = np.asarray(value)
        return jsonable(arr)
    except Exception:
        return {"__repr__": repr(value)[:256]}
