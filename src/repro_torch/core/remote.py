"""Remote materialization tier — fleet-wide sharing across hosts.

The fleet machinery (flock compute leases, shared ledger, benefit
eviction) stops at one filesystem. This module adds a second storage tier
behind the same signature-keyed API so *hosts* share materializations:

* :class:`ObjectStore` — the narrow backend contract (put / get / list /
  delete / conditional-put), deliberately S3/GCS-shaped so a cloud bucket
  adapter is a ~40-line class. :class:`FsObjectStore` is the reference
  implementation: a shared mounted directory standing in for the bucket,
  with ``os.replace`` for atomic whole-object puts and a hard-link trick
  for the conditional put.
* :class:`RemoteStore` — the tier itself: entries live under
  ``entries/<sig>/<file>`` with a ``.complete`` marker uploaded *last*
  (the commit point — readers that don't see the marker don't see the
  entry, so a crashed upload is invisible, never torn). The local
  :class:`~repro_torch.core.store.Store` treats it as a write-through /
  read-through cache (upload after local publish, fetch on local miss).
* **TTL leases** — ``flock`` has no cross-host analogue, so remote
  compute leases, read pins, and waiter markers are *lease objects*:
  small JSONs acquired by conditional-put, renewed by a heartbeat
  thread, and considered released the moment their ``expires`` stamp
  passes. Expiry is the crash-release story: a dead host's leases
  evaporate after one TTL instead of wedging the fleet. The worst case
  of a lease race (two hosts both observe an expired lease and race the
  takeover) is one duplicate compute — never corruption, because entry
  publication is idempotent (same signature ⇒ same value) and committed
  atomically by the marker.
* **Budget + eviction** — the remote tier has its *own* byte budget,
  independent of any host's local cache budget. Uploads that do not fit
  evict the lowest-benefit remote entries first (same
  ``(C/l)·(1+reuse)`` density as eviction.py, ranked from the metadata
  each ``.complete`` marker carries) — but never an entry with a live
  remote lease or read pin, and never for an upload less valuable than
  the candidates (the local evictor's limit-density rule, transposed).
* **Error classification + recovery** — backend errors are two kinds.
  *Transient* ones (:class:`TransientBackendError`: throttles, 5xx,
  connection resets — an adapter raises it for anything worth retrying)
  are retried in place with exponential backoff + jitter and never
  degrade the tier unless retries exhaust. Anything else (*permanent*
  for the purposes of this window: auth failures, dead mounts,
  exhausted retries) marks the tier degraded: every caller sees
  "remote absent" and the host keeps working local-only. Degradation
  is a cool-down that *re-probes*: after the window a single cheap
  health probe runs before the tier is declared usable again, and a
  failing probe re-degrades with an escalating (capped) window — so a
  dead backend costs one probe per window, not one failed real
  operation per caller (see docs/operations.md, failure modes).

Clock caveat: TTL expiry compares the *reader's* clock against the
*writer's* ``expires`` stamp, so lease TTLs must comfortably exceed
worst-case clock skew plus heartbeat jitter (see docs/operations.md for
tuning guidance; the default TTL is 60 s with renewal every TTL/3).
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import socket
import threading
import time
import uuid
from typing import Any

# Objects smaller than this are read/written whole with no streaming —
# everything here qualifies except entry leaves, which are still small
# enough (host-memory materializations) that whole-object I/O is fine.
_LEASE_PREFIX = "leases/"
_ENTRY_PREFIX = "entries/"
_MARKER = ".complete"
# Key probed (a cheap existence check) by the post-degradation health
# re-probe; it never needs to exist — the probe only asks whether the
# backend *answers*.
_HEALTH_KEY = "health/probe"


class TransientBackendError(OSError):
    """A backend failure worth retrying in place (throttle, 5xx,
    connection reset). :class:`RemoteStore` retries these with
    exponential backoff + jitter instead of degrading the tier;
    adapters over real object stores should raise it for any error
    their SDK classifies as retryable. Every other ``OSError`` is
    treated as permanent for the current degradation window."""


class ObjectStore:
    """Minimal object-store contract the remote tier speaks.

    Five operations, all S3/GCS-expressible: ``put`` (atomic
    whole-object visibility), ``get``, ``list`` (prefix scan),
    ``delete``, and ``put_if_absent`` (conditional put — S3
    ``If-None-Match:*`` / GCS ``ifGenerationMatch=0``). ``exists`` has a
    default implementation via ``get`` but backends should override it
    with a HEAD-style probe. Implementations raise ``OSError`` on
    backend failure; :class:`RemoteStore` converts that into local-only
    degradation.
    """

    def put(self, key: str, data: bytes) -> None:
        """Store ``data`` under ``key``, replacing any existing object."""
        raise NotImplementedError

    def get(self, key: str) -> bytes | None:
        """Return the object's bytes, or None when the key is absent."""
        raise NotImplementedError

    def list(self, prefix: str) -> list[str]:
        """All keys starting with ``prefix`` (sorted)."""
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        """Remove ``key``; returns False when it was already absent."""
        raise NotImplementedError

    def put_if_absent(self, key: str, data: bytes) -> bool:
        """Atomically create ``key`` iff it does not exist (the
        conditional put every lease acquisition builds on). Returns
        False when the key is already present."""
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        """Cheap presence probe (default: a full ``get``)."""
        return self.get(key) is not None

    def mtime(self, key: str) -> float | None:
        """Last-modified epoch seconds, or None when the backend cannot
        say (then age-gated maintenance like ``gc_orphans`` must skip
        the object). S3/GCS adapters return the object's LastModified."""
        return None


class FsObjectStore(ObjectStore):
    """Filesystem-backed reference backend (a shared mount as bucket).

    Keys map to files under ``root`` (``/`` separators become
    directories). ``put`` stages a sibling temp file and ``os.replace``s
    it in, so readers only ever see whole objects — the same atomic-put
    semantics a real object store gives. ``put_if_absent`` writes the
    temp file and ``os.link``s it to the target: the link fails with
    ``EEXIST`` when the key exists, and on success the full content
    appears atomically (an ``O_EXCL`` create would expose a torn,
    partially written lease to concurrent readers).
    """

    def __init__(self, root: str):
        """Create the backend over ``root`` (created if missing)."""
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        # Keys are repo-internal (signatures + fixed prefixes); reject
        # anything that could escape the root.
        if key.startswith(("/", "../")) or "/../" in key:
            raise ValueError(f"invalid object key {key!r}")
        return os.path.join(self.root, *key.split("/"))

    def _tmp(self, path: str) -> str:
        return (f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
                f"-{uuid.uuid4().hex[:8]}")

    def put(self, key: str, data: bytes) -> None:
        """Atomic whole-object put (temp file + ``os.replace``)."""
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = self._tmp(path)
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def get(self, key: str) -> bytes | None:
        """Whole-object read; None when absent."""
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except (FileNotFoundError, NotADirectoryError, IsADirectoryError):
            return None

    def list(self, prefix: str) -> list[str]:
        """Prefix scan over the tree rooted at the prefix's directory."""
        # Walk the deepest existing directory the prefix names, then
        # filter — mirrors an object store's flat prefix listing.
        base_dir = os.path.dirname(self._path(prefix + "x"))
        out: list[str] = []
        for dirpath, _dirs, files in os.walk(base_dir):
            for name in files:
                if ".tmp-" in name:
                    continue
                full = os.path.join(dirpath, name)
                key = os.path.relpath(full, self.root).replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> bool:
        """Unlink the object; False when it was already gone."""
        try:
            os.unlink(self._path(key))
            return True
        except (FileNotFoundError, NotADirectoryError):
            return False

    def put_if_absent(self, key: str, data: bytes) -> bool:
        """Conditional put via hard link (atomic, full-content)."""
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = self._tmp(path)
        with open(tmp, "wb") as f:
            f.write(data)
        try:
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def exists(self, key: str) -> bool:
        """stat-based presence probe (the HEAD request analogue)."""
        return os.path.isfile(self._path(key))

    def mtime(self, key: str) -> float | None:
        """File modification time (None when the key is absent)."""
        try:
            return os.stat(self._path(key)).st_mtime
        except OSError:
            return None


class _RetryingStore(ObjectStore):
    """Transparent transient-error retry decorator over a backend.

    Retries :class:`TransientBackendError` with exponential backoff +
    jitter, up to ``max_retries`` extra attempts, then re-raises (the
    caller's degradation handling takes over). Non-transient errors
    pass straight through. Jitter decorrelates N hosts hammering a
    throttled backend in lockstep.

    Retry caveat (shared with every at-least-once client): a request
    that *succeeded* backend-side but whose response was lost is
    retried. All tier operations tolerate that — puts are idempotent
    whole-object writes, deletes return False, and a retried
    ``put_if_absent`` that loses to its own first attempt reports
    "already present", which the lease protocol treats as "someone
    holds it" and resolves via the TTL.
    """

    def __init__(self, inner: ObjectStore, stats: "RemoteStats",
                 max_retries: int = 3, backoff: float = 0.05,
                 backoff_cap: float = 2.0):
        """Wrap ``inner``; retry counts accumulate on ``stats``."""
        self.inner = inner
        self.stats = stats
        self.max_retries = max(0, int(max_retries))
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self._rng = random.Random()   # jitter only — no determinism need

    def _call(self, op: str, *args):
        delay = self.backoff
        attempt = 0
        while True:
            try:
                return getattr(self.inner, op)(*args)
            except TransientBackendError:
                if attempt >= self.max_retries:
                    raise
                attempt += 1
                self.stats.n_retries += 1
                # Full jitter on an exponential schedule.
                time.sleep(delay * (0.5 + self._rng.random()))
                delay = min(delay * 2.0, self.backoff_cap)

    def put(self, key: str, data: bytes) -> None:
        """Retrying ``put``."""
        return self._call("put", key, data)

    def get(self, key: str) -> bytes | None:
        """Retrying ``get``."""
        return self._call("get", key)

    def list(self, prefix: str) -> list[str]:
        """Retrying ``list``."""
        return self._call("list", prefix)

    def delete(self, key: str) -> bool:
        """Retrying ``delete``."""
        return self._call("delete", key)

    def put_if_absent(self, key: str, data: bytes) -> bool:
        """Retrying conditional put (see class docstring's caveat)."""
        return self._call("put_if_absent", key, data)

    def exists(self, key: str) -> bool:
        """Retrying presence probe."""
        return self._call("exists", key)

    def mtime(self, key: str) -> float | None:
        """Retrying mtime probe."""
        return self._call("mtime", key)


@dataclasses.dataclass
class RemoteStats:
    """Counters for one remote tier handle's lifetime."""

    n_uploads: int = 0          # entries committed remotely by this host
    n_upload_refused: int = 0   # uploads dropped (budget unfreeable)
    n_fetches: int = 0          # entries fetched on local miss
    n_evicted: int = 0          # remote entries this host evicted
    bytes_evicted: int = 0      # their recorded bytes
    n_veto_protected: int = 0   # eviction candidates with live lease/pin
    n_errors: int = 0           # backend OSErrors (→ degradation windows)
    n_retries: int = 0          # transient-error retries (backoff layer)
    n_recoveries: int = 0       # successful post-degradation re-probes

    def snapshot(self) -> dict:
        """JSON-safe copy (server status / benchmark reporting)."""
        return dataclasses.asdict(self)


class RemoteLease:
    """A held TTL lease object (compute lease, read pin, or waiter).

    Renewed by the owning :class:`RemoteStore`'s heartbeat thread while
    held; :meth:`release` deletes the object. ``lost`` flips to True if
    a renewal finds the object taken over (our TTL expired — e.g. a long
    GC pause); the holder's work stays correct (publication is
    idempotent) but it no longer excludes other hosts.
    """

    def __init__(self, remote: "RemoteStore", key: str, kind: str):
        self._remote = remote
        self.key = key
        self.kind = kind
        self.lost = False
        self._released = False

    def release(self) -> None:
        """Delete the lease object and stop renewing it (idempotent)."""
        if self._released:
            return
        self._released = True
        self._remote._drop_lease(self)

    def __enter__(self) -> "RemoteLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class RemoteStore:
    """The shared cross-host materialization tier over an ObjectStore.

    One instance per host process (it owns that host's heartbeat thread
    and lease identity); many instances — across hosts — share one
    backend. See the module docstring for the protocol; the local
    :class:`~repro_torch.core.store.Store` is the only intended caller of the
    entry/lease methods (pass ``remote=`` to its constructor).

    ``budget_bytes`` bounds the remote tier independently of any local
    cache budget; ``lease_ttl`` is the crash-release horizon (renewals
    every ``lease_ttl / 3`` while held; ``heartbeats=False`` disables
    renewal — for tests that simulate a crashed holder).
    """

    def __init__(self, objects: ObjectStore, *,
                 budget_bytes: float = float("inf"),
                 lease_ttl: float = 60.0,
                 heartbeats: bool = True,
                 degrade_seconds: float = 30.0,
                 degrade_max_seconds: float | None = None,
                 max_retries: int = 3,
                 retry_backoff: float = 0.05,
                 owner: str | None = None,
                 faults: Any | None = None):
        """Open a per-host handle on the shared tier (see class doc).

        ``max_retries`` / ``retry_backoff`` tune the transient-error
        retry layer (attempts beyond the first, and its initial backoff
        — exponential with jitter). ``degrade_seconds`` is the first
        degradation window after a permanent error; consecutive failed
        re-probes double it up to ``degrade_max_seconds`` (default
        8 × ``degrade_seconds``).

        ``faults`` (tests only) is a :class:`~repro_torch.core.faults
        .FaultPlan` consulted at the named crash points of the
        publish/lease/heartbeat paths — ``upload:begin``,
        ``upload:before_marker`` (between "value uploaded" and "marker
        uploaded"), ``upload:after_marker``, ``lease:acquired``,
        ``lease:before_release``, ``delete:after_marker`` — and before
        each heartbeat renewal (:meth:`FaultPlan.drop_heartbeat`).
        """
        self.stats = RemoteStats()
        self.objects: ObjectStore = _RetryingStore(
            objects, self.stats, max_retries=max_retries,
            backoff=retry_backoff)
        self.budget_bytes = float(budget_bytes)
        self.lease_ttl = float(lease_ttl)
        self.heartbeats = bool(heartbeats)
        self.degrade_seconds = float(degrade_seconds)
        self.degrade_max_seconds = (float(degrade_max_seconds)
                                    if degrade_max_seconds is not None
                                    else 8.0 * self.degrade_seconds)
        self.owner = owner or (f"{socket.gethostname()}-{os.getpid()}"
                               f"-{uuid.uuid4().hex[:8]}")
        self._faults = faults
        self._lock = threading.Lock()
        self._held: dict[str, RemoteLease] = {}
        self._hb_thread: threading.Thread | None = None
        self._hb_stop = threading.Event()
        self._degraded_until = 0.0
        self._degrade_streak = 0        # consecutive windows, resets on probe
        self._probe_pending = False     # degraded at least once; must re-probe
        self._probe_lock = threading.Lock()
        self._closed = False
        # Marker metadata cache: sig -> (stamp, meta | None). Presence
        # probes and rankings hit this instead of the backend; negatives
        # expire fast (a sibling may publish any moment), positives
        # slower (they only go stale through remote eviction, which the
        # fetch path detects and heals by invalidating).
        self._marker_cache: dict[str, tuple[float, dict | None]] = {}
        self._pos_ttl = 15.0
        self._neg_ttl = 2.0
        # Tier byte-total cache: (monotonic stamp, total). A full
        # recount is one list + one get per marker — O(entries) backend
        # round-trips — so budgeted uploads must not pay it every time;
        # own uploads/deletes adjust the cached number in place.
        self._bytes_cache: tuple[float, int] | None = None
        self._bytes_ttl = 10.0

    # -- degradation / recovery --------------------------------------------
    def available(self) -> bool:
        """Is the tier currently usable (not in a degradation window)?

        After a degradation window passes, the first caller runs a
        cheap health probe against the backend before the tier is
        declared usable again (the *re-probe and recover* path): a
        failing probe re-degrades with an escalating window, so a dead
        backend costs one probe per window instead of a failed real
        operation per caller."""
        if self._closed or time.monotonic() < self._degraded_until:
            return False
        if not self._probe_pending:
            return True
        return self._reprobe()

    def _reprobe(self) -> bool:
        """One health probe after a degradation window (single-flight:
        concurrent callers treat the tier as still-degraded while one
        probes). True iff the backend answered and the tier recovered."""
        if not self._probe_lock.acquire(blocking=False):
            return False
        try:
            if not self._probe_pending:      # a racer already recovered us
                return True
            try:
                self.objects.exists(_HEALTH_KEY)
            except OSError as e:
                self._degrade(e)
                return False
            self._probe_pending = False
            self._degrade_streak = 0
            self.stats.n_recoveries += 1
            return True
        finally:
            self._probe_lock.release()

    def _degrade(self, exc: BaseException) -> None:
        self.stats.n_errors += 1
        self._degrade_streak += 1
        window = min(
            self.degrade_seconds * (2.0 ** (self._degrade_streak - 1)),
            self.degrade_max_seconds)
        self._degraded_until = time.monotonic() + window
        self._probe_pending = True

    def _crash_point(self, name: str) -> None:
        """Fire an armed test crash point (no-op without a fault plan)."""
        if self._faults is not None:
            self._faults.crash_point(name)

    # -- lease objects -----------------------------------------------------
    def _lease_key(self, sig: str) -> str:
        return f"{_LEASE_PREFIX}{sig}.lease"

    def _lease_blob(self, kind: str) -> bytes:
        return json.dumps({"owner": self.owner, "kind": kind,
                           "expires": time.time() + self.lease_ttl}
                          ).encode()

    def _read_obj(self, key: str) -> dict | None:
        raw = self.objects.get(key)
        if raw is None:
            return None
        try:
            obj = json.loads(raw)
            return obj if isinstance(obj, dict) else None
        except (ValueError, UnicodeDecodeError):
            return None

    @staticmethod
    def _live(obj: dict | None) -> bool:
        if obj is None:
            return False
        try:
            return float(obj.get("expires", 0.0)) >= time.time()
        except (TypeError, ValueError):
            return False

    def _track(self, lease: RemoteLease) -> RemoteLease:
        with self._lock:
            self._held[lease.key] = lease
            if (self.heartbeats and (self._hb_thread is None
                                     or not self._hb_thread.is_alive())):
                self._hb_stop.clear()
                self._hb_thread = threading.Thread(
                    target=self._heartbeat_loop, name="helix-remote-hb",
                    daemon=True)
                self._hb_thread.start()
        return lease

    def _drop_lease(self, lease: RemoteLease) -> None:
        with self._lock:
            self._held.pop(lease.key, None)
        if lease.lost:
            return  # not ours anymore: deleting would break the taker
        self._crash_point("lease:before_release")
        try:
            cur = self._read_obj(lease.key)
            if cur is not None and cur.get("owner") == self.owner:
                self.objects.delete(lease.key)
        except OSError as e:
            self._degrade(e)   # expiry will release it for us

    def _heartbeat_loop(self) -> None:
        interval = max(self.lease_ttl / 3.0, 0.02)
        while not self._hb_stop.wait(interval):
            with self._lock:
                if not self._held:
                    # Idle exit decided UNDER the lock, clearing the
                    # thread ref in the same critical section — so a
                    # _track racing this exit either sees _held non-empty
                    # here (we keep running) or sees _hb_thread None and
                    # spawns a fresh thread. Deciding outside the lock
                    # would strand a just-acquired lease unrenewed until
                    # it silently expired one TTL later.
                    self._hb_thread = None
                    return
                held = list(self._held.values())
            if (self._faults is not None
                    and self._faults.drop_heartbeat()):
                continue   # injected GC pause: skip this renewal round
            for lease in held:
                if lease.lost or lease._released:
                    continue
                try:
                    cur = self._read_obj(lease.key)
                    if cur is not None and cur.get("owner") != self.owner:
                        lease.lost = True   # expired under us; taken over
                        with self._lock:
                            self._held.pop(lease.key, None)
                        continue
                    self.objects.put(lease.key, self._lease_blob(lease.kind))
                except OSError as e:
                    self._degrade(e)  # keep trying: expiry is the backstop

    def acquire_compute(self, sig: str) -> RemoteLease | None:
        """Take the fleet-wide (cross-host) compute lease for ``sig``.

        Conditional-put acquisition; an expired lease (dead holder) is
        taken over by delete + retry. Returns None when another live
        holder exists *or* the tier is degraded — the local store then
        proceeds local-only, which at worst duplicates one compute.
        """
        if not self.available():
            return None
        key = self._lease_key(sig)
        try:
            for _ in range(2):
                if self.objects.put_if_absent(key,
                                              self._lease_blob("compute")):
                    # Crash point: the lease object exists but the
                    # holder dies before tracking/heartbeating it — the
                    # canonical crashed-holder scenario (released by TTL
                    # expiry + takeover, never by this process).
                    self._crash_point("lease:acquired")
                    return self._track(RemoteLease(self, key, "compute"))
                cur = self._read_obj(key)
                if self._live(cur):
                    return None
                # Stale (holder crashed / heartbeat stopped): reclaim.
                # Two hosts may race this delete+put; exactly one wins
                # the conditional put, the other re-reads a live lease.
                self.objects.delete(key)
            return None
        except OSError as e:
            self._degrade(e)
            return None

    def lease_live(self, sig: str, ours: bool = True) -> bool:
        """Is a compute lease on ``sig`` currently live? With
        ``ours=False``, a lease this handle owns doesn't count."""
        if not self.available():
            return False
        try:
            cur = self._read_obj(self._lease_key(sig))
        except OSError as e:
            self._degrade(e)
            return False
        if not self._live(cur):
            return False
        return ours or cur.get("owner") != self.owner

    def acquire_pin(self, sig: str) -> RemoteLease | None:
        """Pin ``sig`` against *remote* eviction (TTL read pin).

        Any number of pins coexist (each is its own object); they block
        remote eviction, not remote reads. None when degraded."""
        if not self.available():
            return None
        key = f"{_LEASE_PREFIX}{sig}.pin-{uuid.uuid4().hex}"
        try:
            self.objects.put(key, self._lease_blob("pin"))
        except OSError as e:
            self._degrade(e)
            return None
        return self._track(RemoteLease(self, key, "pin"))

    def register_waiter(self, sig: str) -> RemoteLease | None:
        """Register this host as waiting on ``sig``'s compute lease, so
        the holder force-persists the result (see Store.wait_compute).
        TTL-scoped like every lease object; None when degraded."""
        if not self.available():
            return None
        key = f"{_LEASE_PREFIX}{sig}.w-{uuid.uuid4().hex}"
        try:
            self.objects.put(key, self._lease_blob("waiter"))
        except OSError as e:
            self._degrade(e)
            return None
        return self._track(RemoteLease(self, key, "waiter"))

    def _live_objects(self, prefix: str, reap: bool = True) -> int:
        """Count live lease objects under ``prefix``, best-effort
        deleting expired ones (the TTL janitor — every counter doubles
        as cleanup, so dead hosts' leases don't accumulate)."""
        n = 0
        for key in self.objects.list(prefix):
            obj = self._read_obj(key)
            if self._live(obj):
                n += 1
            elif reap:
                try:
                    self.objects.delete(key)
                except OSError:
                    pass
        return n

    def count_waiters(self, sig: str) -> int:
        """Live cross-host waiter markers for ``sig``."""
        if not self.available():
            return 0
        try:
            return self._live_objects(f"{_LEASE_PREFIX}{sig}.w-")
        except OSError as e:
            self._degrade(e)
            return 0

    def pinned(self, sig: str) -> bool:
        """Any live read pin on ``sig``?"""
        if not self.available():
            return False
        try:
            return self._live_objects(f"{_LEASE_PREFIX}{sig}.pin-") > 0
        except OSError as e:
            self._degrade(e)
            return False

    def protected(self, sig: str) -> bool:
        """Eviction veto: live compute lease, read pin, or waiter on
        ``sig``. Remote eviction must never delete a protected entry —
        some host is mid-plan or mid-compute on it right now."""
        return (self.lease_live(sig) or self.pinned(sig)
                or self.count_waiters(sig) > 0)

    def lease_counts(self) -> dict:
        """Live lease-object census: ``{"compute", "pins", "waiters"}``
        (the observability surface docs/operations.md points at)."""
        out = {"compute": 0, "pins": 0, "waiters": 0}
        if not self.available():
            return out
        try:
            now = time.time()
            for key in self.objects.list(_LEASE_PREFIX):
                obj = self._read_obj(key)
                if obj is None:
                    continue
                try:
                    live = float(obj.get("expires", 0.0)) >= now
                except (TypeError, ValueError):
                    live = False
                if not live:
                    continue
                kind = obj.get("kind")
                if kind == "compute":
                    out["compute"] += 1
                elif kind == "pin":
                    out["pins"] += 1
                elif kind == "waiter":
                    out["waiters"] += 1
        except OSError as e:
            self._degrade(e)
        return out

    # -- entries -----------------------------------------------------------
    def _marker_key(self, sig: str) -> str:
        return f"{_ENTRY_PREFIX}{sig}/{_MARKER}"

    def _invalidate(self, sig: str) -> None:
        with self._lock:
            self._marker_cache.pop(sig, None)

    def marker_meta(self, sig: str, fresh: bool = False) -> dict | None:
        """The entry's commit-marker metadata (name/nbytes/benefit
        stats), or None when the entry is not committed remotely.
        Cached (positives ~15 s, negatives ~2 s); ``fresh`` bypasses."""
        if not self.available():
            return None
        now = time.monotonic()
        if not fresh:
            with self._lock:
                hit = self._marker_cache.get(sig)
            if hit is not None:
                stamp, meta = hit
                ttl = self._pos_ttl if meta is not None else self._neg_ttl
                if now - stamp < ttl:
                    return meta
        try:
            meta = self._read_obj(self._marker_key(sig))
        except OSError as e:
            self._degrade(e)
            return None
        with self._lock:
            self._marker_cache[sig] = (now, meta)
        return meta

    def exists(self, sig: str) -> bool:
        """Is ``sig`` committed in the remote tier?"""
        return self.marker_meta(sig) is not None

    def entries(self) -> dict[str, dict]:
        """Committed remote entries by signature (marker metadata)."""
        out: dict[str, dict] = {}
        if not self.available():
            return out
        try:
            for key in self.objects.list(_ENTRY_PREFIX):
                if not key.endswith("/" + _MARKER):
                    continue
                sig = key[len(_ENTRY_PREFIX):-(len(_MARKER) + 1)]
                meta = self._read_obj(key)
                if meta is not None:
                    out[sig] = meta
        except OSError as e:
            self._degrade(e)
        return out

    def _bytes_adjust(self, delta: int) -> None:
        with self._lock:
            if self._bytes_cache is not None:
                stamp, total = self._bytes_cache
                self._bytes_cache = (stamp, max(0, total + delta))

    def total_bytes(self, fresh: bool = False) -> int:
        """Sum of committed remote entries' recorded bytes.

        Served from a short-lived cache adjusted by this handle's own
        uploads/deletes (a recount is O(entries) backend reads — the
        budget check on every upload must not pay that); ``fresh``
        forces the recount. Siblings' concurrent uploads can make the
        cached number stale by up to the TTL — the budget is enforced
        approximately across hosts either way (there is no fleet
        ledger object; see docs/operations.md)."""
        now = time.monotonic()
        if not fresh:
            with self._lock:
                if (self._bytes_cache is not None
                        and now - self._bytes_cache[0] < self._bytes_ttl):
                    return self._bytes_cache[1]
        total = sum(int(m.get("nbytes", 0) or 0)
                    for m in self.entries().values())
        with self._lock:
            self._bytes_cache = (now, total)
        return total

    def upload(self, sig: str, local_dir: str, meta: dict) -> bool:
        """Write-through one locally published entry (idempotent).

        Reads the entry's files from ``local_dir`` (a concurrent local
        eviction aborts the upload harmlessly — uncommitted remote
        objects are invisible), uploads them, and commits by putting the
        ``.complete`` marker last. The marker carries the benefit
        metadata remote eviction ranks on. Over-budget uploads evict
        lowest-benefit unprotected remote entries first; if the deficit
        cannot be freed the upload is refused (local-only entry).
        """
        if not self.available():
            return False
        try:
            if self.objects.exists(self._marker_key(sig)):
                return True   # some host already committed it
            self._crash_point("upload:begin")
            nbytes = int(meta.get("nbytes", 0) or 0)
            if self.budget_bytes != float("inf"):
                from .eviction import benefit_density  # local: no cycle
                deficit = self.total_bytes() + nbytes - self.budget_bytes
                # The upload's own density is the eviction limit: never
                # delete remote entries at least this valuable to admit
                # it (the local evictor's limit rule, transposed).
                # Entries without cost metadata score 0 and may evict
                # nothing — a worthless upload never displaces anything.
                own = benefit_density(
                    float(meta.get("compute_s", 0) or 0),
                    float(meta.get("load_s_est", 0) or 0)
                    or max(nbytes, 1) / 500e6, 0.0)
                if deficit > 0 and \
                        self.evict_to_fit(deficit,
                                          limit_density=own) < deficit:
                    self.stats.n_upload_refused += 1
                    return False
            try:
                names = [n for n in os.listdir(local_dir)
                         if n != _MARKER and ".tmp-" not in n]
            except OSError:
                return False   # entry evicted locally mid-upload
            for name in names:
                try:
                    with open(os.path.join(local_dir, name), "rb") as f:
                        data = f.read()
                except OSError:
                    return False   # local eviction raced us: abort
                self.objects.put(f"{_ENTRY_PREFIX}{sig}/{name}", data)
            # Crash point: every data object uploaded, marker not yet —
            # the torn-publish window the commit protocol exists for.
            # A crash here leaves only invisible orphans (gc_orphans
            # reclaims them); readers never see a partial entry.
            self._crash_point("upload:before_marker")
            marker = {k: meta.get(k) for k in
                      ("name", "nbytes", "created", "compute_s",
                       "load_s_est") if k in meta}
            marker["files"] = names
            marker["uploaded_by"] = self.owner
            marker["uploaded_at"] = time.time()
            self.objects.put(self._marker_key(sig),
                             json.dumps(marker).encode())
            self._crash_point("upload:after_marker")
            self._invalidate(sig)
            self._bytes_adjust(nbytes)
            self.stats.n_uploads += 1
            return True
        except OSError as e:
            self._degrade(e)
            return False

    def fetch(self, sig: str, dest_dir: str) -> dict | None:
        """Read-through: download entry ``sig``'s files into
        ``dest_dir``. Returns the entry's ``meta.json`` dict, or None
        when the entry is absent/evicted-mid-fetch (then ``dest_dir`` is
        left incomplete and the caller discards it)."""
        if not self.available():
            return None
        try:
            marker = self.marker_meta(sig, fresh=True)
            if marker is None:
                return None
            names = marker.get("files") or [
                k[len(f"{_ENTRY_PREFIX}{sig}/"):]
                for k in self.objects.list(f"{_ENTRY_PREFIX}{sig}/")
                if not k.endswith("/" + _MARKER)]
            os.makedirs(dest_dir, exist_ok=True)
            meta: dict | None = None
            for name in names:
                data = self.objects.get(f"{_ENTRY_PREFIX}{sig}/{name}")
                if data is None:       # evicted mid-fetch
                    self._invalidate(sig)
                    return None
                if name == "meta.json":
                    try:
                        meta = json.loads(data)
                    except ValueError:
                        return None
                with open(os.path.join(dest_dir, name), "wb") as f:
                    f.write(data)
            if meta is None:
                return None
            self.stats.n_fetches += 1
            return meta
        except OSError as e:
            self._degrade(e)
            return None

    def delete_entry(self, sig: str, respect_leases: bool = True) -> int:
        """Remove a remote entry; returns its recorded bytes (0 if
        absent or — with ``respect_leases`` — protected by a live
        lease/pin/waiter). The marker is deleted *first* (atomic
        un-publish); data objects follow. A crash in between leaves
        invisible orphans for :meth:`gc_orphans`."""
        if not self.available():
            return 0
        try:
            if respect_leases and self.protected(sig):
                self.stats.n_veto_protected += 1
                return 0
            marker = self.marker_meta(sig, fresh=True)
            if marker is None:
                return 0
            if not self.objects.delete(self._marker_key(sig)):
                return 0   # another host's eviction won the race
            self._invalidate(sig)
            # Crash point: un-published (marker gone) but data objects
            # still present — the interrupted-delete orphan scenario.
            self._crash_point("delete:after_marker")
            for key in self.objects.list(f"{_ENTRY_PREFIX}{sig}/"):
                self.objects.delete(key)
            freed = int(marker.get("nbytes", 0) or 0)
            self._bytes_adjust(-freed)
            return freed
        except OSError as e:
            self._degrade(e)
            return 0

    def evict_to_fit(self, need_bytes: float,
                     limit_density: float | None = None) -> int:
        """Free remote bytes until ``need_bytes`` fit the tier budget.

        Same shape as the local :class:`~repro_torch.core.eviction.Evictor`:
        rank committed entries ascending by benefit density
        ``(C/l)·(1+reuse)`` from the marker metadata (remote markers
        carry no load counts, so density reduces to ``C/l`` with
        upload-time LRU tie-break), skip protected entries, delete
        until the deficit is covered. ``limit_density`` is the incoming
        upload's own density: candidates at or above it are never
        evicted — ascending order means the loop can stop there.
        Returns bytes freed."""
        from .eviction import benefit_density   # local import: no cycle

        freed = 0
        scored = []
        for sig, m in self.entries().items():
            nbytes = max(float(m.get("nbytes", 0) or 0), 1.0)
            load_s = float(m.get("load_s_est", 0) or 0) or nbytes / 500e6
            cost_s = float(m.get("compute_s", 0) or 0)
            scored.append((benefit_density(cost_s, load_s, 0.0),
                           float(m.get("uploaded_at", 0.0) or 0.0),
                           sig, nbytes))
        scored.sort()
        for density, _age, sig, _nbytes in scored:
            if freed >= need_bytes:
                break
            if limit_density is not None and density >= limit_density:
                break   # every remaining candidate is at least as good
            got = self.delete_entry(sig)   # protected entries return 0
            if got > 0:
                self.stats.n_evicted += 1
                self.stats.bytes_evicted += got
                freed += got
        return freed

    def gc_orphans(self, min_age_seconds: float = 3600.0) -> int:
        """Delete entry data objects with no commit marker (crashed
        uploads / interrupted deletes). Only objects provably older than
        ``min_age_seconds`` are touched — async uploads run *after* the
        compute lease is released, so a lease check alone cannot tell an
        in-flight upload from a crashed one; age can, as long as
        ``min_age_seconds`` comfortably exceeds any plausible upload
        duration. Objects whose backend reports no modification time are
        left alone (conservative). Returns the objects removed."""
        if not self.available():
            return 0
        removed = 0
        now = time.time()
        try:
            committed: set[str] = set()
            orphans: dict[str, list[str]] = {}
            for key in self.objects.list(_ENTRY_PREFIX):
                sig = key[len(_ENTRY_PREFIX):].split("/", 1)[0]
                if key.endswith("/" + _MARKER):
                    committed.add(sig)
                else:
                    orphans.setdefault(sig, []).append(key)
            for sig, keys in orphans.items():
                if sig in committed or self.lease_live(sig):
                    continue   # committed, or a compute is in flight
                for key in keys:
                    age = self.objects.mtime(key)
                    if age is None or now - age < min_age_seconds:
                        continue   # unknown or young: maybe mid-upload
                    if self.objects.delete(key):
                        removed += 1
        except OSError as e:
            self._degrade(e)
        return removed

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Release held leases and stop the heartbeat thread."""
        self._hb_stop.set()
        with self._lock:
            held = list(self._held.values())
        for lease in held:
            lease.release()
        t = self._hb_thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        self._closed = True

    def __enter__(self) -> "RemoteStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def as_remote_store(remote: "RemoteStore | ObjectStore | str | None",
                    **kwargs: Any) -> RemoteStore | None:
    """Coerce a remote-tier spec into a :class:`RemoteStore`.

    Accepts an existing :class:`RemoteStore` (returned as-is — the
    caller owns its lifecycle), an :class:`ObjectStore` backend, or a
    filesystem path (the :class:`FsObjectStore` reference deployment:
    a shared mount). ``kwargs`` (budget/TTL/…) apply only when a new
    :class:`RemoteStore` is constructed here."""
    if remote is None or isinstance(remote, RemoteStore):
        return remote
    if isinstance(remote, ObjectStore):
        return RemoteStore(remote, **kwargs)
    if isinstance(remote, str):
        return RemoteStore(FsObjectStore(remote), **kwargs)
    raise TypeError(f"cannot build a remote tier from {type(remote)!r}")
