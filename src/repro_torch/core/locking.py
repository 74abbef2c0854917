"""Cross-process coordination primitives for the shared materialization
store (fleet mode).

One workdir may now be driven by many sessions at once — concurrent threads
in a sweep, or independent OS processes sharing a filesystem. Everything
here builds on POSIX ``flock``:

* :class:`FileLock` — an advisory lock on a dedicated lock file. ``flock``
  is per *open file description*, so two locks on the same path conflict
  even inside one process (each ``FileLock`` opens its own fd), and the
  kernel releases the lock automatically when the holder dies — that is
  the stale-lease story: a crashed session can never wedge the fleet.
* :func:`update_json` — read-modify-write a small JSON file atomically
  (under its sibling ``.lock`` file, published with ``os.replace``).
* :class:`StorageLedger` — the fleet-shared used-bytes ledger backing the
  materialization budget: sessions reserve/release bytes against one
  on-disk counter instead of each keeping a private (and mutually
  clobbering) tally.
* :class:`SharedEwma` — merge-on-flush EWMA statistics (store bandwidth,
  feeding the cost model's l_i estimates): each observation is blended
  into the on-disk value under the lock, so N sessions refine one shared
  estimate rather than overwriting each other's.

On platforms without ``fcntl`` the locks degrade to process-local
``threading`` locks: single-process semantics stay correct, multi-process
sharing is unsupported there.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable

try:
    import fcntl
    HAVE_FLOCK = True
except ImportError:  # pragma: no cover - non-POSIX fallback
    fcntl = None
    HAVE_FLOCK = False

# Fallback registry: path -> (lock, reader/writer bookkeeping is collapsed
# to exclusive-only; good enough for the single-process degradation).
_local_locks: dict[str, threading.Lock] = {}
_local_registry_lock = threading.Lock()


def _local_lock_for(path: str) -> threading.Lock:
    with _local_registry_lock:
        if path not in _local_locks:
            _local_locks[path] = threading.Lock()
        return _local_locks[path]


class FileLock:
    """Advisory file lock (``flock``). Create one instance per acquisition
    site — instances must not be shared between threads.

    ``shared=True`` takes the lock in shared (reader) mode: any number of
    shared holders coexist, but they exclude an exclusive holder and vice
    versa. The non-flock fallback treats shared as exclusive.
    """

    def __init__(self, path: str, shared: bool = False):
        self.path = path
        self.shared = shared
        self._fd: int | None = None
        self._local: threading.Lock | None = None

    def acquire(self, blocking: bool = True,
                timeout: float | None = None,
                cancel: "threading.Event | None" = None) -> bool:
        """Take the lock. ``timeout`` bounds a blocking acquire;
        ``cancel`` (a ``threading.Event``) aborts one early — a set
        event makes this return False at the next poll step, so a
        cancelled job never sits in an unbounded lease wait. Passing
        ``cancel`` forces the polling path even with no timeout."""
        if not HAVE_FLOCK:
            self._local = _local_lock_for(self.path)
            if blocking and cancel is not None:
                deadline = None if timeout is None \
                    else time.monotonic() + timeout
                got = False
                while True:
                    if self._local.acquire(False):
                        got = True
                        break
                    if cancel.is_set() or (
                            deadline is not None
                            and time.monotonic() >= deadline):
                        break
                    time.sleep(0.005)
            else:
                got = self._local.acquire(
                    blocking, -1 if timeout is None else timeout) \
                    if blocking else self._local.acquire(False)
            if not got:
                self._local = None
            return got
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        mode = fcntl.LOCK_SH if self.shared else fcntl.LOCK_EX
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
            got = False
            try:
                if blocking and deadline is None and cancel is None:
                    fcntl.flock(fd, mode)
                    got = True
                else:
                    while True:
                        try:
                            fcntl.flock(fd, mode | fcntl.LOCK_NB)
                            got = True
                            break
                        except OSError:
                            if not blocking or (
                                    deadline is not None
                                    and time.monotonic() >= deadline):
                                break
                            if cancel is not None and cancel.is_set():
                                break
                            time.sleep(0.005)
                if not got:
                    os.close(fd)
                    return False
                # The store's metadata janitor may unlink a lock file it
                # proved idle; if that happened between our open and
                # flock, we hold a lock on a dead inode that a fresh
                # opener cannot see. Verify the path still names our
                # inode — retry with a fresh fd otherwise.
                try:
                    if os.fstat(fd).st_ino == os.stat(self.path).st_ino:
                        self._fd = fd
                        return True
                except OSError:
                    pass
                os.close(fd)
            except BaseException:
                os.close(fd)
                raise

    def release(self) -> None:
        if self._fd is not None:
            try:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            finally:
                os.close(self._fd)
                self._fd = None
        elif self._local is not None:
            self._local.release()
            self._local = None

    def locked_elsewhere(self) -> bool:
        """Probe: is someone (anyone, any mode) holding this lock? Leaves
        the lock unheld on return."""
        if self.acquire(blocking=False):
            self.release()
            return False
        return True

    def probe(self) -> str:
        """Who holds this lock right now: ``"free"``, ``"shared"``, or
        ``"exclusive"``. Two non-blocking probes (exclusive, then
        shared): an exclusive probe succeeds only on a free lock; a
        shared probe coexists with shared holders but not an exclusive
        one. Lets the store's lease census tell compute leases
        (exclusive) from read pins (shared) without bookkeeping files.
        Leaves the lock unheld on return; the answer is inherently a
        snapshot."""
        ex = FileLock(self.path)
        if ex.acquire(blocking=False):
            ex.release()
            return "free"
        sh = FileLock(self.path, shared=True)
        if sh.acquire(blocking=False):
            sh.release()
            return "shared"
        return "exclusive"

    def __enter__(self) -> "FileLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def update_json(path: str, fn: Callable[[Any], Any], default: Any) -> Any:
    """Atomically read-modify-write the JSON blob at ``path``.

    ``fn`` receives the current value (or ``default`` when the file is
    missing/corrupt) and returns the value to persist; returning ``None``
    skips the write. Serialized fleet-wide under ``path + ".lock"``;
    published via temp file + ``os.replace`` so concurrent lock-free
    readers never see a torn file. Returns the persisted (or current)
    value.
    """
    with FileLock(path + ".lock"):
        current = read_json(path, default)
        out = fn(current)
        if out is None:
            return current
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(out, f)
        os.replace(tmp, path)
        return out


def read_json(path: str, default: Any) -> Any:
    """Best-effort read of an atomically-published JSON file (no lock:
    ``os.replace`` publication means we only ever see a whole file)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return default


class StorageLedger:
    """Fleet-shared used-bytes accounting for the materialization budget.

    The single source of truth is ``{"used_bytes": float}`` on disk;
    reserve/release are read-modify-write transactions under the ledger
    lock, so concurrent sessions can never over-commit a shared budget the
    way independent in-memory tallies do.
    """

    def __init__(self, path: str):
        self.path = path

    def used(self) -> float:
        return float(read_json(self.path, {}).get("used_bytes", 0.0))

    def reset(self, used_bytes: float) -> None:
        update_json(self.path, lambda _:
                    {"used_bytes": float(max(0.0, used_bytes))}, {})

    def ensure(self, used_bytes: float) -> None:
        """Initialize the ledger iff it does not exist yet (first session
        to open a workdir seeds it from the store's current size)."""
        update_json(self.path, lambda blob:
                    None if "used_bytes" in blob
                    else {"used_bytes": float(max(0.0, used_bytes))}, {})

    def try_reserve(self, nbytes: float, budget: float) -> bool:
        """Reserve ``nbytes`` iff the total stays within ``budget``."""
        ok = [False]

        def txn(blob):
            used = float(blob.get("used_bytes", 0.0))
            if used + nbytes > budget:
                return None
            ok[0] = True
            return {"used_bytes": used + float(nbytes)}

        update_json(self.path, txn, {})
        return ok[0]

    def release(self, nbytes: float) -> None:
        """Credit ``nbytes`` back (freed by a delete/evict or an undone
        reservation). The fleet evictor routes every eviction's freed
        bytes through here so N concurrent sessions see one consistent
        budget."""
        self.adjust(-float(nbytes))

    def adjust(self, delta: float) -> None:
        """Unconditionally shift the used-bytes counter by ``delta``
        (clamped at 0) — the one RMW primitive credits and reconciles
        share. The top-up direction *reconciles* a reservation made from
        a pre-save estimate with the actual on-disk size once the write
        lands: the bytes are already on disk, so honesty beats refusal
        even when it momentarily overshoots the budget."""
        if delta == 0:
            return
        update_json(self.path, lambda blob: {
            "used_bytes": max(0.0, float(blob.get("used_bytes", 0.0))
                              + float(delta))}, {})


class SharedEwma:
    """Merge-on-flush EWMA statistics shared across sessions.

    Observations EWMA-accumulate in memory (cheap — this sits on the
    store's save/load hot path); at most once per ``flush_interval`` per
    key the running estimate is blended into the *on-disk* value under
    the file lock (new = (1-alpha)·disk + alpha·local) and the merged
    fleet view is adopted back. N sessions thus refine one shared
    estimate without a locked read-modify-write per observation. The
    first observation of a key flushes immediately so cold sessions
    publish an estimate early.
    """

    def __init__(self, path: str, alpha: float = 0.3,
                 flush_interval: float = 1.0):
        self.path = path
        self.alpha = alpha
        self.flush_interval = flush_interval
        self._lock = threading.Lock()
        self._local: dict[str, float] = {}
        self._last_flush: dict[str, float] = {}
        self._disk_cache: dict[str, float] | None = None

    def update(self, key: str, value: float) -> float:
        with self._lock:
            cur = self._local.get(key)
            local = (value if cur is None
                     else (1 - self.alpha) * cur + self.alpha * value)
            self._local[key] = local
            now = time.monotonic()
            last = self._last_flush.get(key)
            if last is not None and now - last < self.flush_interval:
                return local
            self._last_flush[key] = now

        def txn(blob):
            disk = blob.get(key)
            blob[key] = (local if disk is None
                         else (1 - self.alpha) * float(disk)
                         + self.alpha * local)
            return blob

        out = update_json(self.path, txn, {})
        with self._lock:
            self._disk_cache = {k: float(v) for k, v in out.items()}
            self._local[key] = self._disk_cache[key]
            return self._local[key]

    def get(self, key: str) -> float | None:
        with self._lock:
            if key in self._local:
                return self._local[key]
            if self._disk_cache is None:
                self._disk_cache = {k: float(v) for k, v in
                                    read_json(self.path, {}).items()}
            return self._disk_cache.get(key)
