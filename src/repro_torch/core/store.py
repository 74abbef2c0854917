"""Content-addressed materialization store (paper's "materialization
operator" + Helix-JAX's distributed checkpoint substrate).

Entries are keyed by the node's *signature* (see signature.py), so a lookup
hit is exactly the paper's "equivalent materialization" (Def. 3). Values are
arbitrary pytrees (see tree.py) whose array leaves are ``torch.Tensor``s
(CPU or CUDA) or ``np.ndarray``s.

Array leaves are persisted as ``.npy``; a leaf comes back as the type it
went in as. An ``np.ndarray`` stays an ``np.ndarray``; a ``torch.Tensor``
comes back as a tensor of the same dtype, bitwise equal — dtypes numpy
lacks (bf16, fp8…) are stored as raw bits under their torch dtype name, as
``models/convert.py`` carries them. Each tensor leaf's **home device**
(the device it was saved from) is recorded beside its dtype, and a load
puts the leaf back there unless it names another target per leaf
(``sharding_for_leaf(i, shape, dtype)`` returns a ``torch.device``, or
None for the home device); a home device this process lacks is an
error, not a silent move to the host. A leaf bound for the card is read
into pinned host memory and copied without blocking, and the load waits
for those copies before it reports its seconds. The memory tier follows
the same rule, so the device a hit comes back on does not depend on
whether the async offload has landed. Non-array leaves are pickled.
(DTensor placements across a mesh come with the distributed substrate.)

Device copies (the synchronous snapshot of a save, the memory tier's
async offload on the writer thread, placements) all run on the legacy
default CUDA stream, which orders them after the kernels that produced
the tensors. Moving any of them to a side stream would need a CUDA event
(or ``record_stream``) between producer and copy.

The store is safe for concurrent use by the pipelined executor *and* — new
in fleet mode — by many sessions sharing one workdir, whether sweep threads
in one process or independent OS processes:

* Every publish/delete of an entry happens under a **per-signature file
  lock** (``flock``; see locking.py), and removal renames the entry dir to
  a staging name before deleting it, so an entry atomically exists-whole or
  not-at-all from any process's point of view. Loads retry once if they
  race an overwrite.
* An **on-disk index** (``.fleet/index.json``) mirrors the entry set and is
  updated atomically together with each publish/delete (under the same
  per-signature lock), making ``entries()``/``total_bytes()`` one read
  instead of an O(entries) directory walk. A crash between dir-op and
  index-op is healed by the rebuild every ``Store.__init__`` performs.
* **Compute leases** (``acquire_compute`` / ``wait_compute``) give fleets
  in-flight dedupe: the first session to need a signature takes the lease
  and computes; others wait on it and load the published result. Leases
  are ``flock``s, so a crashed holder's lease evaporates with its process
  (stale-lease takeover for free). Waiters register marker files so the
  holder knows someone is blocked on the result and can force-persist it.
  **Read leases** (shared mode) pin entries a session plans to LOAD;
  ``delete`` probes the lease and skips entries other sessions still need.
* Entries carry **benefit metadata** for fleet eviction (eviction.py):
  cost-to-recompute ``compute_s`` and load-estimate ``load_s_est`` are
  persisted at save time (``extra_meta``), and every load bumps a
  ``loads`` count + ``last_load`` stamp in ``meta.json``
  (``_note_load``; mirrored to the index on power-of-two counts so the
  hot load path never serializes on the global index lock), so ranking
  a whole store is one index read. Overwrites carry the old entry's
  load evidence forward.
* Save/load wall-times feed a **merge-on-flush EWMA** bandwidth file
  (``.fleet/bw.json``) shared by all sessions — the cost model's ``l_i``
  estimates (paper §5.1: l_i = bytes / store bandwidth) improve fleet-wide
  instead of per-session.
* ``save_enqueue`` hands a host snapshot to a dedicated **writer thread**;
  in-flight bytes are bounded by ``max_inflight_bytes``. Multi-leaf values
  are written/read with per-leaf parallel .npy I/O (shared small pool).
* With a **remote tier** attached (``remote=``, see remote.py) the local
  store becomes a write-through / read-through cache of a fleet-shared
  object store: every local publish is uploaded asynchronously off a
  dedicated uploader thread (``upload_now`` forces it synchronously —
  the executor uses that for shared signatures so cross-host waiters
  find the entry the moment the compute lease releases); ``has`` /
  ``meta`` / ``load`` fall back to the remote tier on local miss, and a
  fetched entry is published into the local tier (the populate is
  ledger-adjusted so the fleet budget stays exact). Compute leases
  compose: the local ``flock`` dedupes within the host, a remote TTL
  lease object dedupes across hosts (heartbeat-renewed; expiry replaces
  flock's crash-release), and ``wait_compute`` polls the remote lease
  when the holder is another host. Planned-LOAD read pins extend to a
  remote TTL pin when the entry only exists remotely, so no host's
  remote eviction can yank another host's plan. If the remote backend
  errors, the tier degrades to local-only for a cool-down window — the
  host keeps working (docs/operations.md, failure modes).
* **Chunk-partitioned materializations** (chunks.py): saving a
  :class:`~repro_torch.core.chunks.Chunked` value publishes each chunk as an
  ordinary signature-keyed entry (``is_chunk`` meta) plus a small
  *manifest* entry under the node's full signature whose ``chunked``
  meta lists the chunk signatures. Loading the manifest reassembles the
  chunks; deleting it cascades to chunks no other manifest references
  (``keep_chunks`` protects the chunks an upcoming delta will splice);
  ``gc_orphan_chunks`` reclaims chunks stranded by a crash between
  chunk publish and manifest publish (the manifest is the commit point:
  readers never see a partial splice). Ledger accounting stays per
  chunk — every ``SaveInfo``/``delete`` byte count is exactly the bytes
  that appeared on or left the disk, so ledger == disk is preserved.
  Chunked entries are local-tier only (manifests and chunks are not
  uploaded to the remote tier).
* **TierStack** (memory → disk → remote): with ``mem_budget_bytes`` a
  bounded host-RAM tier (memtier.py) sits in front of the disk tier
  behind the same signature-keyed API. Every publish write-through
  admits its host snapshot; every disk/remote load read-through
  promotes its value; a same-process reload is then a zero-copy pytree
  handoff — no ``.npy`` read, no unpickle (placed loads move tensor
  leaves to the named device, and device tensors admitted to the tier
  are offloaded into pinned host tensors asynchronously on the writer
  queue). The memory budget is enforced by
  *demote-not-delete* eviction ranked by ``eviction.ranked_mem``; with
  ``mem_writeback=True`` saves land memory-only (``SaveInfo.nbytes`` is
  0 until demotion spills them to disk through the
  ``memtier:before_spill`` / ``memtier:after_spill`` crash points, at
  which point the bytes are ledger-adjusted in). ``est_load_seconds``
  prices the cheapest tier that can serve a signature via per-tier EWMA
  bandwidths (``costs.TierBandwidth`` over the same ``.fleet/bw.json``)
  and ``tier_status`` reports one unified per-tier record.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import pickle
import shutil
import threading
import time
import uuid
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from .chunks import Chunked
from .costs import TierBandwidth
from .faults import InjectedCrash
from .locking import (FileLock, SharedEwma, StorageLedger, read_json,
                      update_json)
from .memtier import MemEntry, MemTier, leaf_devices
from .remote import RemoteStore
from .tree import (block_until_ready, tree_flatten, tree_leaves, tree_map,
                   tree_unflatten)


@dataclasses.dataclass
class SaveInfo:
    nbytes: int
    seconds: float
    # True when this save overwrote an existing entry for the signature —
    # the caller's budget reservation then double-counts a value already
    # paid for (e.g. two sessions raced the same signature) and should be
    # credited back.
    replaced: bool = False
    # Recorded on-disk size of the entry this save replaced (0 when
    # ``replaced`` is False). The bytes an overwrite frees are the *old*
    # entry's bytes, not the new reservation — budget accounting must
    # credit this number, or the shared ledger drifts from disk whenever
    # the two sizes differ.
    replaced_nbytes: int = 0


class PendingSave:
    """Handle for a queued write. ``result()`` blocks until the writer has
    persisted the entry and returns its :class:`SaveInfo`; ``join()`` is
    kept for drop-in compatibility with the old thread-based API."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._info: SaveInfo | None = None
        self._error: BaseException | None = None

    def _finish(self, info: SaveInfo | None,
                error: BaseException | None = None) -> None:
        self._info = info
        self._error = error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> SaveInfo:
        if not self._event.wait(timeout):
            raise TimeoutError("materialization write still pending")
        if self._error is not None:
            raise self._error
        assert self._info is not None
        return self._info

    def join(self, timeout: float | None = None) -> None:
        self._event.wait(timeout)


def _leaf_to_host(leaf: Any) -> Any:
    """Host snapshot of one leaf: a CUDA tensor is copied into a pinned
    host tensor (so placing it back on the card can be ``non_blocking``);
    everything else is returned as is."""
    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
        host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
        host.copy_(leaf.detach())
        return host
    return leaf


def tree_nbytes(value: Any) -> int:
    """Pre-save storage estimate for a pytree (used by OMP's budget)."""
    total = 0
    for leaf in tree_flatten(value)[0]:
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, np.ndarray):
            total += int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        else:
            total += 64  # nominal
    return total


def _cuda_target(device: Any) -> torch.device:
    """``device`` with a CUDA index filled in, so it compares equal to
    the ``.device`` of a tensor already there."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _home_device(name: str) -> torch.device:
    """The device a tensor leaf was saved from; raises when this process
    does not have it (a card's entry loaded on a host without one)."""
    device = torch.device(name)
    if device.type == "cuda" and (
            not torch.cuda.is_available()
            or (device.index or 0) >= torch.cuda.device_count()):
        raise RuntimeError(
            f"a tensor leaf of this entry was saved from {name}, which this "
            "process does not have; name a device for it with "
            "sharding_for_leaf (load_shardings)")
    return device


def _leaf_target(sharding_for_leaf, i: int, shape: tuple, dtype,
                 home: str | None) -> torch.device:
    """Where tensor leaf ``i`` goes: the caller's placement, else its
    home device (a leaf with no recorded home stays on the host)."""
    device = (sharding_for_leaf(i, shape, dtype)
              if sharding_for_leaf is not None else None)
    if device is not None:
        return _cuda_target(device)
    return _home_device(home or "cpu")


def _split_devices(devices: tuple, parts) -> list[tuple]:
    """Cut a flattened value's per-leaf devices into those of ``parts``,
    the subtrees that flatten one after another into it."""
    out, k = [], 0
    for part in parts:
        n = len(tree_leaves(part))
        out.append(tuple(devices[k:k + n]))
        k += n
    return out


def _place_leaf(leaf: torch.Tensor, device: Any) -> torch.Tensor:
    """Move one tensor leaf to ``device`` (zero-copy when it is already
    there; ``non_blocking`` from pinned host memory)."""
    device = _cuda_target(device)
    if leaf.device == device:
        return leaf
    non_blocking = (device.type == "cuda" and leaf.device.type == "cpu"
                    and leaf.is_pinned())
    return leaf.to(device, non_blocking=non_blocking)


# Leaves smaller than this are not worth a pool round-trip.
_PARALLEL_LEAF_MIN_BYTES = 1 << 20

_io_pool: ThreadPoolExecutor | None = None
_io_pool_lock = threading.Lock()


def _leaf_io_pool() -> ThreadPoolExecutor:
    """Small process-wide pool for per-leaf .npy reads/writes."""
    global _io_pool
    with _io_pool_lock:
        if _io_pool is None:
            _io_pool = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="store-leaf-io")
        return _io_pool


# Integer dtypes of each element size: how a tensor whose dtype numpy
# lacks (bf16, fp8…) is stored in ``.npy``, as raw bits.
_RAW_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _tensor_dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _tensor_storage_view(leaf: torch.Tensor) -> np.ndarray:
    """A host tensor as a numpy array for ``.npy``: itself where numpy
    has its dtype, else its raw bits as an integer of the same size."""
    leaf = leaf.detach().contiguous()
    try:
        return leaf.numpy()
    except TypeError:
        return leaf.view(_RAW_BITS[leaf.element_size()]).numpy()


class ComputeLease:
    """Exclusive right to compute one signature fleet-wide.

    Held from just before the compute starts until the value is either
    published to the store or the holder decides not to persist it. The
    kernel releases the underlying ``flock`` if the holder crashes, so
    waiters take over stale leases automatically. With a remote tier the
    lease spans both scopes: the local ``flock`` excludes this host's
    sessions, a heartbeat-renewed remote TTL lease excludes other hosts
    (its *expiry* is the cross-host crash-release).
    """

    def __init__(self, store: "Store", sig: str, lock: FileLock,
                 remote_lease=None):
        self._store = store
        self.sig = sig
        self._lock: FileLock | None = lock
        self._remote_lease = remote_lease

    def waiters(self) -> int:
        """How many sessions are currently blocked on this signature
        (this host's waiter markers plus remote hosts' TTL markers)."""
        return self._store._count_waiters(self.sig)

    def release(self) -> None:
        # Remote first: a cross-host waiter that wakes on the remote
        # lease vanishing must already be able to see the published
        # entry (upload_now ran before release on shared paths).
        if self._remote_lease is not None:
            self._remote_lease.release()
            self._remote_lease = None
        if self._lock is not None:
            self._lock.release()
            self._lock = None

    def __enter__(self) -> "ComputeLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class ReadPin:
    """A held planned-LOAD pin spanning tiers.

    Wraps the local shared ``flock`` (blocks this host's eviction) and,
    when the entry only exists remotely, a remote TTL pin (blocks every
    host's remote eviction until the load lands)."""

    def __init__(self, lock: FileLock, remote_pin=None):
        self._lock: FileLock | None = lock
        self._remote_pin = remote_pin

    def release(self) -> None:
        """Drop both pins (idempotent)."""
        if self._remote_pin is not None:
            self._remote_pin.release()
            self._remote_pin = None
        if self._lock is not None:
            self._lock.release()
            self._lock = None


# Workdir roots this process has already healed (scan + index rebuild +
# metadata reap). A sweep opens K Stores on one root; only the first pays
# the O(entries) scan. A fresh process (the crash-recovery case) always
# heals on its first open.
_healed_roots: set[str] = set()
_healed_roots_lock = threading.Lock()


class Store:
    _tmp_counter = itertools.count()

    def __init__(self, root: str, max_inflight_bytes: int = 1 << 30,
                 heal: bool | None = None,
                 remote: RemoteStore | None = None,
                 mem_budget_bytes: float = 0.0,
                 mem_writeback: bool = False):
        """``heal`` controls the open-time crash recovery (stale-staging
        reap, fleet-metadata reap, index rebuild from a directory scan):
        None (default) runs it on the first open of this root in this
        process only; True forces it; False skips it. ``remote`` attaches
        a fleet-shared :class:`~repro_torch.core.remote.RemoteStore` tier the
        local store write-through/read-through caches (see remote.py).
        ``mem_budget_bytes`` > 0 attaches the memory tier (memtier.py):
        a bounded process-local host-RAM cache of materialized values in
        front of the disk tier; ``mem_writeback`` makes saves land
        memory-only until demotion spills them (write-back mode)."""
        self.root = root
        self.remote = remote
        os.makedirs(root, exist_ok=True)
        os.makedirs(self._fleet_dir("locks"), exist_ok=True)
        os.makedirs(self._fleet_dir("leases"), exist_ok=True)
        if heal is None:
            key = os.path.realpath(root)
            with _healed_roots_lock:
                heal = key not in _healed_roots
                _healed_roots.add(key)
        # merge-on-flush measured bandwidth (bytes/s), shared fleet-wide
        self._bw = SharedEwma(self._fleet_dir("bw.json"))
        # dedicated writer queue (overlapped materialization)
        self.max_inflight_bytes = int(max_inflight_bytes)
        self._writer_cv = threading.Condition()
        self._writer_queue: deque = deque()
        self._writer_thread: threading.Thread | None = None
        self._inflight_bytes = 0
        # Offloads the writer thread has taken off the queue and not yet
        # finished (writer_drain waits for them too).
        self._offloads_running = 0
        # dedicated remote uploader (write-through off the critical path)
        self._upload_cv = threading.Condition()
        self._upload_queue: deque = deque()
        self._upload_thread: threading.Thread | None = None
        self._uploads_inflight = 0
        # The signature the uploader thread is uploading now, and the
        # injected crashes of background uploads that no ``upload_now``
        # has claimed yet (see upload_now: it owns the upload that save
        # queued); a signature's next enqueue drops its stale crash.
        self._upload_running: str | None = None
        self._upload_errors: dict[str, InjectedCrash] = {}
        # local loads served by a remote fetch (read-through populates)
        self.remote_hits = 0
        # Optional fault-injection plan (faults.FaultPlan): consulted at
        # the named crash points of the chunked-splice publish path
        # (``splice:chunk_published``, ``splice:before_manifest``) and
        # the memory tier's demotion path (``memtier:before_spill``,
        # ``memtier:after_spill``). Production runs leave it None and
        # pay one ``is None`` check.
        self.faults = None
        # Per-tier EWMA bandwidths over the shared bw.json (the disk
        # tier keeps the legacy read/write keys, so old files stay
        # valid and no-sig estimates are numerically unchanged).
        self._tier_bw = TierBandwidth(self._bw)
        # Per-tier load accounting (with the seconds the loads took,
        # placement onto a card included) + the .npy leaf-read counter
        # the zero-serialization-on-hit guarantee is asserted against;
        # and the disk tier's writes (bytes, seconds).
        self.load_stats = {
            "memory": {"hits": 0, "misses": 0, "bytes": 0, "seconds": 0.0},
            "local": {"hits": 0, "misses": 0, "bytes": 0, "seconds": 0.0},
            "remote": {"hits": 0, "misses": 0, "bytes": 0, "seconds": 0.0},
        }
        self.write_stats = {"entries": 0, "bytes": 0, "seconds": 0.0}
        self.npy_leaf_reads = 0
        # load() runs concurrently on executor worker threads; bare
        # ``+=`` on these counters drops increments under contention
        # (read-modify-write races), which the tenant stress harness
        # observes as tier_status() hit counts drifting from truth.
        self._stats_lock = threading.Lock()
        # Signatures whose disk write the writer thread currently owns
        # (popped from the queue, save not yet landed): a memory-tier
        # spill of such a signature may drop instead of double-saving.
        self._writer_active: set[str] = set()
        # Memory tier (TierStack head). 0 budget = no tier: every
        # existing direct-Store caller keeps the two-tier behavior.
        self._mem: MemTier | None = None
        if mem_budget_bytes and mem_budget_bytes > 0:
            self._mem = MemTier(
                mem_budget_bytes, writeback=mem_writeback,
                spill=self._spill_from_mem,
                offload=self._mem_offload_enqueue,
                est_disk_load=lambda nb:
                    self._tier_bw.est_load_seconds("local", nb))
        if heal:
            self._reap_stale_tmp()
            self._reap_fleet_metadata()
            # Heal the index after crashes (a process dying between
            # dir-op and index-op leaves them out of sync; the scan is
            # ground truth).
            self.rebuild_index()

    # A staging dir older than this is an orphan even if we cannot tell
    # whether its owner pid is alive (e.g. it came from another host).
    _TMP_ORPHAN_SECONDS = 3600.0

    @staticmethod
    def _tmp_is_orphan(path: str, name: str) -> bool:
        """A staging dir is an orphan iff its owning process is provably
        dead, or it is old enough that no live save can still be writing
        it. Opening a store while sibling processes are mid-save must NOT
        reap their live staging dirs."""
        try:
            pid = int(name.split(".tmp-", 1)[1].removeprefix("del-")
                      .split("-", 1)[0] or 0)
        except (IndexError, ValueError):
            pid = 0
        if pid > 0:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                return True      # owner is gone (same host)
            except PermissionError:
                pass             # alive, not ours
        try:
            age = time.time() - os.stat(path).st_mtime
        except OSError:
            return False         # vanished already (owner cleaned it up)
        return age > Store._TMP_ORPHAN_SECONDS

    def _reap_stale_tmp(self) -> None:
        """Remove staging dirs orphaned by a crash mid-save. They contain a
        meta.json, so without this sweep a directory rescan would count
        them as phantom entries forever."""
        for sub in os.listdir(self.root):
            subdir = os.path.join(self.root, sub)
            if sub.startswith(".") or not os.path.isdir(subdir):
                continue
            for name in os.listdir(subdir):
                path = os.path.join(subdir, name)
                if ".tmp-" in name and self._tmp_is_orphan(path, name):
                    shutil.rmtree(path, ignore_errors=True)

    def _reap_fleet_metadata(self) -> None:
        """Prune per-signature lock/lease files for long-gone entries,
        dead waiter markers, and orphaned atomic-publish temp files.
        Without this a long-lived workdir accumulates one zero-byte file
        per signature ever seen (and _count_waiters listdirs leases/ on
        every lease-compute). Unlinking a lock file is safe because
        FileLock.acquire verifies it locked the inode the path names."""
        fleet = self._fleet_dir()
        for name in os.listdir(fleet):
            path = os.path.join(fleet, name)
            if ".tmp-" in name and os.path.isfile(path) \
                    and self._tmp_is_orphan(path, name):
                try:
                    os.unlink(path)   # update_json crash leftovers
                except OSError:
                    pass
        now = time.time()
        for sub, suffix in (("locks", ".lock"), ("leases", ".lease")):
            d = self._fleet_dir(sub)
            for name in os.listdir(d):
                path = os.path.join(d, name)
                if sub == "leases" and ".w-" in name:
                    if self._waiter_is_dead(path):
                        try:
                            os.unlink(path)
                        except OSError:
                            pass
                    continue
                if not name.endswith(suffix):
                    continue
                sig = name[: -len(suffix)]
                try:
                    age = now - os.stat(path).st_mtime
                except OSError:
                    continue
                # Cold (no one can be mid-save) and entry-less: reap
                # under the exclusive lock so no live holder is split.
                # Local-tier check only: lock/lease files guard local
                # publishes; a remote-only entry needs no local lock.
                if age <= self._TMP_ORPHAN_SECONDS or self.has_local(sig):
                    continue
                guard = FileLock(path)
                if guard.acquire(blocking=False):
                    try:
                        if not self.has_local(sig):
                            try:
                                os.unlink(path)
                            except OSError:
                                pass
                    finally:
                        guard.release()

    # -- paths ---------------------------------------------------------------
    def _dir(self, sig: str) -> str:
        return os.path.join(self.root, sig[:2], sig)

    def _fleet_dir(self, *parts: str) -> str:
        return os.path.join(self.root, ".fleet", *parts)

    def _entry_lock(self, sig: str) -> FileLock:
        return FileLock(self._fleet_dir("locks", f"{sig}.lock"))

    def _lease_path(self, sig: str) -> str:
        return os.path.join(self._fleet_dir("leases"), f"{sig}.lease")

    @property
    def ledger_path(self) -> str:
        """Path of the fleet-shared storage-budget ledger for this store."""
        return self._fleet_dir("ledger.json")

    @property
    def index_path(self) -> str:
        return self._fleet_dir("index.json")

    def has_local(self, sig: str) -> bool:
        """Entry present in the local tier (one stat)."""
        return os.path.exists(os.path.join(self._dir(sig), "meta.json"))

    def computing(self, sig: str) -> bool:
        """Is an exclusive compute lease held on ``sig`` right now?

        A non-blocking flock probe of the signature's lease file: True
        means some session is mid-compute of this value. Advisory
        observability (the server's marginal-cost estimate counts live
        leaders with it) — never a synchronization primitive; the lease
        can change hands the instant this returns."""
        return FileLock(self._lease_path(sig)).probe() == "exclusive"

    def mem_has(self, sig: str) -> bool:
        """Resident in the memory tier right now (False without one).
        Observability + tier pricing; like :meth:`computing`, never a
        synchronization primitive."""
        return self._mem is not None and self._mem.has(sig)

    def has(self, sig: str) -> bool:
        """Entry reachable on any tier: local disk, memory-resident
        (possibly memory-only in write-back mode — still loadable
        in-process), or committed in the remote tier (loadable through
        the read-through fetch path). This is the planner's reuse test.
        Remote presence may be cached a couple of seconds;
        dedupe-critical paths use :meth:`has_fresh`."""
        if self.has_local(sig):
            return True
        if self._mem is not None and self._mem.has(sig):
            return True
        return self.remote is not None and self.remote.exists(sig)

    def has_fresh(self, sig: str) -> bool:
        """Presence check that bypasses the remote marker cache.

        The executor calls this *after acquiring a compute lease*: a
        stale cached negative there would recompute a value another host
        committed moments ago — the lease acquisition is the natural
        point to pay one uncached probe for exact fleet-wide
        compute-once. (Also refreshes the cache, so the caller's
        follow-up ``has``/``load`` sees the entry.)"""
        if self.has_local(sig):
            return True
        if self._mem is not None and self._mem.has(sig):
            return True
        return (self.remote is not None
                and self.remote.marker_meta(sig, fresh=True) is not None)

    @staticmethod
    def _rewrite_json(path: str, obj: dict) -> bool:
        """Atomically replace the JSON file at ``path`` via a staged
        sibling + ``os.replace`` (readers only ever see a whole file; a
        failed write — ENOSPC… — leaves the original intact and cleans
        the staging file). Returns False on failure — callers treat the
        rewrite as best-effort."""
        tmp = f"{path}.{os.getpid()}-{threading.get_ident()}"
        try:
            with open(tmp, "w") as f:
                json.dump(obj, f)
            os.replace(tmp, path)
            return True
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False

    # -- save ------------------------------------------------------------------
    def _crash_point(self, point: str) -> None:
        """Consult the attached fault plan (no-op without one)."""
        if self.faults is not None:
            self.faults.crash_point(point)

    def save(self, sig: str, name: str, value: Any,
             extra_meta: dict | None = None, *,
             _tier_admit: bool = True,
             _devices: tuple | None = None) -> SaveInfo:
        # ``_devices``: each leaf's home device when ``value`` is already
        # a host snapshot (the writer queue, a spill); else read off it.
        devices = leaf_devices(value) if _devices is None else _devices
        if isinstance(value, Chunked):
            return self._save_chunked(sig, name, value, extra_meta, devices)
        t0 = time.perf_counter()
        host_value = tree_map(_leaf_to_host, value)
        extra = extra_meta or {}
        if (self._mem is not None and self._mem.writeback and _tier_admit
                and not extra.get("is_chunk") and "chunked" not in extra):
            # Write-back mode: the save lands in the memory tier only;
            # the disk write happens at demotion (_spill_from_mem) or an
            # explicit mem_flush(). nbytes=0 keeps the caller's budget
            # ledger equal to on-disk bytes — the spill adjusts the
            # bytes in when they actually land. Chunk entries and
            # manifests always write through: the manifest commit point
            # must never reference chunks another process cannot read.
            wb_nbytes = tree_nbytes(host_value)
            wb_meta = {"name": name, "sig": sig, "nbytes": wb_nbytes,
                       "created": time.time()}
            wb_meta.update(extra)
            if self._mem.put(sig, host_value, wb_nbytes, name=name,
                             meta=wb_meta, state="dirty", devices=devices):
                return SaveInfo(nbytes=0,
                                seconds=time.perf_counter() - t0)
            # Value exceeds the whole memory budget — write through.
        d = self._dir(sig)
        # Unique temp dir: concurrent saves of one signature must not
        # clobber each other's staging area (last publish wins below).
        tmp = (f"{d}.tmp-{os.getpid()}-{threading.get_ident()}"
               f"-{next(self._tmp_counter)}")
        os.makedirs(tmp, exist_ok=True)
        try:
            manifest, nbytes = self._write_leaves(tmp, host_value, devices)
            seconds = time.perf_counter() - t0
            meta = {
                "name": name, "sig": sig, "nbytes": nbytes,
                "save_seconds": seconds, "created": time.time(),
                "manifest": manifest,
            }
            meta.update(extra_meta or {})
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            # Publish + index update as one per-signature transaction, so
            # the index never disagrees with the directory for a signature
            # (concurrent save/delete of one sig serialize here).
            with self._entry_lock(sig):
                replaced = os.path.exists(d)
                replaced_nbytes = 0
                if replaced:
                    try:
                        with open(os.path.join(d, "meta.json")) as f:
                            old_meta = json.load(f)
                    except (OSError, json.JSONDecodeError):
                        old_meta = {}
                    try:
                        replaced_nbytes = int(old_meta.get("nbytes", 0))
                    except (ValueError, TypeError):
                        replaced_nbytes = 0
                    # Carry the observed-reuse evidence forward: an
                    # overwrite (same signature ⇒ same value) must not
                    # reset the entry's load count, or the fleet's
                    # hottest entry ranks as cold for eviction right
                    # after two sessions race a save. Best-effort and
                    # crash-safe: the rewrite goes through a sibling
                    # temp + os.replace, so a failed write (ENOSPC…)
                    # leaves the already-staged meta.json whole and
                    # only drops the carried counters.
                    carried = {k: old_meta[k]
                               for k in ("loads", "last_load")
                               if k in old_meta}
                    if carried:
                        new_meta = dict(meta, **carried)
                        if self._rewrite_json(os.path.join(tmp,
                                                           "meta.json"),
                                              new_meta):
                            meta = new_meta
                    self._retire_dir(d)
                os.rename(tmp, d)
                self._index_apply(add={sig: self._index_entry(meta)})
            self._update_bw("write", nbytes, seconds)
            with self._stats_lock:
                self.write_stats["entries"] += 1
                self.write_stats["bytes"] += nbytes
                self.write_stats["seconds"] += seconds
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self._mem is not None and _tier_admit and not meta.get("chunked"):
            # Write-through admission into the memory tier: the host
            # snapshot is already in hand, so promoting it is free and
            # makes the next same-process load a pointer handoff.
            self._mem.put(sig, host_value, nbytes, name=name, meta=meta,
                          state="durable", devices=devices)
        # Write-through: hand the published entry to the uploader (async
        # — off both the caller and the writer queue's drain path; after
        # the try so a queueing hiccup can't mis-report a landed save).
        # Shared-signature saves additionally upload_now() before their
        # compute lease releases (executor).
        self._enqueue_upload(sig, meta)
        return SaveInfo(nbytes=nbytes, seconds=seconds, replaced=replaced,
                        replaced_nbytes=replaced_nbytes)

    def _save_chunked(self, sig: str, name: str, value: Chunked,
                      extra_meta: dict | None,
                      devices: tuple) -> SaveInfo:
        """Publish a partitioned materialization: per-chunk entries first,
        then the manifest under the node's full signature.

        The manifest is the *commit point* — until it publishes, readers
        see nothing (``has(sig)`` is false), so a crash mid-splice leaves
        only orphan chunk entries for :meth:`gc_orphan_chunks` and a
        retry republishes bit-identically (chunks are content-addressed;
        already-present ones are skipped, not rewritten). The returned
        ``SaveInfo.nbytes`` counts exactly the bytes this call added to
        disk (new chunks + manifest), which is what keeps the fleet
        ledger equal to on-disk bytes."""
        t0 = time.perf_counter()
        new_bytes = 0
        chunk_bytes = 0
        *chunk_devices, final_devices = _split_devices(
            devices, (*value.chunks, value.final))
        try:
            for csig, chunk, cdev in zip(value.chunk_sigs, value.chunks,
                                         chunk_devices):
                if self.has_local(csig):
                    try:
                        chunk_bytes += int(self.meta(csig).get("nbytes", 0))
                        continue
                    except (FileNotFoundError, json.JSONDecodeError):
                        pass  # raced a delete — republish below
                info = self.save(csig, f"{name}#chunk", chunk,
                                 extra_meta={"is_chunk": True},
                                 _devices=cdev)
                new_bytes += info.nbytes
                if info.replaced:
                    new_bytes -= info.replaced_nbytes
                chunk_bytes += info.nbytes
                self._crash_point("splice:chunk_published")
            self._crash_point("splice:before_manifest")
            extra = dict(extra_meta or {})
            extra["chunked"] = {"combine": value.combine,
                                "chunk_sigs": list(value.chunk_sigs),
                                "chunk_bytes": chunk_bytes}
            # Reduce manifests carry the combined value as their own
            # payload (loading one returns the final value directly);
            # concat manifests carry no payload — their value *is* the
            # chunk set.
            if value.combine == "reduce":
                info = self.save(sig, name, value.final, extra_meta=extra,
                                 _devices=final_devices)
            else:
                info = self.save(sig, name, (), extra_meta=extra)
        except BaseException:
            # The chunks published so far are committed entries that stay
            # on disk (a retry dedupes them; gc_orphan_chunks reclaims
            # them if no retry comes), but the caller releases its whole
            # reservation on failure — adjust their bytes in so the fleet
            # ledger keeps mirroring the disk (the same honesty-over-
            # overshoot call as the read-through populate).
            if new_bytes and os.path.exists(self.ledger_path):
                StorageLedger(self.ledger_path).adjust(float(new_bytes))
            raise
        return SaveInfo(nbytes=new_bytes + info.nbytes,
                        seconds=time.perf_counter() - t0,
                        replaced=info.replaced,
                        replaced_nbytes=info.replaced_nbytes)

    def _retire_dir(self, d: str) -> None:
        """Crash-safe removal: rename the entry dir to a staging name (so
        it atomically stops being an entry) before deleting its contents.
        A crash mid-rmtree leaves only a ``.tmp-`` dir for the reaper."""
        trash = (f"{d}.tmp-del-{os.getpid()}-{threading.get_ident()}"
                 f"-{next(self._tmp_counter)}")
        os.rename(d, trash)
        shutil.rmtree(trash, ignore_errors=True)

    def _write_leaves(self, tmp: str, host_value: Any,
                      devices: tuple) -> tuple[list, int]:
        leaves, treedef = tree_flatten(host_value)
        manifest: list[dict] = []
        nbytes = 0
        array_jobs: list[tuple[str, np.ndarray]] = []
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, torch.Tensor):
                fn = f"leaf_{i}.npy"
                manifest.append({"kind": "tensor", "file": fn,
                                 "shape": list(leaf.shape),
                                 "dtype": _tensor_dtype_name(leaf.dtype),
                                 "device": devices[i]})
                stored = _tensor_storage_view(leaf)
                nbytes += stored.nbytes
                array_jobs.append((os.path.join(tmp, fn), stored))
            elif isinstance(leaf, np.ndarray):
                fn = f"leaf_{i}.npy"
                manifest.append({"kind": "array", "file": fn,
                                 "shape": list(leaf.shape),
                                 "dtype": str(leaf.dtype)})
                nbytes += leaf.nbytes
                array_jobs.append((os.path.join(tmp, fn), leaf))
            else:
                fn = f"leaf_{i}.pkl"
                with open(os.path.join(tmp, fn), "wb") as f:
                    pickle.dump(leaf, f)
                manifest.append({"kind": "pickle", "file": fn})
                nbytes += os.path.getsize(os.path.join(tmp, fn))

        def write_one(job):
            path, leaf = job
            np.save(path, leaf, allow_pickle=False)

        big = [j for j in array_jobs
               if j[1].nbytes >= _PARALLEL_LEAF_MIN_BYTES]
        if len(big) >= 2:
            list(_leaf_io_pool().map(write_one, array_jobs))
        else:
            for job in array_jobs:
                write_one(job)
        with open(os.path.join(tmp, "treedef.pkl"), "wb") as f:
            pickle.dump(treedef, f)
        return manifest, nbytes

    # -- writer queue ------------------------------------------------------------
    def save_enqueue(self, sig: str, name: str, value: Any,
                     extra_meta: dict | None = None) -> PendingSave:
        """Queue a write on the store's dedicated writer thread.

        The device→host snapshot happens synchronously (cheap, and it frees
        the caller to evict the value); the disk write runs off the critical
        path. Blocks while the writer's in-flight bytes exceed
        ``max_inflight_bytes`` so queued materializations cannot exhaust
        host memory.
        """
        devices = leaf_devices(value)
        host_value = tree_map(_leaf_to_host, value)
        est = tree_nbytes(host_value)
        pending = PendingSave()
        if (self._mem is not None and not isinstance(value, Chunked)
                and not (extra_meta or {}).get("is_chunk")):
            # Admit before the disk write lands ("queued": the writer
            # thread owns a durable copy in flight, so demotion may drop
            # freely) — in-process reuse never waits on the writer.
            q_meta = {"name": name, "sig": sig, "nbytes": est,
                      "created": time.time()}
            q_meta.update(extra_meta or {})
            self._mem.put(sig, host_value, est, name=name, meta=q_meta,
                          state="queued", devices=devices)
        with self._writer_cv:
            while (self._inflight_bytes > 0
                   and self._inflight_bytes + est > self.max_inflight_bytes):
                self._writer_cv.wait()
            self._inflight_bytes += est
            self._writer_queue.append(
                ("save", sig, name, host_value, extra_meta, est, pending,
                 devices))
            if self._writer_thread is None or not self._writer_thread.is_alive():
                self._writer_thread = threading.Thread(
                    target=self._writer_loop, name="store-writer", daemon=True)
                self._writer_thread.start()
            self._writer_cv.notify_all()
        return pending

    def _writer_loop(self) -> None:
        while True:
            with self._writer_cv:
                if not self._writer_queue:
                    # Exit when idle; save_enqueue restarts the thread on
                    # demand, so an idle Store pins no thread for life.
                    self._writer_thread = None
                    return
                item = self._writer_queue.popleft()
                if item[0] == "save":
                    self._writer_active.add(item[1])
                else:
                    self._offloads_running += 1
            if item[0] == "offload":
                # Async device→host snapshot of a memory-tier entry
                # (placed loads admit CUDA tensors; this moves them
                # into pinned host memory off the critical path).
                try:
                    self._mem_offload_run(item[1])
                except Exception:
                    pass   # advisory: the device copy keeps serving
                with self._writer_cv:
                    self._offloads_running -= 1
                    self._writer_cv.notify_all()
                continue
            _, sig, name, host_value, extra_meta, est, pending, devices = item
            try:
                info = self.save(sig, name, host_value,
                                 extra_meta=extra_meta, _devices=devices)
                pending._finish(info)
            except BaseException as e:
                pending._finish(None, e)
            with self._writer_cv:
                self._writer_active.discard(sig)
                self._inflight_bytes -= est
                self._writer_cv.notify_all()

    def save_async(self, sig: str, name: str, value: Any,
                   extra_meta: dict | None = None) -> PendingSave:
        """Deprecated alias for :meth:`save_enqueue` (kept for callers that
        still ``.join()`` the returned handle)."""
        return self.save_enqueue(sig, name, value, extra_meta=extra_meta)

    def writer_drain(self) -> None:
        """Block until every queued write has been persisted and every
        memory-tier offload has landed — and, with a remote tier, until
        every queued upload has settled too (writes enqueue their own
        uploads, so draining one without the other would leave the
        write-through half-done)."""
        with self._writer_cv:
            while (self._writer_queue or self._inflight_bytes > 0
                   or self._offloads_running):
                self._writer_cv.wait()
        self.remote_drain()

    # -- memory tier (TierStack head) --------------------------------------
    def _mem_offload_enqueue(self, sig: str) -> None:
        """Schedule an async device→host offload of a resident memory-
        tier entry on the writer queue — the same dedicated thread (and
        the same ``writer_drain`` barrier) that owns every other
        off-critical-path materialization write."""
        with self._writer_cv:
            self._writer_queue.append(("offload", sig))
            if self._writer_thread is None \
                    or not self._writer_thread.is_alive():
                self._writer_thread = threading.Thread(
                    target=self._writer_loop, name="store-writer",
                    daemon=True)
                self._writer_thread.start()
            self._writer_cv.notify_all()

    def _mem_offload_run(self, sig: str) -> None:
        """Writer-thread body of one offload: snapshot the entry's
        CUDA tensors into pinned host tensors and swap the snapshot in (a
        racing re-admit of the signature wins — the swap is
        compare-and-set on the exact pytree the snapshot was taken from).

        The copies are issued on this thread's current stream, the
        legacy default stream that the producing kernels also ran on, so
        they are ordered after them; each copy blocks until it has
        landed. A producer on a side stream would need an event here."""
        if self._mem is None:
            return
        ent = self._mem.peek(sig)
        if ent is None or not ent.has_device:
            return
        device_value = ent.value
        t0 = time.perf_counter()
        host_value = tree_map(_leaf_to_host, device_value)
        self._mem.replace_value(sig, host_value, expect=device_value,
                                seconds=time.perf_counter() - t0)

    def _spill_from_mem(self, sig: str, ent: MemEntry) -> None:
        """Demote one dirty (memory-only) entry to the disk tier.

        Called by the memory tier with the entry already removed from
        residency. Skips the write when a durable copy already exists or
        the writer queue owns one in flight — dropping is then free. The
        landed bytes are adjusted into the fleet ledger: nobody reserved
        them, but they are on disk, and ledger==disk outranks momentary
        overshoot (the same honesty call as the read-through populate).

        Crash points frame the torn-demotion window:
        ``memtier:before_spill`` dies with nothing (or only a staging
        ``.tmp-`` dir, reaped at the next heal) on disk — the entry
        vanishes with the process, and recovery is a clean recompute
        because no other process ever saw the signature;
        ``memtier:after_spill`` dies with the entry committed and the
        ledger already adjusted — nothing left to redo."""
        with self._writer_cv:
            queued = sig in self._writer_active or any(
                it[0] == "save" and it[1] == sig
                for it in self._writer_queue)
        if queued or self.has_local(sig):
            return
        self._crash_point("memtier:before_spill")
        extra = {k: v for k, v in ent.meta.items()
                 if k not in ("name", "sig", "nbytes", "save_seconds",
                              "created", "manifest")}
        info = self.save(sig, ent.name or "spill", ent.value,
                         extra_meta=extra, _tier_admit=False,
                         _devices=ent.devices)
        if info.nbytes and not info.replaced \
                and os.path.exists(self.ledger_path):
            StorageLedger(self.ledger_path).adjust(float(info.nbytes))
        self._crash_point("memtier:after_spill")

    def mem_flush(self) -> int:
        """Write-back barrier: spill every dirty memory-tier entry to
        disk (no-op without the tier). Returns the number spilled."""
        return self._mem.flush() if self._mem is not None else 0

    # -- remote tier (write-through / read-through) ------------------------
    def _enqueue_upload(self, sig: str, meta: dict) -> None:
        """Queue one published entry for async upload to the remote
        tier (no-op without one, or while it is degraded). Chunked
        manifests and chunk entries stay in the local tier: a manifest
        names chunk signatures by reference, so shipping it without a
        transactional multi-entry upload would let a remote reader see
        a manifest whose chunks don't exist — a documented local-tier
        limitation for now."""
        if self.remote is None or not self.remote.available():
            return
        if meta.get("chunked") or meta.get("is_chunk"):
            return
        with self._upload_cv:
            self._upload_errors.pop(sig, None)    # a new attempt owns it
            self._upload_queue.append((sig, meta))
            self._uploads_inflight += 1
            if self._upload_thread is None \
                    or not self._upload_thread.is_alive():
                self._upload_thread = threading.Thread(
                    target=self._upload_loop, name="store-uploader",
                    daemon=True)
                self._upload_thread.start()
            self._upload_cv.notify_all()

    def _upload_loop(self) -> None:
        while True:
            with self._upload_cv:
                if not self._upload_queue:
                    # Exit when idle; _enqueue_upload restarts on demand.
                    self._upload_thread = None
                    return
                sig, meta = self._upload_queue.popleft()
                self._upload_running = sig
            crash = None
            try:
                self.remote.upload(sig, self._dir(sig), meta)
            except InjectedCrash as e:
                # A crash point fired in this upload: an upload_now of the
                # signature re-raises it (the process "died" there).
                crash = e
            except BaseException:
                pass   # best-effort; degradation is handled inside upload
            with self._upload_cv:
                self._upload_running = None
                if crash is not None:
                    self._upload_errors[sig] = crash
                self._uploads_inflight -= 1
                self._upload_cv.notify_all()

    def upload_now(self, sig: str) -> bool:
        """Synchronously write-through one published entry.

        The executor calls this for shared signatures *before* releasing
        the compute lease, so a cross-host waiter that wakes on the
        lease vanishing finds the entry committed — the async uploader
        alone would open a recompute window. Idempotent (a committed
        entry is skipped); False without a remote tier, on local miss,
        or when the upload was refused/degraded.

        It owns the upload that ``save`` queued for the entry: a queued
        copy is cancelled and run here; one the uploader thread has
        already started is waited for. If a crash point fired in that
        upload, its ``InjectedCrash`` is raised here, once, instead of a
        second upload silently passing the armed point; any other error
        of it is retried here synchronously."""
        if self.remote is None:
            return False
        try:
            with open(os.path.join(self._dir(sig), "meta.json")) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        if meta.get("chunked") or meta.get("is_chunk"):
            return False   # chunked entries are local-tier only

        with self._upload_cv:
            # The save that published this entry already queued an async
            # upload; cancel it so the entry's bytes don't cross the
            # wire twice (the queue copy would pass the marker check
            # whenever it starts before this synchronous one commits).
            kept = deque(item for item in self._upload_queue
                         if item[0] != sig)
            dropped = len(self._upload_queue) - len(kept)
            if dropped:
                self._upload_queue = kept
                self._uploads_inflight -= dropped
                self._upload_cv.notify_all()
            while self._upload_running == sig:
                self._upload_cv.wait()
            error = self._upload_errors.pop(sig, None)
        if error is not None:
            raise error
        return self.remote.upload(sig, self._dir(sig), meta)

    def remote_drain(self) -> None:
        """Block until the upload queue is empty (no-op without a
        remote tier)."""
        if self.remote is None:
            return
        with self._upload_cv:
            while self._upload_queue or self._uploads_inflight > 0:
                self._upload_cv.wait()

    def _fetch_remote(self, sig: str) -> bool:
        """Read-through: fetch ``sig`` from the remote tier and publish
        it into the local tier. Returns False when the entry is absent
        remotely (or the tier is degraded). The populate is accounted:
        when a fleet budget ledger exists, the entry's bytes are
        adjusted in — nobody reserved them, but they are on disk, and
        the ledger==disk invariant outranks momentary overshoot (the
        next admission's evict-to-fit sees honest occupancy)."""
        if self.remote is None:
            return False
        d = self._dir(sig)
        tmp = (f"{d}.tmp-{os.getpid()}-{threading.get_ident()}"
               f"-{next(self._tmp_counter)}")
        t0 = time.perf_counter()
        meta = self.remote.fetch(sig, tmp)
        fetch_seconds = time.perf_counter() - t0
        if meta is None:
            with self._stats_lock:
                self.load_stats["remote"]["misses"] += 1
            shutil.rmtree(tmp, ignore_errors=True)
            return False
        published = False
        with self._entry_lock(sig):
            if os.path.exists(d):
                # A sibling's fetch (or save) published first — ours is
                # redundant, theirs is equivalent (same signature).
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                os.rename(tmp, d)
                self._index_apply(add={sig: self._index_entry(meta)})
                published = True
        if published:
            nbytes = int(meta.get("nbytes", 0) or 0)
            with self._stats_lock:
                self.remote_hits += 1
                self.load_stats["remote"]["hits"] += 1
                self.load_stats["remote"]["bytes"] += nbytes
                self.load_stats["remote"]["seconds"] += fetch_seconds
            self._tier_bw.observe("remote", "read", nbytes, fetch_seconds)
            if nbytes and os.path.exists(self.ledger_path):
                StorageLedger(self.ledger_path).adjust(float(nbytes))
        return True

    # -- load ------------------------------------------------------------------
    def load(self, sig: str,
             sharding_for_leaf: Callable[[int, tuple, Any], Any] | None = None
             ) -> tuple[Any, float]:
        """Load entry ``sig``. Returns ``(value, seconds)``.

        Every tensor leaf comes back on its home device, the device it
        was saved from, unless ``sharding_for_leaf(i, shape, dtype)``
        (called for each tensor leaf: ``i`` its flatten index, ``dtype``
        its ``torch.dtype``) returns another ``torch.device`` for it;
        a home device this process does not have raises. ``np.ndarray``
        leaves stay numpy arrays on the host. When a leaf was copied onto
        a card, the load waits for the copy before it measures its
        seconds.

        With a remote tier, a local miss falls back to a read-through
        fetch (the entry is published locally, then loaded); the fetch
        wall-time is included in the returned seconds so realized
        per-node runtimes stay honest.

        With a memory tier, a resident signature short-circuits the
        whole path: the stored pytree is handed back (no ``.npy`` read,
        no unpickle, no ``meta.json`` touch — the reuse bump stays
        tier-local), zero-copy for every leaf already where the rule
        above puts it, and every successful disk/remote load
        read-through promotes its value for the next caller.
        """
        if self._mem is not None:
            t0 = time.perf_counter()
            ent = self._mem.get(sig)
            if ent is not None:
                # The entry holds the device tensors (until the offload
                # lands) or their pinned host snapshot: either way each
                # leaf goes where the caller asked, else back home.
                value, moved = self._place_leaves(
                    ent.value, sharding_for_leaf, ent.devices)
                if moved:
                    block_until_ready(value)
                seconds = time.perf_counter() - t0
                self._tier_bw.observe("memory", "read", ent.nbytes,
                                      seconds)
                with self._stats_lock:
                    self.load_stats["memory"]["hits"] += 1
                    self.load_stats["memory"]["bytes"] += ent.nbytes
                    self.load_stats["memory"]["seconds"] += seconds
                return value, seconds
            with self._stats_lock:
                self.load_stats["memory"]["misses"] += 1
        fetch_secs = 0.0
        for attempt in range(4):
            try:
                value, seconds, meta = self._load_once(sig,
                                                       sharding_for_leaf)
                self._note_load(sig)
                with self._stats_lock:
                    self.load_stats["local"]["hits"] += 1
                    self.load_stats["local"]["bytes"] += \
                        int(meta.get("nbytes", 0) or 0)
                    self.load_stats["local"]["seconds"] += seconds
                if (self._mem is not None and not meta.get("chunked")
                        and not isinstance(value, Chunked)):
                    # Read-through promotion (chunk entries promote
                    # individually; manifests don't — their payload is
                    # not the value).
                    self._mem.put(
                        sig, value,
                        int(meta.get("nbytes", 0) or tree_nbytes(value)),
                        name=meta.get("name", ""), meta=meta,
                        state="durable",
                        devices=tuple(leaf.get("device")
                                      for leaf in meta["manifest"]))
                return value, seconds + fetch_secs
            except FileNotFoundError:
                # Either we raced an overwrite of the same signature (tmp
                # dir swapped in under us — retry against the fresh copy)
                # or the entry was never local (remote tier fallback).
                if self.remote is not None and not self.has_local(sig):
                    with self._stats_lock:
                        self.load_stats["local"]["misses"] += 1
                    t0 = time.perf_counter()
                    fetched = self._fetch_remote(sig)
                    fetch_secs += time.perf_counter() - t0
                    if fetched:
                        continue
                if attempt == 3 or not self.has(sig):
                    raise
        raise AssertionError("unreachable")

    @staticmethod
    def _place_leaves(value: Any, sharding_for_leaf,
                      devices: tuple) -> tuple[Any, bool]:
        """Place a memory-resident pytree's tensor leaves: on the
        caller's devices, else on their home ``devices``. Leaf numbering
        matches the saved manifest (both are the pytree flatten order),
        so ``sharding_for_leaf`` sees the same indices it would on a disk
        load; non-tensor leaves pass through untouched. Copies from
        pinned memory are issued without blocking; returns the value and
        whether any leaf was copied, which the caller then waits for."""
        leaves, treedef = tree_flatten(value)
        placed, moved = [], False
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, torch.Tensor):
                device = _leaf_target(sharding_for_leaf, i, tuple(leaf.shape),
                                      leaf.dtype, devices[i])
                new = _place_leaf(leaf, device)
                moved = moved or new is not leaf
                leaf = new
            placed.append(leaf)
        return tree_unflatten(treedef, placed), moved

    def _load_once(self, sig: str, sharding_for_leaf
                   ) -> tuple[Any, float, dict]:
        t0 = time.perf_counter()
        d = self._dir(sig)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        ch = meta.get("chunked")
        if ch and ch.get("combine") == "concat":
            # Partitioned materialization: reassemble from the per-chunk
            # entries (each load updates bandwidth/reuse stats itself; no
            # manifest-level bandwidth sample — its payload is empty).
            # Reduce manifests fall through: their payload *is* the
            # combined value.
            chunks = []
            for cs in ch["chunk_sigs"]:
                v, _ = self.load(cs)
                chunks.append(v)
            value = Chunked(chunks, ch["chunk_sigs"], "concat")
            return value, time.perf_counter() - t0, meta
        with open(os.path.join(d, "treedef.pkl"), "rb") as f:
            treedef = pickle.load(f)

        def load_leaf(i_ent):
            i, ent = i_ent
            path = os.path.join(d, ent["file"])
            if ent["kind"] == "tensor":
                with self._stats_lock:
                    self.npy_leaf_reads += 1
                shape = tuple(ent["shape"])
                dtype = getattr(torch, ent["dtype"])
                device = _leaf_target(sharding_for_leaf, i, shape, dtype,
                                      ent.get("device"))
                if device.type == "cuda":
                    # Read into pinned memory, then copy without blocking.
                    host = torch.empty(shape, dtype=dtype, pin_memory=True)
                    bits = np.load(path, mmap_mode="r").reshape(-1)
                    host.reshape(-1).view(torch.uint8).numpy()[:] = \
                        bits.view(np.uint8)
                    return _place_leaf(host, device)
                return _place_leaf(
                    torch.from_numpy(np.load(path)).view(dtype), device)
            if ent["kind"] == "array":
                with self._stats_lock:
                    self.npy_leaf_reads += 1
                return np.load(path).view(np.dtype(ent["dtype"]))
            with open(path, "rb") as f:
                return pickle.load(f)

        items = list(enumerate(meta["manifest"]))
        n_big_arrays = sum(
            1 for _, ent in items if ent["kind"] in ("array", "tensor")
            and int(np.prod(ent["shape"] or [1])) >= _PARALLEL_LEAF_MIN_BYTES // 8)
        if n_big_arrays >= 2:
            leaves = list(_leaf_io_pool().map(load_leaf, items))
        else:
            leaves = [load_leaf(it) for it in items]
        # Placed leaves were copied without blocking (from the pool's
        # threads too: all on the legacy default stream) — wait for them.
        value = block_until_ready(tree_unflatten(treedef, leaves))
        seconds = time.perf_counter() - t0
        self._update_bw("read", meta["nbytes"], seconds)
        return value, seconds, meta

    def _note_load(self, sig: str) -> None:
        """Record one observed load of ``sig`` (count + recency) in its
        ``meta.json`` — the per-entry reuse signal fleet eviction ranks
        against. Runs under the per-signature entry lock (same order as
        save/delete: entry lock, then index lock) and is best-effort: a
        concurrent delete simply wins.

        The *global* index is only re-synced when the count crosses a
        power of two: a per-load index RMW would serialize every load of
        every session on one flock'd file — exactly the load-heavy reuse
        path the store optimizes. O(log loads) index writes keep the
        evictor's ranking fresh where it matters (the 0→1 transition is
        the big protection signal; recency staleness only tie-breaks),
        and rebuild_index heals the index from meta.json after crashes.

        The entry lock is taken *non-blocking*: concurrent loaders of
        one hot entry (K variants pulling the same shared prefix) must
        never queue on a bookkeeping write — a contended bump is simply
        dropped, slightly undercounting a signal that is already hot."""
        now = time.time()
        lock = self._entry_lock(sig)
        if not lock.acquire(blocking=False):
            return  # someone else is recording/publishing — skip the bump
        try:
            mp = os.path.join(self._dir(sig), "meta.json")
            try:
                with open(mp) as f:
                    meta = json.load(f)
            except (FileNotFoundError, NotADirectoryError,
                    json.JSONDecodeError):
                return  # deleted (or overwrite-in-flight) under us
            loads = int(meta.get("loads", 0)) + 1
            meta["loads"] = loads
            meta["last_load"] = now
            if not self._rewrite_json(mp, meta):
                return
            if loads & (loads - 1) == 0:    # 1, 2, 4, 8, …
                self._index_apply(add={sig: self._index_entry(meta)})
        finally:
            lock.release()

    # -- compute / read leases (in-flight dedupe) --------------------------------
    def acquire_compute(self, sig: str) -> ComputeLease | None:
        """Try to take the fleet-wide compute lease for ``sig``.

        Returns a :class:`ComputeLease` when this caller should compute the
        value, or ``None`` when another session currently holds the lease
        (→ ``wait_compute`` and then load-or-retry). With a remote tier
        the lease is two-scope: local ``flock`` first (host-internal
        dedupe), then the remote TTL lease object (cross-host dedupe).
        A degraded remote tier is skipped — the host proceeds local-only,
        risking at worst one duplicate compute per signature fleet-wide."""
        lock = FileLock(self._lease_path(sig))
        if not lock.acquire(blocking=False):
            return None
        remote_lease = None
        if self.remote is not None and self.remote.available():
            remote_lease = self.remote.acquire_compute(sig)
            if remote_lease is None and self.remote.available():
                # A live holder on another host — not a degradation.
                lock.release()
                return None
        return ComputeLease(self, sig, lock, remote_lease=remote_lease)

    def wait_compute(self, sig: str, timeout: float | None = None,
                     cancel: "threading.Event | None" = None) -> bool:
        """Block until the current compute lease on ``sig`` is released.

        Registers a waiter marker first, so the lease holder knows the
        result is wanted fleet-wide and force-persists it before releasing.
        Returns False on timeout (the caller should fall back to computing
        the value itself — bounded waits keep the fleet deadlock-free even
        under pathological cross-session lease chains). ``cancel`` (a
        ``threading.Event``) aborts the wait early with False — the
        executor passes its job cancel flag so a cancelled session never
        sits out a long lease wait.

        With a remote tier, the holder may be on another host: the local
        ``flock`` is then uncontended and the wait continues by polling
        the remote TTL lease (with a remote waiter marker registered so
        the holder publishes before releasing)."""
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        marker = os.path.join(self._fleet_dir("leases"),
                              f"{sig}.w-{uuid.uuid4().hex}")
        remote_waiter = None
        try:
            with open(marker, "w") as f:
                f.write(str(os.getpid()))
            if self.remote is not None and self.remote.available():
                # Mirror the local protocol: register BEFORE waiting, so
                # a cross-host holder sees this waiter at its
                # post-compute persist decision (registering only once
                # the remote poll starts would lose the race against
                # fast nodes).
                remote_waiter = self.remote.register_waiter(sig)
            waiter = FileLock(self._lease_path(sig), shared=True)
            if not waiter.acquire(timeout=timeout, cancel=cancel):
                return False
            waiter.release()
            if cancel is not None and cancel.is_set():
                return False
            if self.remote is None:
                return True
            return self._wait_remote(sig, deadline, cancel=cancel)
        finally:
            if remote_waiter is not None:
                remote_waiter.release()
            try:
                os.unlink(marker)
            except OSError:
                pass

    def _wait_remote(self, sig: str, deadline: float | None,
                     cancel: "threading.Event | None" = None) -> bool:
        """Poll a cross-host compute lease until it releases/expires, the
        entry appears, or the deadline passes (False) — or ``cancel``
        fires (False). The caller (``wait_compute``) holds a remote TTL
        waiter marker for the duration, so the remote holder knows to
        force-persist. Probes bypass the marker cache — a stale negative
        here would send the caller straight into a duplicate compute."""
        remote = self.remote
        if remote is None or not remote.available():
            return True   # degraded: behave local-only
        interval = 0.05
        while True:
            if cancel is not None and cancel.is_set():
                return False
            if self.has_local(sig):
                return True
            # Fresh marker probe BEFORE the lease probe: a holder
            # commits then releases, so observing "no lease" with a
            # stale cached negative marker would send the caller into a
            # recompute of a committed entry. Probing the marker first
            # (and thereby refreshing the cache) closes that window.
            if remote.marker_meta(sig, fresh=True) is not None:
                return True
            if not remote.lease_live(sig):
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            sleep = interval
            if deadline is not None:
                sleep = min(sleep,
                            max(deadline - time.monotonic(), 0.01))
            time.sleep(sleep)
            interval = min(interval * 1.6, 1.0)

    @staticmethod
    def _waiter_is_dead(path: str) -> bool:
        """A waiter marker is stale iff its recorded pid is provably dead
        (same host) or the marker outlived any plausible lease wait."""
        try:
            pid = int(open(path).read().strip() or 0)
        except (OSError, ValueError):
            pid = 0
        if pid > 0:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                return True
            except PermissionError:
                pass  # alive, different user
        try:
            return (time.time() - os.stat(path).st_mtime
                    > Store._TMP_ORPHAN_SECONDS)
        except OSError:
            return False  # already unlinked by its owner

    def _count_waiters(self, sig: str) -> int:
        prefix = f"{sig}.w-"
        n = 0
        try:
            names = os.listdir(self._fleet_dir("leases"))
        except FileNotFoundError:
            return 0
        for name in names:
            if not name.startswith(prefix):
                continue
            path = os.path.join(self._fleet_dir("leases"), name)
            if self._waiter_is_dead(path):
                # Crashed waiter (SIGKILL before its finally-unlink):
                # reap so it cannot force-persist values forever.
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            n += 1
        if self.remote is not None:
            n += self.remote.count_waiters(sig)
        return n

    def any_live_lease(self) -> bool:
        """Is any signature's lease (compute or read pin) currently held?
        Used as a guard before fleet-wide maintenance like a ledger
        reconcile — a held lease means another session is mid-run."""
        try:
            names = os.listdir(self._fleet_dir("leases"))
        except FileNotFoundError:
            return False
        for name in names:
            if not name.endswith(".lease"):
                continue
            if FileLock(os.path.join(self._fleet_dir("leases"), name)
                        ).locked_elsewhere():
                return True
        return False

    def acquire_read(self, sig: str) -> ReadPin | FileLock | None:
        """Pin ``sig`` against eviction (shared lease; see ``delete``).
        Non-blocking: returns None when the signature is being computed
        right now (then there is nothing on disk to pin yet anyway).

        When the entry exists only in the remote tier (a planned LOAD
        that will fetch), the pin extends to a remote TTL pin so no
        other host's remote eviction can delete the entry between this
        host's plan and its load."""
        lock = FileLock(self._lease_path(sig), shared=True)
        if not lock.acquire(blocking=False):
            return None
        if self.remote is None:
            return lock
        remote_pin = None
        if not self.has_local(sig) and self.remote.exists(sig):
            remote_pin = self.remote.acquire_pin(sig)
        return ReadPin(lock, remote_pin)

    # -- metadata / management ---------------------------------------------------
    def meta(self, sig: str) -> dict:
        """Entry metadata: local ``meta.json``, else the memory tier's
        resident record (write-back entries have no disk copy yet), else
        the remote commit marker (which carries name/nbytes/benefit
        stats — enough for the planner's load-cost estimate on a
        not-yet-fetched entry)."""
        try:
            with open(os.path.join(self._dir(sig), "meta.json")) as f:
                return json.load(f)
        except (FileNotFoundError, NotADirectoryError):
            if self._mem is not None:
                ent = self._mem.peek(sig)
                if ent is not None:
                    return dict(ent.meta)
            if self.remote is not None:
                marker = self.remote.marker_meta(sig)
                if marker is not None:
                    return marker
            raise

    def delete(self, sig: str, respect_leases: bool = True,
               keep_chunks: "frozenset | set | tuple" = ()) -> int:
        """Remove an entry; returns bytes freed (0 if absent or leased).

        With ``respect_leases`` (default), entries another session is
        actively computing or has pinned for a planned LOAD are left alone
        — fleet eviction must not yank values out from under a live
        session. The exclusive lease is *held* for the duration of the
        removal (not probed and dropped), so a read pin can never slip in
        between the check and the delete.

        Deleting a chunked *manifest* cascades to its chunk entries —
        except chunks another manifest still references, and chunks in
        ``keep_chunks`` (the §6.6 purge passes the chunk signatures the
        upcoming delta will splice from, so a stale manifest's removal
        never strands its still-valid sibling chunks). The returned byte
        count includes the cascade, so ledger credits stay equal to the
        bytes that actually left the disk."""
        lease_guard = None
        if respect_leases:
            lease_guard = FileLock(self._lease_path(sig))
            if not lease_guard.acquire(blocking=False):
                return 0
        chunk_sigs: list | None = None
        try:
            with self._entry_lock(sig):
                d = self._dir(sig)
                if not os.path.exists(d):
                    # Deletion is tier-wide: a memory-only resident copy
                    # (write-back, or a promotion outliving a sibling's
                    # disk delete) goes too, so tiers never disagree.
                    # Its bytes live in the memory tier's own ledger —
                    # nothing to credit to the disk ledger.
                    if self._mem is not None:
                        self._mem.drop(sig)
                    return 0
                try:
                    with open(os.path.join(d, "meta.json")) as f:
                        meta = json.load(f)
                    nbytes = meta.get("nbytes", 0)
                    chunk_sigs = meta.get("chunked", {}).get("chunk_sigs")
                except (FileNotFoundError, json.JSONDecodeError):
                    nbytes = 0
                self._retire_dir(d)
                self._index_apply(remove=[sig])
            if self._mem is not None:
                self._mem.drop(sig)
        finally:
            if lease_guard is not None:
                lease_guard.release()
        if chunk_sigs:
            nbytes += self._reap_unreferenced_chunks(
                chunk_sigs, keep_chunks, respect_leases)
        return nbytes

    def _reap_unreferenced_chunks(self, chunk_sigs, keep_chunks,
                                  respect_leases: bool) -> int:
        """Delete the given chunk entries unless some surviving manifest
        still references them (sibling variants share prefix chunks) or
        the caller asked to keep them. Two concurrent manifest deletes
        can each see the other's manifest alive and both skip a chunk —
        that orphan is :meth:`gc_orphan_chunks`'s job, never a lost
        value."""
        referenced: set = set()
        for ent in self.entries().values():
            referenced.update(ent.get("chunk_sigs", ()))
        freed = 0
        for cs in dict.fromkeys(chunk_sigs):
            if cs in keep_chunks or cs in referenced:
                continue
            freed += self.delete(cs, respect_leases=respect_leases)
        return freed

    def gc_orphan_chunks(self, min_age_seconds: float = 3600.0
                         ) -> tuple[int, int]:
        """Reclaim chunk entries no manifest references.

        Orphans come from a crash between chunk publish and manifest
        publish (the manifest is the splice's commit point) and from
        concurrent manifest deletes racing each other's reference scans.
        ``min_age_seconds`` protects in-flight splices — a live save may
        have published chunks whose manifest is milliseconds away.
        Returns ``(entries_reclaimed, bytes_reclaimed)``; callers credit
        the bytes to their ledger (the evictor's ``credit`` path)."""
        entries = self.entries()
        referenced = {cs for ent in entries.values()
                      for cs in ent.get("chunk_sigs", ())}
        now = time.time()
        n = freed = 0
        for sig, ent in entries.items():
            if not ent.get("is_chunk") or sig in referenced:
                continue
            if now - float(ent.get("created", now)) < min_age_seconds:
                continue
            nbytes = self.delete(sig)
            if nbytes > 0:
                n += 1
                freed += nbytes
        return n, freed

    # -- on-disk index ------------------------------------------------------------
    @staticmethod
    def _index_entry(meta: dict) -> dict:
        out = {"name": meta.get("name"), "nbytes": meta.get("nbytes", 0),
               "created": meta.get("created", 0.0)}
        # Benefit metadata for fleet eviction: cost-to-recompute C(n) and
        # the load-cost estimate recorded at save time (see eviction.py),
        # plus the observed load count / recency maintained by _note_load.
        # Mirrored here so ranking a whole store is one index read.
        for key in ("compute_s", "load_s_est", "loads", "last_load"):
            if key in meta:
                out[key] = meta[key]
        # Chunk bookkeeping, mirrored so manifest↔chunk reference scans
        # (delete cascade, gc_orphan_chunks, evictor sizing) are one
        # index read instead of N meta.json opens.
        if meta.get("is_chunk"):
            out["is_chunk"] = True
        ch = meta.get("chunked")
        if ch:
            out["chunk_sigs"] = list(ch.get("chunk_sigs", ()))
            out["chunk_bytes"] = ch.get("chunk_bytes", 0)
        return out

    def _index_apply(self, add: dict[str, dict] | None = None,
                     remove: list[str] | None = None) -> None:
        def txn(index):
            index.update(add or {})
            for sig in remove or ():
                index.pop(sig, None)
            return index

        update_json(self.index_path, txn, {})

    def rebuild_index(self) -> dict[str, dict]:
        """Reconcile the index with a directory scan (ground truth). Runs
        inside the index lock so concurrent publishes are not lost: they
        either precede the scan (and are seen) or follow the write (and
        re-add themselves)."""
        return update_json(
            self.index_path,
            lambda _cur: {sig: self._index_entry(m)
                          for sig, m in self._scan_entries().items()},
            {})

    def _scan_entries(self) -> dict[str, dict]:
        out = {}
        if not os.path.exists(self.root):
            return out
        for sub in sorted(os.listdir(self.root)):
            subdir = os.path.join(self.root, sub)
            if sub.startswith(".") or not os.path.isdir(subdir):
                continue
            for sig in sorted(os.listdir(subdir)):
                if ".tmp-" in sig:
                    continue  # in-progress staging dir, not an entry
                mp = os.path.join(subdir, sig, "meta.json")
                try:
                    with open(mp) as f:
                        out[sig] = json.load(f)
                except (FileNotFoundError, NotADirectoryError,
                        json.JSONDecodeError):
                    continue  # raced a concurrent delete / in-progress save
        return out

    def entries(self) -> dict[str, dict]:
        """Entry metadata by signature, served from the on-disk index
        (one atomic read; kept transactionally in sync by save/delete).
        A missing index (deleted out of band, or healing skipped) is
        rebuilt from the directory scan on demand."""
        index = read_json(self.index_path, None)
        if index is None:
            index = self.rebuild_index()
        return index

    def sigs_by_name(self) -> dict[str, list[str]]:
        by: dict[str, list[str]] = {}
        for sig, meta in self.entries().items():
            by.setdefault(meta["name"], []).append(sig)
        return by

    def total_bytes(self) -> int:
        """Local-tier on-disk bytes (the number the fleet ledger mirrors;
        the remote tier accounts its own — see ``tier_status``)."""
        return sum(m.get("nbytes", 0) for m in self.entries().values())

    def lease_counts(self) -> dict:
        """Live local-tier lease census: ``{"compute", "pins",
        "waiters"}``. Each ``.lease`` file's flock is probed (exclusive
        holder = a compute lease, shared holders = read pins); waiter
        markers are counted live-only. A snapshot for observability
        (``SessionServer.status()`` / docs/operations.md) — not a
        synchronization primitive."""
        out = {"compute": 0, "pins": 0, "waiters": 0}
        try:
            names = os.listdir(self._fleet_dir("leases"))
        except FileNotFoundError:
            return out
        for name in names:
            path = os.path.join(self._fleet_dir("leases"), name)
            if ".w-" in name:
                if not self._waiter_is_dead(path):
                    out["waiters"] += 1
                continue
            if not name.endswith(".lease"):
                continue
            state = FileLock(path).probe()
            if state == "exclusive":
                out["compute"] += 1
            elif state == "shared":
                out["pins"] += 1
        return out

    def tier_status(self) -> dict:
        """Per-tier observability snapshot, in TierStack order (memory →
        local → remote). Every attached tier reports one **unified
        record** — ``{name, bytes, budget, entries, leases, hits,
        misses}`` — plus tier-specific extras (memory: dirty/demotions/
        spills/offloads; local: ``remote_hits``; remote: ``available``
        and the transfer stats). ``budget`` is None where the store does
        not own one (the disk budget lives in the Materializer's
        ledger). Unattached tiers are None. The server's
        ``status()["tiers"]`` returns exactly this snapshot — one schema
        at both layers."""
        entries = self.entries()
        with self._stats_lock:
            stats = {tier: dict(d) for tier, d in self.load_stats.items()}
            remote_hits = self.remote_hits
        status: dict = {
            "memory": (self._mem.status()
                       if self._mem is not None else None),
            "local": {
                "name": "local",
                "bytes": sum(int(m.get("nbytes", 0) or 0)
                             for m in entries.values()),
                "budget": None,
                "entries": len(entries),
                "leases": self.lease_counts(),
                "hits": stats["local"]["hits"],
                "misses": stats["local"]["misses"],
                "remote_hits": remote_hits,
            },
            "remote": None,
        }
        if self.remote is not None:
            remote_entries = self.remote.entries()
            status["remote"] = {
                "name": "remote",
                "available": self.remote.available(),
                "bytes": sum(int(m.get("nbytes", 0) or 0)
                             for m in remote_entries.values()),
                "budget": None,
                "entries": len(remote_entries),
                "leases": self.remote.lease_counts(),
                "hits": stats["remote"]["hits"],
                "misses": stats["remote"]["misses"],
                **self.remote.stats.snapshot(),
            }
        return status

    # -- bandwidth model (feeds l_i estimates) ------------------------------------
    def _update_bw(self, key: str, nbytes: int, seconds: float) -> None:
        # Merge-on-flush: the observation is EWMA-blended into the shared
        # on-disk estimate under its lock, so concurrent sessions (and the
        # pipelined executor's worker threads) refine one number.
        if seconds <= 0 or nbytes <= 0:
            return
        self._bw.update(key, nbytes / seconds)

    def est_load_seconds(self, nbytes: float, sig: str | None = None
                         ) -> float:
        """Estimated seconds to load ``nbytes`` — the paper's ``l_i``,
        priced per tier: with a ``sig``, the cheapest tier that can
        serve it (memory → local → remote, each with its own measured
        EWMA bandwidth and latency floor). Without one (or for an entry
        resident nowhere) the local disk tier is priced — the durable
        default every *write* decision reasons about, and numerically
        identical to the historical single-number estimate."""
        tier = "local"
        if sig is not None:
            if self._mem is not None and self._mem.has(sig):
                tier = "memory"
            elif self.has_local(sig):
                tier = "local"
            elif self.remote is not None and self.remote.exists(sig):
                tier = "remote"
        return self._tier_bw.est_load_seconds(tier, nbytes)
