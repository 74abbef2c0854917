"""The port's cross-process store concurrency (``repro_torch.core``), one
case for each test of the JAX package's ``tests/test_store_concurrency.py``,
by the same name: compute leases, the on-disk index, the shared budget
ledger, ``FileLock``, and merge-on-flush statistics.

The multiprocessing tests spawn real OS processes against one store root,
as the reference's do (N sweep workers or sessions on one filesystem).
Everything must hold with zero shared Python state. Imports no JAX.
"""
import multiprocessing as mp
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.core.costs import CostModel
from repro_torch.core.locking import (FileLock, HAVE_FLOCK, SharedEwma,
                                      StorageLedger)
from repro_torch.core.store import Store


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: when several test processes
    share the cores, torch's OpenMP pool spins at each of its small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.skipif(
    not HAVE_FLOCK, reason="fleet mode needs POSIX flock")


def _sig_value(sig: str) -> np.ndarray:
    return np.full(256, float(int(sig, 16) % 97))


SIGS = [f"{i:02x}a7" for i in range(6)]


def _lease_worker(root: str, order: list[str], budget: float, q) -> None:
    """One fleet member: compute-or-wait every signature (the executor's
    dedupe loop, distilled), persisting under the shared budget ledger."""
    try:
        store = Store(root)
        ledger = StorageLedger(store.ledger_path)
        computed, loaded = [], []
        for sig in order:
            while True:
                if store.has(sig):
                    value, _ = store.load(sig)
                    assert np.array_equal(value, _sig_value(sig)), \
                        f"corrupt read for {sig}"
                    loaded.append(sig)
                    break
                lease = store.acquire_compute(sig)
                if lease is not None:
                    try:
                        time.sleep(0.05)  # the "expensive" compute
                        if ledger.try_reserve(_sig_value(sig).nbytes,
                                              budget):
                            store.save(sig, f"node-{sig}", _sig_value(sig))
                        computed.append(sig)
                    finally:
                        lease.release()
                    break
                if not store.wait_compute(sig, timeout=30):
                    raise TimeoutError(f"lease wait timed out for {sig}")
        q.put(("ok", os.getpid(), computed, loaded))
    except BaseException as e:  # pragma: no cover - failure path
        q.put(("err", os.getpid(), repr(e), []))


def _churn_worker(root: str, seed: int, budget: float, q) -> None:
    """Hammer save/load/delete on a small signature set under the shared
    ledger; every observation must be a whole, uncorrupted entry."""
    try:
        rng = np.random.default_rng(seed)
        store = Store(root)
        ledger = StorageLedger(store.ledger_path)
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            sig = SIGS[int(rng.integers(len(SIGS)))]
            op = rng.integers(3)
            if op == 0:
                if ledger.try_reserve(_sig_value(sig).nbytes, budget):
                    store.save(sig, f"node-{sig}", _sig_value(sig))
            elif op == 1:
                try:
                    value, _ = store.load(sig)
                    assert np.array_equal(value, _sig_value(sig))
                except FileNotFoundError:
                    pass  # concurrently deleted — acceptable
            else:
                freed = store.delete(sig)
                if freed:
                    ledger.release(freed)
        q.put(("ok", os.getpid(), [], []))
    except BaseException as e:  # pragma: no cover - failure path
        q.put(("err", os.getpid(), repr(e), []))


def _collect(procs, q):
    results = []
    for _ in procs:
        results.append(q.get(timeout=120))
    for p in procs:
        p.join(timeout=30)
    errs = [r for r in results if r[0] == "err"]
    assert not errs, errs
    return results


@pytest.mark.parametrize("n_procs", [4])
def test_multiprocess_compute_once_and_index_consistent(tmp_path, n_procs):
    """N processes race the same signatures: each signature is computed by
    exactly one process fleet-wide, every load observes whole data, and
    the on-disk index ends exactly in sync with the filesystem."""
    root = str(tmp_path / "store")
    Store(root)  # pre-create so children skip racing the initial mkdir
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    rng = np.random.default_rng(0)
    procs = []
    for i in range(n_procs):
        order = list(rng.permutation(SIGS))
        p = ctx.Process(target=_lease_worker,
                        args=(root, order, float("inf"), q))
        p.start()
        procs.append(p)
    results = _collect(procs, q)

    all_computed = [sig for r in results for sig in r[2]]
    assert sorted(all_computed) == sorted(SIGS), (
        f"double-compute or miss: {all_computed}")
    store = Store(root)
    assert set(store.entries()) == set(SIGS)
    # index == filesystem, byte for byte
    scan = store._scan_entries()
    assert set(scan) == set(store.entries())
    assert store.total_bytes() == sum(m["nbytes"] for m in scan.values())
    for sig in SIGS:
        value, _ = store.load(sig)
        assert np.array_equal(value, _sig_value(sig))


def test_multiprocess_churn_no_corruption_budget_respected(tmp_path):
    """Racing save/load/delete across processes under one shared budget:
    no torn entries, index consistent, ledger never exceeds the budget."""
    root = str(tmp_path / "store")
    Store(root)
    budget = 3.5 * 256 * 8  # fits ~3 of the 6 entries
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_churn_worker, args=(root, i, budget, q))
             for i in range(4)]
    for p in procs:
        p.start()
    _collect(procs, q)

    store = Store(root)
    scan = store._scan_entries()
    assert set(scan) == set(store.entries())
    for sig in scan:
        value, _ = store.load(sig)
        assert np.array_equal(value, _sig_value(sig))
    ledger = StorageLedger(store.ledger_path)
    assert 0.0 <= ledger.used() <= budget
    # the churn always reserved before saving, so what survived fits too
    assert store.total_bytes() <= budget


# ---------------------------------------------------------------------------
# single-process unit coverage of the fleet primitives
# ---------------------------------------------------------------------------
def test_filelock_excludes_within_process(tmp_path):
    path = str(tmp_path / "x.lock")
    a = FileLock(path)
    assert a.acquire(blocking=False)
    b = FileLock(path)
    assert not b.acquire(blocking=False)
    assert b.locked_elsewhere()
    a.release()
    assert b.acquire(blocking=False)
    b.release()


def test_filelock_shared_readers_coexist(tmp_path):
    path = str(tmp_path / "x.lock")
    r1, r2 = FileLock(path, shared=True), FileLock(path, shared=True)
    assert r1.acquire(blocking=False) and r2.acquire(blocking=False)
    w = FileLock(path)
    assert not w.acquire(blocking=False)   # writers excluded by readers
    r1.release(), r2.release()
    assert w.acquire(blocking=False)
    w.release()


def test_compute_lease_waiters_and_takeover(tmp_path):
    store = Store(str(tmp_path))
    lease = store.acquire_compute("ab01")
    assert lease is not None
    assert store.acquire_compute("ab01") is None   # held
    assert lease.waiters() == 0
    assert not store.wait_compute("ab01", timeout=0.05)  # times out
    lease.release()
    assert store.wait_compute("ab01", timeout=0.05)      # free now
    lease2 = store.acquire_compute("ab01")               # takeover
    assert lease2 is not None
    lease2.release()


def test_delete_respects_live_leases(tmp_path):
    store = Store(str(tmp_path))
    store.save("cd02", "x", np.zeros(16))
    pin = store.acquire_read("cd02")
    assert pin is not None
    assert store.delete("cd02") == 0          # pinned: eviction refused
    assert store.has("cd02")
    pin.release()
    assert store.delete("cd02") > 0
    assert not store.has("cd02")


def test_index_heals_after_out_of_band_changes(tmp_path):
    store = Store(str(tmp_path))
    store.save("ee03", "x", np.zeros(16))
    # simulate a crashed process that published a dir but died pre-index
    other = Store(str(tmp_path))
    other.save("ee04", "y", np.zeros(16))
    os.remove(other.index_path)
    healed = Store(str(tmp_path), heal=True)   # forced heal rebuilds
    assert set(healed.entries()) == {"ee03", "ee04"}
    # and even without healing, a missing index rebuilds on demand
    os.remove(healed.index_path)
    lazy = Store(str(tmp_path), heal=False)
    assert set(lazy.entries()) == {"ee03", "ee04"}


def test_fleet_metadata_reaped(tmp_path):
    """Lock/lease files of long-gone signatures, dead waiter markers, and
    crashed atomic-publish temps are pruned on reopen; metadata of live
    entries and recent signatures survives."""
    import subprocess

    store = Store(str(tmp_path))
    store.save("aa10", "keep", np.zeros(8))
    lease = store.acquire_compute("aa10")
    lease.release()
    # cold signature without an entry: aged lock + lease files
    old = time.time() - 2 * Store._TMP_ORPHAN_SECONDS
    for path in (store._entry_lock("bb20").path, store._lease_path("bb20"),
                 store._entry_lock("aa10").path, store._lease_path("aa10")):
        open(path, "a").close()
        os.utime(path, (old, old))
    # dead waiter marker + crashed update_json temp
    proc = subprocess.Popen(["true"])
    proc.wait()
    marker = os.path.join(store._fleet_dir("leases"), "cc30.w-deadbeef")
    with open(marker, "w") as f:
        f.write(str(proc.pid))
    crash_tmp = store.index_path + f".tmp-{proc.pid}-1"
    open(crash_tmp, "w").close()

    store2 = Store(str(tmp_path), heal=True)
    assert not os.path.exists(store2._lease_path("bb20"))
    assert not os.path.exists(store2._entry_lock("bb20").path)
    assert not os.path.exists(marker)
    assert not os.path.exists(crash_tmp)
    # live entry's metadata kept even though the files are old
    assert os.path.exists(store2._lease_path("aa10"))
    value, _ = store2.load("aa10")
    assert np.array_equal(value, np.zeros(8))
    # and the lease protocol still works after the sweep
    lease = store2.acquire_compute("bb20")
    assert lease is not None
    lease.release()


def test_storage_ledger_reserve_release(tmp_path):
    ledger = StorageLedger(str(tmp_path / "ledger.json"))
    assert ledger.try_reserve(100, budget=150)
    assert not ledger.try_reserve(100, budget=150)  # would exceed
    assert ledger.used() == 100
    ledger.release(40)
    assert ledger.try_reserve(90, budget=150)
    assert ledger.used() == 150


def test_shared_ewma_merges_across_instances(tmp_path):
    path = str(tmp_path / "bw.json")
    a = SharedEwma(path, alpha=0.5, flush_interval=0.0)
    b = SharedEwma(path, alpha=0.5, flush_interval=0.0)
    assert a.update("read", 100.0) == pytest.approx(100.0)
    merged = b.update("read", 200.0)   # blends with a's on-disk value
    assert merged == pytest.approx(150.0)
    fresh = SharedEwma(path)
    assert fresh.get("read") == pytest.approx(150.0)


def test_shared_ewma_throttles_disk_flushes(tmp_path):
    path = str(tmp_path / "bw.json")
    ewma = SharedEwma(path, alpha=0.5, flush_interval=3600.0)
    ewma.update("read", 100.0)          # first observation flushes
    mtime = os.stat(path).st_mtime_ns
    for _ in range(50):
        ewma.update("read", 200.0)      # in-memory only
    assert os.stat(path).st_mtime_ns == mtime
    assert ewma.get("read") > 100.0     # local estimate still advances


def test_cost_model_merge_on_flush(tmp_path):
    path = str(tmp_path / "costs.json")
    a, b = CostModel(path), CostModel(path)
    a.record("s1", compute_seconds=1.0)
    a.record("s2", compute_seconds=4.0)
    b.record("s2", compute_seconds=2.0)
    b.record("s3", compute_seconds=3.0)
    a.save()
    b.save()   # must not clobber a's flush
    fresh = CostModel(path)
    assert fresh.seen == {"s1", "s2", "s3"}
    assert fresh.compute_s["s1"] == 1.0
    assert fresh.compute_s["s3"] == 3.0
    # overlapping key was blended, not overwritten
    assert 2.0 <= fresh.compute_s["s2"] <= 4.0


def test_cost_model_stale_reads_not_remerged(tmp_path):
    """Values a session merely *read* at init must not dilute a sibling's
    fresher measurement when the reader flushes."""
    path = str(tmp_path / "costs.json")
    seed = CostModel(path)
    seed.record("x", compute_seconds=100.0)
    seed.save()
    reader = CostModel(path)       # loads x=100 but never measures it
    sibling = CostModel(path)
    sibling.record("x", compute_seconds=2.0)
    sibling.save()                 # fresh measurement lands on disk
    reader.record("y", compute_seconds=1.0)
    reader.save()                  # must not drag x back toward 100
    fresh = CostModel(path)
    assert fresh.compute_s["x"] < 50.0
    assert fresh.compute_s["y"] == 1.0


def test_save_reports_replaced_and_ledger_self_corrects(tmp_path):
    """Two fleet members racing one signature each reserve budget; the
    overwrite is reported so the loser's reservation can be credited
    back — the ledger converges to one entry's worth."""
    store = Store(str(tmp_path))
    ledger = StorageLedger(store.ledger_path)
    value = np.zeros(256)
    budget = 10 * value.nbytes
    assert ledger.try_reserve(value.nbytes, budget)
    info1 = store.save("ff01", "x", value)
    assert not info1.replaced
    assert ledger.try_reserve(value.nbytes, budget)
    info2 = store.save("ff01", "x", value)
    assert info2.replaced
    ledger.release(value.nbytes)   # what the executor does on replaced
    assert ledger.used() == value.nbytes
    assert store.total_bytes() == value.nbytes


# ---------------------------------------------------------------------------
# the port's stated divergence
# ---------------------------------------------------------------------------
def _recheck_worker(root: str, order: list[str], q) -> None:
    """``_lease_worker`` with the port executor's re-check
    (``core/executor.py`` ``_run_compute_deduped``): after taking the
    lease, ``has_fresh`` again, and load if the entry landed meanwhile.
    The compute is instant, so the window between the presence check and
    the lease is as wide as the scheduler makes it."""
    try:
        store = Store(root)
        computed, loaded = [], []
        for sig in order:
            while True:
                if store.has(sig):
                    value, _ = store.load(sig)
                    assert np.array_equal(value, _sig_value(sig))
                    loaded.append(sig)
                    break
                lease = store.acquire_compute(sig)
                if lease is not None:
                    if store.has_fresh(sig):
                        lease.release()
                        continue
                    try:
                        store.save(sig, f"node-{sig}", _sig_value(sig))
                        computed.append(sig)
                    finally:
                        lease.release()
                    break
                if not store.wait_compute(sig, timeout=30):
                    raise TimeoutError(f"lease wait timed out for {sig}")
        q.put(("ok", os.getpid(), computed, loaded))
    except BaseException as e:  # pragma: no cover - failure path
        q.put(("err", os.getpid(), repr(e), []))


def test_multiprocess_compute_once_holds_for_instant_computes(tmp_path):
    """Stated divergence: the port's executor re-checks the store with
    ``has_fresh`` after taking a compute lease on every tier; the
    reference re-checks only with a remote tier
    (``src/repro/core/executor.py:417-418``). Without the re-check, a
    process whose presence check ran just before a sibling committed and
    released takes the free lease and computes the entry again, so the
    reference's compute-once test needs its 50 ms compute to keep that
    window small. With it, compute-once holds for instant computes too:
    4 processes racing the same signatures compute each exactly once."""
    root = str(tmp_path / "store")
    Store(root)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    rng = np.random.default_rng(1)
    procs = [ctx.Process(target=_recheck_worker,
                         args=(root, list(rng.permutation(SIGS)), q))
             for _ in range(4)]
    for p in procs:
        p.start()
    results = _collect(procs, q)
    all_computed = [sig for r in results for sig in r[2]]
    assert sorted(all_computed) == sorted(SIGS), all_computed
    assert set(Store(root).entries()) == set(SIGS)
