"""Fleet fault cases on the port (twins of the fleet cases of
``tests/test_faults.py``, run on ``repro_torch.serve`` and
``repro_torch.core``):

* a combined latency + transient-failure storm leaves a 2-host
  ``run_sweep``'s outputs bit-identical to a fault-free run, and every
  host's ledger equal to its bytes on disk;
* server hardening: cancellation of running and queued jobs, job
  timeouts and non-drain shutdown report ``cancelled`` and release
  leases and reservations; the bounded admission queue answers ``busy``
  with a retry-after the client honours; socket clients never hang
  (timeouts, chunked waits, cancel over the wire);
* the owning server's maintenance thread reclaims remote orphans;
* the fleet router fails a job over from a shard that dies mid-run
  without recomputing the prefix the remote tier holds, and a shard that
  leaves and rejoins moves only its own rendezvous keys.

Seed: ``HELIX_CHAOS_SEED`` (default 1234) drives every ``FaultPlan``.
"""
import os
import threading
import time

import numpy as np
import pytest

from repro_torch.core import IterativeSession
from repro_torch.core.config import EngineConfig
from repro_torch.core.executor import JobCancelled
from repro_torch.core.faults import ChaosObjectStore, FaultPlan
from repro_torch.core.locking import HAVE_FLOCK, StorageLedger
from repro_torch.core.omp import Policy
from repro_torch.core.remote import FsObjectStore, RemoteStore
from repro_torch.core.store import Store
from repro_torch.core.sweep import SweepVariant, run_sweep
from repro_torch.core.workflow import Workflow
from repro_torch.serve import (FleetRouter, InProcessClient, ServerBusy,
                               connect_unix)
from repro_torch.serve.server import SessionServer

pytestmark = pytest.mark.skipif(
    not HAVE_FLOCK, reason="fleet mode needs POSIX flock")

CHAOS_SEED = int(os.environ.get("HELIX_CHAOS_SEED", "1234"))


def _bucket(tmp_path, name="bucket") -> FsObjectStore:
    return FsObjectStore(str(tmp_path / name))


def _shared_workflow(tag: str, calls: dict, lock: threading.Lock):
    """src → feat (shared, counted) → per-tag tail."""
    def count(name):
        with lock:
            calls[name] = calls.get(name, 0) + 1

    wf = Workflow("takeover")
    src = wf.source(
        "src", lambda: (count("src"),
                        np.arange(512, dtype=np.float64))[1],
        config="v1")

    def featurize(x):
        count("feat")
        return np.tanh(x.reshape(16, 32) @ x.reshape(32, 16))

    feat = wf.extractor("feat", featurize, [src], config="v1")
    out = wf.reducer(
        "out", lambda z, t=tag: {"score": float(np.sum(z)), "tag": t},
        [feat], config=("tail", tag))
    wf.output(out)
    return wf


def _storm_variants(k=3):
    lock = threading.Lock()
    return [SweepVariant(name=f"v{i}",
                         build=(lambda t=f"v{i}": _shared_workflow(
                             t, {}, lock)))
            for i in range(k)]


def test_fault_storm_sweep_bit_identical_to_fault_free(tmp_path):
    """Acceptance: a 2-host sweep under a combined latency + transient
    failure storm completes (no hangs), errors nothing, and produces
    outputs bit-identical to the fault-free run — the retry/degrade
    machinery is invisible to results. Ledgers match disk on each host
    afterwards (no reservation leaks under injected failures)."""
    clean = run_sweep(str(tmp_path / "clean"), _storm_variants(),
                      n_hosts=2, remote=str(tmp_path / "clean_bucket"))
    clean.raise_errors()

    plan = (FaultPlan(seed=CHAOS_SEED)
            .fail_rate(None, 0.05, error="transient", times=200)
            .add_latency("put", 0.002, jitter=0.002)
            .add_latency("get", 0.002, jitter=0.002))
    stormy_remote = RemoteStore(
        ChaosObjectStore(_bucket(tmp_path, "storm_bucket"), plan),
        faults=plan, retry_backoff=0.01)
    storm = run_sweep(str(tmp_path / "storm"), _storm_variants(),
                      n_hosts=2, remote=stormy_remote)
    storm.raise_errors()
    assert storm.outputs == clean.outputs
    assert plan.fired, "the storm plan never injected anything"

    for host in ("host0", "host1"):
        root = str(tmp_path / "storm" / host / "store")
        store = Store(root)
        ledger = StorageLedger(store.ledger_path)
        assert ledger.used() == pytest.approx(float(store.total_bytes()))
    stormy_remote.close()


# -- server hardening: cancellation, timeout, backpressure -------------------

def _chain_registry(n=24, delay=0.08):
    """A registry whose one workflow is an n-node sleeping chain —
    long enough to cancel mid-run, with plenty of between-node checks.
    ``tag`` shifts every signature, so a resubmission with a fresh tag
    really recomputes instead of loading the previous run's entries."""
    def build(tag="t0"):
        wf = Workflow("chain")
        prev = wf.source("n0", lambda: np.float64(1.0),
                         config=("v1", tag))
        for i in range(1, n):
            prev = wf.extractor(
                f"n{i}",
                lambda x, d=delay: (time.sleep(d), x + 1.0)[1],
                [prev], config=("v1", tag))
        out = wf.reducer("out", lambda x: {"v": float(x)}, [prev],
                         config=("tail", tag))
        wf.output(out)
        return wf
    return {"chain": build}


def _wait_status(job, status, timeout=10.0):
    deadline = time.monotonic() + timeout
    while job.status != status and time.monotonic() < deadline:
        time.sleep(0.02)
    assert job.status == status, f"job stuck in {job.status!r}"


def test_cancel_running_job_releases_everything(tmp_path):
    """Cancelling a running job stops it between nodes with status
    ``cancelled`` (not ``error``), drops every lease, keeps the ledger
    honest, and leaves the server healthy for the next submission."""
    server = SessionServer(str(tmp_path / "srv"),
                           registry=_chain_registry(), n_sessions=2,
                           storage_budget_bytes=float(10 * 2 ** 20))
    try:
        job = server.submit_named("chain")
        _wait_status(job, "running")
        time.sleep(0.2)                      # let a few nodes finish
        assert server.cancel(job.id) is True
        server.wait(job, timeout=15.0)
        assert job.status == "cancelled"
        assert isinstance(job.error, JobCancelled)
        assert server.cancel(job.id) is False     # idempotent: finished
        assert server.job_summary(job)["status"] == "cancelled"
        assert server.status()["cancelled"] == 1

        counts = server.store.lease_counts()
        assert counts == {"compute": 0, "pins": 0, "waiters": 0}
        assert StorageLedger(server.store.ledger_path).used() \
            == pytest.approx(float(server.store.total_bytes()))

        # The server is not poisoned: the same workflow now completes
        # (and reuses whatever prefix the cancelled run materialized).
        job2 = server.submit_named("chain")
        server.wait(job2, timeout=60.0)
        assert job2.status == "done"
    finally:
        server.shutdown()


def test_cancel_queued_job_never_runs(tmp_path):
    server = SessionServer(str(tmp_path / "srv"),
                           registry=_chain_registry(), n_sessions=1)
    try:
        running = server.submit_named("chain")
        _wait_status(running, "running")
        queued = server.submit_named("chain")
        assert queued.status == "queued"
        assert server.cancel(queued.id) is True
        assert queued.status == "cancelled"
        assert queued.done.is_set()
        server.cancel(running.id)
        server.wait(running, timeout=15.0)
    finally:
        server.shutdown()


def test_job_timeout_reports_cancelled(tmp_path):
    """A per-submission timeout fires the cancel flag server-side: the
    job stops between nodes and reports ``cancelled``."""
    server = SessionServer(str(tmp_path / "srv"),
                           registry=_chain_registry(n=40, delay=0.1),
                           n_sessions=1)
    try:
        job = server.submit_named("chain", timeout=0.4)
        server.wait(job, timeout=20.0)
        assert job.status == "cancelled"
        assert isinstance(job.error, JobCancelled)
        assert job.run_seconds < 15.0
    finally:
        server.shutdown()


def test_shutdown_nodrain_cancels_running_jobs(tmp_path):
    """shutdown(drain=False) stops *running* jobs through
    the cancel flag — promptly, and reported as cancelled."""
    server = SessionServer(str(tmp_path / "srv"),
                           registry=_chain_registry(n=60, delay=0.1),
                           n_sessions=2)
    running = server.submit_named("chain")
    queued_behind = [server.submit_named("chain") for _ in range(3)]
    _wait_status(running, "running")
    t0 = time.monotonic()
    server.shutdown(drain=False)
    assert time.monotonic() - t0 < 20.0          # did not sit out 6 s/job
    assert running.status == "cancelled"
    assert isinstance(running.error, JobCancelled)
    for j in queued_behind:
        assert j.status == "cancelled"
        assert j.done.is_set()


def test_bounded_queue_busy_and_client_retry(tmp_path):
    """Backpressure: a full admission queue answers busy-with-retry-
    after; the client retries automatically and lands the submit once a
    slot frees."""
    server = SessionServer(str(tmp_path / "srv"),
                           registry=_chain_registry(n=10, delay=0.05),
                           n_sessions=1, max_queue=1,
                           busy_retry_after=0.05)
    try:
        first = server.submit_named("chain")
        _wait_status(first, "running")
        server.submit_named("chain")             # fills the queue
        with pytest.raises(ServerBusy) as exc:
            server.submit_named("chain")         # bounced
        assert exc.value.retry_after == pytest.approx(0.05)
        assert server.status()["max_queue"] == 1

        # The wire shape: ok=false + busy=true + retry_after; the client
        # turns it into automatic retries that eventually succeed.
        client = InProcessClient(server)
        client.busy_retries = 200
        job_id = client.submit("chain")          # blocks through busy
        assert client.wait(job_id, timeout=60.0)["status"] == "done"
    finally:
        server.shutdown()


def test_socket_client_timeouts_chunked_wait_and_cancel(tmp_path):
    """A socket client with a short RPC timeout survives a job that
    runs much longer than the timeout (chunked waits), cancels jobs
    over the wire, and never hangs on a shut-down server."""
    server = SessionServer(str(tmp_path / "srv"),
                           registry=_chain_registry(n=14, delay=0.1),
                           n_sessions=1)
    path = server.serve_unix(str(tmp_path / "helix.sock"))
    client = connect_unix(path, timeout=0.5)
    try:
        job = client.submit("chain")
        summary = client.wait(job)               # ~1.4 s ≫ 0.5 s timeout
        assert summary["status"] == "done"
        assert summary["outputs"]["out"]["v"] == 14.0

        # Fresh tags below: same-tag resubmissions would load the first
        # run's materializations and finish instantly.
        job2 = client.submit("chain", {"tag": "doomed"}, name="doomed")
        assert client.cancel(job2) is True
        assert client.wait(job2, timeout=30.0)["status"] == "cancelled"
        assert client.cancel(job2) is False      # already finished

        # A wait whose overall deadline expires raises TimeoutError on
        # the client — distinct from the ServerError a dead job gives.
        job3 = client.submit("chain", {"tag": "slow"})
        with pytest.raises(TimeoutError):
            client.wait(job3, timeout=0.2)
        assert client.cancel(job3) is True
        assert client.wait(job3, timeout=30.0)["status"] == "cancelled"
        client.shutdown()
    finally:
        client.close()
        server.shutdown()


def test_gc_orphans_scheduled_by_owning_server(tmp_path):
    """The server's maintenance thread runs gc_orphans
    periodically with the min-age guard; crash orphans disappear
    without any client asking."""
    backend = _bucket(tmp_path)
    backend.put("entries/dead01/w.npy", b"x" * 128)   # crashed publish
    backend.put("entries/dead01/meta.json", b"{}")
    server = SessionServer(str(tmp_path / "srv"),
                           remote=RemoteStore(backend, heartbeats=False),
                           gc_interval=0.1, gc_min_age=0.0)
    try:
        deadline = time.monotonic() + 10.0
        while backend.list("entries/dead01/") \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert backend.list("entries/dead01/") == []
        status = server.status()
        assert status["gc"]["runs"] >= 1
        assert status["gc"]["reclaimed"] >= 2
    finally:
        server.shutdown()
        server.store.remote.close()


def test_gc_disabled_without_remote_or_interval(tmp_path):
    """No remote tier (or gc_interval=0) → no maintenance thread."""
    local_only = SessionServer(str(tmp_path / "a"))
    disabled = SessionServer(str(tmp_path / "b"),
                             remote=str(tmp_path / "bucket"),
                             gc_interval=0)
    try:
        assert local_only._maintenance is None
        assert local_only.gc_interval == 0.0
        assert disabled._maintenance is None
        # default interval documented at 900 s when a remote exists
        with_remote = SessionServer(str(tmp_path / "c"),
                                    remote=str(tmp_path / "bucket2"))
        assert with_remote.gc_interval == 900.0
        assert with_remote._maintenance is not None
        with_remote.shutdown()
    finally:
        disabled.shutdown()
        local_only.shutdown()


# -- fleet router: shard death, failover, rebalance ----------------------------

def _slow_family_registry(calls, work=600, delay=0.08):
    """One workflow: heavy counted prefix + an optional sleeping tail.

    ``tail=0`` is the warm arm (prefix only, fast); ``tail=N`` appends N
    sleeping extractors so a second submission can be killed mid-run.
    Both share the same source node, hence the same route key — the
    router must place them on the same shard."""
    def build(family="x", reg=0.1, tail=0):
        wf = Workflow(f"slow-{family}-{reg}-{tail}")
        src = wf.source(
            "src",
            lambda: np.arange(4096, dtype=np.float64).reshape(64, 64),
            config=("v1", family))

        def featurize(m):
            calls.hit(f"feat_{family}")
            acc = m.copy()
            for _ in range(work):
                acc = np.tanh(acc @ m.T @ m / m.size)
            return acc

        prev = wf.extractor("feat", featurize, [src],
                            config=("feat", family))
        for i in range(tail):
            prev = wf.extractor(
                f"t{i}", lambda x, d=delay: (time.sleep(d), x)[1],
                [prev], config=("tail", i))
        out = wf.reducer("out", lambda m, r=reg: {"v": float(np.sum(m)) * r},
                         [prev], config=("eval", reg))
        wf.output(out)
        return wf
    return {"slow": build}


class _Calls:
    """Thread-safe per-node compute counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts: dict[str, int] = {}

    def hit(self, name: str) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + 1

    def get(self, name: str) -> int:
        with self._lock:
            return self.counts.get(name, 0)


def test_shard_death_mid_job_fails_over_compute_once(tmp_path):
    """Kill a shard mid-job: the router detects the shutdown-cancel,
    fails over through the cancellation/retry path, and the job finishes
    on the survivor — with the warm prefix *fetched* from the shared
    remote tier, not recomputed (compute-once holds fleet-wide across
    the failover). The survivor's ledger still matches its disk."""
    calls = _Calls()
    registry = _slow_family_registry(calls)
    servers = {}
    for sid in ("s0", "s1"):
        servers[sid] = SessionServer(
            str(tmp_path / sid), registry=registry,
            remote=RemoteStore(_bucket(tmp_path)), n_sessions=1,
            poll_interval=0.01)
    router = FleetRouter(servers, registry=registry)
    try:
        # warm the prefix through the router, publish it to the remote
        warm = router.submit("slow", {"family": "x", "reg": 0.1,
                                      "tail": 0})
        out = router.wait(warm, timeout=60.0)
        assert out["status"] == "done"
        owner = out["shard"]
        assert calls.get("feat_x") == 1
        servers[owner].store.writer_drain()     # uploads committed

        # same prefix + a sleepy tail: routed to the same (warm) shard
        victim = router.submit("slow", {"family": "x", "reg": 0.1,
                                        "tail": 24})
        assert router._jobs[victim]["shard"] == owner
        _wait_status(servers[owner]._jobs[victim], "running")
        time.sleep(0.2)                         # a few tail nodes in

        servers[owner].shutdown(drain=False)    # the shard dies mid-job
        out = router.wait(victim, timeout=120.0)
        assert out["status"] == "done"
        survivor = out["shard"]
        assert survivor != owner
        assert router.failovers == 1
        assert out["outputs"]["out"]["v"] == pytest.approx(
            float(np.sum(_slow_prefix_value())) * 0.1)

        # compute-once across the failover: the survivor fetched the
        # published prefix instead of recomputing it
        assert calls.get("feat_x") == 1
        # the survivor's ledger matches the bytes actually on its disk
        assert StorageLedger(servers[survivor].store.ledger_path).used() \
            == pytest.approx(float(servers[survivor].store.total_bytes()))
        counts = servers[survivor].store.lease_counts()
        assert counts == {"compute": 0, "pins": 0, "waiters": 0}
        # the router reports the dead shard and the healthy one
        snap = router.status()
        assert snap["failovers"] == 1
        assert snap["shards"][owner].get("dead") is True
        assert snap["shards"][survivor]["accepting"]
    finally:
        router.close()
        for srv in servers.values():
            srv.shutdown()


def _slow_prefix_value():
    """The featurized matrix `_slow_family_registry` computes (work=600)."""
    m = np.arange(4096, dtype=np.float64).reshape(64, 64)
    acc = m.copy()
    for _ in range(600):
        acc = np.tanh(acc @ m.T @ m / m.size)
    return acc


def test_shard_rejoin_rebalances_only_rendezvous_moved_keys(tmp_path):
    """Removing one of N shards re-homes only that shard's keys — an
    expected 1/N of the keyspace — and re-adding it restores the exact
    original placement (no other key ever moves)."""
    servers = {f"s{i}": SessionServer(str(tmp_path / f"s{i}"),
                                      poll_interval=0.01)
               for i in range(4)}
    router = FleetRouter(servers)
    try:
        rng = np.random.default_rng(CHAOS_SEED)
        keys = [bytes(rng.bytes(16)).hex() for _ in range(240)]
        before = {k: router.shard_for(k) for k in keys}
        assert set(before.values()) == set(servers)   # all shards used

        router.remove_shard("s2")
        after = {k: router.shard_for(k) for k in keys}
        moved = [k for k in keys if before[k] != after[k]]
        # only s2's keys moved, and every one of them moved off s2
        assert set(moved) == {k for k in keys if before[k] == "s2"}
        assert all(after[k] != "s2" for k in moved)
        # the move fraction is ~1/4 (binomial slack for 240 keys)
        assert 0.10 <= len(moved) / len(keys) <= 0.45

        router.add_shard("s2", servers["s2"])
        restored = {k: router.shard_for(k) for k in keys}
        assert restored == before                     # exact rebalance
    finally:
        router.close()
        for srv in servers.values():
            srv.shutdown()


# -- compute-once: a commit that lands between the presence check and the
# -- lease -----------------------------------------------------------------

def test_entry_committed_before_the_lease_is_loaded_not_recomputed(
        tmp_path):
    """A sibling session can compute, commit and release a signature
    between this session's presence check and its lease acquisition (a
    fast node under load). The executor re-checks the store once it holds
    the lease, releases it and loads the sibling's entry: the node runs
    no second time. (The JAX package re-checks only with a remote tier.)
    The window is opened deterministically: ``has`` answers from before
    the commit until the first lease is taken."""
    calls = {}
    lock = threading.Lock()
    first = IterativeSession(str(tmp_path), engine=EngineConfig(
        policy=Policy.ALWAYS, dedupe_inflight=True))
    want = first.run(_shared_workflow("t0", calls, lock)).outputs
    assert calls == {"src": 1, "feat": 1}

    sess = IterativeSession(str(tmp_path), engine=EngineConfig(
        policy=Policy.ALWAYS, dedupe_inflight=True))
    store, stale = sess.store, {"on": True}
    has, acquire = store.has, store.acquire_compute

    def stale_has(sig):
        return False if stale["on"] else has(sig)

    def acquire_then_commit_visible(sig):
        stale["on"] = False
        return acquire(sig)

    store.has = stale_has
    store.acquire_compute = acquire_then_commit_visible
    rep = sess.run(_shared_workflow("t1", calls, lock))
    assert calls == {"src": 1, "feat": 1}
    assert set(rep.execution.deduped) >= {"src", "feat"}
    assert rep.outputs["out"]["score"] == want["out"]["score"]
    assert store.lease_counts() == {"compute": 0, "pins": 0, "waiters": 0}
