"""Fleet-router suite on the port (``repro_torch.serve.router``):
placement, protocol parity, warm reruns. Twins of ``tests/test_router.py``.

The chaos-side router tests (shard death mid-job, rejoin rebalance
fractions) live in ``tests/test_torch_fleet_faults.py``; this file covers the
steady-state contract:

* rendezvous hashing is a pure function — independent router instances
  (and independent processes) agree on placement, and arms sharing a
  workflow prefix share a shard;
* the router satisfies the :class:`~repro_torch.serve.client.Client` protocol
  and ``connect()`` passes it through unchanged, so drivers written
  against one server work against a fleet;
* warm-shard reruns are pure cache hits: consistent-hash routing sends
  a repeated submission back to the shard that already holds its
  prefix, so nothing is recomputed (the claim ``bench_multitenant``
  quantifies).
"""
import threading

import numpy as np
import pytest

from repro_torch.core.config import EngineConfig
from repro_torch.core.locking import HAVE_FLOCK
from repro_torch.core.workflow import Workflow
from repro_torch.serve import (FleetRouter, SessionServer, connect, rendezvous)
from repro_torch.serve.client import Client

pytestmark = pytest.mark.skipif(
    not HAVE_FLOCK, reason="fleet mode needs POSIX flock")


class Calls:
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


def build_family(family: str, reg: float, calls: Calls | None = None,
                 work: int = 600) -> Workflow:
    """src → feat (slow, shared within a family) → model(reg) → eval."""
    def count(name):
        if calls is not None:
            calls.hit(name)

    wf = Workflow(f"{family}-{reg}")
    src = wf.source(
        "src",
        lambda: np.arange(4096, dtype=np.float64).reshape(64, 64),
        config=("v1", family))

    def featurize(m):
        count(f"feat_{family}")
        acc = m.copy()
        for _ in range(work):
            acc = np.tanh(acc @ m.T @ m / m.size)
        return acc

    feat = wf.extractor("feat", featurize, [src], config=("feat", family))
    model = wf.learner(
        "model", lambda z, r=reg: float(np.sum(z * z)) * r,
        [feat], config=("LR", reg))
    out = wf.reducer("eval", lambda m: {"score": m}, [model],
                     config=("eval",))
    wf.output(out)
    return wf


def _registry(calls=None, work=600):
    return {"fam": lambda family, reg:
            build_family(family, reg, calls, work=work)}


def _fleet(tmp_path, n=2, calls=None, **kw):
    servers = {}
    for i in range(n):
        sid = f"s{i}"
        servers[sid] = SessionServer(
            str(tmp_path / sid), registry=_registry(calls),
            engine=EngineConfig(n_sessions=2), poll_interval=0.01, **kw)
    return servers


# ---------------------------------------------------------------------------
# placement: pure, deterministic, prefix-affine
# ---------------------------------------------------------------------------
def test_rendezvous_is_pure_and_total():
    ids = ["s0", "s1", "s2", "s3"]
    keys = [f"key-{i}" for i in range(64)]
    a = [rendezvous(ids, k) for k in keys]
    b = [rendezvous(reversed(ids), k) for k in keys]   # order-insensitive
    assert a == b
    assert set(a) == set(ids)        # 64 keys land on all 4 shards
    with pytest.raises(LookupError):
        rendezvous([], "k")


def test_route_keys_are_prefix_affine(tmp_path):
    """Arms of one family share a route key (same source signatures);
    different families get different keys; two independent router
    instances agree on every placement."""
    servers = _fleet(tmp_path, n=2)
    try:
        r1 = FleetRouter(servers, registry=_registry())
        r2 = FleetRouter(servers, registry=_registry())
        ka1 = r1.route_key("fam", {"family": "a", "reg": 0.1})
        ka2 = r1.route_key("fam", {"family": "a", "reg": 0.9})
        kb = r1.route_key("fam", {"family": "b", "reg": 0.1})
        assert ka1 == ka2            # same family → same prefix → same key
        assert ka1 != kb
        for key in (ka1, kb):
            assert r1.shard_for(key) == r2.shard_for(key)
        # without a registry entry the key degrades to (workflow, params)
        # — still deterministic, still total
        bare = FleetRouter(servers)
        k1 = bare.route_key("fam", {"family": "a", "reg": 0.1})
        assert k1 == bare.route_key("fam", {"family": "a", "reg": 0.1})
        assert k1 != bare.route_key("fam", {"family": "a", "reg": 0.2})
    finally:
        for srv in servers.values():
            srv.shutdown()


def test_random_route_is_seeded(tmp_path):
    """The benchmark's control arm: same seed → same placement stream."""
    servers = _fleet(tmp_path, n=2)
    try:
        picks = []
        for _ in range(2):
            r = FleetRouter(servers, registry=_registry(),
                            route="random", seed=7)
            picks.append([r._pick_shard("k") for _ in range(16)])
        assert picks[0] == picks[1]
        assert len(set(picks[0])) == 2      # actually spreads
        with pytest.raises(ValueError, match="unknown route mode"):
            FleetRouter(servers, route="roulette")
    finally:
        for srv in servers.values():
            srv.shutdown()


# ---------------------------------------------------------------------------
# Client-protocol parity
# ---------------------------------------------------------------------------
def test_router_speaks_the_client_protocol(tmp_path):
    """submit/wait/estimate/job/cancel/forget/status/hello through the
    router behave like a single server; ``connect()`` passes a router
    through unchanged."""
    calls = Calls()
    servers = _fleet(tmp_path, n=2, calls=calls)
    try:
        router = FleetRouter(servers, registry=_registry(calls))
        assert isinstance(router, Client)
        assert connect(router) is router

        hello = router.hello()
        assert hello["server"] == "helix-fleet-router"
        assert hello["workflows"] == ["fam"]

        est = router.estimate("fam", {"family": "a", "reg": 0.1})
        assert est["shard"] in servers and est["total_s"] >= 0.0

        job = router.submit("fam", {"family": "a", "reg": 0.1})
        out = router.wait(job, timeout=60.0)
        assert out["status"] == "done"
        assert out["shard"] == router.shard_for(
            router.route_key("fam", {"family": "a", "reg": 0.1}))
        assert "score" in out["outputs"]["eval"]

        assert router.job(job)["status"] == "done"
        assert router.cancel(job) is False          # already finished
        assert router.forget(job) is True
        assert router.forget(job) is False          # record dropped

        snap = router.status()
        assert snap["router"] and snap["failovers"] == 0
        assert sorted(snap["shards"]) == ["s0", "s1"]
        assert snap["live_shards"] == ["s0", "s1"]
    finally:
        for srv in servers.values():
            srv.shutdown()


def test_router_drain_and_shutdown(tmp_path):
    servers = _fleet(tmp_path, n=2)
    try:
        with FleetRouter(servers, registry=_registry()) as router:
            router.submit("fam", {"family": "a", "reg": 0.1})
            assert router.drain(timeout=60.0)
            assert sorted(router.shutdown()["stopped"]) == ["s0", "s1"]
        for srv in servers.values():
            assert not srv._accepting
    finally:
        for srv in servers.values():
            srv.shutdown()          # idempotent


# ---------------------------------------------------------------------------
# warm-shard reruns: the consistent-hash payoff
# ---------------------------------------------------------------------------
def test_warm_rerun_recomputes_nothing(tmp_path):
    """Hash routing sends a repeat submission back to the shard that
    already holds its prefix: the rerun computes zero nodes fleet-wide.
    A fresh router instance (new process, same fleet) gets the same warm
    hit — placement is state-free."""
    calls = Calls()
    servers = _fleet(tmp_path, n=2, calls=calls)
    try:
        arms = [("a", 0.1), ("a", 0.4), ("b", 0.2), ("c", 0.3)]
        router = FleetRouter(servers, registry=_registry(calls))
        jobs = [router.submit("fam", {"family": f, "reg": r})
                for f, r in arms]
        for job in jobs:
            assert router.wait(job, timeout=60.0)["status"] == "done"
        warm = {f: calls.get(f"feat_{f}") for f in "abc"}
        assert warm == {"a": 1, "b": 1, "c": 1}

        # rerun through a *different* router instance: all cache hits
        rerun = FleetRouter(servers, registry=_registry(calls))
        jobs = [rerun.submit("fam", {"family": f, "reg": r})
                for f, r in arms]
        for job in jobs:
            assert rerun.wait(job, timeout=60.0)["status"] == "done"
        assert {f: calls.get(f"feat_{f}") for f in "abc"} == warm
    finally:
        for srv in servers.values():
            srv.shutdown()


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------
def test_rendezvous_matches_reference_on_seeded_keys():
    """1,000 seeded keys over shard sets of 1 to 5 ids: the same home
    shard in both packages."""
    from repro.serve import rendezvous as ref_rendezvous

    rng = np.random.default_rng(11)
    keys = [bytes(rng.bytes(16)).hex() for _ in range(1000)]
    for n in range(1, 6):
        ids = [f"s{i}" for i in range(n)]
        got = [rendezvous(ids, k) for k in keys]
        assert got == [ref_rendezvous(ids, k) for k in keys]
        assert len(set(got)) == n


def test_route_keys_match_reference(tmp_path):
    """Both packages' routers give every (family, reg) the same route key
    and the same shard: the key hashes the workflow's source signatures,
    which are the same in both packages for the same workflow."""
    from repro.core.workflow import Workflow as RefWorkflow
    from repro.serve import FleetRouter as RefRouter
    from repro.serve import SessionServer as RefServer

    def family_of(workflow_cls):
        def build(family, reg):
            wf = workflow_cls(f"{family}-{reg}")
            src = wf.source(
                "src",
                lambda: np.arange(4096, dtype=np.float64).reshape(64, 64),
                config=("v1", family))
            feat = wf.extractor("feat", np.tanh, [src],
                                config=("feat", family))
            model = wf.learner("model", lambda z, r=reg: float(z.sum()) * r,
                               [feat], config=("LR", reg))
            wf.output(wf.reducer("eval", lambda m: {"score": m}, [model],
                                 config=("eval",)))
            return wf
        return {"fam": build}

    shards = ("s0", "s1", "s2", "s3")
    ref_servers = {s: RefServer(str(tmp_path / f"ref-{s}")) for s in shards}
    servers = {s: SessionServer(str(tmp_path / s)) for s in shards}
    ref_router = RefRouter(ref_servers, registry=family_of(RefWorkflow))
    router = FleetRouter(servers, registry=family_of(Workflow))
    try:
        arms = [{"family": f"f{i}", "reg": r}
                for i in range(12) for r in (0.1, 0.3)]
        got = [router.route_key("fam", a) for a in arms]
        assert got == [ref_router.route_key("fam", a) for a in arms]
        # prefix-affine: both regs of a family share the key
        assert got[0::2] == got[1::2]
        assert [router.shard_for(k) for k in got] \
            == [ref_router.shard_for(k) for k in got]
        # the fallback key (no registry entry) too
        assert router.route_key("other", {"x": 1}) \
            == ref_router.route_key("other", {"x": 1})
    finally:
        router.close()
        ref_router.close()
        for srv in list(servers.values()) + list(ref_servers.values()):
            srv.shutdown()
