"""Tenant-isolation harness on the port (``repro_torch.serve.tenancy``).
Twins of ``tests/test_tenancy.py``.

Proves the multi-tenancy contract end to end:

* **Param schemas / allowlists** — the schema is an allowlist; unknown
  params, wrong types, out-of-range values, and off-allowlist workflows
  are rejected at submission, before the factory runs.
* **Quota ledger** — ``TenantQuota`` is transactional (flock'd JSON);
  ``ScopedLedger`` reserves two-phase (tenant quota first, fleet budget
  second, rollback on fleet refusal), credits foreign evictions to the
  fleet only, and reports ``scope_exhausted`` so the Materializer never
  evicts a neighbor chasing quota room.
* **Fair share** (hypothesis, ``--hypothesis-profile=ci-deep`` in CI) —
  random tenant weights × random job streams: no backlogged tenant
  starves, served compute-seconds stay within the classic weighted-fair
  bound, and the pick inside each tenant's turn is exactly what the
  prefix-first scheduler would choose.
* **Concurrency stress** — K tenants × M socket clients against a
  2-shard :class:`~repro_torch.serve.router.FleetRouter`: results bit-identical
  to isolated runs, per-shard ledger == on-disk bytes, zero evictions of
  live entries, and a quota-exhausted tenant gets a clean
  ``quota_exceeded`` wire error (not a hang, not a silent evict).
* **Counter races** — the store's tier hit/miss counters are exact under
  concurrent loads (regression for the unlocked ``+=`` they replaced).
"""
import os
import threading

import numpy as np
import pytest

from repro_torch.core import IterativeSession
from repro_torch.core.config import EngineConfig, StoreConfig
from repro_torch.core.locking import HAVE_FLOCK, StorageLedger
from repro_torch.core.store import Store
from repro_torch.core.workflow import Workflow
from repro_torch.serve import (FleetRouter, InProcessClient, QuotaExceeded,
                               ScopedLedger, ServerError, SessionServer,
                               TenantQuota, TenantScheduler, TenantSpec,
                               validate_params)
from repro_torch.serve.scheduler import PrefixScheduler
from repro_torch.serve.tenancy import resolve_tenant

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

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


# ---------------------------------------------------------------------------
# identity + param schemas (admission-time gates)
# ---------------------------------------------------------------------------
def test_resolve_tenant_catch_all_and_unknown():
    table = {"acme": TenantSpec(weight=3.0)}
    assert resolve_tenant(table, "acme").weight == 3.0
    with pytest.raises(PermissionError, match="unknown tenant"):
        resolve_tenant(table, "ghost")
    table["*"] = TenantSpec(weight=0.5)
    assert resolve_tenant(table, "ghost").weight == 0.5


def test_validate_params_is_an_allowlist():
    schema = {"reg": {"type": "float", "min": 0.0, "max": 1.0},
              "family": "str", "deep": "bool",
              "mode": ["grid", "random"]}
    validate_params("fam", {"reg": 0.3, "family": "a", "deep": True,
                            "mode": "grid"}, schema)
    # unknown param: the schema IS the allowlist
    with pytest.raises(ValueError, match="not in schema"):
        validate_params("fam", {"exploit": 1}, schema)
    # type errors — bool is not an acceptable float/int
    with pytest.raises(ValueError, match="must be float"):
        validate_params("fam", {"reg": "0.3"}, schema)
    with pytest.raises(ValueError, match="must be float"):
        validate_params("fam", {"reg": True}, schema)
    # range + choice constraints
    with pytest.raises(ValueError, match="above max"):
        validate_params("fam", {"reg": 2.0}, schema)
    with pytest.raises(ValueError, match="below min"):
        validate_params("fam", {"reg": -0.1}, schema)
    with pytest.raises(ValueError, match="must be one of"):
        validate_params("fam", {"mode": "exhaustive"}, schema)
    # a bad schema is an error too, not a silent pass
    with pytest.raises(ValueError, match="unknown schema type"):
        validate_params("fam", {"reg": 1}, {"reg": "quaternion"})


# ---------------------------------------------------------------------------
# the quota ledger + the tenant-scoped view the Materializer sees
# ---------------------------------------------------------------------------
def test_tenant_quota_reserve_adjust_charge(tmp_path):
    q = TenantQuota(str(tmp_path / "tenants.json"))
    assert q.try_reserve_bytes("a", 600.0, quota=1000.0)
    assert not q.try_reserve_bytes("a", 600.0, quota=1000.0)  # would bust
    assert q.bytes_used("a") == 600.0                         # no side effect
    assert q.try_reserve_bytes("b", 600.0, quota=1000.0)      # independent
    q.adjust_bytes("a", -700.0)                               # clamped at 0
    assert q.bytes_used("a") == 0.0
    q.charge_compute("a", 1.5)
    q.charge_compute("a", 2.5)
    assert q.compute_used("a") == pytest.approx(4.0)
    q.check_compute("a", TenantSpec(compute_seconds=5.0))     # under: fine
    with pytest.raises(QuotaExceeded) as exc:
        q.check_compute("a", TenantSpec(compute_seconds=4.0))
    assert exc.value.resource == "compute_seconds"
    assert exc.value.tenant == "a"
    # an instantly exhausted tenant: zero quota trips on first check
    with pytest.raises(QuotaExceeded):
        q.check_compute("fresh", TenantSpec(compute_seconds=0.0))


def test_scoped_ledger_two_phase_and_foreign_credit(tmp_path):
    fleet = StorageLedger(str(tmp_path / "ledger.json"))
    fleet.ensure(0.0)
    quota = TenantQuota(str(tmp_path / "tenants.json"))
    led = ScopedLedger(fleet, quota, "a", quota_bytes=1000.0)

    # tenant-side refusal: no fleet reservation happens at all
    assert not led.try_reserve(2000.0, budget=1e9)
    assert fleet.used() == 0.0 and quota.bytes_used("a") == 0.0
    assert led.scope_exhausted(2000.0) and not led.scope_exhausted(500.0)

    # fleet-side refusal rolls the tenant phase back
    assert not led.try_reserve(500.0, budget=100.0)
    assert fleet.used() == 0.0 and quota.bytes_used("a") == 0.0

    # a clean reservation lands on both ledgers; release undoes both
    assert led.try_reserve(500.0, budget=1e9)
    assert fleet.used() == 500.0 and quota.bytes_used("a") == 500.0
    led.adjust(100.0)
    assert fleet.used() == 600.0 and quota.bytes_used("a") == 600.0
    led.release(600.0)
    assert fleet.used() == 0.0 and quota.bytes_used("a") == 0.0

    # foreign evictions credit the fleet only — not this tenant's meter
    assert led.try_reserve(300.0, budget=1e9)
    led.credit_foreign(100.0)
    assert fleet.used() == 200.0 and quota.bytes_used("a") == 300.0

    # an uncapped scope never reports exhaustion
    free = ScopedLedger(fleet, quota, "b")
    assert not free.scope_exhausted(1e18)


# ---------------------------------------------------------------------------
# fair share: property-based, against the scheduler itself
# ---------------------------------------------------------------------------
class _SimStore:
    """Minimal store surface for the scheduler: nothing materialized."""

    def has(self, sig):
        return False


class _SimCost:
    """Unit compute-cost model."""

    def compute_cost(self, sig):
        return 1.0


class _SimJob:
    """The scheduler-facing job shape (see ``_SchedJob``)."""

    def __init__(self, jid, seq, tenant, sigs, dur):
        self.id = jid
        self.seq = seq
        self.tenant = tenant
        self.sigs = frozenset(sigs)
        self.priority = 0
        self.dur = dur


def _drive_fair(weights: list[float], durs: list[list[float]]):
    """Serve every tenant's stream to exhaustion, one slot, checking the
    fair-queueing invariants at every dispatch. Returns served seconds
    per tenant over the all-backlogged interval."""
    tenants = [f"t{i}" for i in range(len(weights))]
    wmap = dict(zip(tenants, weights))
    sched = TenantScheduler(PrefixScheduler(_SimStore(), _SimCost(),
                                            "prefix"), wmap)
    queued, jid = [], 0
    for ti, t in enumerate(tenants):
        for j, d in enumerate(durs[ti]):
            # half of each tenant's jobs share an intra-tenant prefix so
            # the inner prefix-first order has something to prefer
            sigs = {f"{t}:prefix"} if j % 2 == 0 else {f"{t}:solo{j}"}
            sigs.add(f"{t}:tail{j}")
            job = _SimJob(jid, jid, t, sigs, d)
            queued.append(job)
            sched.add(job)
            jid += 1

    d_max = max(max(ds) for ds in durs)
    min_w = min(weights)
    served = {t: 0.0 for t in tenants}
    dispatches = []
    while queued and all(any(j.tenant == t for j in queued)
                         for t in tenants):
        backlogged = {j.tenant for j in queued}
        expect = min(backlogged,
                     key=lambda t: (sched.virtual_time(t), t))
        picked = sched.pick(queued, inflight=set())
        # the fair pass chose the lowest-virtual-time tenant...
        assert picked.tenant == expect
        # ...and within that tenant's queue, exactly the prefix-first
        # choice — fairness composes with reuse, it does not replace it
        mine = [j for j in queued if j.tenant == picked.tenant]
        assert picked is sched.inner.pick(mine, set())
        sched.note_dispatch(picked)
        sched.note_finish(picked, picked.dur)
        served[picked.tenant] += picked.dur
        queued.remove(picked)
        sched.remove(picked)
        dispatches.append(picked.tenant)
        # WFQ bound: while all tenants are backlogged, virtual times
        # stay within d_max/min_w of each other (one max-size job at
        # the minimum weight is the worst possible overshoot)
        vts = [sched.virtual_time(t) for t in tenants]
        assert max(vts) - min(vts) <= d_max / min_w + 1e-9
    return served, dispatches, sched


if HAVE_HYPOTHESIS:
    @settings(deadline=None)
    @given(st.data())
    def test_fair_share_bounds_hypothesis(data):
        """Random weights × random job streams: no starvation, bounded
        virtual-time spread, prefix-first within each tenant's turn."""
        n = data.draw(st.integers(2, 4), label="n_tenants")
        weights = [data.draw(st.floats(0.5, 8.0), label=f"w{i}")
                   for i in range(n)]
        durs = [[data.draw(st.floats(0.05, 1.5), label=f"d{i}_{j}")
                 for j in range(10)] for i in range(n)]
        served, dispatches, sched = _drive_fair(weights, durs)
        # no starvation: with everyone backlogged from t=0, the first n
        # dispatches go to n distinct tenants (each starts at virtual
        # time 0 and is charged before the next pick)
        assert len(set(dispatches[:n])) == n
        assert all(s > 0.0 for s in served.values())
        # the status() snapshot agrees with the meters we tracked
        snap = sched.snapshot()
        for t in sorted(served):
            assert snap[t]["served_s"] == pytest.approx(served[t])
            assert snap[t]["weight"] == pytest.approx(
                max(weights[int(t[1:])], 1e-9))


def test_fair_share_weighted_ratio_converges():
    """Deterministic long stream: a 3:1 weight split serves ~3:1 compute
    seconds over the backlogged interval (within the discretization
    error of one job)."""
    weights = [3.0, 1.0]
    durs = [[0.1] * 400, [0.1] * 400]
    served, _, _ = _drive_fair(weights, durs)
    # t1 exhausts its backlog bound first; compare over the interval
    ratio = served["t0"] / max(served["t1"], 1e-9)
    assert 2.0 <= ratio <= 4.0


def test_fair_share_is_work_conserving():
    """A tenant with no backlog donates its share: the other tenant is
    served at every dispatch instead of the slot idling."""
    sched = TenantScheduler(
        PrefixScheduler(_SimStore(), _SimCost(), "prefix"),
        {"a": 1.0, "b": 100.0})
    jobs = [_SimJob(i, i, "a", {f"a:{i}"}, 0.1) for i in range(5)]
    for j in jobs:
        sched.add(j)
    queued = list(jobs)
    while queued:
        picked = sched.pick(queued, set())       # b has nothing queued
        assert picked.tenant == "a"
        sched.note_dispatch(picked)
        sched.note_finish(picked, picked.dur)
        queued.remove(picked)
        sched.remove(picked)


# ---------------------------------------------------------------------------
# admission gates on the server (in-process = same _handle path as wire)
# ---------------------------------------------------------------------------
def test_quota_exhausted_is_a_clean_refusal(tmp_path):
    """An exhausted tenant's submit raises QuotaExceeded at admission —
    it never queues, never hangs, and neighbors are unaffected."""
    tenants = {"payg": TenantSpec(compute_seconds=0.0),
               "flat": TenantSpec()}
    server = SessionServer(
        str(tmp_path), registry={"fam": build_family},
        tenants=tenants, engine=EngineConfig(schedule="fair"),
        poll_interval=0.01)
    try:
        broke = InProcessClient(server, tenant="payg")
        with pytest.raises(QuotaExceeded) as exc:
            broke.submit("fam", {"family": "a", "reg": 0.1})
        assert exc.value.tenant == "payg"
        assert exc.value.resource == "compute_seconds"
        # the neighbor is untouched by payg's refusal
        ok = InProcessClient(server, tenant="flat")
        job = ok.submit("fam", {"family": "a", "reg": 0.1})
        assert ok.wait(job)["status"] == "done"
        # ...and flat's served seconds are now on the quota meter
        assert server.quota.compute_used("flat") > 0.0
        # unknown tenants are refused outright (no "*" catch-all here)
        ghost = InProcessClient(server, tenant="ghost")
        with pytest.raises(ServerError, match="unknown tenant"):
            ghost.submit("fam", {"family": "a", "reg": 0.1})
    finally:
        server.shutdown()


def test_workflow_allowlist_and_schema_on_the_server(tmp_path):
    """Per-tenant workflow allowlists and per-workflow param schemas
    gate submit_named before the factory ever runs."""
    fired = Calls()

    def fam(family, reg):
        fired.hit("factory")
        return build_family(family, reg)

    server = SessionServer(
        str(tmp_path), registry={"fam": fam, "other": fam},
        tenants={"narrow": TenantSpec(workflows=("other",)),
                 "*": TenantSpec()},
        param_schemas={"fam": {"family": "str",
                               "reg": {"type": "float",
                                       "min": 0.0, "max": 1.0}}},
        poll_interval=0.01)
    try:
        narrow = InProcessClient(server, tenant="narrow")
        with pytest.raises(QuotaExceeded) as exc:
            narrow.submit("fam", {"family": "a", "reg": 0.1})
        assert exc.value.resource == "workflow"
        anyone = InProcessClient(server, tenant="anyone")
        with pytest.raises(ServerError, match="not in schema"):
            anyone.submit("fam", {"family": "a", "reg": 0.1,
                                  "backdoor": 1})
        with pytest.raises(ServerError, match="above max"):
            anyone.submit("fam", {"family": "a", "reg": 5.0})
        assert fired.get("factory") == 0      # nothing reached a factory
        job = anyone.submit("fam", {"family": "a", "reg": 0.5})
        assert anyone.wait(job)["status"] == "done"
        assert fired.get("factory") == 1
    finally:
        server.shutdown()


def test_storage_quota_refuses_without_evicting(tmp_path):
    """A storage-capped tenant degrades to not-materializing: its jobs
    still finish (bit-identical), nothing is evicted on its behalf, and
    an uncapped neighbor's entries stay on disk."""
    calls = Calls()
    server = SessionServer(
        str(tmp_path / "srv"),
        registry={"fam": lambda family, reg:
                  build_family(family, reg, calls)},
        tenants={"capped": TenantSpec(storage_bytes=1.0),
                 "free": TenantSpec()},
        storage=StoreConfig(budget_bytes=50e6),
        poll_interval=0.01)
    try:
        free = InProcessClient(server, tenant="free")
        jf = free.submit("fam", {"family": "f", "reg": 0.2})
        assert free.wait(jf)["status"] == "done"
        n_entries = len(server.store.entries())
        assert n_entries > 0                  # the free tenant persisted

        capped = InProcessClient(server, tenant="capped")
        jc = capped.submit("fam", {"family": "c", "reg": 0.2})
        out = capped.wait(jc)
        assert out["status"] == "done"        # graceful, not an error
        iso = IterativeSession(str(tmp_path / "iso"))
        assert out["outputs"] == iso.run(build_family("c", 0.2)).outputs
        # the 1-byte quota admitted nothing new and evicted nothing
        assert len(server.store.entries()) == n_entries
        assert server.eviction_log == []
        assert server.quota.bytes_used("capped") == 0.0
        # fleet ledger still reconciles with the bytes on disk
        assert StorageLedger(server.store.ledger_path).used() == \
            pytest.approx(server.store.total_bytes())
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# the stress harness: K tenants × M socket clients × a 2-shard router
# ---------------------------------------------------------------------------
def test_multitenant_router_stress(tmp_path):
    """K tenants × M concurrent socket clients against a 2-shard fleet:
    every tenant's results are bit-identical to an isolated run, each
    shard's ledger matches its on-disk bytes, no eviction ever removed
    an entry a live submission wanted, and the quota-exhausted tenant
    got a clean wire error while everyone else kept working."""
    tenant_regs = {"acme": (0.1, 0.3), "bravo": (0.2, 0.4),
                   "cairo": (0.15, 0.35)}
    tenants = {t: TenantSpec(weight=w) for t, w in
               (("acme", 3.0), ("bravo", 1.0), ("cairo", 1.0))}
    tenants["payg"] = TenantSpec(compute_seconds=0.0)
    schemas = {"fam": {"family": "str",
                       "reg": {"type": "float", "min": 0.0, "max": 1.0}}}
    calls = Calls()
    registry = {"fam": lambda family, reg:
                build_family(family, reg, calls)}

    servers, shard_paths = {}, {}
    for sid in ("s0", "s1"):
        srv = SessionServer(
            str(tmp_path / sid), registry=registry, tenants=tenants,
            param_schemas=schemas,
            engine=EngineConfig(schedule="fair", n_sessions=2),
            poll_interval=0.01)
        shard_paths[sid] = srv.serve_unix(str(tmp_path / f"{sid}.sock"))
        servers[sid] = srv

    results: dict[tuple, dict] = {}
    quota_errors: list[QuotaExceeded] = []
    failures: list[BaseException] = []
    lock = threading.Lock()

    def worker(tenant, my_regs):
        # routers are not thread-safe: one per client thread, over the
        # same shard table — deterministic hashing makes them agree
        router = FleetRouter(shard_paths, registry=registry,
                             tenant=tenant, timeout=60.0)
        try:
            jobs = [(r, router.submit("fam", {"family": tenant,
                                              "reg": r}))
                    for r in my_regs]
            for r, job in jobs:
                out = router.wait(job, timeout=120.0)
                assert out["status"] == "done", out
                with lock:
                    results[(tenant, r)] = out["outputs"]
        finally:
            router.close()

    def broke_worker():
        router = FleetRouter(shard_paths, registry=registry,
                             tenant="payg", timeout=60.0)
        try:
            router.submit("fam", {"family": "payg", "reg": 0.1})
        except QuotaExceeded as e:
            with lock:
                quota_errors.append(e)
        finally:
            router.close()

    def run(fn, *args):
        def wrapped():
            try:
                fn(*args)
            except BaseException as e:   # noqa: BLE001 - collected
                with lock:
                    failures.append(e)
        t = threading.Thread(target=wrapped, daemon=True)
        t.start()
        return t

    try:
        threads = [run(broke_worker)]
        for tenant, regs in tenant_regs.items():
            # M=2 socket clients per tenant, splitting its arms
            threads.append(run(worker, tenant, regs[:1]))
            threads.append(run(worker, tenant, regs[1:]))
        for t in threads:
            t.join(timeout=180.0)
            assert not t.is_alive(), "stress worker hung"
        assert not failures, failures

        # the quota-exhausted tenant got exactly one clean refusal
        assert len(quota_errors) == 1
        assert quota_errors[0].tenant == "payg"
        assert quota_errors[0].resource == "compute_seconds"

        # bit-identity: every tenant's wire outputs == an isolated run
        for (tenant, reg), outputs in sorted(results.items()):
            iso = IterativeSession(str(tmp_path / f"iso-{tenant}-{reg}"))
            assert outputs == iso.run(build_family(tenant, reg)).outputs
        assert len(results) == sum(len(r) for r in tenant_regs.values())

        for sid, srv in servers.items():
            # per-shard ledger == bytes actually on disk
            assert StorageLedger(srv.store.ledger_path).used() == \
                pytest.approx(srv.store.total_bytes()), sid
            # zero evictions of entries a live submission wanted
            assert all(not e["live"] for e in srv.eviction_log), sid
            # the status() wire surface carries the same proof
            client = InProcessClient(srv, tenant="acme")
            snap = client.status()
            assert snap["tenants"]["n_evictions_live"] == 0
            assert "payg" not in {
                t for t, u in snap["tenants"]["usage"].items()
                if u.get("compute_s", 0.0) > 0.0}

        # prefix affinity: each family was computed on exactly one
        # shard, exactly once fleet-wide (both clients of a tenant — and
        # both router instances — agreed on placement)
        for tenant in tenant_regs:
            assert calls.get(f"feat_{tenant}") == 1, tenant
    finally:
        for srv in servers.values():
            srv.shutdown()


# ---------------------------------------------------------------------------
# tier counters are exact under concurrency (regression: unlocked +=)
# ---------------------------------------------------------------------------
def test_tier_counters_exact_under_concurrent_loads(tmp_path):
    """T threads × N loads of a memory-resident entry: the hit counter
    equals T·N exactly. Lost updates from the old unlocked ``+=`` made
    the stress harness's accounting assertions flaky."""
    store = Store(str(tmp_path / "store"), mem_budget_bytes=64e6)
    store.save("aa11", "x", np.arange(4096, dtype=np.float64))
    store.writer_drain()
    assert store.mem_has("aa11")
    T, N = 8, 200
    start = threading.Barrier(T)

    def hammer():
        start.wait()
        for _ in range(N):
            store.load("aa11")

    threads = [threading.Thread(target=hammer) for _ in range(T)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive()
    with store._stats_lock:
        hits = store.load_stats["memory"]["hits"]
        misses = store.load_stats["memory"]["misses"]
    assert hits == T * N
    assert misses == 0
    snap = store.tier_status()
    assert snap["local"]["misses"] == 0


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------
PARITY_SCHEMA = {"reg": {"type": "float", "min": 0.0, "max": 1.0},
                 "iters": {"type": "int", "min": 1, "max": 500},
                 "family": "str", "deep": "bool",
                 "mode": ["grid", "random"]}


def _param_draws(seed, n=200):
    """Seeded param dicts, valid and invalid: wrong types, out of range,
    off the choice list, unknown names."""
    rng = np.random.default_rng(seed)
    values = {"reg": [0.0, 0.3, 1.0, 1.5, -0.2, "0.3", True, 2, None],
              "iters": [1, 250, 500, 0, 501, 2.5, False, "7"],
              "family": ["a", "", 3, None],
              "deep": [True, False, 1, "yes"],
              "mode": ["grid", "random", "exhaustive", 0],
              "exploit": [1, "x"]}
    out = []
    for _ in range(n):
        keys = [k for k in values if rng.random() < 0.45]
        out.append({k: values[k][int(rng.integers(len(values[k])))]
                    for k in keys})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_validate_params_verdicts_match_reference(seed):
    """Every seeded param dict gets the same verdict from both packages:
    accepted by both, or refused by both with the same message."""
    from repro.serve.tenancy import validate_params as ref_validate

    def verdict(fn, params):
        try:
            fn("fam", dict(params), PARITY_SCHEMA)
        except ValueError as e:
            return str(e)
        return "ok"

    draws = _param_draws(seed)
    got = [verdict(validate_params, p) for p in draws]
    want = [verdict(ref_validate, p) for p in draws]
    assert got == want
    assert "ok" in got and len(set(got)) > 5


def test_quota_refusals_match_reference(tmp_path):
    """The same seeded sequence of reservations, adjustments, compute
    charges and admission checks against both packages' ``TenantQuota``
    and ``ScopedLedger``: the same grants, refusals (resource, limit,
    used) and final usage snapshots."""
    from repro.core.locking import StorageLedger as RefLedger
    from repro.serve import tenancy as ref

    def drive(pkg_quota, pkg_scoped, pkg_spec, ledger_cls, quota_exc,
              root):
        rng = np.random.default_rng(7)
        quota = pkg_quota(str(root / "tenants.json"))
        fleet = ledger_cls(str(root / "ledger.json"))
        fleet.ensure(0.0)
        scoped = {t: pkg_scoped(fleet, quota, t, quota_bytes=q)
                  for t, q in (("a", 4000.0), ("b", 2500.0),
                                    ("c", float("inf")))}
        trace = []
        for _ in range(300):
            t = "abc"[int(rng.integers(3))]
            op = int(rng.integers(5))
            n = float(rng.integers(1, 900))
            if op == 0:
                trace.append(("reserve", t, scoped[t].try_reserve(
                    n, budget=6000.0)))
            elif op == 1:
                scoped[t].adjust(-n / 2)
                trace.append(("adjust", t))
            elif op == 2:
                quota.charge_compute(t, n / 100)
                trace.append(("charge", t))
            elif op == 3:
                trace.append(("exhausted", t, scoped[t].scope_exhausted(n)))
            else:
                try:
                    quota.check_compute(t, pkg_spec(compute_seconds=30.0))
                    trace.append(("admit", t))
                except quota_exc as e:
                    trace.append(("refused", t, e.resource, e.limit,
                                  round(e.used, 9)))
        trace.append(quota.snapshot())
        trace.append(round(fleet.used(), 9))
        return trace

    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = drive(ref.TenantQuota, ref.ScopedLedger, ref.TenantSpec,
                 RefLedger, ref.QuotaExceeded, tmp_path / "ref")
    got = drive(TenantQuota, ScopedLedger, TenantSpec, StorageLedger,
                QuotaExceeded, tmp_path / "port")
    assert got == want
    assert any(e[0] == "refused" for e in got[:-2])
    assert any(e[0] == "reserve" and e[2] is False for e in got[:-2])
