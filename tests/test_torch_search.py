"""The port's reuse-aware search driver (``repro_torch.core.search``) and
the layered config/client API. Twins of ``tests/test_search.py``.

Covers the acceptance surface: under an arm budget the reuse-aware
frontier computes strictly fewer nodes than a FIFO frontier on a
shared-prefix grid (and never touches the family the budget cannot
afford); successive halving kills losers with their pins/reservations
released (ledger == disk after every rung, zero live leases after the
run, zero wasted recomputes); eager (ASHA) promotion cancels stragglers
mid-run; the estimate RPC prices marginal compute against the live
store; seeded searches replay bit-identically; ``connect()`` unifies the
client constructions; and the legacy-kwarg deprecation shim resolves to
exactly the config-dataclass construction, warning once per kwarg.
"""
import threading
import time
import warnings

import numpy as np
import pytest

from repro_torch.core import (EngineConfig, IterativeSession, ResilienceConfig,
                              StoreConfig, Workflow, random_search,
                              reset_legacy_warnings)
from repro_torch.core.locking import HAVE_FLOCK, StorageLedger
from repro_torch.core.search import (HalvingConfig, SearchConfig, SearchDriver,
                                     tune)
from repro_torch.serve import (Client, InProcessClient, ServerClient,
                               SessionServer, connect)

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


def build_train(lr: float, train_iters: int = 1,
                calls: Calls | None = None,
                slow_lr: float | None = None,
                stall: threading.Event | None = None) -> Workflow:
    """src → feat (shared) → train(lr, iters) → eval{score}.

    The metric rewards larger ``lr``; ``train_iters`` is the halving
    resource; an arm with ``lr == slow_lr`` is the ASHA straggler: it
    blocks on ``stall`` until the test releases it, so "slow" is a
    synchronized condition, not a wall-clock guess that races the fast
    arms on a loaded machine.
    """
    wf = Workflow(f"train-{lr}-{train_iters}")

    def load():
        # A realistic dataset load is expensive enough that OMP
        # materializes it; a free source would be recomputed by every
        # concurrently-started arm (correct economics, but it would
        # muddy the zero-wasted-recomputes accounting below).
        m = np.arange(4096, dtype=np.float64).reshape(64, 64)
        for _ in range(60):
            m = m + np.tanh(m) * 1e-3
        return m

    src = wf.source("src", load, config=("v1",))

    def featurize(m):
        # Heavy enough that OMP materializes it on cost grounds alone:
        # siblings submitted at *different* times (no live multiplicity)
        # must still find it loadable, or they recompute it blindly.
        if calls is not None:
            calls.hit("feat")
        acc = m.copy()
        for _ in range(300):
            acc = np.tanh(acc @ m.T @ m / m.size)
        return acc

    feat = wf.extractor("feat", featurize, [src], config=("feat",))

    def train(z, lr=lr, iters=train_iters):
        if slow_lr is not None and lr == slow_lr and stall is not None:
            # The timeout is a deadlock bound, not pacing: the test
            # sets the event as soon as the causal condition (the
            # driver requested this arm's cancellation) holds.
            stall.wait(timeout=60.0)
        return float(np.sum(z * z)) * lr * (1.0 + 0.01 * iters)

    model = wf.learner("train", train, [feat],
                       config=("sgd", lr, train_iters))
    out = wf.reducer("eval", lambda m: {"score": m}, [model],
                     config=("eval",))
    wf.output(out)
    return wf


# ---------------------------------------------------------------------------
# the acceptance bar: reuse-aware ordering beats FIFO under a budget
# ---------------------------------------------------------------------------
def test_reuse_frontier_computes_fewer_nodes_than_fifo(tmp_path):
    """Interleaved two-family grid, budget of 3 arms, one slot: FIFO
    spends the budget across both families (two heavy prefixes); the
    reuse frontier, re-estimating marginal cost against the live store
    at every pick, stays signature-adjacent and never touches the second
    family. Strictly fewer node computes at the same arm count."""
    space = [{"family": f, "reg": r}
             for r in (0.1, 0.2, 0.4) for f in ("a", "b")]

    def run(frontier, workdir):
        calls = Calls()
        registry = {"fam": lambda family, reg:
                    build_family(family, reg, calls)}
        server = SessionServer(str(workdir), registry=registry,
                               engine=EngineConfig(n_sessions=1),
                               poll_interval=0.01)
        try:
            driver = SearchDriver(
                server, "fam", space=space,
                config=SearchConfig(strategy="grid", max_arms=3,
                                    frontier=frontier, max_inflight=1))
            report = driver.run()
        finally:
            server.shutdown()
        return report, calls

    reuse, reuse_calls = run("reuse", tmp_path / "reuse")
    fifo, fifo_calls = run("fifo", tmp_path / "fifo")

    for rep in (reuse, fifo):
        done = [a for a in rep.arms if a.status == "done"]
        skipped = [a for a in rep.arms if a.status == "skipped"]
        assert len(done) == 3 and len(skipped) == 3
        assert rep.wasted_recomputes() == 0

    # FIFO's first 3 arms touch both families; reuse-aware stays in one.
    assert fifo_calls.get("feat_a") == 1 and fifo_calls.get("feat_b") == 1
    assert sorted([reuse_calls.get("feat_a"),
                   reuse_calls.get("feat_b")]) == [0, 1]
    assert reuse.total_node_computes() < fifo.total_node_computes()
    # The frontier recorded why: later picks had hits, hence a smaller
    # marginal than their total.
    priced = [a.estimate for a in reuse.arms if a.estimate is not None]
    assert any(e["n_hit"] > 0 and e["marginal_s"] < e["total_s"]
               for e in priced)


def test_estimate_rpc_prices_against_live_store(tmp_path):
    """Cold store: marginal == total. After one arm runs, a sibling's
    estimate sees store hits and a strictly smaller marginal; a disjoint
    family still prices at full cost."""
    registry = {"fam": lambda family, reg: build_family(family, reg)}
    server = SessionServer(str(tmp_path), registry=registry,
                           engine=EngineConfig(n_sessions=1),
                           poll_interval=0.01)
    try:
        client = connect(server)
        cold = client.estimate("fam", {"family": "a", "reg": 0.1})
        assert cold["n_hit"] == 0
        assert cold["marginal_s"] == pytest.approx(cold["total_s"])
        job = client.submit("fam", {"family": "a", "reg": 0.1})
        assert client.wait(job)["status"] == "done"
        warm = client.estimate("fam", {"family": "a", "reg": 0.2})
        assert warm["n_hit"] >= 1
        assert warm["marginal_s"] < warm["total_s"]
        other = client.estimate("fam", {"family": "b", "reg": 0.2})
        assert other["n_hit"] == 0
        assert other["marginal_s"] == pytest.approx(other["total_s"])
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# successive halving: losers die clean
# ---------------------------------------------------------------------------
def test_halving_promotes_top_and_releases_ledger(tmp_path):
    """3 arms over 2 rungs at eta=2: rung 0 runs all at the low resource
    level, the top 2 promote to the high level, the loser never does.
    After *every* rung the shared ledger equals on-disk bytes (no
    reservation leaked by a loser), and the run ends with zero live
    leases and zero wasted recomputes."""
    registry = {"train": lambda lr, train_iters:
                build_train(lr, train_iters)}
    server = SessionServer(str(tmp_path), registry=registry,
                           engine=EngineConfig(n_sessions=3),
                           poll_interval=0.01)
    drift_checks: list[tuple[float, int]] = []

    def on_rung(summary):
        ledger = StorageLedger(server.store.ledger_path)
        drift_checks.append((ledger.used(), server.store.total_bytes()))

    try:
        driver = SearchDriver(
            server, "train",
            space=[{"lr": lr} for lr in (0.1, 0.2, 0.3)],
            config=SearchConfig(
                strategy="grid", metric="eval.score", max_inflight=3,
                halving=HalvingConfig(resource="train_iters",
                                      levels=[1, 3], eta=2.0),
                on_rung=on_rung))
        report = driver.run()
    finally:
        server.shutdown()

    assert len(report.rungs) == 2
    assert drift_checks and all(used == disk
                                for used, disk in drift_checks)
    r0, r1 = report.rungs
    assert r0["n_done"] == 3 and len(r0["promoted"]) == 2
    assert r1["n_done"] == 2
    # the metric rewards lr: 0.2 and 0.3 promote, 0.1 never reaches rung 1
    rung1 = [a for a in report.arms if a.rung == 1]
    assert sorted(a.base_params["lr"] for a in rung1) == [0.2, 0.3]
    assert all(a.params["train_iters"] == 3 for a in rung1)
    best = report.best()
    assert best.rung == 1 and best.base_params["lr"] == 0.3
    assert report.wasted_recomputes() == 0
    counts = server.store.lease_counts()
    assert counts["compute"] == 0 and counts["pins"] == 0
    ledger = StorageLedger(server.store.ledger_path)
    assert ledger.used() == server.store.total_bytes()


def test_eager_halving_cancels_straggler(tmp_path):
    """ASHA mode: with one deliberately slow arm, the first two finishers
    fill the promotion quota and the straggler is cancelled mid-run — it
    never reaches rung 1, and its pins/reservations are settled (zero
    live leases, ledger == disk)."""
    calls = Calls()
    stall = threading.Event()
    registry = {"train": lambda lr, train_iters:
                build_train(lr, train_iters, calls=calls, slow_lr=99.0,
                            stall=stall)}
    server = SessionServer(str(tmp_path), registry=registry,
                           engine=EngineConfig(n_sessions=3),
                           poll_interval=0.01)

    def release_on_cancel():
        # Event-synchronized straggler release: unblock the slow arm
        # only once the driver has *requested* its cancellation — the
        # causal condition the old fixed sleep merely guessed at — so
        # the straggler can never finish rung 0 first, at any machine
        # speed. The deadline is a deadlock bound for the failure case.
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and not stall.is_set():
            with server._cv:
                requested = any(j.cancel_event.is_set()
                                for j in server._jobs.values())
            if requested:
                break
            time.sleep(0.01)
        stall.set()

    watcher = threading.Thread(target=release_on_cancel, daemon=True)
    watcher.start()
    try:
        driver = SearchDriver(
            server, "train",
            space=[{"lr": 99.0}, {"lr": 0.2}, {"lr": 0.3}],
            config=SearchConfig(
                strategy="grid", metric="eval.score", max_inflight=3,
                frontier="fifo",     # submit all three immediately
                halving=HalvingConfig(resource="train_iters",
                                      levels=[1, 3], eta=1.5,
                                      eager=True)))
        report = driver.run()
    finally:
        stall.set()
        watcher.join(timeout=5.0)
        server.shutdown()

    assert report.n_cancelled() == 1
    cancelled = [a for a in report.arms if a.status == "cancelled"]
    assert cancelled[0].base_params["lr"] == 99.0
    rung1 = [a for a in report.arms if a.rung == 1]
    assert sorted(a.base_params["lr"] for a in rung1) == [0.2, 0.3]
    assert all(a.status == "done" for a in rung1)
    counts = server.store.lease_counts()
    assert counts["compute"] == 0 and counts["pins"] == 0
    ledger = StorageLedger(server.store.ledger_path)
    assert ledger.used() == server.store.total_bytes()


# ---------------------------------------------------------------------------
# seeded reproducibility
# ---------------------------------------------------------------------------
def test_random_strategy_replays_bit_identically(tmp_path):
    """Same seed → the same draw sequence (and the report records it);
    a different seed draws a different sequence."""
    axes = {"lr": [0.1, 0.2, 0.3, 0.4, 0.5],
            "train_iters": [1, 2, 3, 4]}
    registry = {"train": lambda lr, train_iters:
                build_train(lr, train_iters)}

    def run(workdir, seed):
        server = SessionServer(str(workdir), registry=registry,
                               engine=EngineConfig(n_sessions=2),
                               poll_interval=0.01)
        try:
            driver = SearchDriver(
                server, "train", axes=axes,
                config=SearchConfig(strategy="random", max_arms=4,
                                    frontier="fifo", seed=seed,
                                    detail=False))
            return driver.run()
        finally:
            server.shutdown()

    a = run(tmp_path / "a", seed=7)
    b = run(tmp_path / "b", seed=7)
    c = run(tmp_path / "c", seed=8)
    assert a.seed == b.seed == 7
    assert [x.params for x in a.arms] == [x.params for x in b.arms]
    assert [x.params for x in a.arms] != [x.params for x in c.arms]
    assert all(x.status == "done" for x in a.arms)


def test_random_search_seed_recorded_and_reproducible():
    """The sweep helper's new seed= draws the same variants twice and
    stamps the seed on each variant for replay from a report."""
    def mutate(knobs, rng):
        return {"lr": float(rng.uniform(0.0, 1.0))}

    build = lambda kn: build_train(kn["lr"])  # noqa: E731
    v1 = random_search({"lr": 0.5}, mutate, 4, build=build, seed=13)
    v2 = random_search({"lr": 0.5}, mutate, 4, build=build, seed=13)
    v3 = random_search({"lr": 0.5}, mutate, 4, build=build, seed=14)
    assert [v.knobs for v in v1] == [v.knobs for v in v2]
    assert [v.knobs for v in v1] != [v.knobs for v in v3]
    assert all(v.seed == 13 for v in v1)
    with pytest.raises(TypeError):
        random_search({"lr": 0.5}, mutate, 4)   # build is required


# ---------------------------------------------------------------------------
# mutation (beam) search
# ---------------------------------------------------------------------------
def test_mutation_search_climbs_the_metric(tmp_path):
    """Greedy beam search: each round keeps the best arms and expands
    seeded mutations; the best metric never gets worse round over round
    and dedupe never resubmits a visited point."""
    registry = {"train": lambda lr: build_train(lr)}

    def mutate(params, rng):
        step = float(rng.choice([-0.05, 0.05, 0.1]))
        return {"lr": round(min(1.0, max(0.0, params["lr"] + step)), 3)}

    report = tune(str(tmp_path), registry, "train",
                  base={"lr": 0.2}, mutate=mutate,
                  config=SearchConfig(strategy="mutate",
                                      metric="eval.score",
                                      beam_width=1, children=2,
                                      rounds=3, max_inflight=2,
                                      seed=3))
    assert report.strategy == "mutate"
    assert len(report.rungs) >= 2
    done = [a for a in report.arms if a.status == "done"]
    assert len(done) == len(report.arms)
    # dedupe: no parameter point is ever submitted twice across rounds
    assert len({tuple(sorted(a.base_params.items()))
                for a in report.arms}) == len(report.arms)
    # each round expands at most beam_width * children mutations, all
    # derived from that round's single beam survivor
    for r in report.rungs:
        assert len(r["promoted"]) <= 1
        if r["rung"] > 0:
            assert r["n_arms"] <= 1 * 2
    # the winner is an arm the search actually visited and ranked
    best = report.best()
    assert best is not None
    assert best.metric == max(a.metric for a in done)


# ---------------------------------------------------------------------------
# connect(): one front door for every client shape
# ---------------------------------------------------------------------------
def test_connect_unifies_client_construction(tmp_path):
    registry = {"fam": lambda reg=0.1: build_family("a", reg)}
    server = SessionServer(str(tmp_path / "srv"), registry=registry,
                           engine=EngineConfig(n_sessions=1),
                           poll_interval=0.01)
    sock = server.serve_unix(str(tmp_path / "helix.sock"))
    host, port = server.serve_tcp("127.0.0.1", 0)
    try:
        inproc = connect(server)
        assert isinstance(inproc, InProcessClient)
        assert isinstance(inproc, Client)          # runtime protocol
        assert connect(inproc) is inproc           # idempotent
        with connect(sock) as over_unix:
            assert isinstance(over_unix, ServerClient)
            assert over_unix.hello()["workflows"] == ["fam"]
        with connect(f"{host}:{port}") as over_tcp:
            assert isinstance(over_tcp, ServerClient)
            job = over_tcp.submit("fam", {"reg": 0.2})
            assert over_tcp.wait(job)["status"] == "done"
        with pytest.raises(TypeError):
            connect(12345)
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# config API: shim equivalence + warn-once
# ---------------------------------------------------------------------------
def test_legacy_kwargs_resolve_to_config_and_warn_once(tmp_path):
    """A legacy-kwarg construction resolves to the exact same config
    dataclasses as the config-API construction; each deprecated kwarg
    warns once per process, then never again."""
    reset_legacy_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        legacy = IterativeSession(
            str(tmp_path / "legacy"), max_workers=2, prefetch_depth=8,
            storage_budget_bytes=1e9, dedupe_wait_seconds=5.0)
    deps = [w for w in caught if issubclass(w.category,
                                            DeprecationWarning)]
    assert len(deps) == 4            # one per legacy kwarg
    assert any("EngineConfig" in str(w.message) for w in deps)
    assert any("StoreConfig" in str(w.message) for w in deps)
    assert any("ResilienceConfig" in str(w.message) for w in deps)

    with warnings.catch_warnings(record=True) as again:
        warnings.simplefilter("always")
        legacy2 = IterativeSession(
            str(tmp_path / "legacy2"), max_workers=2, prefetch_depth=8,
            storage_budget_bytes=1e9, dedupe_wait_seconds=5.0)
    assert not [w for w in again if issubclass(w.category,
                                               DeprecationWarning)]

    with warnings.catch_warnings(record=True) as clean:
        warnings.simplefilter("always")
        modern = IterativeSession(
            str(tmp_path / "modern"),
            engine=EngineConfig(max_workers=2, prefetch_depth=8),
            storage=StoreConfig(budget_bytes=1e9),
            resilience=ResilienceConfig(dedupe_wait_seconds=5.0))
    assert not [w for w in clean if issubclass(w.category,
                                               DeprecationWarning)]

    for a in (legacy, legacy2):
        assert a.engine_config == modern.engine_config
        assert a.store_config == modern.store_config
        assert a.resilience_config == modern.resilience_config
    # resolved call-site defaults are explicit in the frozen configs
    assert modern.engine_config.share_nondet is False
    assert modern.store_config.purge_stale is True


def test_server_config_equivalence(tmp_path):
    """Same shim contract on the server, whose call-site defaults differ
    from a standalone session's (fleet sharing on by default)."""
    reset_legacy_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        legacy = SessionServer(str(tmp_path / "legacy"), n_sessions=2,
                               schedule="fifo", poll_interval=0.01)
    assert [w for w in caught
            if issubclass(w.category, DeprecationWarning)]
    modern = SessionServer(str(tmp_path / "modern"),
                           engine=EngineConfig(n_sessions=2,
                                               schedule="fifo"),
                           poll_interval=0.01)
    try:
        assert legacy.engine_config == modern.engine_config
        assert legacy.store_config == modern.store_config
        assert legacy.resilience_config == modern.resilience_config
        assert modern.engine_config.share_nondet is True
        assert modern.store_config.purge_stale is False
    finally:
        legacy.shutdown()
        modern.shutdown()


def test_config_type_errors_are_loud(tmp_path):
    with pytest.raises(TypeError, match="EngineConfig"):
        IterativeSession(str(tmp_path), engine=StoreConfig())


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------
def _parity_registry(workflow_cls):
    """One workflow family for both packages: src(family) → feat(family)
    → train(reg, train_iters) → eval{score}; the metric rises with reg
    and train_iters."""
    def build(family="a", reg=0.1, train_iters=1):
        wf = workflow_cls(f"{family}-{reg}-{train_iters}")
        src = wf.source(
            "src", lambda f=family: np.arange(1024, dtype=np.float64)
            .reshape(32, 32) * (1 + "abc".index(f)),
            config=("v1", family))
        feat = wf.extractor("feat", lambda m: np.tanh(m @ m.T / m.size),
                            [src], config=("feat", family))
        model = wf.learner(
            "train", lambda z, r=reg, it=train_iters:
            float(np.sum(z * z)) * r * (1.0 + 0.01 * it),
            [feat], config=("sgd", reg, train_iters))
        wf.output(wf.reducer("eval", lambda m: {"score": m}, [model],
                             config=("eval",)))
        return wf
    return {"fam": build}


def _mutate(params, rng):
    out = dict(params)
    out["reg"] = round(out["reg"] * float(rng.choice([0.5, 2.0, 3.0])), 6)
    if rng.random() < 0.5:
        out["family"] = "abc"[int(rng.integers(3))]
    return out


PARITY_CASES = {
    "random-halving": dict(
        axes={"family": ["a", "b", "c"], "reg": [0.1, 0.2, 0.4, 0.8]},
        config=dict(strategy="random", max_arms=6, seed=5,
                    halving=("train_iters", [1, 3]))),
    "grid-reuse": dict(
        space=[{"family": f, "reg": r} for r in (0.1, 0.3)
               for f in "abc"],
        config=dict(strategy="grid", max_arms=4)),
    "mutate": dict(
        base={"family": "a", "reg": 0.1}, mutate=_mutate,
        config=dict(strategy="mutate", seed=3, rounds=3, beam_width=2,
                    children=2)),
}


def _tune_both(case, tmp_path, monkeypatch):
    """``tune`` of one case in each package, with every compute priced at
    1 s and every load at 0.01 s, one session slot and one arm in flight,
    so the frontier's estimates and the halving see the same store in
    both packages."""
    from repro.core import costs as jcosts, search as jsearch
    from repro.core import store as jstore
    from repro.core.config import EngineConfig as JEngine
    from repro.core.omp import Policy as JPolicy
    from repro.core.workflow import Workflow as JWorkflow
    from repro_torch.core import costs as tcosts, store as tstore
    from repro_torch.core import search as tsearch
    from repro_torch.core.omp import Policy

    for mod in (jcosts, tcosts):
        monkeypatch.setattr(mod.CostModel, "compute_cost",
                            lambda self, sig, hint=None, default=1.0: 1.0)
    for mod in (jstore, tstore):
        monkeypatch.setattr(mod.Store, "est_load_seconds",
                            lambda self, nbytes, sig=None: 0.01)
    spec = PARITY_CASES[case]
    out = {}
    for pkg, search, engine, policy, wf_cls in (
            ("jax", jsearch, JEngine, JPolicy, JWorkflow),
            ("torch", tsearch, EngineConfig, Policy, Workflow)):
        kw = dict(spec["config"])
        halving = kw.pop("halving", None)
        cfg = search.SearchConfig(
            frontier="reuse", max_inflight=1, metric="eval.score",
            halving=None if halving is None else search.HalvingConfig(
                resource=halving[0], levels=halving[1], eta=2.0), **kw)
        out[pkg] = search.tune(
            str(tmp_path / pkg), _parity_registry(wf_cls), "fam",
            axes=spec.get("axes"), space=spec.get("space"),
            base=spec.get("base"), mutate=spec.get("mutate"), config=cfg,
            engine=engine(n_sessions=1, policy=policy.ALWAYS))
    return out


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_tune_matches_reference(case, tmp_path, monkeypatch):
    """The same arms, in the same dispatch order, at the same rungs, with
    the same statuses, metrics and promotions, and the same best arm."""
    reps = _tune_both(case, tmp_path, monkeypatch)

    def arms(rep):
        return [(a.name, a.params, a.base_params, a.rung, a.order, a.status,
                 a.metric, a.estimate and a.estimate["marginal_s"])
                for a in rep.arms]

    assert arms(reps["torch"]) == arms(reps["jax"])
    assert reps["torch"].rungs == reps["jax"].rungs
    assert reps["torch"].seed == reps["jax"].seed
    best = {pkg: rep.best() for pkg, rep in reps.items()}
    assert best["torch"].name == best["jax"].name
    assert reps["torch"].wasted_recomputes() == 0
    assert sum(a.status == "done" for a in reps["torch"].arms) >= 3

