"""The port's schedulers (``repro_torch.serve.scheduler``) against the JAX
package's, on the same seeded event streams.

Each stream draws jobs (a signature set from a shared pool, a priority, a
tenant) from a numpy generator, then interleaves submissions, dispatch
decisions and completions; a completion materializes some of the
finished job's signatures. Both packages' ``PrefixScheduler`` (modes
``prefix`` and ``fifo``) and ``TenantScheduler`` (``fair``) see the same
events, with the store and the cost model replaced by the same pinned
stand-ins, and must dispatch the same jobs in the same order, report the
same multiplicities and, for ``fair``, the same virtual times. The
dispatch order is exact: no tolerance.
"""
import dataclasses

import numpy as np
import pytest

from repro.serve import scheduler as jsched
from repro_torch.serve import scheduler as tsched

N_JOBS, N_SIGS, SLOTS = 24, 40, 3
TENANTS = ("alice", "bob", "carol")
WEIGHTS = {"alice": 1.0, "bob": 2.0, "*": 0.5}


@dataclasses.dataclass(eq=False)
class _Job:
    id: int
    seq: int
    sigs: frozenset
    priority: int
    tenant: str


class _Store:
    """``has`` over a set the test fills as jobs finish."""

    def __init__(self):
        self.materialized: set[str] = set()

    def has(self, sig):
        return sig in self.materialized


class _Costs:
    """Pinned per-signature compute costs, the same for both packages."""

    def __init__(self, costs):
        self.costs = costs

    def compute_cost(self, sig, hint=None, default=1.0):
        return self.costs[sig]


def _stream(seed):
    """Jobs and an event list: ("submit", job) / ("step",) / ("finish", k)."""
    rng = np.random.default_rng(seed)
    pool = [f"s{i:02d}" for i in range(N_SIGS)]
    costs = {s: float(rng.choice([0.01, 0.5, 2.0, 7.0])) for s in pool}
    jobs = []
    for i in range(N_JOBS):
        # a shared prefix family (one of 4) plus a private tail
        fam = int(rng.integers(4))
        prefix = pool[fam * 5:fam * 5 + int(rng.integers(1, 6))]
        tail = list(rng.choice(pool[20:], size=int(rng.integers(1, 4)),
                               replace=False))
        jobs.append(_Job(id=i, seq=i + 1, sigs=frozenset(prefix + tail),
                         priority=int(rng.choice([0, 0, 0, 1, 2])),
                         tenant=TENANTS[int(rng.integers(len(TENANTS)))]))
    events, left = [], list(range(N_JOBS))
    while left:
        for _ in range(int(rng.integers(1, 5))):
            if left:
                events.append(("submit", left.pop(0)))
        for _ in range(int(rng.integers(1, 4))):
            events.append(("step", float(rng.uniform(0.1, 3.0)),
                           int(rng.integers(1 << 30))))
    events += [("step", float(rng.uniform(0.1, 3.0)),
                int(rng.integers(1 << 30)))] * (4 * N_JOBS)
    return jobs, costs, events


def _replay(pkg, mode, seed):
    """Drive one package's scheduler through the stream, as the server
    does: dispatch while slots are free, else finish the running job the
    stream picks (materializing half of its signatures)."""
    jobs, costs, events = _stream(seed)
    store = _Store()
    inner = pkg.PrefixScheduler(store, _Costs(costs),
                                mode="prefix" if mode == "fair" else mode)
    sched = pkg.TenantScheduler(inner, WEIGHTS) if mode == "fair" else inner
    queued, running, trace = [], [], []
    for ev in events:
        if ev[0] == "submit":
            job = jobs[ev[1]]
            queued.append(job)
            sched.add(job)
            continue
        _, seconds, pick_finish = ev
        if queued and len(running) < SLOTS:
            inflight = set().union(*(j.sigs for j in running))
            job = sched.pick(queued, inflight)
            queued.remove(job)
            running.append(job)
            if mode == "fair":
                sched.note_dispatch(job)
            trace.append(("dispatch", job.id))
        elif running:
            job = running.pop(pick_finish % len(running))
            store.materialized |= set(sorted(job.sigs)[::2])
            if mode == "fair":
                sched.note_finish(job, seconds)
            sched.remove(job)
            trace.append(("finish", job.id))
        trace.append(tuple(sched.multiplicity(s)
                           for s in sorted(costs)))
        if mode == "fair":
            trace.append(tuple(round(sched.virtual_time(t), 12)
                               for t in TENANTS))
    assert not queued and not running
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["prefix", "fifo", "fair"])
def test_dispatch_order_matches_reference(mode, seed):
    ref = _replay(jsched, mode, seed)
    port = _replay(tsched, mode, seed)
    assert port == ref
    order = [e[1] for e in port if e[0] == "dispatch"]
    assert sorted(order) == list(range(N_JOBS))


def test_fifo_is_arrival_order_within_a_priority_class():
    jobs, costs, _ = _stream(3)
    sched = tsched.PrefixScheduler(_Store(), _Costs(costs), mode="fifo")
    for j in jobs:
        sched.add(j)
    queue, order = list(jobs), []
    while queue:
        job = sched.pick(queue, set())
        queue.remove(job)
        order.append(job)
    assert [(-j.priority, j.seq) for j in order] == sorted(
        (-j.priority, j.seq) for j in jobs)


def test_unknown_mode_is_refused():
    with pytest.raises(ValueError, match="unknown schedule mode"):
        tsched.PrefixScheduler(_Store(), _Costs({}), mode="lifo")
