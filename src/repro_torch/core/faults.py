"""Deterministic fault injection for the fleet substrate.

The remote tier's failure story (remote.py: marker-committed publishes,
TTL leases, degradation windows) is only credible if every protocol step
can be *made* to fail on demand, reproducibly. This module is that
harness:

* :class:`FaultPlan` — a seeded, scriptable schedule of faults: fail the
  Nth ``put``, fail a fraction of ``get``\\ s, add latency, drop
  heartbeat renewals, or crash a participant at a named protocol step
  (e.g. between "value uploaded" and "marker uploaded"). One plan is
  shared by every wrapper/handle participating in a scenario, so "the
  3rd put anywhere in the fleet" means exactly that.
* :class:`ChaosObjectStore` — an :class:`~repro_torch.core.remote.ObjectStore`
  decorator that consults the plan *before* delegating each backend
  call. Faults therefore fire before the operation has any side effect,
  which keeps injected transient errors safe to retry — exactly the
  semantics a real backend's connection-refused / 503 has.
* :class:`InjectedCrash` — raised at an armed crash point.
  Deliberately a ``BaseException`` subclass: production code catches
  ``OSError`` (degrade) and ``Exception`` (job errors), and a simulated
  *process death* must sail through both and stop the participant where
  a ``kill -9`` would. Tests catch it at the scenario boundary.

:class:`~repro_torch.core.remote.RemoteStore` accepts a plan via its
``faults=`` parameter and calls :meth:`FaultPlan.crash_point` at the
named steps of its publish/lease/heartbeat paths (the point names are
listed on that parameter's docstring); the heartbeat loop additionally
asks :meth:`FaultPlan.drop_heartbeat` before each renewal. Production
runs pass ``faults=None`` and pay a single ``is None`` check.

:class:`~repro_torch.core.store.Store` consults a plan assigned to its
``faults`` attribute at the crash points of its multi-step local-disk
protocols: the chunked-splice publish path
(``splice:chunk_published``, ``splice:before_manifest``) and the
memory tier's demotion path (``memtier:before_spill`` dies before any
durable byte exists — a torn spill must be invisible after restart;
``memtier:after_spill`` dies with the disk entry committed and the
ledger already adjusted).

Error classes: ``error="transient"`` injects
:class:`~repro_torch.core.remote.TransientBackendError` (retried with backoff
by the remote tier), ``error="permanent"`` injects a plain
:class:`OSError` (degrades the tier to local-only). A callable can be
passed instead to inject custom exceptions.

Everything is deterministic given the seed and the call order; the
``fired`` log records every injected fault so a failing chaos test can
print what actually happened.
"""
from __future__ import annotations

import random
import threading
import time

from .remote import ObjectStore, TransientBackendError

# Every backend operation the plan can target.
_OPS = ("put", "get", "list", "delete", "put_if_absent", "exists", "mtime")


class InjectedCrash(BaseException):
    """Simulated process death at a named crash point.

    A ``BaseException`` (not ``Exception``): the degradation handlers
    (``except OSError``) and job-error handlers must not absorb it —
    a crashed process doesn't degrade gracefully, it stops. Scenario
    code catches it where the "process boundary" of the simulated
    participant is.
    """


def _make_error(spec, op: str, key: str) -> BaseException:
    """Build the exception a rule injects (see module docstring)."""
    if callable(spec):
        return spec(op, key)
    if spec == "permanent":
        return OSError(f"injected permanent {op} failure on {key!r}")
    return TransientBackendError(
        f"injected transient {op} failure on {key!r}")


class _Rule:
    """One scripted failure: which ops/keys it matches and when it fires."""

    def __init__(self, op: str | None, *, error="transient",
                 nth: int | None = None, times: int = 1,
                 rate: float | None = None, key_substr: str | None = None):
        if op is not None and op not in _OPS:
            raise ValueError(f"unknown backend op {op!r}; one of {_OPS}")
        self.op = op                    # None matches every op
        self.error = error
        self.nth = nth                  # fire on the nth *matching* call
        self.remaining = int(times)     # how many times it may still fire
        self.rate = rate                # probabilistic instead of counted
        self.key_substr = key_substr
        self.seen = 0                   # matching calls observed so far

    def matches(self, op: str, key: str) -> bool:
        if self.op is not None and op != self.op:
            return False
        return self.key_substr is None or self.key_substr in key

    def should_fire(self, rng: random.Random) -> bool:
        """Called once per matching op (under the plan lock)."""
        if self.remaining <= 0:
            return False
        self.seen += 1
        if self.rate is not None:
            fire = rng.random() < self.rate
        else:
            fire = self.seen >= (self.nth or 1)
        if fire:
            self.remaining -= 1
        return fire


class FaultPlan:
    """A seeded, scriptable schedule of injected faults.

    Script it with :meth:`fail_nth` / :meth:`fail_rate` /
    :meth:`add_latency` / :meth:`crash_at` / :meth:`drop_heartbeats`,
    then hand it to a :class:`ChaosObjectStore` (backend faults) and/or
    a :class:`~repro_torch.core.remote.RemoteStore` (crash points, heartbeat
    drops). All hooks are thread-safe; determinism holds whenever the
    cross-thread call order does (single-participant scenarios are
    bit-deterministic; storms are distribution-deterministic).
    """

    def __init__(self, seed: int = 0):
        """Create an empty plan; ``seed`` drives every random draw."""
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._rules: list[_Rule] = []
        self._latency: list[tuple[str | None, float, float]] = []
        self._crash_points: dict[str, list[int]] = {}  # name -> [nth, times]
        self._crash_seen: dict[str, int] = {}
        self._drop_heartbeats = 0
        #: Log of injected faults, in order: ``("error", op, key, kind)``,
        #: ``("latency", op, key, seconds)``, ``("crash", point)``,
        #: ``("heartbeat_drop",)`` — print it to reproduce a failure.
        self.fired: list[tuple] = []

    # -- scripting ---------------------------------------------------------
    def fail_nth(self, op: str | None, n: int = 1, *, error="transient",
                 times: int = 1, key_substr: str | None = None
                 ) -> "FaultPlan":
        """Fail the ``n``-th matching backend call (then ``times-1``
        more). ``op=None`` matches every operation; ``key_substr``
        narrows to keys containing it. Returns self for chaining."""
        with self._lock:
            self._rules.append(_Rule(op, error=error, nth=n, times=times,
                                     key_substr=key_substr))
        return self

    def fail_rate(self, op: str | None, rate: float, *, error="transient",
                  times: int = 10 ** 9, key_substr: str | None = None
                  ) -> "FaultPlan":
        """Fail each matching call with probability ``rate`` (seeded),
        at most ``times`` times in total. Returns self for chaining."""
        with self._lock:
            self._rules.append(_Rule(op, error=error, rate=float(rate),
                                     times=times, key_substr=key_substr))
        return self

    def add_latency(self, op: str | None, seconds: float,
                    jitter: float = 0.0) -> "FaultPlan":
        """Sleep ``seconds`` (+ uniform ``jitter``) before each matching
        backend call. Returns self for chaining."""
        with self._lock:
            self._latency.append((op, float(seconds), float(jitter)))
        return self

    def crash_at(self, point: str, nth: int = 1,
                 times: int = 1) -> "FaultPlan":
        """Arm a named crash point: the ``nth`` time a participant
        reaches ``point`` (see ``RemoteStore(faults=...)`` for the point
        names), :class:`InjectedCrash` is raised there — ``times`` times
        in total. Returns self for chaining."""
        with self._lock:
            self._crash_points[point] = [int(nth), int(times)]
            self._crash_seen.setdefault(point, 0)
        return self

    def drop_heartbeats(self, n: int = 1) -> "FaultPlan":
        """Skip the next ``n`` lease-heartbeat renewals (simulates a GC
        pause / CPU-starved heartbeat thread: the lease silently expires
        under a live holder). Returns self for chaining."""
        with self._lock:
            self._drop_heartbeats += int(n)
        return self

    # -- hooks (called by the chaos wrapper / RemoteStore) -----------------
    def on_op(self, op: str, key: str) -> None:
        """Consulted by :class:`ChaosObjectStore` before each delegated
        backend call: applies scripted latency, then raises the first
        matching armed error rule."""
        naps: list[float] = []
        err: BaseException | None = None
        with self._lock:
            for rule_op, seconds, jitter in self._latency:
                if rule_op is None or rule_op == op:
                    naps.append(seconds + (self._rng.random() * jitter
                                           if jitter else 0.0))
            for rule in self._rules:
                if rule.matches(op, key) and rule.should_fire(self._rng):
                    err = _make_error(rule.error, op, key)
                    self.fired.append(
                        ("error", op, key, type(err).__name__))
                    break
            if naps:
                self.fired.extend(("latency", op, key, s) for s in naps)
        for s in naps:      # sleep outside the lock
            time.sleep(s)
        if err is not None:
            raise err

    def crash_point(self, name: str) -> None:
        """Consulted by :class:`~repro_torch.core.remote.RemoteStore` at each
        named protocol step; raises :class:`InjectedCrash` when the
        point is armed and its turn has come."""
        with self._lock:
            armed = self._crash_points.get(name)
            if armed is None:
                return
            nth, times = armed
            if times <= 0:
                return
            self._crash_seen[name] += 1
            if self._crash_seen[name] < nth:
                return
            armed[1] -= 1
            self.fired.append(("crash", name))
        raise InjectedCrash(f"injected crash at {name!r}")

    def drop_heartbeat(self) -> bool:
        """Consulted by the heartbeat loop before each renewal round;
        True means skip this renewal (scripted via
        :meth:`drop_heartbeats`)."""
        with self._lock:
            if self._drop_heartbeats <= 0:
                return False
            self._drop_heartbeats -= 1
            self.fired.append(("heartbeat_drop",))
            return True


class ChaosObjectStore(ObjectStore):
    """Fault-injecting decorator over any :class:`ObjectStore`.

    Consults the shared :class:`FaultPlan` *before* delegating, so an
    injected failure leaves the backend untouched (safe to retry — the
    semantics of a connection that died before the request landed).
    Stack it under a :class:`~repro_torch.core.remote.RemoteStore` to exercise
    the tier's retry/degradation machinery::

        plan = FaultPlan(seed=7).fail_nth("put", 3).add_latency("get", 0.01)
        remote = RemoteStore(ChaosObjectStore(backend, plan), faults=plan)
    """

    def __init__(self, inner: ObjectStore, plan: FaultPlan):
        """Wrap ``inner``; every call consults (and logs to) ``plan``."""
        self.inner = inner
        self.plan = plan

    def put(self, key: str, data: bytes) -> None:
        """Delegated ``put`` behind the fault plan."""
        self.plan.on_op("put", key)
        return self.inner.put(key, data)

    def get(self, key: str) -> bytes | None:
        """Delegated ``get`` behind the fault plan."""
        self.plan.on_op("get", key)
        return self.inner.get(key)

    def list(self, prefix: str) -> list[str]:
        """Delegated ``list`` behind the fault plan."""
        self.plan.on_op("list", prefix)
        return self.inner.list(prefix)

    def delete(self, key: str) -> bool:
        """Delegated ``delete`` behind the fault plan."""
        self.plan.on_op("delete", key)
        return self.inner.delete(key)

    def put_if_absent(self, key: str, data: bytes) -> bool:
        """Delegated conditional put behind the fault plan."""
        self.plan.on_op("put_if_absent", key)
        return self.inner.put_if_absent(key, data)

    def exists(self, key: str) -> bool:
        """Delegated presence probe behind the fault plan."""
        self.plan.on_op("exists", key)
        return self.inner.exists(key)

    def mtime(self, key: str) -> float | None:
        """Delegated mtime probe behind the fault plan."""
        self.plan.on_op("mtime", key)
        return self.inner.mtime(key)
