"""Consistent-hash fleet router: N session-server shards, one client.

One :class:`~repro_torch.serve.server.SessionServer` owns one workdir; scaling
past a single host means N servers — and the whole value of the shared
substrate (warm signature prefixes, live multiplicity, compute-once)
depends on *which* shard a submission lands on. :class:`FleetRouter`
speaks the :class:`~repro_torch.serve.client.Client` protocol (so the search
driver, ``connect()``, and every example work against it unchanged) and
adds the placement policy:

* **Prefix-affine routing** — the route key of a submission is the hash
  of its workflow's *source-node signatures* (the nodes with no parents,
  compiled under the router's own nonce map). Sweep arms that share a
  data/featurization prefix share sources, hence share a route key,
  hence land on the same shard — where that prefix is already cached and
  the live multiplicity map actually sees the siblings. Arms over
  different datasets spread out.
* **Rendezvous (highest-random-weight) hashing** — ``shard_for(key)``
  picks the live shard maximizing ``sha256(shard_id + key)``. Adding or
  removing a shard moves only the keys whose argmax changed — an
  expected ``1/N`` fraction — so a rebalance never reshuffles the whole
  fleet's warm caches (the chaos suite asserts the move fraction).
* **Failover through the cancellation/retry path** — a shard that dies
  mid-job (connection error, or a non-drain shutdown that cancelled the
  job) is marked dead and the job is resubmitted to the rendezvous
  choice among the survivors. With the shards sharing a remote tier
  (remote.py), publish-before-release keeps the retry compute-once
  fleet-wide: whatever the dead shard published is fetched, not
  recomputed.

Like :class:`~repro_torch.serve.client.ServerClient`, a router instance wraps
live connections and is not thread-safe; concurrent callers each build
their own (deterministic hashing makes independent routers agree on
placement). ``route="random"`` (seeded) is the control arm for the
``bench_multitenant`` benchmark — same fleet, placement by coin flip.
"""
from __future__ import annotations

import hashlib
import json
import random
from typing import Any, Callable, Mapping

from ..core.signature import compute_signatures
from ..core.workflow import Workflow
from .client import Client, ServerError, connect
from .protocol import QuotaExceeded, ServerBusy
from .server import SharedNonces


def rendezvous(shard_ids, key: str) -> str:
    """Highest-random-weight choice of a shard for ``key``.

    Pure function of ``(sorted shard ids, key)``: every router instance
    — and every test — computes the same placement, and removing one
    shard re-homes only that shard's keys (their argmax is gone; every
    other key's argmax is untouched). Raises :class:`LookupError` on an
    empty shard set.
    """
    ids = sorted(str(s) for s in shard_ids)
    if not ids:
        raise LookupError("no live shards")
    return max(ids, key=lambda sid: hashlib.sha256(
        f"{sid}:{key}".encode()).digest())


class FleetRouter:
    """Route submissions across N session-server shards (Client-shaped).

    ``shards`` maps shard id → anything :func:`~repro_torch.serve.client.connect`
    accepts (a live :class:`~repro_torch.serve.server.SessionServer`, a unix
    socket path, ``(host, port)``, or an existing client). ``registry``
    — the same name→factory table the shards serve — lets the router
    compile a submission locally to derive its prefix-affine route key;
    without it, routing degrades to hashing ``(workflow, params)``
    (deterministic, but arms sharing a prefix no longer co-locate).
    ``timeout``/``tenant`` forward to each shard connection;
    ``route="random"`` + ``seed`` give the benchmark's randomized
    placement control.
    """

    def __init__(self, shards: Mapping[str, Any], *,
                 registry: Mapping[str, Callable[..., Workflow]]
                 | None = None,
                 nonces: SharedNonces | None = None,
                 timeout: float | None = None,
                 tenant: str = "default",
                 route: str = "hash",
                 seed: int = 0):
        """Connect every shard; see the class docstring for knobs."""
        if route not in ("hash", "random"):
            raise ValueError(f"unknown route mode: {route!r}")
        self.tenant = str(tenant)
        self.registry = dict(registry or {})
        self.nonces = nonces if nonces is not None else SharedNonces()
        self.route = route
        self._rng = random.Random(seed)
        self._clients: dict[str, Client] = {}
        self._targets: dict[str, Any] = {}
        self._dead: set[str] = set()
        self._timeout = timeout
        for sid, target in shards.items():
            self._targets[str(sid)] = target
            self._clients[str(sid)] = connect(target, timeout=timeout,
                                              tenant=tenant)
        if not self._clients:
            raise ValueError("FleetRouter needs at least one shard")
        # job id -> submission record for re-routing on shard death.
        self._jobs: dict[str, dict] = {}
        # Failovers performed, for status()/tests.
        self.failovers = 0

    # -- placement ---------------------------------------------------------
    def live_shards(self) -> list[str]:
        """Shard ids currently considered alive (sorted)."""
        return sorted(s for s in self._clients if s not in self._dead)

    def route_key(self, workflow: str,
                  params: Mapping[str, Any] | None = None) -> str:
        """Prefix-affine route key for a submission.

        With the workflow's factory available: compile it under the
        router's nonce map and hash the sorted *source-node* signatures
        — identical for every arm sharing the same input data/config
        nodes, different across datasets. Fallback (no registry entry):
        hash the workflow name + canonical params JSON.
        """
        factory = self.registry.get(workflow)
        if factory is not None:
            dag = factory(**dict(params or {})).build()
            sigs = compute_signatures(dag, nonces=self.nonces)
            sources = sorted(sigs[name] for name, node in dag.nodes.items()
                             if not node.parents)
            return hashlib.sha256(
                ",".join(sources).encode()).hexdigest()
        blob = json.dumps([workflow, dict(params or {})], sort_keys=True,
                          default=str)
        return hashlib.sha256(blob.encode()).hexdigest()

    def shard_for(self, key: str) -> str:
        """Rendezvous choice among the *live* shards for ``key``."""
        return rendezvous(self.live_shards(), key)

    def add_shard(self, sid: str, target: Any) -> None:
        """Join a shard (or revive a dead id with a fresh target).

        Rendezvous hashing means only the keys whose argmax becomes the
        new shard move to it — an expected ``1/N`` of the keyspace; the
        rest keep their warm placement.
        """
        sid = str(sid)
        self._targets[sid] = target
        self._clients[sid] = connect(target, timeout=self._timeout,
                                     tenant=self.tenant)
        self._dead.discard(sid)

    def remove_shard(self, sid: str) -> None:
        """Administratively mark a shard dead (its keys re-home)."""
        self._dead.add(str(sid))

    # -- Client protocol ---------------------------------------------------
    def hello(self) -> dict:
        """Router identity plus each live shard's hello."""
        out = {"ok": True, "server": "helix-fleet-router",
               "route": self.route, "shards": {}}
        workflows: set[str] = set()
        for sid in self.live_shards():
            try:
                h = self._clients[sid].hello()
            except (OSError, ServerError) as e:
                h = {"ok": False, "error": str(e)}
            out["shards"][sid] = h
            workflows.update(h.get("workflows", []))
        out["workflows"] = sorted(workflows)
        return out

    def _pick_shard(self, key: str) -> str:
        if self.route == "random":
            live = self.live_shards()
            if not live:
                raise LookupError("no live shards")
            return self._rng.choice(live)
        return self.shard_for(key)

    def submit(self, workflow: str, params: Mapping[str, Any]
               | None = None, name: str | None = None,
               timeout: float | None = None,
               priority: int = 0) -> str:
        """Submit to the routed shard; returns the shard's job id.

        A shard that refuses the connection at submit time is marked
        dead and the submission re-routes among the survivors (up to
        the fleet size). ``busy``/``quota_exceeded`` refusals are *not*
        failover triggers — they come from a healthy shard and carry
        their own semantics (the shard client retries ``busy`` itself).
        """
        key = self.route_key(workflow, params)
        last_err: Exception | None = None
        for _ in range(len(self._clients)):
            try:
                sid = self._pick_shard(key)
            except LookupError:
                break
            try:
                job = self._clients[sid].submit(
                    workflow, params, name=name, timeout=timeout,
                    priority=priority)
            except (ServerBusy, QuotaExceeded):
                raise
            except (OSError, ConnectionError) as e:
                self._dead.add(sid)
                last_err = e
                continue
            self._jobs[job] = {
                "shard": sid, "key": key, "workflow": workflow,
                "params": dict(params or {}), "name": name,
                "timeout": timeout, "priority": priority,
            }
            return job
        raise last_err or LookupError("no live shards")

    def _shard_dead(self, sid: str) -> bool:
        """Probe a shard after a suspicious cancel: unreachable or no
        longer accepting means dead (shutdown), a healthy answer means
        the cancel was a genuine user/timeout cancel."""
        try:
            st = self._clients[sid].status()
        except (OSError, ConnectionError, ServerError):
            return True
        return not st.get("accepting", False)

    def _failover(self, job: str, rec: dict) -> str:
        """Resubmit a dead shard's job among the survivors.

        The retry rides the normal submit path; with a shared remote
        tier, whatever the dead shard already published is a cache hit
        on the new shard — fleet-wide compute-once holds across the
        failover (the chaos suite asserts it).
        """
        self._dead.add(rec["shard"])
        self.failovers += 1
        self._jobs.pop(job, None)
        return self.submit(rec["workflow"], rec["params"],
                           name=rec["name"], timeout=rec["timeout"],
                           priority=rec["priority"])

    def wait(self, job: str, timeout: float | None = None,
             detail: bool = False) -> dict:
        """Wait on the owning shard; fail over if that shard dies.

        Two death signals: the connection errors out (socket shard
        gone), or the job reports ``cancelled`` while its shard stopped
        accepting (non-drain shutdown cancelled it — a *user* cancel on
        a healthy shard is returned as-is, not retried). Either way the
        job is resubmitted via rendezvous among the survivors and the
        wait continues there.
        """
        for _ in range(len(self._clients) + 1):
            rec = self._jobs.get(job)
            if rec is None:
                return self._clients[self.live_shards()[0]].wait(
                    job, timeout=timeout, detail=detail)
            sid = rec["shard"]
            try:
                out = self._clients[sid].wait(job, timeout=timeout,
                                              detail=detail)
            except (OSError, ConnectionError):
                job = self._failover(job, rec)
                continue
            except ServerError:
                raise
            if (out.get("status") == "cancelled"
                    and self._shard_dead(sid)):
                job = self._failover(job, rec)
                continue
            out["job"] = job          # the surviving job id
            out["shard"] = sid
            return out
        raise RuntimeError("failover loop exhausted the fleet")

    def estimate(self, workflow: str, params: Mapping[str, Any]
                 | None = None) -> dict:
        """Estimate on the shard the submission would route to."""
        sid = self._pick_shard(self.route_key(workflow, params))
        out = self._clients[sid].estimate(workflow, params)
        out["shard"] = sid
        return out

    def _owning(self, job: str) -> Client:
        rec = self._jobs.get(job)
        sid = rec["shard"] if rec is not None else self.live_shards()[0]
        return self._clients[sid]

    def job(self, job: str, detail: bool = False) -> dict:
        """Non-blocking summary from the job's owning shard."""
        return self._owning(job).job(job, detail=detail)

    def cancel(self, job: str) -> bool:
        """Cancel on the owning shard (False when unknown/finished)."""
        try:
            return self._owning(job).cancel(job)
        except (OSError, ConnectionError):
            return False

    def forget(self, job: str) -> bool:
        """Forget on the owning shard; drops the routing record too."""
        rec = self._jobs.pop(job, None)
        if rec is None:
            return False
        try:
            return self._clients[rec["shard"]].forget(job)
        except (OSError, ConnectionError):
            return False

    def status(self) -> dict:
        """Fleet snapshot: per-shard status plus router placement state."""
        shards = {}
        for sid in sorted(self._clients):
            if sid in self._dead:
                shards[sid] = {"ok": False, "dead": True}
                continue
            try:
                shards[sid] = self._clients[sid].status()
            except (OSError, ConnectionError, ServerError) as e:
                shards[sid] = {"ok": False, "error": str(e)}
        return {"ok": True, "router": True, "route": self.route,
                "live_shards": self.live_shards(),
                "failovers": self.failovers, "shards": shards}

    def multiplicity(self, sig: str) -> int:
        """Max live multiplicity of ``sig`` across live shards."""
        best = 0
        for sid in self.live_shards():
            try:
                best = max(best, self._clients[sid].multiplicity(sig))
            except (OSError, ConnectionError, ServerError):
                continue
        return best

    def drain(self, timeout: float | None = None) -> bool:
        """Drain every live shard; True iff all drained in time."""
        return all(self._clients[sid].drain(timeout)
                   for sid in self.live_shards())

    def shutdown(self) -> dict:
        """Shut down every live shard (graceful)."""
        out = {"ok": True, "stopped": []}
        for sid in self.live_shards():
            try:
                self._clients[sid].shutdown()
                out["stopped"].append(sid)
            except (OSError, ConnectionError, ServerError):
                continue
        return out

    def close(self) -> None:
        """Close every shard connection (idempotent)."""
        for client in self._clients.values():
            try:
                client.close()
            except OSError:
                pass

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
