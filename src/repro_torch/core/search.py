"""Reuse-aware hyperparameter search: the sweep engine as a *tuner*.

``run_sweep`` executes a fixed K-arm grid the user chose up front. This
module closes the loop the ROADMAP names: a :class:`SearchDriver` that
*chooses* the arms, submitting them to a live
:class:`~repro_torch.serve.server.SessionServer` dynamically instead of as one
held batch, following "Exploiting Reuse in Pipeline-Aware Hyperparameter
Tuning" (Li et al., 2019). Four ideas compose:

* **Candidate generation** — ``grid`` (cartesian product over knob
  axes), ``random`` (seeded independent draws per axis), and ``mutate``
  (greedy/beam search: each round keeps the best ``beam_width`` arms by
  the reported metric and expands each with ``children`` seeded
  mutations).
* **Reuse-aware frontier ordering** — before each dispatch, every
  pending candidate is priced by the server's ``estimate`` RPC
  (:meth:`~repro_torch.serve.server.SessionServer.estimate_marginal_cost`):
  compiled DAG cost minus signatures already materialized in the store
  or live in the multiplicity map. The driver submits the candidate with
  the least *marginal* compute — arms adjacent in signature space run
  back-to-back, so shared prefixes are computed once and loaded by the
  rest. Under an arm budget (``max_arms`` < |space|) this beats a FIFO
  frontier outright: FIFO spends the budget on whatever order the grid
  was enumerated in; the reuse frontier spends it where the store has
  already paid.
* **Successive-halving early stopping** — with a
  :class:`HalvingConfig`, arms run at increasing resource levels
  (epochs, iterations, data fraction); each rung promotes the top
  ``1/eta`` fraction by metric and the losers' read pins, ledger
  reservations, and queued work are released immediately through the
  server's cooperative cancellation path. ``eager=True`` is the
  ASHA variant: the first finishers promote and the stragglers are
  cancelled mid-run.
* **Lease-following dispatch** — the estimate's ``follow_s`` prices the
  part of a candidate's frontier a *running* leader is already
  producing (``n_live_leases`` counts signatures under an exclusive
  compute lease right now). Ties in marginal cost break toward the
  largest ``follow_s``: the follower is submitted while the leader is
  live, its signatures raise the shared multiplicity to ≥ 2, the
  leader's executor force-persists them (`_LiveShareView`), and the
  follower loads instead of recomputing — following beats queueing.

The driver is a *client*: it speaks the JSON protocol through whatever
:func:`repro_torch.serve.connect` returns, so the same tuning script drives an
in-process server, a unix socket, or TCP unchanged. Candidates must
therefore be registry workflows (``registry={name: factory}`` on the
server) with JSON-able params.

Quickstart::

    from repro_torch.core.search import SearchConfig, tune

    report = tune(workdir, registry={"census": build},
                  workflow="census",
                  axes={"reg": [0.01, 0.1, 1.0], "threshold": [0.5, 0.7]},
                  config=SearchConfig(max_arms=4, metric="check.value"))
    print(report.best().params, report.total_node_computes())
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class HalvingConfig:
    """Successive-halving rungs over one resource knob.

    ``resource`` is the workflow param to scale (e.g. ``train_iters``);
    ``levels`` are its per-rung values, low fidelity first. Each rung
    promotes the top ``ceil(n / eta)`` arms by metric to the next level;
    the rest are cancelled/never promoted (their pins, reservations, and
    queued work are released immediately). ``eager=True`` promotes the
    first finishers instead of waiting for the whole rung (ASHA-style)
    and cancels the stragglers mid-run.
    """

    resource: str = ""
    levels: Sequence[Any] = ()
    eta: float = 2.0
    eager: bool = False


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Knobs of the :class:`SearchDriver`.

    ``strategy``
        ``"grid"`` | ``"random"`` | ``"mutate"`` (see module docstring).
    ``max_arms``
        Arm budget for the first rung (grid/random) or across all rounds
        (mutate). ``None`` = the whole candidate space. The *frontier
        ordering decides which* candidates spend the budget.
    ``frontier``
        ``"reuse"`` (marginal-compute order via the estimate RPC, the
        point of this module) or ``"fifo"`` (enumeration order — the
        baseline the bench compares against).
    ``max_inflight``
        Concurrent submissions the driver keeps live (≈ the server's
        session slots).
    ``seed``
        Seeds the random/mutate RNG and is recorded in the report, so a
        tuning run replays bit-identically.
    ``metric`` / ``maximize``
        Dotted path into a job summary's ``outputs`` (e.g.
        ``"checkResults.value"``) used to rank arms. Required for
        halving and mutate; optional otherwise.
    ``halving``
        A :class:`HalvingConfig` to early-stop losing arms
        (grid/random strategies only).
    ``beam_width`` / ``children`` / ``rounds``
        Mutation search: survivors per round, mutations per survivor,
        and maximum rounds.
    ``poll_interval``
        Driver-side completion poll period (the protocol is pull-based).
    ``priority_rungs``
        Submit rung r at scheduler priority r, so promoted survivors
        outrank fresh low-rung arms on a busy server.
    ``detail``
        Fetch detailed summaries (per-arm computed-signature lists) so
        the report can do fleet duplicate-compute accounting.
    ``on_rung``
        Optional callback ``fn(rung_summary: dict)`` invoked after each
        rung/round settles — the test hook for ledger==disk invariants.
    """

    strategy: str = "grid"
    max_arms: int | None = None
    frontier: str = "reuse"
    max_inflight: int = 2
    seed: int = 0
    metric: str = ""
    maximize: bool = True
    halving: HalvingConfig | None = None
    beam_width: int = 2
    children: int = 2
    rounds: int = 3
    poll_interval: float = 0.02
    priority_rungs: bool = True
    detail: bool = True
    on_rung: Callable[[dict], None] | None = None


@dataclasses.dataclass
class ArmResult:
    """One submitted (or skipped) arm of the search."""

    name: str
    params: dict               # as submitted (includes the resource knob)
    base_params: dict          # without the halving resource knob
    rung: int
    order: int                 # global dispatch sequence of this driver
    job_id: str | None = None
    # queued→running→(done|error|cancelled) server-side; "skipped" means
    # the arm budget or an eager-promotion cut dropped it unsubmitted.
    status: str = "skipped"
    metric: float | None = None
    summary: dict = dataclasses.field(default_factory=dict)
    estimate: dict | None = None   # the frontier estimate at dispatch
    error: str | None = None


@dataclasses.dataclass
class SearchReport:
    """Outcome of one :meth:`SearchDriver.run`."""

    arms: list[ArmResult]
    rungs: list[dict]
    wall_seconds: float
    seed: int
    strategy: str
    frontier: str
    maximize: bool = True

    def best(self) -> ArmResult | None:
        """The finished arm with the best metric (None when no arm
        reported one)."""
        scored = [a for a in self.arms
                  if a.status == "done" and a.metric is not None]
        if not scored:
            return None
        pick = max if self.maximize else min
        return pick(scored, key=lambda a: a.metric)

    def total_node_computes(self) -> int:
        """Nodes actually computed across all arms (planned COMPUTE and
        not turned into a load by the in-flight dedupe) — the
        reuse-efficiency headline the bench compares."""
        total = 0
        for a in self.arms:
            ex = a.summary.get("execution")
            if ex:
                total += int(ex["n_computed"]) - int(ex["n_deduped"])
        return total

    def fleet_computes(self) -> dict[str, int]:
        """How many arms computed each signature (requires
        ``SearchConfig.detail``, the default)."""
        counts: dict[str, int] = {}
        for a in self.arms:
            ex = a.summary.get("execution") or {}
            for sig in ex.get("computed_sigs", ()):
                counts[sig] = counts.get(sig, 0) + 1
        return counts

    def wasted_recomputes(self) -> int:
        """Signatures *blindly* computed more than once — coordination
        failures, excluding the planner's deliberate
        recompute-cheaper-than-load choices (same contract as
        ``SweepReport.wasted_recomputes``; requires
        ``SearchConfig.detail``)."""
        blind: dict[str, int] = {}
        for a in self.arms:
            ex = a.summary.get("execution") or {}
            for sig in ex.get("blind_computed_sigs", ()):
                blind[sig] = blind.get(sig, 0) + 1
        return sum(1 for c in blind.values() if c > 1)

    def n_cancelled(self) -> int:
        """Arms stopped by early stopping (or a server shutdown)."""
        return sum(1 for a in self.arms if a.status == "cancelled")


class _Candidate:
    """A not-yet-submitted arm: base params + enumeration index."""

    __slots__ = ("params", "idx", "_last_est")

    def __init__(self, params: dict, idx: int):
        self.params = params
        self.idx = idx
        self._last_est: dict | None = None


class SearchDriver:
    """Submit arms to a live session server, reuse-aware (module doc).

    ``target`` is anything :func:`repro_torch.serve.connect` accepts — a
    :class:`~repro_torch.serve.server.SessionServer`, a client, a unix-socket
    path, ``"host:port"``, or a ``(host, port)`` tuple. ``workflow`` is
    the server-side registry name; candidates are the JSON param dicts
    its factory accepts.

    Candidate sources (exactly one is required):

    * ``axes`` — ``{param: [values...]}``; the grid strategy enumerates
      the cartesian product (first axis outermost), the random strategy
      draws each param independently per arm.
    * ``space`` — an explicit candidate list of param dicts, in
      enumeration order (what the FIFO frontier would follow).
    * ``base`` + ``mutate`` — the mutation strategy's starting point:
      ``mutate(params, rng) -> params`` proposes a seeded variation.
    """

    def __init__(self, target: Any, workflow: str, *,
                 axes: Mapping[str, Sequence[Any]] | None = None,
                 space: Sequence[Mapping[str, Any]] | None = None,
                 base: Mapping[str, Any] | None = None,
                 mutate: Callable[[dict, Any], dict] | None = None,
                 config: SearchConfig | None = None):
        from ..serve.client import connect   # local: serve imports core
        self.client = connect(target)
        self.workflow = str(workflow)
        self.axes = {k: list(v) for k, v in (axes or {}).items()}
        self.space = [dict(p) for p in (space or [])]
        self.base = dict(base or {})
        self.mutate = mutate
        cfg = config if config is not None else SearchConfig()
        if cfg.strategy not in ("grid", "random", "mutate"):
            raise ValueError(f"unknown strategy {cfg.strategy!r}")
        if cfg.frontier not in ("reuse", "fifo"):
            raise ValueError(f"unknown frontier {cfg.frontier!r}")
        if cfg.strategy == "grid" and not (self.axes or self.space):
            raise ValueError("grid search needs axes= or space=")
        if cfg.strategy == "random":
            if not self.axes:
                raise ValueError("random search needs axes=")
            if cfg.max_arms is None:
                raise ValueError("random search needs max_arms "
                                 "(the number of draws)")
        if cfg.strategy == "mutate":
            if self.mutate is None:
                raise ValueError("mutation search needs mutate=")
            if not cfg.metric:
                raise ValueError("mutation search ranks by metric; set "
                                 "SearchConfig.metric")
            if cfg.halving is not None:
                raise ValueError("halving applies to grid/random "
                                 "strategies (mutation has its own "
                                 "round-based early stopping)")
        if cfg.halving is not None:
            if not cfg.halving.resource or not cfg.halving.levels:
                raise ValueError("HalvingConfig needs resource and a "
                                 "non-empty levels sequence")
            if not cfg.metric:
                raise ValueError("halving ranks by metric; set "
                                 "SearchConfig.metric")
            if cfg.halving.eta <= 1.0:
                raise ValueError("halving eta must be > 1")
        self.config = cfg
        self._order = 0
        self._submitted = 0

    # -- public ------------------------------------------------------------
    def run(self) -> SearchReport:
        """Run the configured search to completion; returns the report."""
        t0 = time.perf_counter()
        if self.config.strategy == "mutate":
            arms, rungs = self._run_mutation()
        else:
            arms, rungs = self._run_rungs()
        arms.sort(key=lambda a: a.order)
        return SearchReport(
            arms=arms, rungs=rungs,
            wall_seconds=time.perf_counter() - t0,
            seed=self.config.seed, strategy=self.config.strategy,
            frontier=self.config.frontier,
            maximize=self.config.maximize)

    # -- candidate generation ----------------------------------------------
    def _initial_candidates(self) -> list[_Candidate]:
        cfg = self.config
        if cfg.strategy == "random":
            rng = np.random.default_rng(cfg.seed)
            out, seen = [], set()
            # Bounded rejection sampling: duplicates are redrawn, but a
            # small space must not loop forever.
            for _ in range(cfg.max_arms * 16):
                if len(out) >= cfg.max_arms:
                    break
                p = {k: v[int(rng.integers(len(v)))]
                     for k, v in self.axes.items()}
                key = self._key(p)
                if key in seen:
                    continue
                seen.add(key)
                out.append(_Candidate(p, len(out)))
            return out
        if self.space:
            return [_Candidate(dict(p), i)
                    for i, p in enumerate(self.space)]
        import itertools
        keys = list(self.axes)
        return [_Candidate(dict(zip(keys, combo)), i)
                for i, combo in enumerate(
                    itertools.product(*(self.axes[k] for k in keys)))]

    @staticmethod
    def _key(params: Mapping[str, Any]) -> tuple:
        return tuple(sorted((k, repr(v)) for k, v in params.items()))

    # -- rung/round engines --------------------------------------------------
    def _run_rungs(self) -> tuple[list[ArmResult], list[dict]]:
        cfg = self.config
        halving = cfg.halving
        levels: Sequence[Any] = halving.levels if halving else (None,)
        cands = self._initial_candidates()
        all_arms: list[ArmResult] = []
        rungs: list[dict] = []
        for rung, level in enumerate(levels):
            last = rung == len(levels) - 1
            n_promote = None if last else max(
                1, math.ceil(len(cands) / halving.eta))
            eager_quota = n_promote if (halving and halving.eager
                                        and not last) else None
            arms, eager_winners = self._dispatch_batch(
                cands, rung=rung, level=level,
                budget=cfg.max_arms if rung == 0 else None,
                eager_quota=eager_quota)
            all_arms.extend(arms)
            if eager_quota is not None:
                promoted = eager_winners
            elif n_promote is not None:
                ranked = sorted(
                    (a for a in arms
                     if a.status == "done" and a.metric is not None),
                    key=lambda a: a.metric, reverse=cfg.maximize)
                promoted = ranked[:n_promote]
            else:
                promoted = []
            summary = self._rung_summary(rung, level, arms, promoted)
            rungs.append(summary)
            if cfg.on_rung is not None:
                cfg.on_rung(summary)
            if last or not promoted:
                break
            cands = [_Candidate(dict(a.base_params), i)
                     for i, a in enumerate(promoted)]
        return all_arms, rungs

    def _run_mutation(self) -> tuple[list[ArmResult], list[dict]]:
        cfg = self.config
        rng = np.random.default_rng(cfg.seed)
        population = [dict(p) for p in (self.space or [dict(self.base)])]
        seen = {self._key(p) for p in population}
        all_arms: list[ArmResult] = []
        rounds: list[dict] = []
        for rnd in range(cfg.rounds):
            budget = None if cfg.max_arms is None \
                else cfg.max_arms - self._submitted
            if budget is not None and budget <= 0:
                break
            cands = [_Candidate(p, i) for i, p in enumerate(population)]
            arms, _ = self._dispatch_batch(cands, rung=rnd, level=None,
                                           budget=budget)
            all_arms.extend(arms)
            ranked = sorted(
                (a for a in arms
                 if a.status == "done" and a.metric is not None),
                key=lambda a: a.metric, reverse=cfg.maximize)
            beam = ranked[:cfg.beam_width]
            summary = self._rung_summary(rnd, None, arms, beam)
            rounds.append(summary)
            if cfg.on_rung is not None:
                cfg.on_rung(summary)
            population = []
            for parent in beam:
                for _ in range(cfg.children):
                    child = self.mutate(dict(parent.base_params), rng)
                    key = self._key(child)
                    if key not in seen:
                        seen.add(key)
                        population.append(dict(child))
            if not population:
                break
        return all_arms, rounds

    @staticmethod
    def _rung_summary(rung: int, level: Any, arms: list[ArmResult],
                      promoted: list[ArmResult]) -> dict:
        return {
            "rung": rung, "level": level, "n_arms": len(arms),
            "n_done": sum(1 for a in arms if a.status == "done"),
            "n_error": sum(1 for a in arms if a.status == "error"),
            "n_cancelled": sum(1 for a in arms
                               if a.status == "cancelled"),
            "n_skipped": sum(1 for a in arms if a.status == "skipped"),
            "promoted": [a.name for a in promoted],
        }

    # -- the dispatch loop ---------------------------------------------------
    def _full_params(self, cand: _Candidate, level: Any) -> dict:
        params = dict(cand.params)
        if level is not None:
            params[self.config.halving.resource] = level
        return params

    def _pick(self, pending: list[_Candidate], level: Any) -> _Candidate:
        """Choose the next candidate off the frontier.

        ``"fifo"``: enumeration order. ``"reuse"``: re-estimate every
        pending candidate against the server's *current* store and
        in-flight state and take the least marginal compute; ties break
        toward the largest ``follow_s`` (prefer drafting behind a live
        leader — lease-following dispatch), then enumeration order.
        Estimates are refreshed at every pick because each completed arm
        changes what the store holds.
        """
        if self.config.frontier == "fifo" or len(pending) == 1:
            return pending[0]
        best, best_key = None, None
        for cand in pending:
            est = self.client.estimate(self.workflow,
                                       self._full_params(cand, level))
            key = (est["marginal_s"], -est["follow_s"], cand.idx)
            if best_key is None or key < best_key:
                best, best_key, best_est = cand, key, est
        best._last_est = best_est
        return best

    def _dispatch_batch(self, cands: list[_Candidate], *, rung: int,
                        level: Any, budget: int | None = None,
                        eager_quota: int | None = None
                        ) -> tuple[list[ArmResult], list[ArmResult]]:
        """Run one rung/round: windowed dynamic dispatch + completion poll.

        Keeps up to ``max_inflight`` submissions live, choosing each next
        submission with :meth:`_pick`. ``budget`` bounds submissions
        (leftover candidates become ``skipped`` arms — the frontier
        ordering thereby decides *which* arms spend the budget).
        ``eager_quota`` turns on ASHA promotion: the first that many
        finishers win and every other live submission of the rung is
        cancelled immediately (pins/reservations release server-side).
        Returns ``(all arms of this rung, eager winners)``.
        """
        cfg = self.config
        pending = list(cands)
        inflight: dict[str, ArmResult] = {}
        finished: list[ArmResult] = []
        winners: list[ArmResult] = []
        n_submitted = 0

        def _skip_rest() -> None:
            for cand in pending:
                finished.append(ArmResult(
                    name=self._arm_name(cand, rung), rung=rung,
                    params=self._full_params(cand, level),
                    base_params=dict(cand.params),
                    order=self._next_order()))
            pending.clear()

        while pending or inflight:
            while (pending and len(inflight) < cfg.max_inflight
                   and (budget is None or n_submitted < budget)):
                cand = self._pick(pending, level)
                pending.remove(cand)
                arm = ArmResult(
                    name=self._arm_name(cand, rung), rung=rung,
                    params=self._full_params(cand, level),
                    base_params=dict(cand.params),
                    order=self._next_order(),
                    estimate=getattr(cand, "_last_est", None))
                try:
                    arm.job_id = self.client.submit(
                        self.workflow, arm.params, name=arm.name,
                        priority=rung if cfg.priority_rungs else 0)
                except Exception as e:
                    arm.status = "error"
                    arm.error = f"{type(e).__name__}: {e}"
                    finished.append(arm)
                    continue
                arm.status = "queued"
                self._submitted += 1
                n_submitted += 1
                inflight[arm.job_id] = arm
            if pending and (budget is not None and n_submitted >= budget):
                _skip_rest()
            progressed = False
            for job_id, arm in list(inflight.items()):
                s = self.client.job(job_id, detail=cfg.detail)
                if s["status"] not in ("done", "error", "cancelled"):
                    arm.status = s["status"]
                    continue
                progressed = True
                inflight.pop(job_id)
                self._finalize(arm, s)
                finished.append(arm)
                if (eager_quota is not None and arm.status == "done"
                        and arm.metric is not None
                        and len(winners) < eager_quota):
                    winners.append(arm)
                    if len(winners) >= eager_quota:
                        # Quota filled: the rest of the rung are losers.
                        # Cancel the live ones (the server releases
                        # their pins/reservations on the way out) and
                        # skip the unsubmitted ones.
                        for other_id in list(inflight):
                            self.client.cancel(other_id)
                        for other_id, other in list(inflight.items()):
                            self._finalize(
                                other,
                                self.client.wait(other_id,
                                                 detail=cfg.detail))
                            finished.append(other)
                        inflight.clear()
                        _skip_rest()
                        break   # the items() snapshot is stale now
            if (pending or inflight) and not progressed:
                time.sleep(cfg.poll_interval)
        return finished, winners

    def _finalize(self, arm: ArmResult, summary: dict) -> None:
        arm.status = summary["status"]
        arm.summary = summary
        arm.error = summary.get("error")
        if arm.status == "done" and self.config.metric:
            arm.metric = self._metric(summary)

    def _metric(self, summary: Mapping[str, Any]) -> float | None:
        """Extract the configured dotted metric path from ``outputs``."""
        cur: Any = summary.get("outputs", {})
        for part in self.config.metric.split("."):
            if isinstance(cur, Mapping) and part in cur:
                cur = cur[part]
            else:
                return None
        try:
            return float(cur)
        except (TypeError, ValueError):
            return None

    def _next_order(self) -> int:
        self._order += 1
        return self._order

    def _arm_name(self, cand: _Candidate, rung: int) -> str:
        label = ",".join(f"{k}={cand.params[k]}"
                         for k in sorted(cand.params))
        return f"{self.workflow}[{label[:80]}]@r{rung}"


def tune(workdir: str, registry: Mapping[str, Callable[..., Any]],
         workflow: str, *,
         axes: Mapping[str, Sequence[Any]] | None = None,
         space: Sequence[Mapping[str, Any]] | None = None,
         base: Mapping[str, Any] | None = None,
         mutate: Callable[[dict, Any], dict] | None = None,
         config: SearchConfig | None = None,
         engine: Any = None, storage: Any = None,
         resilience: Any = None) -> SearchReport:
    """One-call tuning: spin a server over ``workdir``, search, shut down.

    Constructs an in-process
    :class:`~repro_torch.serve.server.SessionServer` with ``registry`` and the
    given config dataclasses (``engine.n_sessions`` defaults to the
    search's ``max_inflight`` so the dispatch window matches the slot
    count), runs a :class:`SearchDriver` against it, and always shuts
    the server down. Everything else matches :class:`SearchDriver`.
    """
    from ..serve.server import SessionServer   # local: serve imports core
    from .config import EngineConfig
    cfg = config if config is not None else SearchConfig()
    if engine is None:
        engine = EngineConfig(n_sessions=cfg.max_inflight)
    elif engine.n_sessions is None:
        engine = dataclasses.replace(engine, n_sessions=cfg.max_inflight)
    server = SessionServer(workdir, registry=dict(registry),
                           engine=engine, storage=storage,
                           resilience=resilience)
    try:
        driver = SearchDriver(server, workflow, axes=axes, space=space,
                              base=base, mutate=mutate, config=cfg)
        return driver.run()
    finally:
        server.shutdown()
