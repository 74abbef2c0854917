"""Execution engine (paper §2.1 component 3 + §5.3 streaming discipline).

Executes a planned DAG with a **ready-set scheduler**: a pool of
``max_workers`` worker threads repeatedly pops the lowest-topological-index
node whose dependencies are all resolved, so independent branches of the
sliced DAG run concurrently while the paper's semantics are preserved:

* LOAD nodes are pure store I/O with no in-DAG dependencies, so they are
  *prefetched* as soon as execution starts — bounded by ``prefetch_depth``
  (the maximum number of loaded-but-unconsumed values resident at once, so
  host memory stays bounded). When the whole pool would otherwise sit idle,
  the lowest-index gated load is admitted anyway (starvation guard), which
  makes the scheduler deadlock-free even when a consumer needs more than
  ``prefetch_depth`` loads resident at once.
* COMPUTE nodes call ``node.fn(*parent_values)`` once every parent value is
  in the cache; CUDA tensors in the result are waited for *inside the worker
  measuring that node* (``_block``: ``tree.block_until_ready``) so realized
  per-node runtimes — the C(n) that feeds OMP and OEP — count the node's
  device work, not only the Python that launched it.
* PRUNE nodes never run.

**CUDA streams.** Every worker thread issues its work on the legacy default
stream, so the device runs the nodes' kernels in one queue. With
``max_workers > 1`` one node's wait therefore also covers whatever another
worker queued before it: runtimes stay honest for the node that waits, but
concurrent nodes do not overlap on the card. (Streams per worker would
need events between producers and consumers; none are used.)

Out-of-scope detection (Def. 5 / Constraint 3): when the last non-pruned
child of a node has been produced, the node gets a materialization decision
from the :class:`Materializer` and is evicted from the in-memory cache (the
paper's eager cache pruning, transposed to freeing host/HBM memory).
Mandatory outputs are kept and returned.

**Determinism.** Materialization decisions and storage-budget accounting are
processed strictly in the out-of-scope order of the *sequential* engine
(:meth:`DAG.oos_order`), regardless of the order nodes actually finish in.
With ``max_workers=1`` the scheduler degenerates to exactly the sequential
topological sweep — same execution order, same decision order, same store
traffic — so the OEP/OMP invariants and the Theorem-1 correctness argument
carry over verbatim, and any worker count yields identical outputs and
decisions on deterministic nodes. One carve-out: with an evictor attached
(evict-to-admit), over-budget admissions are deferred off the scheduler
lock — at ``max_workers=1`` they still happen in decision order, but
under parallel workers admission order may interleave (the same
nondeterminism class as the fleet-shared ledger itself).

Materialization writes run off the critical path when
``async_materialization`` is set: values are handed to the store's dedicated
writer queue (bounded in-flight bytes) and ``mat_seconds`` aggregates the
writer's measured wall time so overhead accounting is honest in both modes.

**In-flight dedupe (fleet mode).** With ``dedupe_inflight`` set, a COMPUTE
node first takes the store's fleet-wide *compute lease* on its signature:

* lease acquired → compute as usual; if other sessions registered as
  waiters meanwhile, the value is force-persisted (budget permitting)
  before the lease is released, so the waiters can load it — each
  signature is computed at most once fleet-wide;
* lease held elsewhere → wait for the holder, then load its published
  result (recorded in ``ExecutionReport.deduped``; the node's realized
  runtime is the load time). If the entry was not persisted (no budget /
  holder crashed) the wait loop retries the lease and computes. Waits are
  bounded by ``dedupe_wait_seconds`` — on timeout the session computes the
  value itself (duplicate work, never a deadlock).

Dedupe introduces cross-*session* scheduling nondeterminism by design (who
computes vs. loads depends on arrival order); within a single session the
determinism guarantees above are unchanged, and the mode is off by default.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Any, Callable, Mapping

from .chunks import Chunked, tree_stack
from .dag import DAG, State
from .eviction import benefit_density
from .omp import Materializer, cumulative_runtime
from .store import Store, tree_nbytes
from .tree import block_until_ready as _block


class JobCancelled(RuntimeError):
    """The execution's cancel flag fired and the run stopped between
    nodes. Raised out of :func:`execute` after the normal settle path
    (pending saves drained, reservations reconciled or released, leases
    released by their ``finally`` blocks) — the session server reports
    it as status ``cancelled``, not ``error``."""


@dataclasses.dataclass
class ExecutionReport:
    states: dict[str, State]
    runtime: dict[str, float]            # realized per-node seconds (c or l)
    materialized: dict[str, str]         # name -> reason
    skipped_mat: dict[str, str]          # name -> reason
    mat_seconds: float                   # total time spent writing (both modes)
    total_seconds: float                 # wall clock of execute()
    outputs: dict[str, Any]
    max_workers: int = 1                 # worker-pool width used
    peak_resident_loads: int = 0         # prefetch-gate high-water mark
    # COMPUTE-planned nodes whose value was in fact loaded because another
    # session computed the same signature first (in-flight dedupe).
    deduped: dict[str, str] = dataclasses.field(default_factory=dict)
    # Chunk-granular accounting (incremental recomputation, chunks.py):
    # per chunked node, how many chunks ran fn vs. spliced from cache.
    # On a pure-incremental path after an append, chunk_computed equals
    # exactly the number of appended chunks — the oracle asserts this.
    chunk_computed: dict[str, int] = dataclasses.field(default_factory=dict)
    chunk_reused: dict[str, int] = dataclasses.field(default_factory=dict)
    # Nodes the planner chose to COMPUTE although a loadable entry existed
    # (recomputing was cheaper than loading). These are deliberate
    # economics, not missed reuse — fleet accounting (SweepReport)
    # distinguishes them from coordination failures.
    chose_compute: frozenset = frozenset()

    @property
    def n_computed(self) -> int:
        return sum(1 for s in self.states.values() if s is State.COMPUTE)

    @property
    def n_loaded(self) -> int:
        return sum(1 for s in self.states.values() if s is State.LOAD)

    @property
    def n_pruned(self) -> int:
        return sum(1 for s in self.states.values() if s is State.PRUNE)


class _Scheduler:
    """Shared state of one ``execute()`` call. All mutable fields are
    guarded by ``self.cv``'s lock; node work (fn calls, store I/O) runs
    outside it."""

    def __init__(self, dag: DAG, sigs, states, store, materializer,
                 load_shardings, async_materialization: bool,
                 max_workers: int, prefetch_depth: int,
                 dedupe_inflight: bool = False,
                 dedupe_wait_seconds: float = 120.0,
                 share_sigs: frozenset | set | None = None,
                 dedupe_skip: frozenset | set | None = None,
                 worker_pool=None,
                 cancel: threading.Event | None = None,
                 chunk_plans: Mapping | None = None):
        self.dag = dag
        self.sigs = sigs
        self.states = states
        self.store = store
        self.materializer = materializer
        self.load_shardings = load_shardings or {}
        self.async_mat = async_materialization
        self.max_workers = max(1, int(max_workers))
        self.prefetch_depth = max(0, int(prefetch_depth))
        self.dedupe = bool(dedupe_inflight)
        self.dedupe_wait_seconds = float(dedupe_wait_seconds)
        # Signatures known (by the sweep driver / session server) to be
        # wanted by sibling sessions: always persisted on lease-compute, so
        # each is computed exactly once fleet-wide even when siblings race
        # the waiter registration or arrive later. Any object supporting
        # ``in`` works — the session server passes a live view over its
        # cross-client multiplicity map so clients that arrive mid-run
        # still count.
        self.share_sigs = (share_sigs if share_sigs is not None
                           else frozenset())
        # Optional process-wide elastic worker pool (serve/pool.py): when
        # set, extra workers beyond the caller's thread are borrowed from
        # (and bounded by) the shared pool instead of spawned per-execute.
        self.worker_pool = worker_pool
        # Nodes the planner chose to COMPUTE *despite* a loadable entry
        # (load costlier than recompute): the dedupe shortcut must not
        # override that judgment by loading anyway.
        self.dedupe_skip = frozenset(dedupe_skip or ())
        # Cooperative cancellation: checked between nodes (and inside
        # lease waits). When it fires, the first worker to notice sets
        # ``self.error`` to JobCancelled and the run winds down through
        # the normal error path — leases, pins, and reservations are
        # released by the same finally/settle code an exception uses.
        self.cancel = cancel

        self.cv = threading.Condition()
        topo = dag.topological()
        self.idx = {n: i for i, n in enumerate(topo)}
        self.indeg = dag.exec_indegree(states)
        self.runnable: list[tuple[int, str]] = [
            (self.idx[n], n) for n, d in self.indeg.items() if d == 0]
        heapq.heapify(self.runnable)
        self.n_total = len(self.indeg)
        self.n_done = 0
        self.n_inflight = 0

        # Out-of-scope bookkeeping (sequential-order decision processing).
        self.remaining = {
            name: sum(1 for ch in dag.children(name)
                      if states[ch] is State.COMPUTE)
            for name in dag.nodes
        }
        self.oos_seq = dag.oos_order(states)
        self.oos_ptr = 0
        self.oos_ready: set[str] = set()   # COMPUTE-state nodes actually OOS
        self.oos_done: set[str] = set()    # LOAD-state nodes already handled

        # Prefetch gate: loads in flight or resident-and-unconsumed.
        self.resident_loads = 0
        self.peak_resident_loads = 0

        # Chunk-granular plans (chunks.py): COMPUTE nodes with a plan run
        # per-chunk — cached chunks spliced in, missing ones recomputed —
        # and *always* per-chunk even on a cold store, so results are a
        # pure function of (chunk values, plan) and the differential
        # oracle's bit-identity holds exactly.
        self.chunk_plans = dict(chunk_plans or {})
        self.chunk_computed: dict[str, int] = {}
        self.chunk_reused: dict[str, int] = {}

        self.cache: dict[str, Any] = {}
        self.runtime: dict[str, float] = {}
        self.materialized: dict[str, str] = {}
        self.skipped: dict[str, str] = {}
        self.deduped: dict[str, str] = {}
        self.mat_seconds = 0.0
        self.pending_saves: list[Any] = []
        self.error: BaseException | None = None

    # -- scheduling --------------------------------------------------------
    def _cancelled_locked(self) -> bool:
        """Between-nodes cancel check (lock held): the first worker that
        sees the flag turns it into the run's error so every worker winds
        down through the normal error path."""
        if self.cancel is None or not self.cancel.is_set():
            return False
        if self.error is None:
            self.error = JobCancelled("job cancelled between nodes")
            self.cv.notify_all()
        return True

    def _pop_runnable_locked(self) -> str | None:
        """Pop the lowest-topo-index runnable node, honoring the prefetch
        gate for LOAD nodes. Returns None when nothing can start right now.

        The gate is disabled at ``max_workers=1`` (no overlap to bound, and
        disabling it keeps the execution order exactly the sequential
        topological sweep).
        """
        gated = (self.max_workers > 1)
        blocked: list[tuple[int, str]] = []
        picked: str | None = None
        while self.runnable:
            i, name = heapq.heappop(self.runnable)
            if (gated and self.states[name] is State.LOAD
                    and self.resident_loads >= self.prefetch_depth):
                blocked.append((i, name))
                continue
            picked = name
            break
        if picked is None and blocked and self.n_inflight == 0:
            # Starvation guard: nothing can run anywhere else, so the plan
            # genuinely needs more than ``prefetch_depth`` loads resident at
            # once — admit the lowest-index one to guarantee progress.
            picked = blocked.pop(0)[1]
        for item in blocked:
            heapq.heappush(self.runnable, item)
        if picked is not None:
            self.n_inflight += 1
            if self.states[picked] is State.LOAD:
                self.resident_loads += 1
                self.peak_resident_loads = max(self.peak_resident_loads,
                                               self.resident_loads)
        return picked

    # -- node execution (outside the lock) ---------------------------------
    def _run_node(self, name: str) -> tuple[Any, float]:
        node = self.dag.nodes[name]
        if self.states[name] is State.LOAD:
            value, secs = self.store.load(
                self.sigs[name],
                sharding_for_leaf=self.load_shardings.get(name))
            _block(value)
            return value, secs
        if self.dedupe and name not in self.dedupe_skip:
            return self._run_compute_deduped(name, node)
        return self._run_compute(name, node)

    def _run_compute(self, name: str, node) -> tuple[Any, float]:
        plan = self.chunk_plans.get(name)
        with self.cv:
            raw = [self.cache[p] for p in node.parents]
        if plan is not None:
            t0 = time.perf_counter()
            value = self._run_chunked(name, node, plan, raw)
            return value, time.perf_counter() - t0
        # Opaque consumers always see the assembled (logical) value: a
        # chunked parent's partitioning is an executor-internal carrier.
        args = [v.assemble() if isinstance(v, Chunked) else v for v in raw]
        t0 = time.perf_counter()
        value = _block(node.fn(*args))
        return value, time.perf_counter() - t0

    # -- chunk-granular execution (incremental recomputation) --------------
    def _chunk_from_store(self, csig: str):
        """Load one cached chunk; ``(None, False)`` on miss (or when a
        concurrent eviction raced the presence check — then it is simply
        recomputed, same as a miss)."""
        if not self.store.has_local(csig):
            return None, False
        try:
            value, _secs = self.store.load(csig)
        except FileNotFoundError:
            return None, False
        return value, True

    def _run_chunked(self, name: str, node, plan, raw: list) -> Any:
        """Execute one node at chunk granularity per its ChunkPlan.

        Cached chunks (signature-keyed entries published by an earlier
        iteration's splice) are loaded; missing chunks run ``fn``; the
        pieces splice into a :class:`Chunked`. Per-chunk load/compute
        seconds land in the node's single realized runtime — so the cost
        model's recorded compute cost automatically reflects the *delta*,
        which is what makes OMP re-price incrementally maintained nodes
        correctly on the next iteration."""
        n_reused = n_computed = 0
        if plan.mode == "source":
            cached = [self._chunk_from_store(cs) for cs in plan.chunk_sigs]
            if all(hit for _v, hit in cached):
                chunks = tuple(v for v, _hit in cached)
                n_reused = len(chunks)
            else:
                produced = list(node.fn())
                if len(produced) != plan.n_chunks:
                    raise ValueError(
                        f"{name}: chunked source returned {len(produced)} "
                        f"chunks for {plan.n_chunks} declared descriptors")
                # Prefer cached copies where present (bit-identical by the
                # determinism contract; keeps splice I/O honest in counts).
                chunks = tuple(v if hit else _block(produced[j])
                               for j, (v, hit) in enumerate(cached))
                n_reused = sum(1 for _v, hit in cached if hit)
                n_computed = plan.n_chunks - n_reused
            value = Chunked(chunks, plan.chunk_sigs)
        elif plan.mode == "union":
            parts = dict(zip(node.parents, raw))
            chunks, csigs = [], []
            for p in node.parents:
                pv = parts[p]
                if not isinstance(pv, Chunked):
                    raise ValueError(
                        f"{name}: union parent {p!r} is not chunked")
                chunks.extend(pv.chunks)
                csigs.extend(pv.chunk_sigs)
            if tuple(csigs) != plan.chunk_sigs:
                raise ValueError(
                    f"{name}: union parents' chunk signatures do not "
                    "match the plan (parent re-chunked mid-run?)")
            n_reused = len(chunks)   # concat invokes no fn at all
            value = Chunked(tuple(chunks), plan.chunk_sigs)
        elif plan.mode in ("map", "assoc_reduce"):
            chunked = {p: v for p, v in zip(node.parents, raw)
                       if p in plan.chunked_parents}
            broadcast = {p: (v.assemble() if isinstance(v, Chunked) else v)
                         for p, v in zip(node.parents, raw)
                         if p not in plan.chunked_parents}
            pieces = []
            for j, csig in enumerate(plan.chunk_sigs):
                piece, hit = self._chunk_from_store(csig)
                if hit:
                    n_reused += 1
                else:
                    args = [chunked[p].chunks[j] if p in chunked
                            else broadcast[p] for p in node.parents]
                    piece = _block(node.fn(*args))
                    n_computed += 1
                pieces.append(piece)
            if plan.mode == "map":
                value = Chunked(tuple(pieces), plan.chunk_sigs)
            else:
                # Combine partials through fn itself, substituting the
                # stacked partials for the chunked parent
                # (fn(concat(chunks)) == fn(stack(partials))).
                args = [tree_stack(pieces) if p in chunked
                        else broadcast[p] for p in node.parents]
                final = _block(node.fn(*args))
                value = Chunked(tuple(pieces), plan.chunk_sigs,
                                "reduce", final=final)
        else:
            raise ValueError(f"{name}: unknown chunk-plan mode "
                             f"{plan.mode!r}")
        with self.cv:
            self.chunk_reused[name] = n_reused
            self.chunk_computed[name] = n_computed
        return value

    def _run_compute_deduped(self, name: str, node) -> tuple[Any, float]:
        """Fleet-wide compute-once: lease → compute (+ force-persist when
        waiters exist) | lease busy → wait, then load the holder's result."""
        sig = self.sigs[name]
        lease = None
        deadline = time.monotonic() + self.dedupe_wait_seconds
        while True:
            if self.cancel is not None and self.cancel.is_set():
                raise JobCancelled(f"cancelled while deduping {name!r}")
            if self.store.has(sig):
                try:
                    value, secs = self.store.load(
                        sig, sharding_for_leaf=self.load_shardings.get(name))
                except FileNotFoundError:
                    continue  # raced an eviction — retry
                _block(value)
                with self.cv:
                    self.deduped[name] = "computed by another session"
                return value, secs
            lease = self.store.acquire_compute(sig)
            if lease is not None:
                if self.store.has_fresh(sig):
                    # Another session (on this host or another) computed,
                    # committed and released the entry between our
                    # presence check and the lease acquisition — release
                    # and loop to the load path; computing here would
                    # break fleet-wide compute-once. (The JAX package
                    # re-checks only with a remote tier, so a fast node
                    # can be computed twice on one host under load.)
                    lease.release()
                    continue
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break  # bounded wait: duplicate-compute beats deadlock
            if not self.store.wait_compute(sig, timeout=remaining,
                                           cancel=self.cancel):
                if self.cancel is not None and self.cancel.is_set():
                    raise JobCancelled(
                        f"cancelled while waiting on lease for {name!r}")
                break
            # The lease lock came free (or is only held by shared read
            # pins, which coexist with our shared wait) yet the entry is
            # still absent and exclusive acquisition failed. Back off
            # briefly so this retry loop can never busy-spin; the
            # deadline above bounds it overall.
            time.sleep(0.005)
        try:
            value, secs = self._run_compute(name, node)
            if lease is not None:
                self._share_inflight(name, sig, lease, value, secs)
            return value, secs
        finally:
            if lease is not None:
                lease.release()

    def _share_inflight(self, name: str, sig: str, lease,
                        value: Any, compute_seconds: float) -> None:
        """Persist a just-computed value for the fleet, *before* the lease
        is released (so waiters find it on wake-up). Persists when the
        signature is known-shared across sibling variants, when someone is
        registered as waiting, or when reloading is cheaper than the
        measured compute (a sibling that races the waiter registration —
        or plans later — then LOADs instead of recomputing). This bypasses
        Algorithm 2 — cross-session reuse makes the payoff certain — but
        still reserves against the (possibly fleet-shared) budget."""
        if self.store.has(sig):
            return
        n_waiting = lease.waiters()
        est_bytes = tree_nbytes(value)
        # Write decisions price the durable (disk) tier: the value is not
        # resident on any tier yet, and the waiters this persist serves
        # will read it from disk/remote, not this process's memory tier.
        est_load = self.store.est_load_seconds(est_bytes)
        if (sig not in self.share_sigs and n_waiting == 0
                and est_load >= compute_seconds):
            return  # nobody wants it and recompute is cheaper than load
        # Benefit metadata for fleet eviction: C(n) per Def. 6 — the node's
        # own measured compute plus its ancestors' realized runtimes (all
        # finished: they are its inputs). self.runtime has no entry for
        # this node yet (the worker records it after _run_node returns).
        with self.cv:
            rt = dict(self.runtime)
        rt[name] = compute_seconds
        c_cum = cumulative_runtime(self.dag, name, self.states, rt)
        # Evict-to-admit may clear space, but only of entries less
        # valuable than this one. Expected future loads: registered
        # waiters now, or the materializer's multiplicity-aware horizon
        # (known-shared signatures whose siblings have not reached the
        # waiter registration yet must not get a weaker admission limit
        # than the same signature would get on the decide path).
        expected = max(float(n_waiting),
                       self.materializer.effective_horizon(sig) - 1.0)
        density = benefit_density(c_cum, est_load, expected)
        if not self.materializer.try_reserve(est_bytes,
                                             benefit_density=density):
            return  # no budget: waiters recompute after the timeout/retry
        extra = {"compute_s": c_cum, "load_s_est": est_load}
        info = self._budgeted_save(sig, name, value, est_bytes,
                                   extra_meta=extra)
        if self.store.remote is not None:
            # Publish-before-release: a cross-host waiter wakes the
            # moment the remote TTL lease vanishes and has no view of
            # this host's local tier — the async uploader alone would
            # open a recompute window exactly where dedupe matters.
            # Synchronous write-through here keeps compute-once exact
            # fleet-wide; non-shared materializations stay async.
            self.store.upload_now(sig)
        with self.cv:
            self.mat_seconds += info.seconds
            self.materialized[name] = (
                f"in-flight dedupe: {n_waiting} waiting session(s)"
                if n_waiting else "in-flight dedupe: shared signature")

    def _budgeted_save(self, sig: str, name: str, value: Any,
                       est_bytes: float,
                       extra_meta: dict | None = None) -> Any:
        """Persist a value whose budget was already reserved, keeping the
        (possibly fleet-shared) ledger honest: the reservation is
        *reconciled* to the actual on-disk size once known (the pre-save
        host-array estimate drifts from npy/pickle reality), credited back
        entirely if the write fails, and — when the save overwrote an
        entry a concurrent session already paid for — the *replaced
        entry's* recorded bytes are credited (they are what the overwrite
        freed; crediting the new reservation instead drifts the ledger
        whenever the sizes differ)."""
        try:
            info = self.store.save(sig, name, value, extra_meta=extra_meta)
        except BaseException:
            self.materializer.release(est_bytes)
            raise
        self._settle_save(est_bytes, info)
        return info

    def _settle_save(self, est_bytes: float, info) -> None:
        """The one place for the landed-write accounting invariant:
        reconcile the estimate-based reservation to the actual on-disk
        size, and credit the *replaced* entry's recorded bytes when the
        save overwrote one (sync saves and the async drain both settle
        through here, so the ledger-drift fixes cannot diverge)."""
        self.materializer.reconcile(est_bytes, info.nbytes)
        if info.replaced:
            self.materializer.credit_foreign(info.replaced_nbytes)

    def _persist_value(self, sig: str, name: str, value: Any,
                       est_bytes: float, extra_meta: dict) -> None:
        """Hand an admitted (budget-reserved) value to the configured
        write path: the store's writer queue under async materialization
        (settled at the drain), else a settling synchronous save. One
        body for the normal and eviction-admitted branches, so their
        accounting cannot diverge."""
        if self.async_mat:
            self.pending_saves.append(
                (est_bytes, self.store.save_enqueue(
                    sig, name, value, extra_meta=extra_meta)))
        else:
            info = self._budgeted_save(sig, name, value, est_bytes,
                                       extra_meta=extra_meta)
            with self.cv:
                self.mat_seconds += info.seconds

    # -- out-of-scope / materialization ------------------------------------
    def _on_actual_oos(self, name: str) -> None:
        """Node ``name`` just lost its last live consumer (lock held)."""
        state = self.states[name]
        if state is State.PRUNE:
            return
        if state is State.LOAD:
            # Trivial decision — a loaded value is by definition already in
            # the store. Handle eagerly so the prefetch permit frees at the
            # true consumption point, not at the decision pointer.
            self.skipped[name] = "already materialized"
            if not self.dag.nodes[name].is_output:
                self.cache.pop(name, None)  # eager eviction (§5.4)
            self.resident_loads -= 1
            self.oos_done.add(name)
        else:
            self.oos_ready.add(name)

    def _advance_oos_ptr_locked(self, jobs: list[Callable[[], None]]) -> None:
        """Process materialization decisions strictly in sequential OOS
        order; slow store writes are deferred into ``jobs`` to run outside
        the lock."""
        while self.oos_ptr < len(self.oos_seq):
            name = self.oos_seq[self.oos_ptr]
            if self.states[name] is State.LOAD:
                if name not in self.oos_done:
                    break
            elif name in self.oos_ready:
                self._decide_locked(name, jobs)
            else:
                break
            self.oos_ptr += 1

    def _decide_locked(self, name: str,
                       jobs: list[Callable[[], None]]) -> None:
        node = self.dag.nodes[name]
        value = self.cache.get(name)
        if name in self.materialized:
            pass  # force-persisted by the in-flight dedupe path
        elif self.store.has(self.sigs[name]):
            self.skipped[name] = "already materialized"
        else:
            est_bytes = tree_nbytes(value)
            # Durable-tier price on purpose (no sig): Algorithm 2 is
            # deciding whether a *future* load beats a recompute, and
            # the future loader pays the disk tier — the memory tier's
            # zero-copy hit is a same-process bonus on top, not the
            # cost this write must amortize.
            est_load = self.store.est_load_seconds(est_bytes)
            # evict_inline=False: this runs under the scheduler lock, and
            # eviction is store I/O (index scan + deletes) that every
            # worker would otherwise stall behind — an over-budget
            # "materialize" verdict comes back as needs_eviction and the
            # evict+reserve+save runs as a deferred job below.
            decision = self.materializer.decide(
                self.dag, name, self.states, self.runtime,
                est_load, est_bytes, sig=self.sigs[name],
                evict_inline=False)
            # Cost metadata rides with the entry so fleet eviction can
            # rank its benefit density (C(n)/l_i) later.
            extra = {"compute_s": decision.cum_runtime,
                     "load_s_est": est_load}
            sig = self.sigs[name]
            if decision.materialize:
                self.materialized[name] = decision.reason
                jobs.append(lambda sig=sig, name=name, value=value,
                            est=est_bytes, extra=extra:
                            self._persist_value(sig, name, value, est,
                                                extra))
            elif decision.needs_eviction:
                # Evict-to-admit, off the lock. With max_workers=1 the
                # job runs immediately after this decision (sequential
                # semantics unchanged); under parallel workers deferred
                # admissions may interleave with later decisions — the
                # same nondeterminism class the fleet ledger already has
                # (budget state is shared across sessions). The decision
                # carries the node's own benefit density as the eviction
                # limit: mandatory outputs may evict whatever fits
                # (None); everything else only displaces entries *less*
                # valuable than itself.
                def job(sig=sig, name=name, value=value, est=est_bytes,
                        extra=extra, reason=decision.reason,
                        limit=decision.benefit_density):
                    if not self.materializer.try_reserve(
                            est, benefit_density=limit):
                        with self.cv:
                            self.skipped[name] = \
                                f"{reason}; storage budget exhausted"
                        return
                    with self.cv:
                        self.materialized[name] = \
                            f"{reason} (admitted by eviction)"
                    self._persist_value(sig, name, value, est, extra)
                jobs.append(job)
            else:
                self.skipped[name] = decision.reason
        if not node.is_output:
            self.cache.pop(name, None)  # eager eviction (§5.4 cache pruning)

    # -- worker loop -------------------------------------------------------
    def _worker(self) -> None:
        while True:
            with self.cv:
                name = None
                while self.error is None and self.n_done < self.n_total:
                    if self._cancelled_locked():
                        break
                    name = self._pop_runnable_locked()
                    if name is not None:
                        break
                    # The canceller only sets an Event (it has no handle
                    # on this cv), so waits must time out to notice it.
                    self.cv.wait(timeout=0.25 if self.cancel is not None
                                 else None)
                if name is None:
                    return
            try:
                value, secs = self._run_node(name)
            except BaseException as e:  # propagate to execute()
                with self.cv:
                    self.n_inflight -= 1
                    if self.error is None:
                        self.error = e
                    self.cv.notify_all()
                return
            jobs: list[Callable[[], None]] = []
            with self.cv:
                self.cache[name] = value
                self.runtime[name] = secs
                self.n_done += 1
                self.n_inflight -= 1
                node = self.dag.nodes[name]
                if self.states[name] is State.COMPUTE:
                    for p in node.parents:
                        self.remaining[p] -= 1
                        if self.remaining[p] == 0:
                            self._on_actual_oos(p)
                for ch in self.dag.children(name):
                    if self.states[ch] is State.COMPUTE:
                        self.indeg[ch] -= 1
                        if self.indeg[ch] == 0:
                            heapq.heappush(self.runnable,
                                           (self.idx[ch], ch))
                if self.remaining[name] == 0:
                    self._on_actual_oos(name)
                self._advance_oos_ptr_locked(jobs)
                self.cv.notify_all()
            # Run the whole decision batch even if one job raises: every
            # job owns a decide-time ledger reservation that it settles
            # itself (save, reconcile, or release-on-failure) — aborting
            # mid-batch would strand the remaining jobs' reservations in
            # the fleet-shared ledger permanently.
            batch_error: BaseException | None = None
            for job in jobs:
                try:
                    job()
                except BaseException as e:
                    if batch_error is None:
                        batch_error = e
            if batch_error is not None:
                with self.cv:
                    if self.error is None:
                        self.error = batch_error
                    self.cv.notify_all()
                return

    def run(self) -> None:
        n_workers = min(self.max_workers, max(self.n_total, 1))
        if n_workers <= 1:
            self._worker()
        elif self.worker_pool is not None:
            # Elastic: the calling thread always runs one worker (progress
            # is guaranteed even with the pool exhausted); up to
            # n_workers-1 extras are borrowed from the shared pool.
            self.worker_pool.run(self._worker, n_workers)
        else:
            threads = [threading.Thread(target=self._worker,
                                        name=f"helix-exec-{i}", daemon=True)
                       for i in range(n_workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        # Settle the writer queue *before* propagating any worker error:
        # enqueued saves' reservations live in the (possibly fleet-shared)
        # ledger and must be reconciled or released no matter how the run
        # ended — skipping them on a worker error would leak reservations
        # into .fleet/ledger.json permanently (shrinking every future
        # session's budget and triggering spurious fleet-wide evictions).
        drain_error = self._drain_pending_saves()
        if self.error is not None:
            raise self.error
        if drain_error is not None:
            raise drain_error

    def _drain_pending_saves(self) -> BaseException | None:
        """Settle every queued async save: measured write time feeds
        ``mat_seconds`` (§6.6 accounting honesty), each landed write
        reconciles its estimate-based reservation to the actual on-disk
        size, and failed writes credit the reservation back. Never aborts
        early; returns the first error instead of raising so the caller
        can settle everything first."""
        drain_error: BaseException | None = None
        for est, pending in self.pending_saves:
            try:
                info = pending.result()
            except BaseException as e:
                self.materializer.release(est)
                if drain_error is None:
                    drain_error = e
                continue
            self._settle_save(est, info)
            self.mat_seconds += info.seconds
        return drain_error


def execute(dag: DAG,
            sigs: Mapping[str, str],
            states: Mapping[str, State],
            store: Store,
            materializer: Materializer,
            load_shardings: Mapping[str, Callable] | None = None,
            async_materialization: bool = False,
            max_workers: int = 1,
            prefetch_depth: int = 4,
            dedupe_inflight: bool = False,
            dedupe_wait_seconds: float = 120.0,
            share_sigs: frozenset | set | None = None,
            dedupe_skip: frozenset | set | None = None,
            worker_pool=None,
            cancel: threading.Event | None = None,
            chunk_plans: Mapping | None = None) -> ExecutionReport:
    """Execute a planned DAG. See the module docstring for the scheduler
    model; ``max_workers=1`` reproduces the sequential paper engine
    exactly. ``dedupe_inflight`` enables the fleet-wide compute-once
    protocol for COMPUTE nodes (shared-store concurrent sessions);
    ``share_sigs`` marks signatures known to recur across sibling
    sessions (always persisted on lease-compute). ``worker_pool`` (the
    serving layer's ``repro_torch.serve.SharedWorkerPool``) makes the
    worker count elastic: extra workers are borrowed from one process-wide pool shared by all
    sessions instead of spawned per call. ``cancel`` (a
    ``threading.Event``) requests cooperative cancellation: workers
    check it between nodes and inside lease waits, the run stops with
    :class:`JobCancelled`, and cleanup (pending saves, reservations,
    leases) follows the same settle path any error takes.
    ``chunk_plans`` (``{name: ChunkPlan}`` from
    ``compute_chunk_signatures``) turns on chunk-granular execution for
    the planned nodes: cached chunks are spliced from the store and only
    missing ones recomputed (see chunks.py)."""
    t_start = time.perf_counter()
    sched = _Scheduler(dag, sigs, states, store, materializer,
                       load_shardings, async_materialization,
                       max_workers, prefetch_depth,
                       dedupe_inflight=dedupe_inflight,
                       dedupe_wait_seconds=dedupe_wait_seconds,
                       share_sigs=share_sigs,
                       dedupe_skip=dedupe_skip,
                       worker_pool=worker_pool,
                       cancel=cancel,
                       chunk_plans=chunk_plans)
    sched.run()
    # Outputs are always the logical values: the chunk partitioning is an
    # executor/store-internal carrier, invisible to session callers.
    outputs = {n: (v.assemble() if isinstance(v, Chunked) else v)
               for n, v in ((n, sched.cache[n]) for n in dag.outputs()
                            if n in sched.cache)}
    return ExecutionReport(
        states=dict(states), runtime=sched.runtime,
        materialized=sched.materialized, skipped_mat=sched.skipped,
        mat_seconds=sched.mat_seconds,
        total_seconds=time.perf_counter() - t_start, outputs=outputs,
        max_workers=sched.max_workers,
        peak_resident_loads=sched.peak_resident_loads,
        deduped=sched.deduped,
        chose_compute=frozenset(dedupe_skip or ()),
        chunk_computed=sched.chunk_computed,
        chunk_reused=sched.chunk_reused)
