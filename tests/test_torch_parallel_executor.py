"""The port's pipelined ready-set executor and store threads
(``repro_torch.core``), one case for each test of the JAX package's
``tests/test_parallel_executor.py``, by the same name: determinism against
the sequential engine, prefetch bounding, writer-queue accounting, and the
store's thread safety. The values are numpy arrays, as in the reference;
torch tensors through the same engine are held against the reference in
``tests/test_torch_core_store.py``. Imports no JAX."""
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.dag import DAG, Node, State
from repro_torch.core.executor import execute
from repro_torch.core.omp import Materializer, Policy
from repro_torch.core.store import Store


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: when several test processes
    share the cores, torch's OpenMP pool spins at each of its small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

N = 1000


def _sig(name: str) -> str:
    return f"sig{abs(hash(name)) % 10**8:08d}{name}"


def diamond_dag(width: int = 12) -> DAG:
    """src → width branches (f_i → g_i) → join → out, plus dangling d_i
    extractors (prune fodder)."""
    nodes = [Node("src", lambda: np.arange(N, dtype=np.float64))]
    gs = []
    for i in range(width):
        nodes.append(Node(f"f{i}", (lambda i=i: lambda x: x + i)(),
                          parents=("src",)))
        nodes.append(Node(f"g{i}", lambda x: x * 2.0, parents=(f"f{i}",)))
        gs.append(f"g{i}")
    for i in range(3):
        nodes.append(Node(f"d{i}", lambda x: x - 1.0, parents=("src",)))
    nodes.append(Node("join", lambda *vs: np.sum(vs, axis=0),
                      parents=tuple(gs)))
    nodes.append(Node("out", lambda v: float(v.sum()), parents=("join",),
                      is_output=True))
    return DAG(nodes)


def diamond_states(dag: DAG, load_branches=(3, 7)) -> dict[str, State]:
    """Mixed plan: two branches load their g_i (f_i pruned), the dangling
    d_i are pruned, everything else computes."""
    states = {name: State.COMPUTE for name in dag.nodes}
    for i in load_branches:
        states[f"g{i}"] = State.LOAD
        states[f"f{i}"] = State.PRUNE
    for i in range(3):
        states[f"d{i}"] = State.PRUNE
    return states


def seed_loads(store: Store, load_branches=(3, 7)) -> None:
    x = np.arange(N, dtype=np.float64)
    for i in load_branches:
        store.save(_sig(f"g{i}"), f"g{i}", (x + i) * 2.0)


def run_engine(tmp_path, tag: str, max_workers: int, budget: float,
               async_mat: bool = False, prefetch_depth: int = 4):
    dag = diamond_dag()
    states = diamond_states(dag)
    store = Store(str(tmp_path / f"store-{tag}"))
    seed_loads(store)
    sigs = {n: _sig(n) for n in dag.nodes}
    mat = Materializer(policy=Policy.ALWAYS, storage_budget_bytes=budget)
    report = execute(dag, sigs, states, store, mat,
                     async_materialization=async_mat,
                     max_workers=max_workers,
                     prefetch_depth=prefetch_depth)
    if async_mat:
        store.writer_drain()
    return report, store


def test_parallel_matches_sequential_with_budget_hit(tmp_path):
    """Wide diamond, mixed COMPUTE/LOAD/PRUNE, storage budget exhausted
    mid-run: 1 and 8 workers must produce identical outputs, runtimes
    coverage, materialization decisions (incl. reasons), and store
    contents."""
    budget = 6.5 * N * 8  # fits ~6 of the ~13 candidate values
    rep1, store1 = run_engine(tmp_path, "w1", 1, budget)
    rep8, store8 = run_engine(tmp_path, "w8", 8, budget)

    assert rep1.outputs.keys() == rep8.outputs.keys()
    assert rep1.outputs["out"] == rep8.outputs["out"]
    assert set(rep1.runtime) == set(rep8.runtime)
    assert rep1.states == rep8.states
    # Decision determinism: same nodes materialized/skipped for the same
    # reasons, despite arbitrary completion order under 8 workers.
    assert rep1.materialized == rep8.materialized
    assert rep1.skipped_mat == rep8.skipped_mat
    assert set(store1.entries()) == set(store8.entries())
    # The budget genuinely ran out mid-run.
    assert any("budget exhausted" in r for r in rep8.skipped_mat.values())
    assert rep8.materialized


def test_parallel_matches_ground_truth(tmp_path):
    x = np.arange(N, dtype=np.float64)
    expected = float(np.sum([(x + i) * 2.0 for i in range(12)]))
    rep, _ = run_engine(tmp_path, "gt", 8, float("inf"))
    assert rep.outputs["out"] == expected
    assert rep.max_workers == 8


def test_prune_load_accounting(tmp_path):
    rep, _ = run_engine(tmp_path, "acct", 4, float("inf"))
    assert rep.n_loaded == 2
    assert rep.n_pruned == 5   # f3, f7, d0..d2
    assert rep.n_computed == len(rep.states) - 7


def test_mat_seconds_accounted_in_async_mode(tmp_path):
    """satellite: mat_seconds must not silently read 0 under the writer
    queue — it aggregates measured write wall time in both modes."""
    rep_sync, _ = run_engine(tmp_path, "sync", 1, float("inf"),
                             async_mat=False)
    rep_async, store = run_engine(tmp_path, "async", 4, float("inf"),
                                  async_mat=True)
    assert rep_sync.mat_seconds > 0
    assert rep_async.mat_seconds > 0
    assert rep_sync.materialized == rep_async.materialized
    # everything decided for materialization actually hit the disk
    for name in rep_async.materialized:
        assert store.has(_sig(name))


def test_prefetch_depth_bounds_resident_loads(tmp_path):
    """Loads feeding a chain of consumers must not all be prefetched at
    once: residency stays within prefetch_depth (+1 for the starvation
    guard admitting a needed load)."""
    k = 8
    nodes = [Node(f"L{i}", None) for i in range(k)]
    prev = None
    for i in range(k):
        parents = (f"L{i}",) if prev is None else (prev, f"L{i}")
        fn = ((lambda v: v + 0.0) if prev is None
              else (lambda acc, v: acc + v))
        nodes.append(Node(f"C{i}", fn, parents=parents,
                          is_output=(i == k - 1)))
        prev = f"C{i}"
    dag = DAG(nodes)
    states = {f"L{i}": State.LOAD for i in range(k)}
    states.update({f"C{i}": State.COMPUTE for i in range(k)})
    store = Store(str(tmp_path / "store"))
    sigs = {n: _sig(n) for n in dag.nodes}
    for i in range(k):
        store.save(sigs[f"L{i}"], f"L{i}", np.full(N, float(i)))
    rep = execute(dag, sigs, states, store,
                  Materializer(policy=Policy.NEVER),
                  max_workers=4, prefetch_depth=2)
    assert rep.outputs[f"C{k-1}"] == pytest.approx(
        sum(range(k)) * np.ones(N))
    assert rep.peak_resident_loads <= 3
    # and with a generous depth everything may be prefetched
    rep2 = execute(dag, sigs, states, store,
                   Materializer(policy=Policy.NEVER),
                   max_workers=4, prefetch_depth=k)
    assert rep2.peak_resident_loads <= k


def test_worker_exception_propagates(tmp_path):
    dag = DAG([Node("a", lambda: 1.0),
               Node("b", lambda x: 1.0 / 0.0, parents=("a",),
                    is_output=True)])
    states = {"a": State.COMPUTE, "b": State.COMPUTE}
    store = Store(str(tmp_path / "store"))
    with pytest.raises(ZeroDivisionError):
        execute(dag, {n: _sig(n) for n in dag.nodes}, states, store,
                Materializer(policy=Policy.NEVER), max_workers=4)


def test_oos_order_matches_sequential_semantics():
    dag = diamond_dag(width=3)
    states = {name: State.COMPUTE for name in dag.nodes}
    for i in range(3):
        states[f"d{i}"] = State.PRUNE
    order = dag.oos_order(states)
    # src goes out of scope once every f_i (its last compute children) ran;
    # out (terminal, no children) goes out of scope right after itself.
    assert order.index("src") < order.index("join")
    assert order[-1] == "out"
    assert all(states[n] is not State.PRUNE for n in order)
    assert len(order) == len([n for n in dag.nodes
                              if states[n] is not State.PRUNE])


# ---------------------------------------------------------------------------
# Store concurrency
# ---------------------------------------------------------------------------
def test_store_concurrent_save_load_delete_same_prefix(tmp_path):
    """Hammer save/load/delete on signatures sharing one directory prefix:
    readers must never observe a torn entry, and the store must stay
    consistent."""
    store = Store(str(tmp_path))
    sigs = [f"ab{i:02d}" for i in range(4)]   # all under root/ab/
    for s in sigs:
        store.save(s, f"node-{s}", np.full(256, 0.0))
    errors: list[BaseException] = []
    stop = threading.Event()

    def saver(sig, gen0):
        g = gen0
        while not stop.is_set():
            store.save(sig, f"node-{sig}", np.full(256, float(g)))
            g += 1

    def loader(sig):
        while not stop.is_set():
            try:
                value, _ = store.load(sig)
            except FileNotFoundError:
                continue  # concurrently deleted — acceptable
            # atomic publish: the array must be one whole generation
            assert value.shape == (256,)
            assert np.all(value == value[0]), "torn read"

    def deleter(sig):
        while not stop.is_set():
            store.delete(sig)
            store.save(sig, f"node-{sig}", np.full(256, -1.0))

    def wrap(fn, *args):
        def run():
            try:
                fn(*args)
            except BaseException as e:  # pragma: no cover - failure path
                errors.append(e)
                stop.set()
        return run

    threads = [threading.Thread(target=wrap(saver, sigs[0], 1)),
               threading.Thread(target=wrap(saver, sigs[0], 1000)),
               threading.Thread(target=wrap(loader, sigs[0])),
               threading.Thread(target=wrap(loader, sigs[1])),
               threading.Thread(target=wrap(saver, sigs[1], 1)),
               threading.Thread(target=wrap(deleter, sigs[2])),
               threading.Thread(target=wrap(saver, sigs[3], 7))]
    for t in threads:
        t.start()
    stopper = threading.Timer(2.0, stop.set)
    stopper.start()
    for t in threads:
        t.join(timeout=30)
    stopper.cancel()
    stop.set()
    assert not errors, errors
    # post-race: every surviving sig loads cleanly
    for s in sigs:
        if store.has(s):
            value, _ = store.load(s)
            assert value.shape == (256,)
    assert store.total_bytes() >= 0


def test_stale_tmp_dirs_reaped_and_not_counted(tmp_path):
    import subprocess

    store = Store(str(tmp_path))
    store.save("ee55", "x", np.zeros(16))
    # simulate a crash mid-save: an orphaned staging dir (owned by a
    # provably dead pid) holding a meta.json
    proc = subprocess.Popen(["true"])
    proc.wait()
    stale = tmp_path / "ee" / f"ee56.tmp-{proc.pid}-456-0"
    stale.mkdir(parents=True)
    (stale / "meta.json").write_text('{"name": "ghost", "nbytes": 999}')
    assert set(store.entries()) == {"ee55"}   # never counted as an entry
    assert set(Store(str(tmp_path), heal=True).entries()) == {"ee55"}
    assert not stale.exists()                 # reaped on healing reopen

    # a staging dir owned by a *live* process must never be reaped
    live = tmp_path / "ee" / f"ee57.tmp-{os.getpid()}-456-0"
    live.mkdir(parents=True)
    Store(str(tmp_path), heal=True)
    assert live.exists()


def test_writer_queue_bounded_and_ordered(tmp_path):
    store = Store(str(tmp_path), max_inflight_bytes=4 * 256 * 8)
    pendings = [store.save_enqueue(f"cd{i:02d}", f"n{i}",
                                   np.full(256, float(i)))
                for i in range(16)]
    infos = [p.result(timeout=30) for p in pendings]
    assert all(i.nbytes == 256 * 8 for i in infos)
    store.writer_drain()
    for i in range(16):
        value, _ = store.load(f"cd{i:02d}")
        assert np.all(value == float(i))
