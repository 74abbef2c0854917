"""The port's store stack and executor vs the JAX package's: round trips
keep type, dtype and bits through the memory, disk and remote tiers;
eviction demotes without losing entries; a ``Chunked`` concat
reassembles; the upload race of the reference is repaired; the
pipelined executor gives the same outputs and decisions for 1 and 4
workers. Mirrors ``tests/test_store.py``, ``test_tiers.py``,
``test_eviction.py``, ``test_remote_store.py``, ``test_incremental.py``,
``test_faults.py`` and ``test_parallel_executor.py``."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dag as jdag, executor as jexecutor, omp as jomp
from repro.core import store as jstore
from repro.core.chunks import Chunked as JChunked
from repro_torch.core import dag as tdag, executor as texecutor, omp as tomp
from repro_torch.core import store as tstore, tree
from repro_torch.core.chunks import Chunked
from repro_torch.core.eviction import Evictor
from repro_torch.core.faults import FaultPlan, InjectedCrash
from repro_torch.core.locking import HAVE_FLOCK, StorageLedger
from repro_torch.core.remote import FsObjectStore, RemoteStore

RNG = np.random.default_rng(0)
F32 = RNG.standard_normal((32, 16)).astype(np.float32)
I32 = RNG.integers(-2**31, 2**31 - 1, size=(7, 5), dtype=np.int32)

# name -> (the port's leaf, the reference's leaf for the same data)
LEAVES = {
    "bf16_tensor": (lambda: torch.from_numpy(F32).to(torch.bfloat16),
                    lambda: jnp.asarray(F32, jnp.bfloat16)),
    "fp32_tensor": (lambda: torch.from_numpy(F32.copy()), lambda: F32),
    "int32_tensor": (lambda: torch.from_numpy(I32.copy()), lambda: I32),
    "f64_numpy": (lambda: F32.astype(np.float64),
                  lambda: F32.astype(np.float64)),
    "i32_numpy": (lambda: I32.copy(), lambda: I32.copy()),
    "pickled": (lambda: {"k": (1, "two")}, lambda: {"k": (1, "two")}),
}


def _bits(x):
    """Raw bits of an array leaf as a numpy array (NaN-safe equality)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().view(f"u{x.element_size()}")
    x = np.asarray(x)
    return x.view(f"u{x.itemsize}")


def _same(got, want):
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(_bits(got), _bits(want))
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        assert np.array_equal(_bits(got), _bits(want))
    else:
        assert got == want


def _load_from(tier, tmp_path, value):
    """Save ``value`` and load it back through ``tier``."""
    if tier == "memory":
        store = tstore.Store(str(tmp_path / "s"), mem_budget_bytes=64e6)
        store.save("ab12", "node", value)
        got, _ = store.load("ab12")
        assert store.load_stats["memory"]["hits"] == 1
        return got
    if tier == "disk":
        tstore.Store(str(tmp_path / "s"), mem_budget_bytes=64e6).save(
            "ab12", "node", value)
        store = tstore.Store(str(tmp_path / "s"))     # a fresh process
        got, _ = store.load("ab12")
        assert store.load_stats["local"]["hits"] == 1
        return got
    fs = FsObjectStore(str(tmp_path / "bucket"))
    host_a = tstore.Store(str(tmp_path / "a"), remote=RemoteStore(
        fs, heartbeats=False))
    host_a.save("ab12", "node", value)
    assert host_a.upload_now("ab12")
    host_b = tstore.Store(str(tmp_path / "b"), remote=RemoteStore(
        fs, heartbeats=False))
    assert not host_b.has_local("ab12")
    got, _ = host_b.load("ab12")
    assert host_b.remote_hits == 1
    host_a.remote.close()
    host_b.remote.close()
    return got


@pytest.mark.parametrize("tier", ["memory", "disk", "remote"])
@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_round_trip_keeps_type_dtype_and_bits(tmp_path, leaf, tier):
    if tier == "remote" and not HAVE_FLOCK:
        pytest.skip("the remote tier's leases need POSIX flock")
    value = {"x": LEAVES[leaf][0](), "none": None, "tag": "t"}
    got = _load_from(tier, tmp_path, value)
    assert got["none"] is None and got["tag"] == "t"
    _same(got["x"], value["x"])


@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_disk_entry_matches_reference(tmp_path, leaf):
    """The same data saved by both stores: the same byte count, and the
    same bits in each ``.npy`` (bf16 as raw bits in both)."""
    port, ref = LEAVES[leaf]
    t_store, j_store = (tstore.Store(str(tmp_path / "t")),
                        jstore.Store(str(tmp_path / "j")))
    t_info = t_store.save("ab12", "n", {"x": port(), "y": 3})
    j_info = j_store.save("ab12", "n", {"x": ref(), "y": 3})
    assert t_info.nbytes == j_info.nbytes
    names = sorted(os.listdir(j_store._dir("ab12")))
    assert names == sorted(os.listdir(t_store._dir("ab12")))
    for name in names:
        if name.endswith(".npy"):
            t_arr = np.load(os.path.join(t_store._dir("ab12"), name))
            j_arr = np.load(os.path.join(j_store._dir("ab12"), name))
            assert np.array_equal(_bits(t_arr), _bits(j_arr)), name


def test_placement_sees_flatten_indices_and_keeps_numpy_on_host(tmp_path):
    """``sharding_for_leaf`` is called for tensor leaves with their
    flatten index and torch dtype, on the disk path and the memory-tier
    path alike; numpy leaves stay numpy arrays."""
    value = {"b": torch.ones(3, dtype=torch.bfloat16), "a": np.arange(4),
             "c": [torch.zeros(2, 2), "s"]}
    seen = {}

    def place(i, shape, dtype):
        seen[i] = (shape, dtype)
        return torch.device("cpu")

    store = tstore.Store(str(tmp_path / "s"), mem_budget_bytes=1e6)
    store.save("ab12", "n", value)
    for fresh in (True, False):
        s = tstore.Store(str(tmp_path / "s")) if fresh else store
        seen.clear()
        got, _ = s.load("ab12", sharding_for_leaf=place)
        assert seen == {1: ((3,), torch.bfloat16), 2: ((2, 2), torch.float32)}
        assert isinstance(got["a"], np.ndarray)
        _same(got["b"], value["b"])


def test_load_without_placement_returns_each_leaf_to_its_home_device(tmp_path):
    """The manifest records each tensor leaf's device beside its dtype; a
    load with no placement puts the leaf back there, and one from a card
    this process lacks raises instead of handing back host tensors."""
    import json
    value = {"t": torch.ones(3, dtype=torch.bfloat16), "a": np.arange(4),
             "p": "s"}
    store = tstore.Store(str(tmp_path / "s"))
    store.save("ab12", "n", value)
    manifest = store.meta("ab12")["manifest"]
    assert [m.get("device") for m in manifest] == [None, None, "cpu"]
    got, _ = tstore.Store(str(tmp_path / "s")).load("ab12")
    _same(got["t"], value["t"])
    assert got["t"].device.type == "cpu" and isinstance(got["a"], np.ndarray)

    missing = f"cuda:{torch.cuda.device_count()}"   # a card not here
    manifest[2]["device"] = missing
    path = os.path.join(store._dir("ab12"), "meta.json")
    with open(path) as f:
        meta = json.load(f)
    meta["manifest"] = manifest
    with open(path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(RuntimeError, match=missing):
        tstore.Store(str(tmp_path / "s")).load("ab12")
    got, _ = tstore.Store(str(tmp_path / "s")).load(
        "ab12", sharding_for_leaf=lambda i, shape, dtype: torch.device("cpu"))
    _same(got["t"], value["t"])


def test_memory_hit_device_does_not_depend_on_the_offload(tmp_path):
    """A memory-tier hit comes back on the devices its value was admitted
    from, whether the entry still holds those tensors or (after the
    async offload landed) a host snapshot of them. The ``meta`` device
    stands in for the card, which a CPU-only build cannot hold."""
    store = tstore.Store(str(tmp_path / "s"), mem_budget_bytes=1e6)
    value = {"w": torch.empty(4, 4, device="meta"), "n": np.arange(3),
             "h": torch.ones(2)}
    assert store._mem.put("ab12", value, 80)    # as a placed load admits it
    before, _ = store.load("ab12")
    assert before["w"] is value["w"] and before["h"] is value["h"]
    snapshot = {"w": torch.zeros(4, 4), "n": value["n"], "h": value["h"]}
    assert store._mem.replace_value("ab12", snapshot, expect=value)
    after, _ = store.load("ab12")
    assert after["w"].device == before["w"].device == torch.device("meta")
    assert after["h"].device.type == "cpu" and after["n"] is value["n"]
    placed, _ = store.load(
        "ab12", sharding_for_leaf=lambda i, shape, dtype: torch.device("cpu"))
    assert placed["w"].device.type == "cpu"


def test_demote_not_delete_and_ledger_invariant_match_reference(tmp_path):
    """Churn past the memory budget in both packages: the same number of
    demotions, bytes held equal to a recount, every entry still loads."""
    status = {}
    for pkg, mod, make in (("torch", tstore, torch.from_numpy),
                           ("jax", jstore, lambda a: a)):
        store = mod.Store(str(tmp_path / pkg), mem_budget_bytes=40_000)
        rng = np.random.default_rng(0)
        for i in range(12):
            store.save(f"sig{i:02d}", f"n{i}", make(rng.standard_normal(1024)))
            assert store._mem.bytes_held == store._mem.recount() <= 40_000
        status[pkg] = store.tier_status()["memory"]
        rng = np.random.default_rng(0)
        for i in range(12):
            got, _ = store.load(f"sig{i:02d}")
            assert np.array_equal(np.asarray(got), rng.standard_normal(1024))
    assert status["torch"]["demotions"] == status["jax"]["demotions"] > 0


def test_writeback_demotion_spills_dirty_tensor(tmp_path):
    """As ``tests/test_tiers.py``: evicting a dirty (memory-only) entry
    spills it to disk; the ledger stays equal to disk; both reload."""
    store = tstore.Store(str(tmp_path / "s"), mem_budget_bytes=20_000,
                         mem_writeback=True)
    StorageLedger(store.ledger_path).ensure(0.0)
    a = torch.arange(1500, dtype=torch.float64)           # 12KB
    b = torch.arange(1500, 3000, dtype=torch.float64)
    assert store.save("aa11", "a", a).nbytes == 0         # memory only
    assert not store.has_local("aa11")
    store.save("bb22", "b", b)                            # demotes, spills
    assert store.has_local("aa11")
    assert StorageLedger(store.ledger_path).used() == store.total_bytes()
    fresh = tstore.Store(str(tmp_path / "s"))
    _same(fresh.load("aa11")[0], a)
    _same(store.load("bb22")[0], b)


def test_evict_to_admit_prefers_lowest_benefit(tmp_path):
    """As ``tests/test_eviction.py``: a full budget admits a reservation
    by evicting the lowest-benefit entry (no cost metadata), never the
    high-C(n) one; the ledger stays equal to disk plus the reservation."""
    store = tstore.Store(str(tmp_path / "s"))
    store.save("junk", "junk", torch.ones(256))
    store.save("good", "good", torch.ones(256),
               extra_meta={"compute_s": 50.0, "load_s_est": 0.01})
    total = store.total_bytes()
    ledger = StorageLedger(store.ledger_path)
    ledger.reset(float(total))
    ev = Evictor(store)
    m = tomp.Materializer(policy=tomp.Policy.OPT,
                          storage_budget_bytes=float(total), ledger=ledger,
                          evictor=ev)
    need = store.meta("junk")["nbytes"]
    assert m.try_reserve(need)
    assert store.has("good") and not store.has("junk")
    assert ev.stats.n_evicted == 1 and ev.stats.bytes_evicted == need
    assert ledger.used() == store.total_bytes() + need


@pytest.mark.parametrize("chunks", ["tensor", "numpy"])
def test_chunked_concat_round_trip(tmp_path, chunks):
    """Per-chunk entries plus a manifest; loading the manifest reassembles
    the chunks (``torch.cat`` for tensors, as ``np.concatenate`` does for
    arrays in the reference) with the same byte count as the reference."""
    arrs = [np.arange(6, dtype=np.float64) * (i + 1) for i in range(3)]
    pieces = [torch.from_numpy(a) for a in arrs] if chunks == "tensor" \
        else arrs
    sigs = tuple(f"ch{i:02d}" for i in range(3))
    store = tstore.Store(str(tmp_path / "t"))
    info = store.save("full", "node", Chunked(pieces, sigs))
    j_info = jstore.Store(str(tmp_path / "j")).save("full", "node",
                                                  JChunked(arrs, sigs))
    assert info.nbytes == j_info.nbytes
    got, _ = tstore.Store(str(tmp_path / "t")).load("full")
    assert isinstance(got, Chunked) and got.chunk_sigs == sigs
    whole = got.assemble()
    assert type(whole) is type(pieces[0])
    assert np.array_equal(np.asarray(whole), np.concatenate(arrs))


# -- the upload race (ROADMAP §3), repaired in the port's store ----------------

def _crash_then_gc(tmp_path):
    """Twin of ``tests/test_faults.py::test_crash_between_value_and_marker_
    is_invisible_then_gc`` on the port's store."""
    plan = FaultPlan(seed=1234).crash_at("upload:before_marker")
    backend = FsObjectStore(str(tmp_path / "bucket"))
    remote = RemoteStore(backend, faults=plan, heartbeats=False)
    store = tstore.Store(str(tmp_path / "host" / "store"), remote=remote)
    info = store.save("ab12", "node", {"w": torch.ones(32, 16),
                                       "idx": np.arange(64, dtype=np.int32)})
    with pytest.raises(InjectedCrash):
        store.upload_now("ab12")      # dies after the data, pre-marker
    reader = RemoteStore(backend, heartbeats=False)
    assert not reader.exists("ab12")
    orphans = list(backend.list("entries/ab12/"))
    assert orphans and not any(k.endswith(".complete") for k in orphans)
    assert reader.gc_orphans(min_age_seconds=3600.0) == 0
    assert reader.total_bytes(fresh=True) == 0
    assert reader.gc_orphans(min_age_seconds=0.0) == len(orphans)
    assert backend.list("entries/ab12/") == []
    assert store.upload_now("ab12")   # the retry commits
    assert reader.marker_meta("ab12", fresh=True)["nbytes"] == info.nbytes
    reader.close()
    remote.close()


@pytest.mark.skipif(not HAVE_FLOCK, reason="fleet mode needs POSIX flock")
@pytest.mark.parametrize("run", range(20))
def test_upload_now_owns_the_queued_upload(tmp_path, run):
    """``upload_now`` owns the upload ``save`` queued, whichever of the
    two threads reaches the armed crash point: 20 runs, no failure."""
    _crash_then_gc(tmp_path)


class _FailingFirstUpload(RemoteStore):
    """A remote tier whose first upload raises an ordinary error."""

    def __init__(self, *args, error, **kwargs):
        super().__init__(*args, **kwargs)
        self.error = error

    def upload(self, sig, local_dir, meta):
        if self.error is not None:
            error, self.error = self.error, None
            raise error
        return super().upload(sig, local_dir, meta)


@pytest.mark.skipif(not HAVE_FLOCK, reason="fleet mode needs POSIX flock")
@pytest.mark.parametrize("error", [OSError("disk hiccup"),
                                   RuntimeError("backend bug")],
                         ids=["oserror", "runtimeerror"])
def test_upload_now_retries_after_an_ordinary_background_failure(tmp_path,
                                                                 error):
    """Only an injected crash of the background upload is re-raised by
    ``upload_now``; any other error of it is retried synchronously."""
    backend = FsObjectStore(str(tmp_path / "bucket"))
    remote = _FailingFirstUpload(backend, heartbeats=False, error=error)
    store = tstore.Store(str(tmp_path / "host" / "store"), remote=remote)
    store.save("ab12", "node", {"w": torch.ones(8)})
    store.remote_drain()                 # the background upload failed
    assert remote.error is None and not remote.exists("ab12")
    assert store.upload_now("ab12") and remote.exists("ab12")
    remote.close()


@pytest.mark.skipif(not HAVE_FLOCK, reason="fleet mode needs POSIX flock")
def test_interrupted_delete_leaves_only_invisible_orphans(tmp_path):
    plan = FaultPlan(seed=1234).crash_at("delete:after_marker")
    backend = FsObjectStore(str(tmp_path / "bucket"))
    remote = RemoteStore(backend, faults=plan, heartbeats=False)
    store = tstore.Store(str(tmp_path / "host" / "store"), remote=remote)
    store.save("cd34", "node", {"w": torch.ones(8)})
    assert store.upload_now("cd34") and remote.exists("cd34")
    with pytest.raises(InjectedCrash):
        remote.delete_entry("cd34")
    reader = RemoteStore(backend, heartbeats=False)
    assert not reader.exists("cd34")
    assert backend.list("entries/cd34/")
    assert reader.gc_orphans(min_age_seconds=0.0) > 0
    reader.close()
    remote.close()


# -- the pipelined executor ------------------------------------------------------

N = 1000


def _diamond(pkg, width=12):
    """As ``tests/test_parallel_executor.py::diamond_dag``: src → width
    branches (f_i → g_i) → join → out, plus dangling d_i; the port's
    values are tensors."""
    dag, arange, total = {
        "jax": (jdag, lambda: np.arange(N, dtype=np.float64),
                lambda vs: np.sum(vs, axis=0)),
        "torch": (tdag, lambda: torch.arange(N, dtype=torch.float64),
                  lambda vs: torch.stack(vs).sum(0)),
    }[pkg]
    nodes = [dag.Node("src", arange)]
    gs = []
    for i in range(width):
        nodes.append(dag.Node(f"f{i}", (lambda i=i: lambda x: x + i)(),
                              parents=("src",)))
        nodes.append(dag.Node(f"g{i}", lambda x: x * 2.0,
                              parents=(f"f{i}",)))
        gs.append(f"g{i}")
    for i in range(3):
        nodes.append(dag.Node(f"d{i}", lambda x: x - 1.0, parents=("src",)))
    nodes.append(dag.Node("join", lambda *vs: total(vs), parents=tuple(gs)))
    nodes.append(dag.Node("out", lambda v: float(v.sum()), parents=("join",),
                          is_output=True))
    return dag.DAG(nodes)


def _run_engine(tmp_path, pkg, max_workers, async_mat):
    dag_mod, ex, omp, st = {"jax": (jdag, jexecutor, jomp, jstore),
                            "torch": (tdag, texecutor, tomp, tstore)}[pkg]
    dag = _diamond(pkg)
    states = {n: dag_mod.State.COMPUTE for n in dag.nodes}
    for i in (3, 7):
        states[f"g{i}"], states[f"f{i}"] = (dag_mod.State.LOAD,
                                            dag_mod.State.PRUNE)
    for i in range(3):
        states[f"d{i}"] = dag_mod.State.PRUNE
    store = st.Store(str(tmp_path / f"{pkg}-{max_workers}-{async_mat}"))
    x = np.arange(N, dtype=np.float64)
    for i in (3, 7):
        g = (x + i) * 2.0
        store.save(f"sig-g{i}", f"g{i}", torch.from_numpy(g)
                   if pkg == "torch" else g)
    sigs = {n: f"sig-{n}" for n in dag.nodes}
    mat = omp.Materializer(policy=omp.Policy.ALWAYS,
                           storage_budget_bytes=6.5 * N * 8)
    report = ex.execute(dag, sigs, states, store, mat,
                        async_materialization=async_mat,
                        max_workers=max_workers)
    store.writer_drain()
    return report, store


@pytest.mark.parametrize("async_mat", [False, True])
@pytest.mark.parametrize("max_workers", [1, 4])
def test_executor_matches_reference(tmp_path, max_workers, async_mat):
    """Mixed COMPUTE/LOAD/PRUNE with the budget running out mid-run: the
    port at ``max_workers`` gives the reference's sequential outputs,
    states and materialization decisions, and the same store entries."""
    t_rep, t_store = _run_engine(tmp_path, "torch", max_workers, async_mat)
    j_rep, j_store = _run_engine(tmp_path, "jax", 1, False)
    assert t_rep.outputs == j_rep.outputs
    assert t_rep.max_workers == max_workers
    assert ({n: s.name for n, s in t_rep.states.items()}
            == {n: s.name for n, s in j_rep.states.items()})
    assert t_rep.materialized == j_rep.materialized
    assert t_rep.skipped_mat == j_rep.skipped_mat
    assert any("budget exhausted" in r for r in t_rep.skipped_mat.values())
    assert set(t_store.entries()) == set(j_store.entries())
    assert (t_rep.n_computed, t_rep.n_loaded, t_rep.n_pruned) == (
        j_rep.n_computed, j_rep.n_loaded, j_rep.n_pruned)


def test_block_passes_cpu_values_through():
    value = {"a": torch.ones(2), "b": [np.zeros(1), None]}
    assert texecutor._block(value) is value
    assert tree.cuda_devices(value) == set()


def test_writer_drain_waits_for_a_running_offload(tmp_path):
    """An offload the writer thread has already taken off its queue still
    counts: ``writer_drain`` returns only after it has landed."""
    import threading
    import time
    store = tstore.Store(str(tmp_path / "s"), mem_budget_bytes=1e6)
    started, landed = threading.Event(), []

    def slow_offload(sig):
        started.set()
        time.sleep(0.2)
        landed.append(sig)

    store._mem_offload_run = slow_offload
    store._mem_offload_enqueue("ab12")
    assert started.wait(5.0)          # the writer is inside the offload
    store.writer_drain()
    assert landed == ["ab12"]
