"""The port's session server (``repro_torch.serve``): many clients, one
store, globally-aware scheduling.

Twins of ``tests/test_serve.py`` on the port: shared-prefix-first dispatch order
under staggered arrival (vs. the FIFO baseline), sibling deferral in favor
of independent work, N concurrent in-process clients bit-identical to
isolated runs, shared worker-pool fairness, graceful drain on shutdown,
and the unix/TCP JSON protocol round-trip.
"""
import threading
import time

import numpy as np
import pytest

from repro_torch.core import IterativeSession, Workflow
from repro_torch.core.locking import HAVE_FLOCK
from repro_torch.serve import (InProcessClient, ServerError, SessionServer,
                               SharedWorkerPool, connect_tcp, connect_unix)

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
    """src → feat (slow, shared within a family) → model(reg) → eval.

    Two workflows of the same ``family`` share everything up to ``feat``;
    different families are completely disjoint. ``work`` scales the
    prefix's compute cost.
    """
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
# global scheduling
# ---------------------------------------------------------------------------
def test_prefix_first_dispatch_order(tmp_path):
    """Staggered arrival: an independent job arrives first, then two
    siblings sharing an expensive prefix. Prefix-first runs a sibling
    first (its prefix is the most shared work in the system) even though
    it arrived later; FIFO preserves arrival order."""
    def run(schedule, workdir):
        calls = Calls()
        server = SessionServer(str(workdir), n_sessions=1,
                               schedule=schedule, poll_interval=0.01)
        try:
            with server.hold_dispatch():
                server.submit(lambda: build_family("b", 0.5, calls),
                              name="B")
                server.submit(lambda: build_family("a", 0.1, calls),
                              name="A1")
                server.submit(lambda: build_family("a", 0.2, calls),
                              name="A2")
            server.wait_all()
        finally:
            server.shutdown()
        return server.dispatch_log, calls

    log, calls = run("prefix", tmp_path / "prefix")
    assert log[0] == "A1"              # shared prefix scheduled first
    assert set(log) == {"A1", "A2", "B"}
    assert calls.get("feat_a") == 1    # prefix computed once fleet-wide
    assert calls.get("feat_b") == 1

    log_fifo, calls_fifo = run("fifo", tmp_path / "fifo")
    assert log_fifo == ["B", "A1", "A2"]   # arrival order
    assert calls_fifo.get("feat_a") == 1   # lease dedupe still holds


def test_sibling_deferral_prefers_independent_work(tmp_path):
    """With 2 slots and [A1, A2, B] queued (A-family shares a slow
    prefix), the global scheduler dispatches A1 + B: A2 would only block
    on A1's compute lease, so the slot goes to independent work first and
    A2 follows (reusing the prefix, never recomputing it)."""
    calls = Calls()
    server = SessionServer(str(tmp_path), n_sessions=2,
                           poll_interval=0.01)
    try:
        with server.hold_dispatch():
            server.submit(lambda: build_family("a", 0.1, calls, work=2000),
                          name="A1")
            server.submit(lambda: build_family("a", 0.2, calls, work=2000),
                          name="A2")
            server.submit(lambda: build_family("b", 0.5, calls),
                          name="B")
        jobs = server.wait_all()
    finally:
        server.shutdown()
    assert server.dispatch_log[:2] == ["A1", "B"]
    assert server.dispatch_log[2] == "A2"
    assert calls.get("feat_a") == 1
    for j in jobs:
        assert j.status == "done", j.error
    # the sibling reused the prefix (planned load or lease-follow dedupe)
    a2 = next(j for j in jobs if j.name == "A2")
    ex = a2.report.execution
    assert ex.n_loaded + len(ex.deduped) >= 1


def test_live_multiplicity_map(tmp_path):
    """The cross-client signature-multiplicity map counts live
    submissions and empties as they finish; observed reuse lands in the
    shared cost model for future amortization."""
    server = SessionServer(str(tmp_path), n_sessions=2,
                           poll_interval=0.01)
    try:
        with server.hold_dispatch():
            jobs = [server.submit(lambda r=r: build_family("a", r),
                                  name=f"A{r}") for r in (0.1, 0.2, 0.4)]
            shared = frozenset.intersection(*[j.sigs for j in jobs])
            assert shared  # the family prefix
            for sig in shared:
                assert server.multiplicity(sig) == 3
        server.wait_all(jobs)
        for sig in shared:
            assert server.multiplicity(sig) == 0
        # two siblings loaded (or dedupe-loaded) each shared value
        assert any(server.cost_model.reuse_count(s) >= 1 for s in shared)
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# correctness: concurrent clients == isolated runs
# ---------------------------------------------------------------------------
def test_concurrent_clients_bit_identical_to_isolated(tmp_path):
    """N clients hammering one server concurrently get outputs
    bit-identical to N isolated cold runs."""
    regs = [0.1, 0.2, 0.4, 0.8]
    registry = {"fam": lambda reg: build_family("a", reg)}
    server = SessionServer(str(tmp_path / "srv"), registry=registry,
                           n_sessions=len(regs), poll_interval=0.01)
    wire_results: dict[float, dict] = {}
    errors: list[BaseException] = []

    def client_thread(reg: float) -> None:
        try:
            client = InProcessClient(server)
            job_id = client.submit("fam", {"reg": reg}, name=f"c{reg}")
            wire_results[reg] = client.wait(job_id)
        except BaseException as e:  # surfaced below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client_thread, args=(r,))
                   for r in regs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        server.shutdown()
    assert not errors
    for reg in regs:
        iso = IterativeSession(str(tmp_path / f"iso{reg}"))
        expected = iso.run(build_family("a", reg)).outputs
        assert wire_results[reg]["status"] == "done"
        # outputs here are plain floats, so the JSON wire form is exact
        assert wire_results[reg]["outputs"] == expected


# ---------------------------------------------------------------------------
# shared worker pool
# ---------------------------------------------------------------------------
def test_shared_pool_floor_and_bound():
    """Every session always gets its inline worker (progress floor);
    borrowed workers never exceed the pool size.

    Event-synchronized, not sleep-synchronized: every worker holds its
    slot until all three sessions' *inline* workers are live (the inline
    worker runs in the session's own thread, so three live inline
    workers prove all three ``run`` calls decided their width while no
    slot had been returned). The ``sum(widths)`` bound therefore cannot
    flake on a slow runner where sleeping sessions would serialize."""
    pool = SharedWorkerPool(2)
    lock = threading.Lock()
    live, peak, inline_live = [0], [0], [0]
    release = threading.Event()
    session_threads: set = set()

    def worker():
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
            if threading.current_thread() in session_threads:
                inline_live[0] += 1
        release.wait(timeout=60.0)
        with lock:
            live[0] -= 1

    widths: list[int] = []

    def one_session():
        widths.append(pool.run(worker, want=4))

    threads = [threading.Thread(target=one_session) for _ in range(3)]
    session_threads.update(threads)
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        with lock:
            if inline_live[0] == 3:
                break
        time.sleep(0.001)
    release.set()
    for t in threads:
        t.join()
    assert inline_live[0] == 3           # progress floor held everywhere
    assert len(widths) == 3 and all(w >= 1 for w in widths)
    assert sum(widths) <= 3 + 2          # 3 inline + at most 2 borrowed
    assert peak[0] <= 3 + 2
    assert pool.peak_in_use <= 2
    assert pool.in_use == 0              # all slots returned


def test_server_sessions_share_one_pool(tmp_path):
    """3 sessions × max_workers=4 draw from one 2-slot pool: the
    process-wide borrowed-worker count stays ≤ 2."""
    server = SessionServer(str(tmp_path), n_sessions=3, pool_workers=2,
                           max_workers=4, poll_interval=0.01)
    try:
        with server.hold_dispatch():
            jobs = [server.submit(lambda f=f: build_family(f, 0.1),
                                  name=f) for f in ("x", "y", "z")]
        server.wait_all(jobs)
    finally:
        server.shutdown()
    for j in jobs:
        assert j.status == "done", j.error
    assert server.pool.peak_in_use <= 2


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------
def test_wait_timeout_is_an_error(tmp_path):
    """A wait that times out answers ok:false (client raises), never a
    partial summary a caller could mistake for a finished job."""
    server = SessionServer(str(tmp_path), n_sessions=1, poll_interval=0.01)
    try:
        client = InProcessClient(server)
        with server.hold_dispatch():   # job cannot finish while held
            job = server.submit(lambda: build_family("a", 0.1))
            with pytest.raises(ServerError, match="TimeoutError"):
                client.wait(job.id, timeout=0.05)
        server.wait(job)
        assert client.wait(job.id)["status"] == "done"
    finally:
        server.shutdown()


def test_finished_job_retention_bounded(tmp_path):
    """Only the newest max_finished_jobs reports stay resident."""
    server = SessionServer(str(tmp_path), n_sessions=1, poll_interval=0.01,
                           max_finished_jobs=2)
    try:
        jobs = []
        for i in range(4):
            jobs.append(server.submit(
                lambda i=i: build_family(f"f{i}", 0.1), name=f"f{i}"))
            server.wait(jobs[-1])
        assert jobs[0].id not in server._jobs   # evicted
        assert jobs[-1].id in server._jobs      # newest retained
    finally:
        server.shutdown()


def test_graceful_drain_on_shutdown(tmp_path):
    """drain() finishes every submitted job, then refuses new work;
    shutdown is idempotent."""
    server = SessionServer(str(tmp_path), n_sessions=1, poll_interval=0.01)
    with server.hold_dispatch():
        jobs = [server.submit(lambda f=f: build_family(f, 0.1), name=f)
                for f in ("x", "y", "z")]
    assert server.drain(timeout=120.0)
    assert all(j.status == "done" for j in jobs)
    with pytest.raises(RuntimeError):
        server.submit(lambda: build_family("late", 0.1))
    server.shutdown()
    server.shutdown()   # idempotent


def test_shutdown_without_drain_cancels_queued(tmp_path):
    """shutdown(drain=False) cancels still-queued jobs instead of running
    them; already-running work completes."""
    server = SessionServer(str(tmp_path), n_sessions=1, poll_interval=0.01)
    with server.hold_dispatch():
        jobs = [server.submit(lambda f=f: build_family(f, 0.1), name=f)
                for f in ("x", "y", "z")]
    server.shutdown(drain=False)
    statuses = {j.status for j in jobs}
    assert "cancelled" in statuses           # the tail never ran
    for j in jobs:
        assert j.done.is_set()
        assert j.status in ("done", "cancelled")


# ---------------------------------------------------------------------------
# RPC protocol
# ---------------------------------------------------------------------------
def _registry():
    return {"fam": lambda reg=0.1: build_family("a", reg)}


def test_unix_socket_protocol_roundtrip(tmp_path):
    server = SessionServer(str(tmp_path / "srv"), registry=_registry(),
                           n_sessions=2, poll_interval=0.01)
    path = server.serve_unix(str(tmp_path / "helix.sock"))
    try:
        with connect_unix(path) as client:
            hello = client.hello()
            assert hello["workflows"] == ["fam"]
            job_id = client.submit("fam", {"reg": 0.3})
            result = client.wait(job_id)
            assert result["status"] == "done"
            assert "score" in result["outputs"]["eval"]
            assert result["execution"]["n_computed"] >= 1
            status = client.status()
            assert status["total_jobs"] == 1
            # finished jobs can be released eagerly; twice is a no-op
            assert client.forget(job_id) is True
            assert client.forget(job_id) is False
            with pytest.raises(ServerError):
                client.submit("nope", {})
            with pytest.raises(ServerError):
                client.wait("no-such-job")
    finally:
        server.shutdown()


def test_tcp_protocol_roundtrip(tmp_path):
    server = SessionServer(str(tmp_path), registry=_registry(),
                           n_sessions=1, poll_interval=0.01)
    host, port = server.serve_tcp("127.0.0.1", 0)
    try:
        with connect_tcp(host, port) as client:
            job_id = client.submit("fam", {"reg": 0.2})
            result = client.wait(job_id)
            assert result["status"] == "done"
            assert client.multiplicity("deadbeef") == 0
    finally:
        server.shutdown()


def test_client_shutdown_stops_server(tmp_path):
    """A client-initiated shutdown drains and stops the server."""
    server = SessionServer(str(tmp_path), registry=_registry(),
                           n_sessions=1, poll_interval=0.01)
    path = server.serve_unix(str(tmp_path / "s.sock"))
    client = connect_unix(path)
    job_id = client.submit("fam", {})
    assert client.wait(job_id)["status"] == "done"
    assert client.shutdown()["stopping"]
    client.close()
    with server._cv:
        assert server._cv.wait_for(lambda: server._shutdown_started,
                                   timeout=30.0)


# ---------------------------------------------------------------------------
# the port against the reference: jsonable of tensors, a model served
# ---------------------------------------------------------------------------
def _jsonable_cases():
    """(name, numpy array, dtype name): seeded values, each given to the
    reference as a JAX array and to the port as a torch tensor of the
    same bits."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal(7).astype(np.float32)
    return [
        ("fp32", f32, "float32"),
        ("bf16", f32, "bfloat16"),
        ("int32", rng.integers(-50, 50, (3, 4)).astype(np.int32), "int32"),
        ("bool", rng.random(5) < 0.5, "bool"),
        ("0d-fp32", np.float32(rng.standard_normal()), "float32"),
        ("0d-bf16", np.float32(rng.standard_normal()), "bfloat16"),
        ("fp32-64", rng.standard_normal((8, 8)).astype(np.float32),
         "float32"),
        ("fp32-65", rng.standard_normal(65).astype(np.float32), "float32"),
        ("bf16-2x40", rng.standard_normal((2, 40)).astype(np.float32),
         "bfloat16"),
    ]


@pytest.mark.parametrize("name,values,dtype", _jsonable_cases(),
                         ids=[c[0] for c in _jsonable_cases()])
def test_jsonable_of_a_tensor_matches_reference(name, values, dtype):
    """The port's ``jsonable`` of a CPU tensor ``==`` the reference's of a
    JAX array holding the same values (a bf16 tensor's bits are the JAX
    array's); the result is never a ``__repr__`` stub."""
    import jax.numpy as jnp
    import torch

    from repro.serve.protocol import jsonable as ref_jsonable
    from repro_torch.serve.protocol import jsonable

    arr = jnp.asarray(values).astype(dtype)
    host = np.asarray(arr.astype(jnp.float32)) if dtype == "bfloat16" \
        else np.asarray(arr)
    tensor = torch.from_numpy(np.array(host)).to(getattr(torch, dtype))
    got, want = jsonable(tensor), ref_jsonable(arr)
    assert "__repr__" not in got
    assert got == want
    assert got["shape"] == list(values.shape) and got["dtype"] == dtype
    assert (got["data"] is None) == (values.size > 64)


def test_jsonable_of_tensors_in_an_output_tree_matches_reference():
    """Grad-carrying and nested tensors, beside plain numbers, as a job
    summary carries them."""
    import jax.numpy as jnp
    import torch

    from repro.serve.protocol import jsonable as ref_jsonable
    from repro_torch.serve.protocol import jsonable

    rng = np.random.default_rng(1)
    w = rng.standard_normal((2, 3)).astype(np.float32)
    tok = rng.integers(0, 100, (2, 5)).astype(np.int32)
    port = {"w": torch.from_numpy(w).requires_grad_(),
            "out": [torch.from_numpy(tok), 3, 0.5, "x"],
            "score": torch.tensor(np.float32(w.sum()))}
    ref = {"w": jnp.asarray(w), "out": [jnp.asarray(tok), 3, 0.5, "x"],
           "score": jnp.asarray(np.float32(w.sum()))}
    got = jsonable(port)
    assert got == ref_jsonable(ref)
    assert "__repr__" not in repr(got)


SERVE_B, SERVE_S, SERVE_MAX_LEN, SERVE_GENS = 2, 16, 24, (4, 6)


def _serve_registry():
    """The serving workflow ``chip_smoke.py`` phase 9 hosts, on a 2-layer
    dense model (internlm2-1.8b reduced) on the CPU, with the port's own
    seeded weights."""
    import dataclasses
    import os
    import sys

    import torch

    sys.path.insert(0, os.path.abspath(os.path.join(
        os.path.dirname(__file__), os.pardir)))
    import chip_smoke
    from repro_torch import configs
    from repro_torch.models import registry

    cfg = dataclasses.replace(configs.reduced(configs.get("internlm2-1.8b")),
                              num_layers=2, attn_impl="flash")

    def init():
        return registry.init(cfg, torch.Generator().manual_seed(0), "cpu")

    def serve(gen_tokens=SERVE_GENS[0]):
        return chip_smoke.serve_workflow(
            cfg, init, int(gen_tokens), device="cpu", batch=SERVE_B,
            prompt=SERVE_S, max_len=SERVE_MAX_LEN)
    return {"serve": serve}


@pytest.fixture
def one_torch_thread():
    """One intra-op thread: several test processes share the cores, and
    torch's OpenMP pool spins at each of the model's small ops."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_model_served_by_the_server_matches_isolated_session(
        tmp_path, one_torch_thread):
    """Two socket clients submit the dense serving workflow at once
    (different ``gen_tokens``): each job's tokens and last logits are
    bitwise those of an isolated port session of the same workflow; the
    shared params, prompts and prefill are computed once; the wire
    summary carries the tokens' shape and dtype."""
    import torch

    registry = _serve_registry()
    server = SessionServer(str(tmp_path / "srv"), registry=registry,
                           n_sessions=2, poll_interval=0.01)
    path = server.serve_unix(str(tmp_path / "helix.sock"))
    summaries: dict[int, dict] = {}
    errors: list[BaseException] = []

    def client_thread(gen: int) -> None:
        try:
            with connect_unix(path) as client:
                job = client.submit("serve", {"gen_tokens": gen})
                summaries[gen] = client.wait(job, detail=True)
        except BaseException as e:  # surfaced below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client_thread, args=(g,))
                   for g in SERVE_GENS]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        reports = {g: server._jobs[summaries[g]["job"]].report
                   for g in SERVE_GENS}
    finally:
        server.shutdown()
    blind: dict[str, int] = {}
    for gen in SERVE_GENS:
        summary = summaries[gen]
        assert summary["status"] == "done"
        tokens = summary["outputs"]["decode"]["tokens"]
        assert tokens["shape"] == [SERVE_B, gen]
        assert tokens["dtype"] == "int32"
        logits = summary["outputs"]["decode"]["last_logits"]
        assert logits["dtype"] == "bfloat16" and logits["data"] is None
        for sig in summary["execution"]["blind_computed_sigs"]:
            blind[sig] = blind.get(sig, 0) + 1
        iso = IterativeSession(str(tmp_path / f"iso{gen}"))
        want = iso.run(registry["serve"](gen)).outputs["decode"]
        got = reports[gen].outputs["decode"]
        assert tokens["data"] == want["tokens"].tolist()
        for key in ("tokens", "last_logits"):
            assert got[key].dtype == want[key].dtype
            assert torch.equal(got[key].view(torch.uint8),
                               want[key].view(torch.uint8))
    assert max(blind.values()) == 1, blind
