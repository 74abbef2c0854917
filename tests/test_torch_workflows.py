"""The paper's workflows on the port (``repro_torch.workflows``) vs the JAX
package's (``benchmarks/workflows.py``), on the CPU at small knobs.

- Knobs, ``mutate_*`` and ``iteration_schedule`` are the reference's; each
  workflow's node signatures equal its twin's for the same knobs.
- ``synth``'s sources and every ``tabular`` function give the reference's
  bytes; the numpy learners (``train_logreg_np``, ``train_softmax_np``,
  ``logreg_predict``) are bitwise the reference's.
- Each torch learner against its jitted JAX twin on the same numpy inputs:
  weights, embeddings, centroids and the parse within LEARNER_TOL of
  max(1, max |ref|); int32 assignments equal.
- Census, genomics and NLP run three iterations (cold and two edits) in
  both packages' sessions with pinned costs: the same signatures and node
  states, metrics that agree wherever no prediction flipped, and every
  flipped row within FLIP_MARGIN of the decision boundary.
- The daily-retrain census in both packages: the same outputs and chunk
  counts after an append.
- MNIST's random-FFT nodes are recomputed in every iteration.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

import workflows as JW
from repro.core import config as jconfig, costs as jcosts
from repro.core import session as jsession
from repro.core.omp import Policy as JPolicy
from repro.core.signature import compute_signatures as jsigs
from repro.data import synth as jsynth, tabular as jtab
from repro_torch import workflows as TW
from repro_torch.core import config as tconfig, costs as tcosts
from repro_torch.core import session as tsession
from repro_torch.core.omp import Policy as TPolicy
from repro_torch.core.signature import compute_signatures as tsigs
from repro_torch.data import synth as tsynth, tabular as ttab

# fp32 learners that differ from their JAX twins only in summation order:
# 300 logistic steps read ~5e-8 apart, the embeddings ~1.5e-8
LEARNER_TOL = 1e-5
# a prediction may flip between the packages only where the reference's
# logit is this close to 0
FLIP_MARGIN = 1e-4
SURVEY = ("census", "genomics", "nlp", "mnist")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: when several test processes
    share the cores, torch's OpenMP pool spins at each of the learners'
    thousands of small ops and runs them ~100x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(ref, got, tol=LEARNER_TOL):
    ref, got = np.asarray(ref), np.asarray(got)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max())


# --------------------------------------------------------------- knobs etc.
KNOBS = [(JW.CensusKnobs, TW.CensusKnobs),
         (JW.IncrementalCensusKnobs, TW.IncrementalCensusKnobs),
         (JW.GenomicsKnobs, TW.GenomicsKnobs), (JW.NLPKnobs, TW.NLPKnobs),
         (JW.MNISTKnobs, TW.MNISTKnobs), (JW.LMKnobs, TW.LMKnobs)]


@pytest.mark.parametrize("jk,tk", KNOBS, ids=lambda c: c.__name__)
def test_knobs_are_the_references(jk, tk):
    assert [f.name for f in dataclasses.fields(tk)] == \
        [f.name for f in dataclasses.fields(jk)]
    assert dataclasses.asdict(tk()) == dataclasses.asdict(jk())


def test_registry_is_the_references():
    assert list(TW.WORKFLOWS) == list(JW.WORKFLOWS)
    for name, twd in TW.WORKFLOWS.items():
        jwd = JW.WORKFLOWS[name]
        assert twd.name == jwd.name and twd.freqs == jwd.freqs
        assert dataclasses.asdict(twd.knobs0) == dataclasses.asdict(jwd.knobs0)


@pytest.mark.parametrize("name", list(JW.WORKFLOWS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mutate_and_schedule_are_the_references(name, seed):
    jwd, twd = JW.WORKFLOWS[name], TW.WORKFLOWS[name]
    for kind in ("DPR", "LI", "PPR"):
        want = jwd.mutate(jwd.knobs0, kind, np.random.default_rng(seed))
        got = twd.mutate(twd.knobs0, kind, np.random.default_rng(seed))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    want = JW.iteration_schedule(jwd, 10, seed)
    got = TW.iteration_schedule(twd, 10, seed)
    assert [dataclasses.asdict(k) for k in got] == \
        [dataclasses.asdict(k) for k in want]


SIGNED = {  # builds that draw nothing: their signatures alone are compared
    "census": (JW.build_census, TW.build_census, [
        TW.CensusKnobs(), TW.CensusKnobs(use_interaction=False, n_buckets=7)]),
    "census_inc": (JW.build_census_incremental, TW.build_census_incremental,
                   [TW.IncrementalCensusKnobs(),
                    TW.IncrementalCensusKnobs(n_chunks=11)]),
    "genomics": (JW.build_genomics, TW.build_genomics,
                 [TW.GenomicsKnobs(), TW.GenomicsKnobs(emb_dim=96)]),
    "nlp": (JW.build_nlp, TW.build_nlp,
            [TW.NLPKnobs(), TW.NLPKnobs(pair_window=12)]),
    "mnist": (JW.build_mnist, TW.build_mnist,
              [TW.MNISTKnobs(), TW.MNISTKnobs(n_towers=4, n_features=64)]),
}


@pytest.mark.parametrize("name", list(SIGNED))
def test_signatures_are_the_references(name):
    jbuild, tbuild, knobs = SIGNED[name]
    for k in knobs:
        jk = getattr(JW, type(k).__name__)(**dataclasses.asdict(k))
        jdag, tdag = jbuild(jk).build(), tbuild(k, device="cpu").build()
        nonces = {n: f"nonce-{n}" for n, node in tdag.nodes.items()
                  if not node.deterministic}
        assert tdag.topological() == jdag.topological()
        for n in tdag.topological():
            t, j = tdag.nodes[n], jdag.nodes[n]
            assert (t.kind.value, t.version, t.parents, t.deterministic,
                    t.incremental, t.chunk_ids, t.is_output) == \
                (j.kind.value, j.version, j.parents, j.deterministic,
                 j.incremental, j.chunk_ids, j.is_output), n
        assert tsigs(tdag, nonces) == jsigs(jdag, nonces)


# ------------------------------------------------------------------- data
def _same(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 7])
def test_synth_sources_are_the_references(seed):
    _same(jsynth.census_rows(seed, 500), tsynth.census_rows(seed, 500))
    _same(jsynth.documents(seed, 40, 30, 300), tsynth.documents(seed, 40, 30, 300))
    _same(jsynth.images(seed, 60), tsynth.images(seed, 60))
    _same(jsynth.lm_tokens(seed, 1000, 97), tsynth.lm_tokens(seed, 1000, 97))


def test_tabular_is_the_references():
    rows = jsynth.census_rows(3, 700)
    for fn, args in [
            ("column", (rows, "age")),
            ("bucketize", (rows["age"], 10)),
            ("one_hot", (rows["education"], 16)),
            ("one_hot", (rows["race"], 3)),            # clipped
            ("interact", (jtab.one_hot(rows["sex"], 2),
                          jtab.one_hot(rows["occupation"], 15))),
            ("fixed_bucketize", (rows["hours"], range(10, 90, 8))),
            ("census_chunk_descriptors", (7, 4, 50)),
            ("load_census_chunks", ([(7, 30), (8, 20)],)),
            ("standardize", (rows["age"],)),
            ("standardize", (np.log1p(rows["capital_gain"]),))]:
        _same(getattr(jtab, fn)(*args), getattr(ttab, fn)(*args))
    blocks = {"b1": jtab.standardize(rows["hours"]),
              "b0": jtab.one_hot(rows["sex"], 2),
              "b2": rows["age"].astype(np.float64)}
    _same(jtab.assemble(blocks), ttab.assemble(blocks))


# --------------------------------------------------------------- learners
def _logreg_data(n=600, d=24, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, 0] + 0.5 * rng.normal(size=n) > 0).astype(np.int32)
    return X, y


@pytest.mark.parametrize("reg,iters", [(0.1, 300), (0.01, 50)])
def test_train_logreg_matches_reference(reg, iters):
    X, y = _logreg_data()
    X[:5] *= 40.0                 # logits past softplus's threshold of 20
    want = JW.train_logreg(X, y, reg, iters=iters)
    got = TW.train_logreg(X, y, reg, iters=iters, device="cpu")
    assert got.dtype == np.float32 and got.shape == (X.shape[1] + 1,)
    _close(want, got)
    np.testing.assert_array_equal(JW.logreg_predict(want, X),
                                  TW.logreg_predict(want, X))


@pytest.mark.parametrize("seed", [0, 3])
def test_train_embeddings_matches_reference(seed):
    docs = tsynth.documents(11, 60, 40, 300)
    want = JW.train_embeddings(docs, 300, 16, 4, seed=seed)
    got = TW.train_embeddings(docs, 300, 16, 4, seed=seed, device="cpu")
    _close(want, got)


def test_segment_sum_is_the_scatter_add():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 50, 400)
    idx[idx == 7] = 8             # an index with no rows
    rows = torch.as_tensor(rng.normal(size=(400, 5)), dtype=torch.float64)
    want = torch.zeros(50, 5, dtype=torch.float64).index_add_(
        0, torch.as_tensor(idx), rows)
    got = TW._SegmentSum(idx, 50, torch.device("cpu"))(rows)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert not got[7].any()


@pytest.mark.parametrize("k", [4, 16])
def test_kmeans_matches_reference(k):
    X = tsynth.documents(5, 1, 400 * 8, 1000)[0].reshape(400, 8) / 100.0
    X = X.astype(np.float32)
    (cw, aw), (cg, ag) = JW.kmeans(X, k), TW.kmeans(X, k, device="cpu")
    _close(cw, cg)
    assert ag.dtype == aw.dtype == np.int32
    np.testing.assert_array_equal(ag, aw)


def _reference_parse_weights(vocab, seed=0, dim=128, layers=4):
    """What the reference's encoder_parse draws, as numpy arrays."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 2 + 4 * layers)
    E = jax.random.normal(ks[0], (vocab, dim)) * 0.05
    Ws = [tuple(np.asarray(jax.random.normal(ks[2 + 4 * i + j], (dim, dim))
                           * dim ** -0.5) for j in range(4))
          for i in range(layers)]
    return np.asarray(E), Ws


def test_encoder_parse_matches_reference_given_its_weights():
    docs = tsynth.documents(23, 300, 24, 200)      # two batches of 256
    want = JW.encoder_parse(docs, 200, dim=32, layers=2)
    got = TW.encoder_parse(docs, 200, dim=32, layers=2, device="cpu",
                           weights=_reference_parse_weights(200, 0, 32, 2))
    _close(want, got)


def test_encoder_parse_default_weights_come_from_a_seeded_generator():
    docs = tsynth.documents(23, 4, 16, 100)
    a = TW.encoder_parse(docs, 100, dim=16, layers=1, device="cpu")
    b = TW.encoder_parse(docs, 100, dim=16, layers=1, device="cpu",
                         weights=TW.encoder_weights(100, 0, 16, 1))
    c = TW.encoder_parse(docs, 100, seed=1, dim=16, layers=1, device="cpu")
    assert a.dtype == np.float32 and a.shape == (4, 16, 16)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def _fft_features(n=400, n_feat=48):
    X, y = tsynth.images(5, n)
    rng = np.random.default_rng(1)
    W = rng.normal(0, 1.0, (28 * 28, n_feat)).astype(np.float32)
    b = rng.uniform(0, 2 * np.pi, n_feat).astype(np.float32)
    return np.cos(X.reshape(n, -1) @ W + b), y


@pytest.mark.parametrize("reg,epochs", [(1e-3, 60), (1e-2, 20)])
def test_train_softmax_matches_reference(reg, epochs):
    Z, y = _fft_features()
    k = JW.MNISTKnobs(reg=reg, epochs=epochs)
    want = JW.build_mnist(k).build().nodes["softmax"].fn((Z, y))
    got = TW.train_softmax(Z, y, reg, epochs, device="cpu")
    _close(want, got)


def test_numpy_learners_are_bitwise_the_references():
    X, y = _logreg_data()
    _same(JW.train_logreg_np(X, y, 0.1, 15), TW.train_logreg_np(X, y, 0.1, 15))
    Z, yz = _fft_features()
    _same(JW.train_softmax_np(Z, yz, 1e-3, 5),
          TW.train_softmax_np(Z, yz, 1e-3, 5))


# --------------------------------------------------------------- sessions
def _pinned(cost_model_cls):
    class Pinned(cost_model_cls):
        def compute_cost(self, sig, hint=None, default=1.0):
            return 1.0
    return Pinned


SESSIONS = {"jax": (jsession.IterativeSession, _pinned(jcosts.CostModel),
                    jconfig, JPolicy),
            "torch": (tsession.IterativeSession, _pinned(tcosts.CostModel),
                      tconfig, TPolicy)}


def _session(pkg, workdir, policy="ALWAYS"):
    """A session whose planner sees every compute cost as 1 s and every
    load as 0.01 s."""
    cls, costs, config, pol = SESSIONS[pkg]
    sess = cls(workdir, cost_model=costs(f"{workdir}/costs.json"),
               engine=config.EngineConfig(policy=getattr(pol, policy)))
    sess.store.est_load_seconds = lambda nbytes, sig=None: 0.01
    return sess


def _states(rep):
    return {n: s.name for n, s in rep.execution.states.items()}


def _value(sess, rep, name):
    return sess.store.load(rep.sigs[name])[0]


def _check_logreg(sess, reps, X, learner):
    """The logistic weights agree; predictions flip only at the boundary,
    and where none flips the metrics are equal."""
    j, t = reps["jax"], reps["torch"]
    wj, wt = _value(sess["jax"], j, learner), _value(sess["torch"], t, learner)
    _close(wj, wt)
    margin = X @ wj[:-1] + wj[-1]
    flipped = JW.logreg_predict(wj, X) != TW.logreg_predict(wt, X)
    assert np.all(np.abs(margin[flipped]) < FLIP_MARGIN)
    if not flipped.any():
        assert t.outputs == j.outputs


def _check_census(sess, reps):
    X = _value(sess["jax"], reps["jax"], "income")["X"]
    _check_logreg(sess, reps, X, "incPred")


def _check_genomics(sess, reps):
    j, t = reps["jax"], reps["torch"]
    _close(_value(sess["jax"], j, "word2vec"), _value(sess["torch"], t, "word2vec"))
    (cj, aj), (ct, at) = (_value(sess["jax"], j, "kmeans"),
                          _value(sess["torch"], t, "kmeans"))
    _close(cj, ct)
    np.testing.assert_array_equal(aj, at)
    jo, to = j.outputs["clusterReport"], t.outputs["clusterReport"]
    assert to["top_cluster_sizes"] == jo["top_cluster_sizes"]
    assert abs(to["inertia"] - jo["inertia"]) <= LEARNER_TOL * abs(jo["inertia"])


def _check_nlp(sess, reps):
    j, t = reps["jax"], reps["torch"]
    _close(_value(sess["jax"], j, "corenlp"), _value(sess["torch"], t, "corenlp"))
    X, _ = _value(sess["jax"], j, "candidates")
    _check_logreg(sess, reps, X, "spouseLR")


NLP_SMALL = TW.NLPKnobs(n_docs=40, vocab=300)
SESSION_CASES = {
    # cold, then a DPR edit and a PPR edit (loads of the learner)
    "census": (TW.build_census, JW.build_census,
               [TW.CensusKnobs(n_rows=3000),
                TW.CensusKnobs(n_rows=3000, use_hours=False),
                TW.CensusKnobs(n_rows=3000, use_hours=False,
                               eval_metric="f1", eval_threshold=0.6)],
               _check_census),
    # cold, then an LI edit (k-means reruns on loaded embeddings) and PPR
    "genomics": (TW.build_genomics, JW.build_genomics,
                 [TW.GenomicsKnobs(n_docs=120, vocab=400, emb_dim=16,
                                   emb_epochs=3, kb_size=40),
                  TW.GenomicsKnobs(n_docs=120, vocab=400, emb_dim=16,
                                   emb_epochs=3, kb_size=40, n_clusters=8),
                  TW.GenomicsKnobs(n_docs=120, vocab=400, emb_dim=16,
                                   emb_epochs=3, kb_size=40, n_clusters=8,
                                   report_top=3)],
                 _check_genomics),
    # the reference's weights handed over; two DPR edits on the loaded parse
    "nlp": (lambda k, **kw: TW.build_nlp(
                k, parse_weights=_reference_parse_weights(k.vocab), **kw),
            JW.build_nlp,
            [NLP_SMALL, dataclasses.replace(NLP_SMALL, pair_window=6),
             dataclasses.replace(NLP_SMALL, pair_window=6, feat_dim=32)],
            _check_nlp),
}


@pytest.mark.parametrize("name", list(SESSION_CASES))
def test_workflow_sessions_match_reference(name, tmp_path):
    tbuild, jbuild, edits, check = SESSION_CASES[name]
    sess = {pkg: _session(pkg, str(tmp_path / pkg)) for pkg in SESSIONS}
    jknobs = getattr(JW, type(edits[0]).__name__)
    seen = set()
    for it, k in enumerate(edits):
        reps = {"jax": sess["jax"].run(jbuild(jknobs(**dataclasses.asdict(k)))),
                "torch": sess["torch"].run(tbuild(k, device="cpu"))}
        assert reps["torch"].sigs == reps["jax"].sigs, it
        assert _states(reps["torch"]) == _states(reps["jax"]), it
        seen.update(_states(reps["torch"]).values())
        check(sess, reps)
    assert seen >= {"COMPUTE", "LOAD"}, seen


def test_incremental_census_matches_reference(tmp_path):
    k0 = TW.IncrementalCensusKnobs(n_chunks=3, rows_per_chunk=300,
                                   feat_dim=32, feat_layers=2)
    k1 = dataclasses.replace(k0, n_chunks=4)
    sess = {pkg: _session(pkg, str(tmp_path / pkg)) for pkg in SESSIONS}
    for k in (k0, k1):
        jk = JW.IncrementalCensusKnobs(**dataclasses.asdict(k))
        j = sess["jax"].run(JW.build_census_incremental(jk))
        t = sess["torch"].run(TW.build_census_incremental(k, device="cpu"))
        assert t.sigs == j.sigs and _states(t) == _states(j)
        assert t.outputs == j.outputs
        assert t.execution.chunk_reused == j.execution.chunk_reused
        assert t.execution.chunk_computed == j.execution.chunk_computed
    assert sum(t.execution.chunk_computed.values()) > 0
    assert sum(t.execution.chunk_reused.values()) > 0


@pytest.mark.parametrize("towers", [1, 3])
@pytest.mark.parametrize("policy", ["NEVER", "ALWAYS", "OPT"])
def test_mnist_fft_nodes_are_recomputed_every_iteration(tmp_path, towers,
                                                        policy):
    k = TW.MNISTKnobs(n_images=300, epochs=5, n_features=48, n_towers=towers)
    ffts = ["randomFFT"] if towers == 1 else [f"fftTower{t}"
                                              for t in range(towers)]
    sess = _session("torch", str(tmp_path), policy)
    for it in range(3):               # identical knobs every time
        rep = sess.run(TW.build_mnist(k, device="cpu"))
        states = _states(rep)
        assert all(states[f] == "COMPUTE" for f in ffts), (it, states)
        assert all(f in rep.original for f in ffts)
        assert "mnist" not in rep.original or it == 0
        assert 0.0 <= rep.outputs["evalAcc"]["top1"] <= 1.0


@pytest.mark.parametrize("name", SURVEY)
def test_builders_refuse_to_run_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("the rule under test is for machines without a card")
    wd = TW.WORKFLOWS[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        wd.build(wd.knobs0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TW.train_logreg(*_logreg_data(20, 3), 0.1, iters=2)
