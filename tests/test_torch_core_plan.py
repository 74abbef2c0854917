"""The port's planning core vs the JAX package's: the same DAGs give the
same signatures, OEP states, OMP decisions (under pinned costs) and
pruning slices, and ``repro_torch.core.tree`` flattens in
``jax.tree_util``'s leaf order. Cases mirror ``tests/test_signature.py``,
``test_oep.py``, ``test_omp.py`` and ``test_pruning.py``."""
import collections
import pickle
import random

import numpy as np
import pytest

import jax

from repro import configs as jconfigs
from repro.core import dag as jdag, oep as joep, omp as jomp
from repro.core import pruning as jpruning, signature as jsignature
from repro.core.workflow import Workflow as JWorkflow
from repro.models import registry as jregistry
from repro_torch.core import dag as tdag, oep as toep, omp as tomp
from repro_torch.core import pruning as tpruning, signature as tsignature
from repro_torch.core import tree
from repro_torch.core.workflow import Workflow as TWorkflow

PKGS = {"jax": (jdag, joep, jomp, jpruning, jsignature),
        "torch": (tdag, toep, tomp, tpruning, tsignature)}


def _names(states):
    return {n: s.name for n, s in states.items()}


def _dag(pkg, spec):
    """``spec``: [(name, parents, kw)] → that package's DAG."""
    dag = PKGS[pkg][0]
    return dag.DAG([dag.Node(n, None, tuple(p), **kw) for n, p, kw in spec])


# -- signatures ---------------------------------------------------------------

def _lin(n=3, versions=None, det=None):
    versions = versions or ["v"] * n
    det = det or [True] * n
    return [(f"n{i}", [f"n{i-1}"] if i else [],
             {"version": versions[i], "deterministic": det[i]})
            for i in range(n)]


SIG_CASES = {
    "identical": (_lin(), None),
    "edited_middle": (_lin(versions=["v", "w", "v"]), None),
    "nondet_pinned": (_lin(det=[True, False, True]), {"n1": "x"}),
    "diamond": ([("a", [], {}), ("b", ["a"], {"version": "1"}),
                 ("c", ["a"], {"version": "2"}),
                 ("d", ["b", "c"], {"is_output": True})], None),
}


@pytest.mark.parametrize("case", sorted(SIG_CASES))
def test_signatures_match_reference(case):
    spec, nonces = SIG_CASES[case]
    sigs = {pkg: PKGS[pkg][4].compute_signatures(_dag(pkg, spec),
                                                 nonces=nonces)
            for pkg in PKGS}
    assert sigs["torch"] == sigs["jax"]


def test_workflow_signatures_and_versions_match_reference():
    """The DSL derives versions from configs (``source_version``) in both
    packages identically, so whole workflows sign the same."""
    def build(cls, k):
        wf = cls("w")
        src = wf.source("src", lambda: None, config={"rows": 10})
        f = wf.extractor("f", lambda x: x, [src], config={"k": k})
        g = wf.learner("g", lambda x: x, [f], config="lr=0.1")
        wf.output(g)
        return wf.build()
    for k in (1, 2):
        assert (tsignature.compute_signatures(build(TWorkflow, k))
                == jsignature.compute_signatures(build(JWorkflow, k)))
    assert (tsignature.source_version({"reg": 0.1})
            == jsignature.source_version({"reg": 0.1}))


# -- OEP ----------------------------------------------------------------------

def _random_instance(seed):
    """As ``tests/test_oep.py::random_instance``, as a spec both packages
    build: a sliced random DAG, costs, loadability and originality."""
    rng = random.Random(seed)
    n = rng.randint(1, 7)
    spec = []
    for i in range(n):
        parents = [f"n{j}" for j in range(i) if rng.random() < 0.4]
        spec.append((f"n{i}", parents,
                     {"is_output": i == n - 1 or rng.random() < 0.2}))
    full = _dag("jax", spec)
    keep = jpruning.slice_from_outputs(full)
    spec = [s for s in spec if s[0] in keep]
    names = full.subgraph(keep).topological()
    cc = {m: rng.randint(1, 20) * 1.0 for m in names}
    lc = {m: (rng.randint(1, 20) * 1.0 if rng.random() < 0.6 else None)
          for m in names}
    orig = {m for m in names if rng.random() < 0.25}
    by_name = {s[0]: s[1] for s in spec}
    changed = True
    while changed:
        changed = False
        for name in names:
            if name not in orig and any(p in orig for p in by_name[name]):
                orig.add(name)
                changed = True
    for o in orig:
        lc[o] = None
    return spec, cc, lc, orig


@pytest.mark.parametrize("seed", range(24))
def test_oep_plan_matches_reference(seed):
    spec, cc, lc, orig = _random_instance(seed)
    out = {}
    for pkg, (_, oep, *_rest) in PKGS.items():
        dag = _dag(pkg, spec)
        states = oep.plan(dag, cc, lc, orig)
        out[pkg] = (_names(states), oep.plan_runtime(dag, states, cc, lc),
                    oep.brute_force_plan(dag, cc, lc, orig)[1])
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1:] == pytest.approx(out["jax"][1:])
    assert out["torch"][1] == pytest.approx(out["torch"][2])   # Theorem 2


FIG4 = [("a", [], {}), ("b", ["a"], {}), ("c", ["b"], {}),
        ("out", ["c"], {"is_output": True})]
OEP_CASES = {
    "fig4_load_c": (FIG4, {"a": 10.0, "b": 10.0, "c": 10.0, "out": 1.0},
                    {"a": None, "b": None, "c": 1.0, "out": None}, {"out"}),
    "fig4_recompute": (FIG4, {"a": 10.0, "b": 10.0, "c": 10.0, "out": 1.0},
                       {"a": None, "b": None, "c": 100.0, "out": None},
                       {"out"}),
    "output_loadable": ([("x", [], {}), ("y", ["x"], {"is_output": True})],
                        {"x": 5.0, "y": 5.0}, {"x": 1.0, "y": 0.1}, set()),
}


@pytest.mark.parametrize("case", sorted(OEP_CASES))
def test_oep_named_cases_match_reference(case):
    spec, cc, lc, orig = OEP_CASES[case]
    got = {pkg: _names(PKGS[pkg][1].plan(_dag(pkg, spec), cc, lc, orig))
           for pkg in PKGS}
    assert got["torch"] == got["jax"]


# -- OMP ----------------------------------------------------------------------

def _chain(n):
    return [(f"n{i}", [f"n{i-1}"] if i else [], {"is_output": i == n - 1})
            for i in range(n)]


def _decisions(pkg, scenario):
    """Run one scenario's ``decide`` calls in one package; returns each
    decision's (materialize, reason, C(n), density)."""
    _, _, omp, _, _ = PKGS[pkg]
    spec, states, runtime, mat_kw, calls = scenario
    mat_kw = dict(mat_kw)
    dag = _dag(pkg, spec)
    st = {n: getattr(PKGS[pkg][0].State, s) for n, s in states.items()}
    mult = mat_kw.pop("mult", None)
    m = omp.Materializer(policy=getattr(omp.Policy, mat_kw.pop("policy")),
                         multiplicity=(None if mult is None
                                       else lambda s: mult.get(s, 0.0)),
                         **mat_kw)
    out = []
    for call in calls:
        if call == "release":
            m.release(10)
            continue
        name, load_s, nbytes, sig = call
        d = m.decide(dag, name, st, runtime, est_load_seconds=load_s,
                     est_bytes=nbytes, sig=sig)
        out.append((d.materialize, d.reason, d.cum_runtime,
                    d.benefit_density, d.needs_eviction))
    return out


C3 = {f"n{i}": "COMPUTE" for i in range(3)}
C2 = {"n0": "COMPUTE", "n1": "COMPUTE"}
C8 = {f"n{i}": "COMPUTE" for i in range(8)}
OMP_CASES = {
    "threshold": (_chain(3), C3, {"n0": 5.0, "n1": 5.0, "n2": 0.1},
                  {"policy": "OPT"},
                  [("n1", 2.0, 10, None), ("n1", 6.0, 10, None)]),
    "loaded_parent": (_chain(3), {"n0": "LOAD", "n1": "COMPUTE",
                                  "n2": "COMPUTE"},
                      {"n0": 1.0, "n1": 2.0, "n2": 4.0}, {"policy": "OPT"},
                      [("n1", 0.5, 10, None), ("n2", 0.5, 10, None)]),
    "budget": (_chain(2), C2, {"n0": 100.0, "n1": 100.0},
               {"policy": "OPT", "storage_budget_bytes": 15},
               [("n0", 0.01, 10, None), ("n1", 0.01, 10, None), "release",
                ("n1", 0.01, 10, None)]),
    "always": (_chain(2), C2, {"n0": 0.001, "n1": 0.001},
               {"policy": "ALWAYS"}, [("n0", 100.0, 1, None)]),
    "never": (_chain(2), C2, {"n0": 0.001, "n1": 0.001},
              {"policy": "NEVER"}, [("n0", 0.0, 1, None)]),
    "nondet_opt": ([("nd", [], {"deterministic": False}),
                    ("out", ["nd"], {"is_output": True})],
                   {"nd": "COMPUTE", "out": "COMPUTE"}, {"nd": 100.0},
                   {"policy": "OPT"}, [("nd", 0.0, 1, None)]),
    "horizon_5": (_chain(2), C2, {"n0": 10.0, "n1": 0.1},
                  {"policy": "OPT", "horizon": 5.0}, [("n0", 6.0, 1, None)]),
    "multiplicity": (_chain(2), C2, {"n0": 10.0, "n1": 0.1},
                     {"policy": "OPT", "mult": {"shared-sig": 4.0}},
                     [("n0", 6.0, 1, "lone-sig"),
                      ("n0", 6.0, 1, "shared-sig")]),
    "pathological_chain": (_chain(8), C8, {f"n{i}": 3.0 for i in range(8)},
                           {"policy": "OPT"},
                           [(f"n{i}", float(i), 1, None)
                            for i in range(2, 8)]),
}


@pytest.mark.parametrize("case", sorted(OMP_CASES))
def test_omp_decisions_match_reference(case):
    got = {pkg: _decisions(pkg, OMP_CASES[case]) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    assert got["jax"]                     # the scenario decided something


def test_cumulative_runtime_matches_reference():
    spec = _chain(3)
    states = {"n0": "LOAD", "n1": "COMPUTE", "n2": "COMPUTE"}
    runtime = {"n0": 1.0, "n1": 2.0, "n2": 4.0}
    got = {}
    for pkg in PKGS:
        st = {n: getattr(PKGS[pkg][0].State, s) for n, s in states.items()}
        got[pkg] = PKGS[pkg][2].cumulative_runtime(_dag(pkg, spec), "n2", st,
                                                   runtime)
    assert got["torch"] == got["jax"] == 7.0


# -- pruning --------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_slice_from_outputs_matches_reference(seed):
    rng = random.Random(1000 + seed)
    n = rng.randint(2, 10)
    spec = [(f"n{i}", [f"n{j}" for j in range(i) if rng.random() < 0.3],
             {"is_output": rng.random() < 0.25 or i == n // 2})
            for i in range(n)]
    assert (tpruning.slice_from_outputs(_dag("torch", spec))
            == jpruning.slice_from_outputs(_dag("jax", spec)))


PRUNE_CASES = {
    "zero_weight": ("zero_weight_extractors",
                    (np.array([0.0, 0.5, 1e-12, 0.0]),
                     {"a": [0, 2], "b": [1], "c": [3], "empty": []})),
    "zero_weight_tol": ("zero_weight_extractors",
                        (np.array([0.0, 0.5, 1e-12, 0.0]),
                         {"a": [0, 2], "b": [1], "c": [3]}, 1.0)),
    "stale_current": ("stale_variants",
                      ({"n": ["sig-old", "sig-cur"], "m": ["sig-m"]},
                       {"n", "m"}, {"n": "sig-cur", "m": "sig-m"})),
    "stale_original_only": ("stale_variants",
                            ({"n": ["old-n"], "m": ["old-m"]}, {"n"},
                             {"n": "cur-n", "m": "cur-m"})),
    "stale_order": ("stale_variants",
                    ({"b": ["b1", "b2"], "a": ["a1"]}, {"a", "b"},
                     {"a": "a-cur", "b": "b-cur"})),
}


@pytest.mark.parametrize("case", sorted(PRUNE_CASES))
def test_pruning_rules_match_reference(case):
    fn, args = PRUNE_CASES[case]
    assert (getattr(tpruning, fn)(*args) == getattr(jpruning, fn)(*args))


# -- tree -----------------------------------------------------------------------

Pair = collections.namedtuple("Pair", "x y")


def test_tree_flattens_reference_params_in_jax_order():
    """Leaf i is the same leaf in both packages: the reference model's
    params (small config) flatten to the same leaves in the same order."""
    cfg = jconfigs.reduced(jconfigs.get("internlm2-1.8b"))
    params = jax.tree_util.tree_map(
        np.asarray, jregistry.init(cfg, jax.random.PRNGKey(0)))
    j_leaves, j_def = jax.tree_util.tree_flatten(params)
    t_leaves, t_def = tree.tree_flatten(params)
    assert len(t_leaves) == len(j_leaves) > 5
    assert all(a is b for a, b in zip(t_leaves, j_leaves))
    rebuilt = tree.tree_unflatten(t_def, t_leaves)
    assert jax.tree_util.tree_structure(rebuilt) == j_def


@pytest.mark.parametrize("case", ["nested", "none_and_tuples", "namedtuple",
                                  "ordered_dict"])
def test_tree_order_and_pickled_treedef_match_jax(case):
    value = {
        "nested": {"b": [1, {"z": 2, "a": 3}], "a": (4, 5), "c": 6},
        "none_and_tuples": (None, [7, None, (8,)], {"k": None, "j": 9}),
        "namedtuple": [Pair(x=1, y={"q": 2, "p": 3}), Pair(4, None)],
        "ordered_dict": collections.OrderedDict([("z", 1), ("a", 2)]),
    }[case]
    t_leaves, t_def = tree.tree_flatten(value)
    assert t_leaves == jax.tree_util.tree_leaves(value)
    t_def = pickle.loads(pickle.dumps(t_def))     # the store's treedef.pkl
    assert tree.tree_unflatten(t_def, t_leaves) == value
    doubled = tree.tree_map(lambda a, b: a + b, value, value)
    assert tree.tree_leaves(doubled) == [2 * x for x in t_leaves]
