"""The port's sharding substrate vs the JAX package's, on the CPU.

``models.params.param_specs`` against the reference's on the same axis
names and sizes: the seven cases of ``tests/test_sharding.py`` (each
with its own expectation, the reference's spec made on
``conftest.make_abstract_mesh``, the port's from a ``{name: size}``
mapping), then every config of the port's registry, full and reduced,
under each rule set and four meshes, leaf for leaf by path. Then what has
no reference twin: DTensor ``placements`` of a spec, ``constrain``'s entry
resolution (a table taken from the reference's loop) and what it returns,
the local mesh on ``gloo`` (started from an in-process store, no
``MASTER_ADDR``), ``place`` aliasing storage, a two-process ``gloo`` mesh
in subprocesses, and the train and serve launchers bitwise a run with no
mesh. No test here leaves a process group running.
"""
import functools
import os
import subprocess
import sys
import threading

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec

from conftest import make_abstract_mesh
from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.models.params import P as JP, param_specs as jparam_specs
from repro.sharding import rules as jrules
from repro_torch import configs as tconfigs
from repro_torch.core.tree import tree_leaves
from repro_torch.data import synth
from repro_torch.data.pipeline import TokenBatcher, batch_to
from repro_torch.launch import mesh as tmesh, serve as tserve, train as ttrain
from repro_torch.models import params as tparams, registry as tregistry
from repro_torch.sharding import activation as tact, rules as trules
from repro_torch.train import steps as tsteps

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SRC = os.path.join(ROOT, "src")

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
RULES = {"default": None, **{name: name for name in trules.RULESETS}}


@pytest.fixture(autouse=True)
def no_process_group():
    """No process group before or after each test."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def reference_specs(cfg_name, reduced, mesh_id, rules=None):
    cfg = jconfigs.get(cfg_name)
    if reduced:
        cfg = jconfigs.reduced(cfg)
    sizes, names = MESHES[mesh_id]
    specs = jparam_specs(jregistry.param_defs(cfg),
                         make_abstract_mesh(sizes, names), rules)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {jax.tree_util.keystr(p): tuple(v) for p, v in flat}


def by_path(tree, prefix=""):
    """The port's spec tree by the reference's ``keystr`` paths (a tuple
    is a spec, so a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(by_path(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, t in enumerate(tree):
            out.update(by_path(t, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def port_specs(cfg_name, reduced, mesh_id, rules=None):
    cfg = tconfigs.get(cfg_name)
    if reduced:
        cfg = tconfigs.reduced(cfg)
    sizes, names = MESHES[mesh_id]
    return by_path(tparams.param_specs(tregistry.param_defs(cfg),
                                       dict(zip(names, sizes)), rules))


def both(cfg_name, mesh_id, reduced=False):
    """The reference's and the port's specs by path, required equal."""
    want = reference_specs(cfg_name, reduced, mesh_id)
    got = port_specs(cfg_name, reduced, mesh_id)
    assert got == want
    return got


# ------------------------------------------------- twins of test_sharding.py
def test_dense_2d_sharding():
    specs = both("yi-9b", "16x16")
    assert specs["['embed']"] == ("model", "data")
    assert specs["['blocks']['attn']['wq']"][:3] == (None, "data", "model")


def test_kv_heads_fallback_replicated():
    specs = both("yi-9b", "16x16")     # kv=4 < 16-way model axis
    assert specs["['blocks']['attn']['wk']"] == (None, "data")


def test_granite_gets_expert_parallelism():
    specs = both("granite-moe-1b-a400m", "16x16")   # 32 experts % 16 == 0
    assert specs["['blocks']['moe']['w_gate']"] == (None, "model", "data")


def test_qwen2moe_falls_back_to_expert_tp():
    specs = both("qwen2-moe-a2.7b", "16x16")        # 60 experts % 16 != 0
    assert specs["['blocks']['moe']['w_gate']"] == (None, None, "data",
                                                     "model")


def test_axis_used_once_per_tensor():
    sizes, names = MESHES["16x16"]
    want = tuple(jparam_specs({"w": JP((32, 32), ("mlp", "heads"))},
                              make_abstract_mesh(sizes, names))["w"])
    got = tparams.param_specs({"w": tparams.P((32, 32), ("mlp", "heads"))},
                              dict(zip(names, sizes)))["w"]
    assert got == want
    assert [e for e in got if e is not None].count("model") <= 1


def test_multipod_mesh_resolution():
    specs = both("internlm2-1.8b", "pod2x16x16")
    assert "model" in specs["['blocks']['attn']['wq']"]


def test_single_device_mesh_all_replicated():
    specs = both("internlm2-1.8b", "1x1", reduced=True)
    assert all(all(e is None for e in s) for s in specs.values())


# ------------------------------------------------------------ parity sweep
@functools.lru_cache(maxsize=None)
def _reference(cfg_name, reduced, mesh_id, rules_name):
    rules = None if rules_name is None else jrules.RULESETS[rules_name]
    return reference_specs(cfg_name, reduced, mesh_id, rules)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("rules_name", list(RULES))
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("cfg_name", list(tconfigs.ARCHS))
def test_param_specs_match_reference(cfg_name, reduced, rules_name, mesh_id):
    """Every leaf's spec, by path, under ``rules_name`` (``default``:
    ``DEFAULT_RULES`` alone) equals the reference's ``param_specs``."""
    name = RULES[rules_name]
    assert trules.RULESETS == jrules.RULESETS
    assert trules.BATCH_AXES_BY_RULESET == jrules.BATCH_AXES_BY_RULESET
    rules = None if name is None else trules.RULESETS[name]
    want = _reference(cfg_name, reduced, mesh_id, name)
    got = port_specs(cfg_name, reduced, mesh_id, rules)
    assert set(got) == set(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


def test_default_rules_match_reference():
    from repro.models.params import DEFAULT_RULES
    assert tparams.DEFAULT_RULES == DEFAULT_RULES


def test_rule_naming_an_absent_axis_raises_in_both():
    """A rule naming an axis the mesh lacks: the reference reads its size
    before it checks the mesh for it, and raises ``KeyError``; so does
    the port."""
    rules = {"embed": ("pod",)}
    with pytest.raises(KeyError):
        reference_specs("yi-9b", False, "16x16", rules)
    with pytest.raises(KeyError):
        port_specs("yi-9b", False, "16x16", rules)


# -------------------------------------------------------------- placements
def test_placements_of_specs_on_a_16x16_mesh():
    """Made without a process group, from the mesh's dim names."""
    from torch.distributed.tensor import Replicate, Shard
    names = ("data", "model")
    cases = [
        ((), 2, (Replicate(), Replicate())),
        (("model", "data"), 2, (Shard(1), Shard(0))),
        ((None, "data", "model"), 4, (Shard(1), Shard(2))),
        ((None, "model"), 3, (Replicate(), Shard(1))),
        ((("data", "model"),), 2, (Shard(0), Shard(0))),
    ]
    for spec, ndim, want in cases:
        assert tact.placements(spec, ndim, names) == want, spec
    # every full config's specs on the 16x16 mesh give placements
    specs = port_specs("qwen2-moe-a2.7b", False, "16x16")
    for spec in specs.values():
        assert len(tact.placements(spec, len(spec), names)) == 2


def test_placements_refuse_what_dtensor_would_shard_otherwise():
    names = ("pod", "data", "model")
    with pytest.raises(ValueError, match="order"):
        tact.placements((("model", "data"),), 1, names)
    with pytest.raises(ValueError, match="order"):
        tact.placements(((("data", "pod")),), 1, names)
    with pytest.raises(ValueError, match="twice"):
        tact.placements(("data", "data"), 2, names)
    with pytest.raises(KeyError):
        tact.placements(("expert",), 1, names)
    with pytest.raises(ValueError, match="more entries"):
        tact.placements(("data", None), 1, names)


# --------------------------------------------------------------- constrain
# (shape, axes, {axis: size}) -> entries: the reference's loop at
# src/repro/sharding/activation.py:56-69
RESOLVE_TABLE = [
    ((8, 6, 4), (("pod", "data"), None, "model"), {"data": 4, "model": 2},
     ("data", None, "model")),
    ((8, 6, 5), (("pod", "data"), None, "model"), {"data": 4, "model": 2},
     ("data", None, None)),                       # 5 % 2: not bound
    ((6, 4), ("data", "model"), {"data": 4, "model": 2},
     (None, "model")),                            # 6 % 4
    ((16,), (("data", "model"),), {"data": 4, "model": 2},
     (("data", "model"),)),
    ((12,), (("data", "model"),), {"data": 4, "model": 2},
     (None,)),                                    # 12 % 8
    ((16,), (("pod", "data"),), {"pod": 2, "data": 4, "model": 2},
     (("pod", "data"),)),
    ((8,), ("pod",), {"data": 4, "model": 2}, (None,)),   # no such axis
    ((8, 8), ("data", "model"), {"data": 1, "model": 1},
     (None, None)),                               # size-1 axes
    ((8, 8), (("data", "model"), None), {"data": 2, "model": 1},
     (("data", "model"), None)),                  # a size-1 axis stays in
    ((8, 8), (("model", "data"),), {"data": 2, "model": 2},
     (("model", "data"),)),                       # the entry's own order
    ((8, 4, 2), ("data",), {"data": 4}, ("data",)),   # fewer axes than dims
]


@pytest.mark.parametrize("shape,axes,sizes,want", RESOLVE_TABLE)
def test_constrain_entry_resolution(shape, axes, sizes, want):
    assert tact.resolve_entries(shape, axes, sizes) == want


def test_constrain_returns_its_input_itself_without_a_binding_axis():
    """With no mesh, and under a gloo (1, 1) mesh for a plain tensor and
    for a DTensor: the same object."""
    from torch.distributed.tensor import DTensor, Replicate
    x = torch.randn(4, 8, 16)
    assert tact.constrain(x, tact.batch_axes(), None, "model") is x
    mesh = tmesh.make_local_mesh("cpu")
    d = DTensor.from_local(x, mesh, (Replicate(), Replicate()),
                           run_check=False)
    with tact.use_mesh(mesh):
        assert tact.active_mesh() is mesh
        assert tact.constrain(x, tact.batch_axes(), None, None) is x
        assert tact.constrain(x, ("pod", "data"), None, "model") is x
        assert tact.constrain(d, tact.batch_axes(), None, None) is d
    assert tact.active_mesh() is None


TWO_RANKS = r"""
import sys
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import mesh as tmesh
from repro_torch.models import params as tparams
from repro_torch.sharding import activation as tact
rank, path = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(path, 2), rank=rank,
                        world_size=2)
mesh = tmesh.make_local_mesh("cpu")
assert tuple(mesh.shape) == (2, 1), mesh.shape
assert tact.axis_sizes(mesh) == {"data": 2, "model": 1}
full = torch.arange(4 * 3 * 6, dtype=torch.float32).reshape(4, 3, 6)
x = DTensor.from_local(full, mesh, (Replicate(), Replicate()),
                       run_check=False)
with tact.use_mesh(mesh):
    y = tact.constrain(x, tact.batch_axes(), None, "model")
    assert y is not x
    assert tuple(y.placements) == (Shard(0), Replicate()), y.placements
    assert torch.equal(y.to_local(), full[2 * rank:2 * rank + 2])
    assert torch.equal(y.full_tensor(), full)
    try:
        tact.constrain(full, tact.batch_axes(), None, None)
        raise SystemExit("a plain tensor under a binding axis passed")
    except NotImplementedError as e:
        assert "plain tensor" in str(e) and "DTensors" in str(e), e
try:
    tparams.place({"w": full}, {"w": tparams.NamedSharding(mesh, ())})
    raise SystemExit("place on two devices passed")
except NotImplementedError as e:
    assert "9d" in str(e), e
dist.destroy_process_group()
print("ok", rank)
"""


def test_constrain_redistributes_a_dtensor_on_two_gloo_ranks(tmp_path):
    """Two processes, one gloo group from a ``FileStore``: a replicated
    DTensor under ``constrain(x, batch_axes(), None, "model")`` on the
    (2, 1) local mesh comes back sharded over "data" (each rank its half
    of the batch, the whole tensor gathered back); a plain tensor under
    the same binding raises, naming the DTensors a sharded step takes,
    and so does ``place`` (item 9d)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("MASTER_ADDR", None)
    env.pop("MASTER_PORT", None)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", TWO_RANKS, str(r), store],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=180))
        finally:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-3000:]
        assert out.split() == ["ok", str(r)], out


def test_use_batch_axes_nests_and_is_per_thread():
    seen = {}

    def other():
        seen["other"] = tact.batch_axes()

    assert tact.batch_axes() == tact.BATCH_AXES == ("pod", "data")
    with tact.use_batch_axes(("pod", "data", "model")):
        assert tact.batch_axes() == ("pod", "data", "model")
        with tact.use_batch_axes(["data"]):
            assert tact.batch_axes() == ("data",)
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        assert tact.batch_axes() == ("pod", "data", "model")
    assert tact.batch_axes() == tact.BATCH_AXES
    assert seen["other"] == tact.BATCH_AXES
    assert tact.SEQ_AXES == ("data",)


# -------------------------------------------------------------- local mesh
def test_local_mesh_starts_gloo_from_a_store_and_is_idempotent(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    first = tmesh.make_local_mesh("cpu")
    group = dist.group.WORLD
    second = tmesh.make_local_mesh("cpu")
    assert dist.group.WORLD is group               # the group reused
    assert first == second
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert tuple(first.shape) == (1, 1)
    assert first.mesh_dim_names == ("data", "model")
    assert first.device_type == "cpu"
    assert tact.axis_sizes(first) == {"data": 1, "model": 1}


def test_local_mesh_block_destroys_only_the_group_it_started():
    with tmesh.local_mesh("cpu") as mesh:
        assert dist.is_initialized() and mesh.size() == 1
    assert not dist.is_initialized()
    tmesh.make_local_mesh("cpu")
    with tmesh.local_mesh("cpu"):
        pass
    assert dist.is_initialized()                   # it was running before


def test_production_mesh_needs_its_devices():
    with pytest.raises(RuntimeError, match="need 256 devices, have 1"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 devices, have 1"):
        tmesh.make_production_mesh(multi_pod=True)


def test_place_aliases_storage_at_one_device():
    from torch.distributed.tensor import DTensor, Replicate
    cfg = tconfigs.reduced(tconfigs.get("internlm2-1.8b"))
    mesh = tmesh.make_local_mesh("cpu")
    state = tsteps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    placed = tparams.place(state, ttrain.state_shardings(cfg, mesh))
    back = tparams.local(placed)
    leaves, placed_leaves = tree_leaves(state), tree_leaves(placed)
    assert len(leaves) == len(placed_leaves) == len(tree_leaves(back))
    for t, d, b in zip(leaves, placed_leaves, tree_leaves(back)):
        assert isinstance(d, DTensor)
        assert d.placements == (Replicate(), Replicate())
        assert d.to_local().untyped_storage().data_ptr() == \
            t.untyped_storage().data_ptr()
        assert b.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
        assert b.shape == t.shape and b.dtype == t.dtype
    with pytest.raises(ValueError, match="moves nothing"):
        tparams.place({"w": torch.empty(2, device="meta")},
                      {"w": tparams.NamedSharding(mesh, ())})


# --------------------------------------------------------------- launchers
def test_train_main_on_the_mesh_is_bitwise_a_run_without_one(tmp_path):
    """``launch.train.main`` (local mesh, state placed under TRAIN_2D)
    for two steps: the losses and every leaf of the state bitwise those
    of ``train_step`` on the same init and batches with no mesh; no
    process group left."""
    args = ["--device", "cpu", "--reduced", "--arch", "internlm2-1.8b",
            "--steps", "2", "--batch", "2", "--seq", "16", "--log-every", "1",
            "--workdir", str(tmp_path)]
    res = ttrain.main(args)
    assert not dist.is_initialized()
    cfg = tconfigs.reduced(tconfigs.get("internlm2-1.8b"))
    state = tsteps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    tokens = synth.lm_tokens(0, max(2_000_000, 2 * 17 * 4), cfg.vocab_size)
    batcher = TokenBatcher(tokens, 2, 16, seed=0)
    losses = []
    for step in range(2):
        state, metrics = tsteps.train_step(
            cfg, state, batch_to(batcher.batch_at(step), "cpu"),
            peak_lr=3e-3, warmup_steps=20, total_steps=2)
        losses.append(float(metrics["loss"]))
    assert res.losses == losses
    got, want = tree_leaves(res.state), tree_leaves(state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert type(a) is torch.Tensor
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_serve_main_on_the_mesh_gives_the_tokens_of_a_run_without_one():
    res = tserve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                       "8", "--gen-tokens", "3"])
    assert not dist.is_initialized()
    cfg = tconfigs.reduced(tconfigs.get("internlm2-1.8b"))
    params = tregistry.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = synth.lm_tokens(0, 2 * 8 + 1, cfg.vocab_size)
    want = tserve.run(cfg, params, toks[:16].reshape(2, 8), 3, device="cpu")
    assert torch.equal(res.tokens, want.tokens)
    assert torch.equal(res.last_logits, want.last_logits)


def test_shardings_for_on_the_local_mesh_are_replicated():
    from torch.distributed.tensor import Replicate
    mesh = tmesh.make_local_mesh("cpu")
    cfg = tconfigs.get("internlm2-1.8b")
    defs = tregistry.param_defs(cfg)
    for name in ("train_2d", "serve"):
        sh = tparams.shardings_for(defs, mesh, trules.RULESETS[name])
        leaves = tree_leaves(sh)
        assert len(leaves) == len(tree_leaves(defs))
        for s in leaves:
            assert s.mesh is mesh and all(e is None for e in s.spec)
            assert s.placements == (Replicate(), Replicate())
