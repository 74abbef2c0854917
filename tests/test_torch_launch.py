"""The launch layer's shapes and steps in the port (``repro_torch.launch
.shapes``) against the reference's ``repro.launch.shapes``: the twins of
``tests/test_launch.py``'s cases, every ``ASSIGNED`` config's input specs
leaf for leaf, every sharding of ``build_step`` on the 16×16 and 2×16×16
meshes, and the reduced steps that ``build_step`` returns run on a (1, 1)
``gloo`` mesh against the reference's eager steps. The reference's own
lowering of those steps fails (``test_build_step_lowers_on_local_mesh``),
so the port's steps are held against its eager ones instead."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import make_abstract_mesh
from repro import configs as jconfigs
from repro.launch import shapes as jshapes
from repro.launch.dryrun import model_flops as jmodel_flops
from repro.models import registry as jregistry
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import dryrun as tdryrun, mesh as tmesh
from repro_torch.launch import shapes as tshapes
from repro_torch.models import registry as tregistry
from repro_torch.optim import adamw as tadamw
from repro_torch.sharding.activation import use_mesh
from repro_torch.train import steps as tsteps
from test_torch_moe import port_picks, reference_picks

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# bf16 steps on the same weights and picks (the MoE tests' bounds)
REL_TOL = 3e-2
LOSS_RTOL = 1e-3
GNORM_RTOL = 1e-2


@pytest.fixture(autouse=True)
def no_process_group():
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def small_shape(name, **kw):
    """``SHAPES[name]`` replaced in both packages for the block."""
    old_j, old_t = jshapes.SHAPES[name], tshapes.SHAPES[name]
    jshapes.SHAPES[name] = dataclasses.replace(old_j, **kw)
    tshapes.SHAPES[name] = dataclasses.replace(old_t, **kw)
    try:
        yield
    finally:
        jshapes.SHAPES[name], tshapes.SHAPES[name] = old_j, old_t


def rel_err(want, got) -> float:
    a = np.asarray(want, np.float32)
    b = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        got, np.float32)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


# ------------------------------------------------------------- test_launch twins
def test_cells_cover_assignment():
    total = 0
    for name in tconfigs.ASSIGNED:
        cs = tshapes.cells(tconfigs.get(name))
        assert cs == jshapes.cells(jconfigs.get(name))
        assert "train_4k" in cs and "prefill_32k" in cs and "decode_32k" in cs
        total += len(cs)
    assert total == 33        # 10 archs × 3 + long_500k for 3 of them


def test_long500k_policy():
    for name in tconfigs.ASSIGNED:
        assert tshapes.long_ok(tconfigs.get(name)) == jshapes.long_ok(
            jconfigs.get(name)), name
    assert tshapes.long_ok(tconfigs.get("mamba2-130m"))
    assert not tshapes.long_ok(tconfigs.get("yi-9b"))
    assert not tshapes.long_ok(tconfigs.get("whisper-medium"))


def test_input_specs_shapes():
    cfg = tconfigs.get("internlm2-1.8b")
    state, batch = tshapes.input_specs(cfg, "train_4k")
    assert batch["tokens"].shape == (256, 4096)
    params, tok, cache = tshapes.input_specs(cfg, "decode_32k")
    assert tok.shape == (128, 1)
    assert cache["k"].shape == (24, 128, 32768, 8, 128)
    assert cache["pos"] == 0
    # nothing allocated anywhere
    for leaf in tree_leaves((state, batch, params, tok, cache)):
        assert not isinstance(leaf, torch.Tensor) or leaf.is_meta


def test_vlm_audio_input_specs():
    vlm = tconfigs.get("qwen2-vl-7b")
    _, batch = tshapes.input_specs(vlm, "train_4k")
    assert batch["vision_embeds"].shape == (256, 1024, vlm.d_model)
    assert batch["mrope_positions"].shape == (3, 256, 4096)
    aud = tconfigs.get("whisper-medium")
    _, batch = tshapes.input_specs(aud, "train_4k")
    assert batch["frames"].shape == (256, 4096, aud.d_model)
    assert batch["tokens"].shape == (256, 448)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internlm2-1.8b"])
def test_model_flops_conventions(arch):
    cfg = tconfigs.get(arch)
    assert tdryrun.model_flops(cfg, "train_4k") == pytest.approx(
        6 * cfg.active_param_count() * 256 * 4096)
    assert tdryrun.model_flops(cfg, "decode_32k") == pytest.approx(
        2 * cfg.active_param_count() * 128)
    for shape in jshapes.SHAPES:
        assert tdryrun.model_flops(cfg, shape) == jmodel_flops(
            jconfigs.get(arch), shape)


# ------------------------------------------------------------- input specs
def _cells():
    return [(n, c) for n in tconfigs.ASSIGNED
            for c in tshapes.cells(tconfigs.get(n))]


def _leaves_with_names(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_names(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _leaves_with_names(t, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,shape", _cells())
def test_input_specs_match_reference(arch, shape):
    """Every leaf's shape and dtype of the step's arguments equals the
    reference's ``input_specs`` (``jax.eval_shape``); the cache's ``pos``
    is a host 0 where the reference keeps an int32 scalar."""
    want = list(_leaves_with_names(jshapes.input_specs(jconfigs.get(arch),
                                                       shape)))
    got = list(_leaves_with_names(tshapes.input_specs(tconfigs.get(arch),
                                                      shape)))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, j), (_, t) in zip(want, got):
        if name.endswith("/pos"):
            assert t == 0 and tuple(j.shape) == () and j.dtype == jnp.int32
            continue
        assert t.is_meta, name
        assert tuple(t.shape) == tuple(j.shape), name
        assert str(t.dtype).removeprefix("torch.") == np.dtype(j.dtype).name


# ------------------------------------------------------------- shardings
def _spec_cases():
    out = []
    for arch, shape in _cells():
        for mesh_id in MESHES:
            rulesets = [None]
            if tshapes.SHAPES[shape].kind == "train":
                rulesets += ["train_tp_only", "train_fsdp"]
            out += [(arch, shape, mesh_id, r) for r in rulesets]
    return out


@pytest.mark.parametrize("arch,shape,mesh_id,ruleset", _spec_cases())
def test_build_step_shardings_match_reference(arch, shape, mesh_id, ruleset,
                                              monkeypatch):
    """Every entry of ``in_shardings`` and ``out_shardings`` equals the
    reference's ``PartitionSpec`` from ``build_step`` on an abstract mesh
    (the port resolves against ``{axis: size}``), and ``donate`` its
    argnums."""
    sizes, names = MESHES[mesh_id]
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    sh = tshapes.SHAPES[shape]

    def cache_shapes(fn, params, batch):
        cache = tregistry.init_cache(tcfg, sh.batch, sh.seq, device="meta")
        return dict(cache, pos=sh.seq)

    monkeypatch.setattr(tshapes, "shapes", cache_shapes)
    _, _, jin, jout, jdonate = jshapes.build_step(
        jcfg, shape, make_abstract_mesh(sizes, names), ruleset_name=ruleset)
    _, _, tin, tout, tdonate = tshapes.build_step(
        tcfg, shape, dict(zip(names, sizes)), ruleset_name=ruleset)
    assert tdonate == jdonate
    for jtree, ttree in ((jin, tin), (jout, tout)):
        want = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
            jtree, is_leaf=lambda x: hasattr(x, "spec"))]
        got = [s.spec for s in tree_leaves(ttree)]
        assert got == want


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-4b",
                                  "mamba2-130m", "whisper-medium"])
def test_prefill_cache_shapes_are_init_cache(arch):
    """``shapes`` of the reduced prefill step gives ``init_cache``'s
    leaves, ``pos`` advanced by the prompt, as ``jax.eval_shape`` gives
    the reference's."""
    cfg = tconfigs.reduced(tconfigs.get(arch))
    b, s = 2, 16
    params = tshapes._params_sds(cfg)
    batch = {"tokens": tshapes._meta((b, s), torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = tshapes._meta((b, s, cfg.d_model), torch.bfloat16)
    got = tshapes.shapes(
        lambda p, x: tsteps.prefill_step(cfg, p, x, max_len=32)[1],
        params, batch)
    if cfg.family == "audio":
        want = tregistry.encdec.init_cache(cfg, b, 32, s, "meta")
    else:
        want = tregistry.init_cache(cfg, b, 32, "meta")
    assert sorted(got) == sorted(want) and got["pos"] == s
    for k, t in want.items():
        if k != "pos":
            assert got[k].is_meta and got[k].shape == t.shape, k
            assert got[k].dtype == t.dtype, k


# ------------------------------------------------------------- the steps run
def _weights(name):
    """(reference cfg, port cfg, reference params, port params): the
    reduced config, ``remat="none"`` (one top-k call a layer a step), the
    port's seeded init carried to JAX bit for bit."""
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(name)),
                               remat="none")
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get(name)),
                               remat="none")
    tparams = tregistry.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    jparams = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy(),
                              getattr(jnp, str(t.dtype).removeprefix("torch."))),
        tparams)
    return jcfg, tcfg, jparams, tparams


@contextlib.contextmanager
def local_step(tcfg, shape, ruleset=None):
    """``build_step``'s step on a (1, 1) gloo mesh, run on the local
    tensors inside ``use_mesh`` as ``launch.train`` and ``launch.serve``
    step them on one device (the dry run's DTensor traces are held in
    ``test_torch_dryrun.py``). The mesh and its group live for the
    block."""
    with tmesh.local_mesh("cpu") as mesh:
        fn, _, in_sh, _, _ = tshapes.build_step(tcfg, shape, mesh,
                                                ruleset_name=ruleset)
        assert all(e is None for s in tree_leaves(in_sh) for e in s.spec)

        def run(*args):
            with use_mesh(mesh):
                return fn(*args)
        yield run


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_build_step_runs_on_local_mesh(shape):
    """The reduced granite-moe's step from ``build_step`` on a (1, 1) gloo
    mesh (every sharding collapses to replicated) against the reference's
    eager step on the same weights and, for the MoE layers, the
    reference's top-k picks."""
    jcfg, tcfg, jparams, tparams = _weights("granite-moe-1b-a400m")
    b, s = 2, 64
    tok = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (b, s if shape != "decode_32k" else 1)
    ).astype(np.int32)
    with small_shape(shape, seq=s, batch=b):
        if shape == "train_4k":
            jstate = jsteps.TrainState(params=jparams,
                                       opt=jadamw.init(jparams))
            with reference_picks() as picks:
                jnew, jmet = jax.jit(lambda st, x: jsteps.train_step(
                    jcfg, st, x))(jstate, {"tokens": jnp.asarray(tok)})
                jax.effects_barrier()
            tstate = tsteps.TrainState(params=tparams,
                                       opt=tadamw.init(tparams))
            with local_step(tcfg, shape) as run, port_picks(picks):
                tnew, tmet = run(tstate, {"tokens": torch.from_numpy(tok)})
            assert rel_err(jmet["loss"], tmet["loss"]) < LOSS_RTOL
            assert rel_err(jmet["grad_norm"], tmet["grad_norm"]) < GNORM_RTOL
            for j, t in zip(jax.tree_util.tree_leaves(jnew.params),
                            tree_leaves(tnew.params)):
                assert rel_err(j, t) < REL_TOL
            assert int(tnew.opt.step) == int(jnew.opt.step) == 1
            return
        if shape == "prefill_32k":
            with reference_picks() as picks:
                jlog, jcache = jax.jit(lambda p, x: jsteps.prefill_step(
                    jcfg, p, x, max_len=s))(jparams,
                                            {"tokens": jnp.asarray(tok)})
                jax.effects_barrier()
            with local_step(tcfg, shape) as run, port_picks(picks):
                tlog, tcache = run(tparams, {"tokens": torch.from_numpy(tok)})
        else:
            jcache0 = jax.tree_util.tree_map(
                jnp.asarray, jregistry.init_cache(jcfg, b, s))
            with reference_picks() as picks:
                jlog, jcache = jax.jit(lambda p, t, c: jsteps.decode_step(
                    jcfg, p, t, c))(jparams, jnp.asarray(tok), jcache0)
                jax.effects_barrier()
            tcache0 = tregistry.init_cache(tcfg, b, s, "cpu")
            with local_step(tcfg, shape) as run, port_picks(picks):
                tlog, tcache = run(tparams, torch.from_numpy(tok), tcache0)
    assert tlog.shape == tuple(jlog.shape)
    assert bool(torch.isfinite(tlog.float()).all())
    assert rel_err(jlog, tlog) < REL_TOL
    assert tcache["pos"] == int(jcache["pos"])
    for k in ("k", "v"):
        assert rel_err(jcache[k], tcache[k]) < REL_TOL, k


def test_fsdp_ruleset_build():
    """train_fsdp spreads the batch over (pod, data, model) and strips TP;
    its reduced step runs on a (1, 1) gloo mesh (every spec collapses to
    replicated) and gives the meshless step's loss, grad norm and params
    bit for bit."""
    cfg = tconfigs.reduced(tconfigs.get("internlm2-1.8b"))
    params = tregistry.init(cfg, torch.Generator().manual_seed(1), "cpu")
    state = tsteps.TrainState(params=params, opt=tadamw.init(params))
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32))
    with small_shape("train_4k", seq=32, batch=4), \
            local_step(cfg, "train_4k", "train_fsdp") as run:
        new, met = run(state, {"tokens": tok})
    want, wmet = tsteps.train_step(cfg, state, {"tokens": tok})
    assert torch.equal(met["loss"], wmet["loss"])
    assert torch.equal(met["grad_norm"], wmet["grad_norm"])
    for a, b in zip(tree_leaves(new.params), tree_leaves(want.params)):
        assert torch.equal(a, b)
