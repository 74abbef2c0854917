"""The MoE block's sharded forms on the port (``moe_block_sharded``,
expert tensor parallelism, and ``moe_block_a2a``, expert parallelism
through two all-to-alls), the twins of ``tests/test_moe_parallel.py``
case for case, and more.

- On a (1, 1) ``gloo`` mesh with plain tensors, each form against the
  reference's ``moe_block`` on ``_setup``'s inputs (the reference test's
  own recipe: a tie-free router, scaled by 50), at its bounds.
- On real ``gloo`` ranks, processes of their own (one ``FileStore`` a
  group, as ``tests/test_torch_sharded_step.py`` runs them): eight ranks
  on a (2, 4) mesh of ("data", "model"), four on a (2, 2) and a (1, 4)
  mesh, with the weights and tokens laid out as DTensors. Drop-free
  (capacity factor E), each form's output, aux loss, ``dx`` and every
  parameter's gradient against the meshless ``moe_block``'s, fp32 at
  1e-5. At granite's capacity factor 1.25, where drops follow the
  shard's tokens: ``moe_block_sharded`` equals the meshless block run on
  each data shard's rows in turn, and on the (2, 4) mesh both forms equal
  the reference's own forms on a (2, 4) mesh of 8 forced host devices,
  run in a JAX subprocess and passed across as numpy. The router there is
  checked to be tie-free (a gap between the k-th and the next probability
  of every token), so that both programs pick the same experts.
- A (1, 4) mesh does not divide 6 experts: ``moe_block_a2a`` falls back
  to ``moe_block_sharded`` and gives its bits.
- The reduced granite-moe's train step on a (1, 1) mesh, its MoE layers
  through ``moe_block_sharded``'s local body and all-reduces over the
  one-rank group, gives the meshless step's bits.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

from repro.models.moe import moe_block as jmoe_block
from repro_torch import configs as tconfigs
from repro_torch.core.tree import tree_leaves
from repro_torch.launch.mesh import local_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.config import MoECfg
from repro_torch.sharding.activation import use_mesh
from repro_torch.train import steps
from test_moe_parallel import _setup

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SRC = os.path.join(ROOT, "src")
TOL = 1e-5           # fp32, relative to the reference's max |value|
FORMS = {"sharded": tmoe.moe_block_sharded, "a2a": tmoe.moe_block_a2a}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _torch_tree(p):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), p)


# ------------------------------------------------ twins, on a (1, 1) mesh
@pytest.mark.parametrize("impl", ["sharded", "a2a"])
def test_parallel_impls_match_einsum(impl):
    mcfg, p, x = _setup()
    o1, a1 = jmoe_block(mcfg, p, x)
    tcfg = MoECfg(**dataclasses.asdict(mcfg))
    with local_mesh("cpu") as mesh, use_mesh(mesh), torch.no_grad():
        o2, a2 = FORMS[impl](tcfg, _torch_tree(p),
                             torch.from_numpy(np.asarray(x)))
    np.testing.assert_allclose(np.asarray(o1), o2.numpy(), atol=1e-5,
                               rtol=1e-4)
    assert abs(float(a1) - float(a2)) < 1e-4


def test_a2a_falls_back_when_indivisible():
    """The reference's case (6 experts on the local mesh, which 1 divides:
    the a2a path itself) is finite; the fallback proper, 6 experts on a
    4-way model axis, is held on the ranks below."""
    mcfg, p, x = _setup(e=6, k=2)
    tcfg = MoECfg(**dataclasses.asdict(mcfg))
    with local_mesh("cpu") as mesh, use_mesh(mesh), torch.no_grad():
        o, _ = tmoe.moe_block_a2a(tcfg, _torch_tree(p),
                                  torch.from_numpy(np.asarray(x)))
    assert torch.isfinite(o).all()


# ------------------------------------------------ real ranks
WEIGHTS = r'''
import numpy as np


def weights(shared, e=8, seed=0):
    """Weights and tokens of one case, numpy fp32 from a seed."""
    rng = np.random.default_rng(seed + 10 * shared + e)
    d, ff, sff = 32, 16, 24
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = {"router": f(d, e) * 0.5, "w_gate": f(e, d, ff) * 0.2,
         "w_up": f(e, d, ff) * 0.2, "w_down": f(e, ff, d) * 0.2}
    if shared:
        p["shared"] = {"w_gate": f(d, sff) * 0.2, "w_up": f(d, sff) * 0.2,
                       "w_down": f(sff, d) * 0.2}
        p["shared_gate"] = f(d, 1)
    return p, f(4, 16, d), f(4, 16, d)
'''

REFERENCE = WEIGHTS + r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.models.config import MoECfg
from repro.models.moe import moe_block_a2a, moe_block_sharded
out = {}
mesh = jax.make_mesh((2, 4), ("data", "model"))
for shared in (0, 1):
    mcfg = MoECfg(num_experts=8, top_k=2, expert_d_ff=16,
                  capacity_factor=1.25, num_shared=shared, shared_d_ff=24)
    p, x, _ = weights(shared)
    with mesh:
        for name, impl in (("a2a", moe_block_a2a),
                           ("sharded", moe_block_sharded)):
            o, a = jax.jit(lambda p, x: impl(mcfg, p, x))(p, x)
            out[f"{name}.{shared}.out"] = np.asarray(o)
            out[f"{name}.{shared}.aux"] = np.asarray(a)
np.savez(sys.argv[1], **out)
'''

RANKS = WEIGHTS + r'''
import json, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from repro_torch.models import moe
from repro_torch.models.config import MoECfg
from repro_torch.sharding.activation import use_mesh

rank, world, store, ref_path = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
FORMS = {"sharded": moe.moe_block_sharded, "a2a": moe.moe_block_a2a}


def rel(want, got):
    return float((want - got).abs().max() / want.abs().max())


def leaves(p):
    return [p[k] for k in ("router", "w_gate", "w_up", "w_down")] + (
        [p["shared"][j] for j in ("w_gate", "w_up", "w_down")]
        + [p["shared_gate"]] if "shared" in p else [])


def tree(p, f):
    return {k: ({j: f(w) for j, w in v.items()} if isinstance(v, dict)
                else f(v)) for k, v in p.items()}


def run(impl, mcfg, p, x, ct, mesh):
    """The form on DTensors (weights replicated, tokens over "data"; each
    rank cuts its shard from its own copy, with no collective, as
    ``tests/torch_sharded_ranks.py`` ``on`` says why): the whole output,
    aux, dx and each weight's gradient."""
    rep = [Replicate()] * mesh.ndim
    dp = tree(p, lambda w: distribute_tensor(
        torch.from_numpy(w), mesh, rep, src_data_rank=None).requires_grad_())
    bat = [Shard(0), Replicate()]
    dx = distribute_tensor(torch.from_numpy(x), mesh, bat,
                           src_data_rank=None).requires_grad_()
    with use_mesh(mesh):
        o, a = impl(mcfg, dp, dx)
        (o * distribute_tensor(torch.from_numpy(ct), mesh, bat,
                               src_data_rank=None)).sum().backward()
    return (o.full_tensor(), a.full_tensor(), dx.grad.full_tensor(),
            [w.grad.full_tensor() for w in leaves(dp)], str(o.placements))


def meshless(mcfg, p, x, ct):
    tp = tree(p, lambda w: torch.from_numpy(w).requires_grad_())
    tx = torch.from_numpy(x).requires_grad_()
    o, a = moe.moe_block(mcfg, tp, tx)
    (o * torch.from_numpy(ct)).sum().backward()
    return o.detach(), a.detach(), tx.grad, [w.grad for w in leaves(tp)]


def tie_gap(mcfg, p, x):
    """The least gap between a token's k-th and next router probability."""
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, x.shape[-1])
                          @ torch.from_numpy(p["router"]), -1)
    top = probs.sort(-1, descending=True).values
    return float((top[:, mcfg.top_k - 1] - top[:, mcfg.top_k]).min())


def einsums(mesh):
    """``activation.einsum`` on the SSD products' layouts (batch over
    "data", heads over "model"; an operand replicated where the other is
    sharded, a contraction over a sharded dim, a ``Partial`` operand)
    against ``torch.einsum`` on the whole tensors: the output and both
    gradients, and whether the local path was taken."""
    from torch.distributed.tensor import Partial
    from repro_torch.sharding import activation
    g = torch.Generator().manual_seed(5)
    S, R = Shard, Replicate
    cases = [("bcihp,bcjhp->bcijh", (4, 2, 8, 4, 6), (4, 2, 8, 4, 6),
              [S(0), S(3)], [S(0), R()]),
             ("bcijh,bcjhp->bcihp", (4, 2, 8, 8, 4), (4, 2, 8, 4, 6),
              [S(0), S(4)], [S(0), S(3)]),
             ("bclhp,bchnp->bcln", (4, 2, 8, 4, 6), (4, 2, 4, 6, 6),
              [S(0), S(3)], [S(0), S(2)]),
             ("bcin,bcjn->bcij", (4, 2, 8, 6), (4, 2, 8, 6),
              [R(), S(3)], [R(), S(3)]),
             ("bcln,bchnp->bclhp", (4, 2, 8, 6), (4, 2, 4, 6, 6),
              [S(0), R()], [S(0), Partial()])]
    res = []
    for eq, sa, sb, pa, pb in cases:
        a, b = torch.randn(sa, generator=g), torch.randn(sb, generator=g)
        if pb[1].is_partial():      # b is the sum of the model shards' parts
            parts = [torch.randn(sb, generator=g) for _ in range(2)]
            b = parts[0] + parts[1]
            mine = parts[mesh.get_local_rank(1)].chunk(2)[
                mesh.get_local_rank(0)]
            db = DTensor.from_local(mine, mesh, pb,
                                    run_check=False).requires_grad_()
        else:
            db = distribute_tensor(b, mesh, pb,
                                   src_data_rank=None).requires_grad_()
        da = distribute_tensor(a, mesh, pa, src_data_rank=None
                               ).requires_grad_()
        local = activation._local_einsum_placements(eq, (da, db)) is not None
        with use_mesh(mesh):
            o = activation.einsum(eq, da, db)
        ct = torch.randn(tuple(o.shape), generator=g)
        (o * distribute_tensor(ct, mesh, [R(), R()], src_data_rank=None)
         ).sum().backward()
        wa, wb = a.clone().requires_grad_(), b.clone().requires_grad_()
        want = torch.einsum(eq, wa, wb)
        (want * ct).sum().backward()
        res.append([local, rel(want, o.full_tensor()),
                    rel(wa.grad, da.grad.full_tensor()),
                    rel(wb.grad, db.grad.full_tensor())])
    return res


out = {}
shapes = {8: [(2, 4)], 4: [(2, 2), (1, 4)]}[world]
ref = np.load(ref_path) if world == 8 else None
for shape in shapes:
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    label = f"{shape[0]}x{shape[1]}"
    n_data = shape[0]
    for shared in (0, 1):
        p, x, ct = weights(shared)
        # drop-free: every form is the meshless block
        free = MoECfg(num_experts=8, top_k=2, expert_d_ff=16,
                      capacity_factor=8.0, num_shared=shared, shared_d_ff=24)
        wo, _, wdx, wg = meshless(free, p, x, ct)
        shard_aux = sum(float(moe.moe_block(free, tree(p, torch.from_numpy),
                                            torch.from_numpy(xs))[1])
                        for xs in np.split(x, n_data)) / n_data
        drop = MoECfg(
            num_experts=8, top_k=2, expert_d_ff=16, capacity_factor=1.25,
            num_shared=shared, shared_d_ff=24)
        tp = tree(p, torch.from_numpy)
        per_shard = torch.cat([moe.moe_block(drop, tp, torch.from_numpy(xs))[0]
                               for xs in np.split(x, n_data)]).detach()
        whole = moe.moe_block(drop, tp, torch.from_numpy(x))[0].detach()
        for name, impl in FORMS.items():
            o, a, dx, g, layout = run(impl, free, p, x, ct, mesh)
            res = {"out": rel(wo, o), "dx": rel(wdx, dx),
                   "grads": max(rel(w, v) for w, v in zip(wg, g)),
                   "n_grads": len(g), "aux": abs(float(a) - shard_aux),
                   "layout": layout}
            o, a, _, _, _ = run(impl, drop, p, x, ct, mesh)
            if name == "sharded":
                res["per_shard"] = rel(per_shard, o)
            res["vs_whole_batch"] = rel(whole, o)
            if ref is not None:
                res["reference"] = rel(torch.from_numpy(
                    ref[f"{name}.{shared}.out"]), o)
                res["reference_aux"] = abs(
                    float(ref[f"{name}.{shared}.aux"]) - float(a))
            out[f"{label}.{name}.{shared}"] = res
        out[f"{label}.tie_gap.{shared}"] = tie_gap(free, p, x)
    if shape == (2, 2):
        out["einsum"] = einsums(mesh)
    if shape == (1, 4):
        # 6 experts on a 4-way model axis: a2a falls back to expert-TP
        six = MoECfg(num_experts=6, top_k=2, expert_d_ff=16,
                     capacity_factor=1.25)
        p, x, ct = weights(0, e=6)
        got = [run(f, six, p, x, ct, mesh)[0] for f in FORMS.values()]
        out["fallback_bitwise"] = bool(torch.equal(*got))
dist.destroy_process_group()
if rank == 0:
    print(json.dumps(out))
'''


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(var, None)
    return env


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's comparisons of both gloo groups, {mesh: ...}: the JAX
    reference first (its npz feeds the 8-rank group), then both groups
    at once."""
    tmp = tmp_path_factory.mktemp("moe_ranks")
    ref = str(tmp / "reference.npz")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, ref],
                          env=dict(_env(), JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    procs = {}
    for world in (8, 4):
        store = str(tmp / f"store{world}")
        procs[world] = [subprocess.Popen(
            [sys.executable, "-c", RANKS, str(r), str(world), store, ref],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)]
    out = {}
    for world, group in procs.items():
        outs = []
        for p in group:
            try:
                outs.append(p.communicate(timeout=300))
            finally:
                p.kill()
        for r, (p, (_, err)) in enumerate(zip(group, outs)):
            assert p.returncode == 0, (world, r, err[-4000:])
        out.update(json.loads(outs[0][0].strip().splitlines()[-1]))
    return out


CASES = [(m, f, s) for m in ("2x4", "2x2", "1x4") for f in FORMS
         for s in (0, 1)]


@pytest.mark.parametrize("mesh,form,shared", CASES)
def test_forms_on_ranks_match_meshless_block(ranks, mesh, form, shared):
    """Drop-free, the form on the ranks gives the meshless block's output,
    ``dx`` and every weight's gradient (the shared expert's too) at 1e-5
    in fp32, and its aux is the mean of the data shards' own; the output
    comes back sharded over "data", whole over "model"."""
    r = ranks[f"{mesh}.{form}.{shared}"]
    assert r["out"] < TOL and r["dx"] < TOL and r["grads"] < TOL, r
    assert r["n_grads"] == (8 if shared else 4), r
    assert r["aux"] < 1e-6, r
    assert r["layout"] == "(Shard(dim=0), Replicate())", r


@pytest.mark.parametrize("mesh,shared", [(m, s) for m in ("2x4", "2x2",
                                                          "1x4")
                                         for s in (0, 1)])
def test_sharded_capacity_follows_the_shard(ranks, mesh, shared):
    """At capacity factor 1.25 the expert-TP form drops what the meshless
    block drops on each data shard's rows alone; where the batch is split,
    that is not what the block drops on the whole batch."""
    r = ranks[f"{mesh}.sharded.{shared}"]
    assert r["per_shard"] < TOL, r
    if mesh != "1x4":
        assert r["vs_whole_batch"] > 100 * TOL, r


@pytest.mark.parametrize("form,shared", [(f, s) for f in FORMS
                                         for s in (0, 1)])
def test_forms_at_drops_match_reference_on_8_devices(ranks, form, shared):
    """At capacity factor 1.25 on a (2, 4) mesh, each form's output and
    aux equal the reference's own form on 8 forced host devices, on a
    router with no near tie."""
    r = ranks[f"2x4.{form}.{shared}"]
    assert ranks[f"2x4.tie_gap.{shared}"] > 1e-4
    assert r["reference"] < TOL and r["reference_aux"] < 1e-5, r


def test_a2a_falls_back_on_ranks_when_indivisible(ranks):
    """6 experts on the (1, 4) mesh's 4-way model axis: ``moe_block_a2a``
    is ``moe_block_sharded``, bit for bit."""
    assert ranks["fallback_bitwise"]


def test_einsum_on_local_shards_matches_whole_tensors(ranks):
    """``activation.einsum`` on four ranks takes the local path at every
    layout of the SSD products (the case a ``bmm`` of DTensors cannot
    shard) and gives ``torch.einsum``'s output and gradients."""
    for local, out, da, db in ranks["einsum"]:
        assert local and out < TOL and da < TOL and db < TOL, \
            ranks["einsum"]


def test_a_recompute_on_another_thread_sees_the_forward_mesh():
    """A checkpointed block's recompute runs where the autograd engine
    runs it (a thread of its own for a CUDA device): ``carried`` brings
    the forward's mesh and batch axes there, so the MoE layers recompute
    through the sharded form's local body."""
    import threading
    from repro_torch.sharding.activation import (active_mesh, batch_axes,
                                                 carried, use_batch_axes)
    seen = {}
    with local_mesh("cpu") as mesh, use_mesh(mesh), \
            use_batch_axes(("data",)):
        fn = carried(lambda: seen.update(mesh=active_mesh(),
                                         axes=batch_axes()))
        plain = lambda: seen.update(bare=active_mesh())  # noqa: E731
        for f in (fn, plain):
            t = threading.Thread(target=f)
            t.start()
            t.join(timeout=30)
        assert seen == {"mesh": mesh, "axes": ("data",), "bare": None}
        assert active_mesh() is mesh


# ------------------------------------------------ the step on one rank
def test_reduced_granite_step_on_one_rank_mesh_is_bitwise_meshless():
    """One ``train_step`` of the reduced granite-moe (``moe_impl`` is
    ``"shard_map"``, its config's) with plain tensors on a (1, 1) gloo
    mesh, its MoE layers through ``moe_block_sharded``, against the same
    step with no mesh: loss, aux, grad norm and every updated leaf
    bitwise."""
    cfg = tconfigs.reduced(tconfigs.get("granite-moe-1b-a400m"))
    assert cfg.moe_impl == "shard_map"
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    calls = []
    real = tmoe.moe_block_sharded

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    def step():
        state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                       "cpu")
        return steps.train_step(cfg, state, {"tokens": tok})

    want, wmet = step()
    tmoe.moe_block_sharded = counted
    try:
        with local_mesh("cpu") as mesh, use_mesh(mesh):
            got, gmet = step()
    finally:
        tmoe.moe_block_sharded = real
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    assert len(calls) == 2 * n_moe > 0      # the forward and the recompute
    for key in ("loss", "aux_loss", "grad_norm"):
        assert torch.equal(wmet[key], gmet[key]), key
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert torch.equal(a, b)
