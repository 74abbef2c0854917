"""The sharded step executed: the reduced internlm2's train, prefill and
decode steps from ``launch/shapes.py`` ``build_step`` run on DTensors
over a real four-rank ``gloo`` group, on a (2, 2) and a (1, 4) mesh of
("data", "model"), against the same steps run with no mesh on the same
weights and inputs.

These are the code paths that exist only on a mesh of several devices
and that the dry run traces at full width (``sharding/activation.py``:
``splittable`` on values and gradients, ``write_slice`` into a cache
whose sequence is sharded, ``laid_out_as`` on the gradients, the cache
made by ``cache_leaf``; ``layers.gqa_attention``'s head and sequence
layout with the KV heads repeated; the one-hot embedding over a vocab
shard; the gold logit as a masked sum over the vocab). The (1, 4) mesh
puts 2 KV heads on a 4-way model axis, as internlm2-1.8b puts 8 on the
16-way axis of the pod, so its shards split unevenly. The decode step
writes position 40 of a 64-long cache, which falls in the second of the
(2, 2) mesh's sequence shards and the third of the (1, 4) mesh's.

The four ranks are processes of their own (one ``FileStore``); rank 0
prints one JSON object of the comparisons, which the tests read. Every
value is held at the bf16 bounds of the port's steps against the
reference (``test_torch_launch.py``)."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SRC = os.path.join(ROOT, "src")
MESHES = ("2x2", "1x4")
# bf16 steps, the bounds of test_torch_launch.py's steps
REL_TOL = 3e-2
LOSS_RTOL = 1e-3
GNORM_RTOL = 1e-2

RANKS = r'''
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch import configs
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.launch import shapes
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.sharding.activation import use_batch_axes, use_mesh
from repro_torch.train import steps

rank, store = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)
cfg = dataclasses.replace(configs.reduced(configs.get("internlm2-1.8b")),
                          num_layers=2)
B, S, MAX, POS = 4, 32, 64, 40
for name, kw in (("train_4k", dict(batch=B, seq=S)),
                 ("prefill_32k", dict(batch=B, seq=S)),
                 ("decode_32k", dict(batch=B, seq=MAX))):
    shapes.SHAPES[name] = dataclasses.replace(shapes.SHAPES[name], **kw)
params = registry.init(cfg, torch.Generator().manual_seed(1), "cpu")
rng = np.random.default_rng(2)
tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
tok1 = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32))
cache0 = registry.init_cache(cfg, B, MAX, "cpu")
for k in ("k", "v"):
    cache0[k] = torch.from_numpy(rng.standard_normal(
        tuple(cache0[k].shape)).astype(np.float32)).to(torch.bfloat16)
cache0["pos"] = POS


def clone(tree):
    return tree_unflatten(tree_flatten(tree)[1], [
        t.clone() if isinstance(t, torch.Tensor) else t
        for t in tree_flatten(tree)[0]])


def on(args, in_sh):
    """Each tensor of ``args`` as a DTensor laid out by its sharding."""
    flat, treedef = tree_flatten(args)
    shs = tree_leaves(in_sh)
    assert len(flat) == len(shs), (len(flat), len(shs))
    return tree_unflatten(treedef, [
        distribute_tensor(t.clone(), sh.mesh, sh.placements)
        if isinstance(t, torch.Tensor) else t for t, sh in zip(flat, shs)])


def whole(tree):
    return [t.full_tensor() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree)]


def err(want, got):
    a, b = want.float(), got.float()
    return float((a - b).abs().max() / (a.abs().max() + 1e-9))


out = {}
for label, shape in (("2x2", (2, 2)), ("1x4", (1, 4))):
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    res = out[label] = {}

    # train: one step with two microbatches, and the gradients
    tcfg = dataclasses.replace(cfg, grad_accum=2)
    fn, args, in_sh, _, _ = shapes.build_step(tcfg, "train_4k", mesh)
    state = steps.TrainState(params=params, opt=adamw.init(params))
    with use_mesh(mesh):
        new, met = fn(*on((state, {"tokens": tok}), in_sh))
    pshard = in_sh[0].params
    vg = shapes._replicating(lambda p, b: steps.value_and_grad(tcfg, p, b))
    with use_mesh(mesh), use_batch_axes(("pod", "data")):
        gmet, grads = vg(*on((params, {"tokens": tok}), (pshard, in_sh[1])))
    layout = all(g.placements == sh.placements for g, sh in
                 zip(tree_leaves(grads), tree_leaves(pshard)))
    got = dict(loss=whole(met["loss"])[0], gnorm=whole(met["grad_norm"])[0],
               params=whole(new.params), grad_loss=whole(gmet["loss"])[0],
               grads=whole(grads))

    # prefill of S into a cache of S
    fn, _, in_sh, _, _ = shapes.build_step(cfg, "prefill_32k", mesh)
    with use_mesh(mesh):
        plog, pcache = fn(*on((params, {"tokens": tok}), in_sh))
    got.update(plog=whole(plog)[0], pcache={k: whole(v)[0] for k, v in
                                          pcache.items() if k != "pos"},
               ppos=pcache["pos"], pcache_sharded=str(pcache["k"].placements))

    # decode at POS of MAX: the write falls in a later sequence shard
    fn, _, in_sh, _, _ = shapes.build_step(cfg, "decode_32k", mesh)
    with use_mesh(mesh):
        dlog, dcache = fn(*on((params, tok1, clone(cache0)), in_sh))
    got.update(dlog=whole(dlog)[0], dcache={k: whole(v)[0] for k, v in
                                          dcache.items() if k != "pos"},
               dpos=dcache["pos"], dcache_sharded=str(dcache["k"].placements))

    if rank == 0:
        wnew, wmet = steps.train_step(tcfg, state, {"tokens": tok})
        wgm, wgrads = steps.value_and_grad(tcfg, params, {"tokens": tok})
        wlog, wcache = steps.prefill_step(cfg, params, {"tokens": tok},
                                          max_len=S)
        dwant = clone(cache0)
        dwlog, dwcache = steps.decode_step(cfg, params, tok1, dwant)
        res["train"] = dict(
            loss=err(wmet["loss"], got["loss"]),
            grad_norm=err(wmet["grad_norm"], got["gnorm"]),
            params=max(err(a, b) for a, b in
                       zip(tree_leaves(wnew.params), got["params"])),
            grad_loss=err(wgm["loss"], got["grad_loss"]),
            grads=max(err(a, b) for a, b in
                      zip(tree_leaves(wgrads), got["grads"])),
            n_grads=len(got["grads"]), grads_laid_out_as_params=layout)
        res["prefill"] = dict(
            logits=err(wlog, got["plog"]),
            cache=max(err(wcache[k], v) for k, v in got["pcache"].items()),
            pos=[got["ppos"], wcache["pos"]],
            finite=bool(torch.isfinite(got["plog"].float()).all()),
            layout=got["pcache_sharded"])
        written = slice(POS, POS + 1)
        res["decode"] = dict(
            logits=err(dwlog, got["dlog"]),
            cache=max(err(dwcache[k], v) for k, v in got["dcache"].items()),
            written=max(err(dwcache[k][:, :, written],
                            got["dcache"][k][:, :, written])
                        for k in ("k", "v")),
            moved=max(err(dwcache[k][:, :, written], cache0[k][:, :, written])
                      for k in ("k", "v")),
            pos=[got["dpos"], dwcache["pos"]],
            finite=bool(torch.isfinite(got["dlog"].float()).all()),
            layout=got["dcache_sharded"])
dist.destroy_process_group()
if rank == 0:
    print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("ranks") / "store")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, "-c", RANKS, str(r), store],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300))
        finally:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, err[-4000:])
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_train_step_matches_meshless(executed, mesh):
    """Loss, grad norm, every updated param and every gradient of the
    step on the mesh equal the meshless step's at the bf16 bounds, and
    each gradient comes laid out as its param."""
    r = executed[mesh]["train"]
    assert r["loss"] < LOSS_RTOL and r["grad_loss"] < LOSS_RTOL, r
    assert r["grad_norm"] < GNORM_RTOL, r
    assert r["params"] < REL_TOL and r["grads"] < REL_TOL, r
    assert r["n_grads"] > 0 and r["grads_laid_out_as_params"], r


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_prefill_matches_meshless(executed, mesh):
    """The last logits and the whole cache written by ``write_slice``
    into sequence shards equal the meshless prefill's."""
    r = executed[mesh]["prefill"]
    assert r["finite"] and r["logits"] < REL_TOL and r["cache"] < REL_TOL, r
    assert r["pos"][0] == r["pos"][1]
    assert "Shard(dim=2)" in r["layout"], r


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_decode_in_a_later_shard_matches_meshless(executed, mesh):
    """A decode step at position 40 of 64, in a sequence shard after the
    first: the logits and the whole cache equal the meshless step's, and
    the written position holds the new K/V (not the cache's old
    values)."""
    r = executed[mesh]["decode"]
    assert r["finite"] and r["logits"] < REL_TOL and r["cache"] < REL_TOL, r
    assert r["written"] < REL_TOL < r["moved"], r
    assert r["pos"][0] == r["pos"][1] == 41
    assert "Shard(dim=2)" in r["layout"], r
