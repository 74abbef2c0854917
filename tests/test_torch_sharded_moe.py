"""The MoE family's sharded steps executed: the reduced
granite-moe-1b-a400m and qwen2-moe-a2.7b (4 layers, each with 8
experts, top 2; qwen2-moe's with a shared expert).

Four ``gloo`` ranks (``tests/torch_sharded_ranks.py``): the train step
at ``grad_accum`` 2, ``value_and_grad``, the prefill and a decode at
position 40 of 64 from ``launch/shapes.py`` ``build_step`` on DTensors
(the configs' ``moe_impl``, expert-tensor-parallel
``moe_block_sharded``), on a (2, 2) and a (1, 4) mesh of ("data",
"model"), against the same steps with no mesh on the same weights and
inputs.

Two bf16 programs routing near-ties may pick other experts, so in bf16
the loss is held, the logits and the cache with the meshless step on the
mesh's top-k picks, and the picks' agreement apart (as
``tests/test_torch_moe.py`` holds them against the reference). The
wiring is held in fp32 (every weight cast, the embedding in fp32): loss,
aux loss, every gradient, the moments and each update. There the oracle
on a mesh with ``data`` > 1 is the reference's per-shard aux loss
(``src/repro/models/moe.py`` pmeans each device's own Switch loss): the
meshless loss plus 0.01 x the mean of the aux over each data shard's
rows; on (1, 4), where ``data`` is 1, the meshless step. granite-moe's
fp32 step on both meshes is also held against the reference's own
sharded step, run under ``shard_map`` on 4 forced host devices in a JAX
subprocess on the same weights and batch."""
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_sharded_ranks as ranks

ARCHS = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"]
CASES = [(a, m) for a in ARCHS for m in ranks.MESHES]
REF_ARCH = ARCHS[0]      # held against the reference's own sharded step

# The reference's sharded fp32 step on 4 forced host devices: the ranks'
# weights and batch (rank 0's npz), ``launch/shapes.py`` ``build_step``'s
# train step (grad_accum 2) and ``value_and_grad`` jitted with its
# in-shardings under the mesh, each MoE layer through ``moe_block_sharded``
# (``shard_map``, the aux pmeaned over each device's own batch shard).
REFERENCE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from repro import configs
from repro.launch import shapes
from repro.models import lm, registry
from repro.optim import adamw
from repro.sharding.activation import use_batch_axes
from repro.train import steps

arch, src, dst = sys.argv[1:4]
B, S = int(sys.argv[4]), int(sys.argv[5])
got = dict(np.load(src))
cfg = dataclasses.replace(configs.reduced(configs.get(arch)), grad_accum=2)
shapes.SHAPES["train_4k"] = dataclasses.replace(shapes.SHAPES["train_4k"],
                                                batch=B, seq=S)
# the whole model in fp32: the embedding table kept in fp32
lm.embed_lookup = lambda cfg, table, tok: table.astype(jnp.float32)[tok]


def name(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


abstract = jax.eval_shape(lambda: registry.init(cfg, jax.random.PRNGKey(0)))
paths, treedef = jax.tree_util.tree_flatten_with_path(abstract)
names = [name(p) for p, _ in paths]
params = jax.tree_util.tree_unflatten(
    treedef, [jnp.asarray(got[f"params.{n}"]) for n in names])
assert all(a.dtype == jnp.float32 for a in jax.tree_util.tree_leaves(params))
batch = {"tokens": jnp.asarray(got["batch.tokens"])}
out = {}
for label, shape in (("2x2", (2, 2)), ("1x4", (1, 4))):
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(shape),
                             ("data", "model"))
    fn, _, in_sh, out_sh, _ = shapes.build_step(cfg, "train_4k", mesh)
    pshard = in_sh[0].params

    def vg(p, b):
        with use_batch_axes(("pod", "data")):
            return jax.value_and_grad(lambda p, b: steps.loss_fn(cfg, p, b),
                                      has_aux=True)(p, b)

    state = steps.TrainState(params=params, opt=adamw.init(params))
    with mesh:
        new, met = jax.jit(fn, in_shardings=in_sh,
                           out_shardings=out_sh)(state, batch)
        (_, gmet), grads = jax.jit(vg, in_shardings=(pshard, in_sh[1]),
                                   out_shardings=(None, pshard))(params, batch)
    for n, g in zip(names, jax.tree_util.tree_leaves(grads)):
        out[f"{label}.grads.{n}"] = np.asarray(g)
    for n, m in zip(names, jax.tree_util.tree_leaves(new.opt.m)):
        out[f"{label}.m.{n}"] = np.asarray(m)
    for k in ("loss", "aux_loss"):
        out[f"{label}.gmet.{k}"] = np.asarray(gmet[k])
    for k in ("loss", "aux_loss", "grad_norm"):
        out[f"{label}.met.{k}"] = np.asarray(met[k])
np.savez(dst, **out)
'''


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    """(rank 0's comparisons, rank 0's fp32 values of REF_ARCH, the
    reference's): the ranks, then the reference on their weights."""
    tmp = tmp_path_factory.mktemp("moe_ranks")
    res = ranks.run_group(tmp, ARCHS)
    got, ref = str(tmp / f"{REF_ARCH}.npz"), str(tmp / "reference.npz")
    env = dict(os.environ, PYTHONPATH=ranks.SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, REF_ARCH, got,
                           ref, str(ranks.B), str(ranks.S)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return res, dict(np.load(got)), dict(np.load(ref))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_bf16_train_loss_matches_meshless(executed, arch, mesh):
    """The bf16 step's loss and ``value_and_grad``'s, at LOSS_RTOL."""
    r = executed[0][arch][mesh]["train"]
    where = (arch, mesh, "train")
    assert r["loss"] < ranks.LOSS_RTOL, (where, "loss", r["loss"])
    assert r["grad_loss"] < ranks.LOSS_RTOL, (where, "loss", r["grad_loss"])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_fp32_gradients_match_the_per_shard_aux_oracle(
        executed, arch, mesh):
    """In fp32: loss, aux loss, grad norm, every gradient and both
    moments at FP32_RTOL of each leaf's max (v at twice that), against
    the per-shard aux oracle where ``data`` > 1, else the meshless step;
    each gradient laid out as its param."""
    r = executed[0][arch][mesh]["train_fp32"]
    where = (arch, mesh, "train_fp32", r["oracle"])
    assert r["oracle"] == ("per-shard aux" if mesh == "2x2" else "meshless")
    for k in ("aux", "grad_aux"):
        assert r[k] < ranks.FP32_RTOL, (where, k, r[k])
    ranks.check_train(r, where, ranks.FP32_RTOL, ranks.FP32_RTOL,
                      ranks.FP32_RTOL)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_fp32_update_in_units_of_lr(executed, arch, mesh):
    """Each param's update of the fp32 step against the oracle's, element
    by element, in units of the step's lr."""
    r = executed[0][arch][mesh]["train_fp32"]
    ranks.check_updates(r, (arch, mesh, "train_fp32"))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_prefill_on_the_mesh_picks_matches_meshless(
        executed, arch, mesh):
    """The last logits and the cache after the prompt, the meshless step
    on the mesh's picks; the picks of the prefill and the decode agree
    with the meshless step's own on PICKS_AGREE of the (token, layer)
    rows."""
    res = executed[0][arch][mesh]
    ranks.check_serve(res["prefill"], (arch, mesh), "prefill")
    ranks.check_picks(res, (arch, mesh))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_decode_on_the_mesh_picks_matches_meshless(
        executed, arch, mesh):
    """A decode at position 40 of 64, in a later sequence shard, the
    meshless step on the mesh's picks: the logits and the cache, the
    written position holding the new K/V."""
    ranks.check_serve(executed[0][arch][mesh]["decode"], (arch, mesh),
                      "decode")


@pytest.mark.parametrize("mesh", ranks.MESHES)
def test_sharded_fp32_step_matches_the_references_sharded_step(
        executed, mesh):
    """granite-moe's fp32 step on the mesh against the reference's own
    sharded step on a mesh of the same shape (4 forced host devices, in a
    JAX subprocess, on the same weights and batch): every gradient of
    ``value_and_grad`` and its loss and aux loss; the train step's loss,
    aux loss, grad norm and every first moment; each at FP32_RTOL of the
    reference's max. This holds the per-shard aux oracle, and the port's
    ``_MeanOver``, to the reference's ``pmean`` itself."""
    _, got, ref = executed
    keys = [k for k in ref if k.startswith(f"{mesh}.")]
    assert sorted(keys) == sorted(k for k in got if k.startswith(f"{mesh}."))
    assert sum(".grads." in k for k in keys) >= 13, keys
    for k in keys:
        want, have = ref[k], got[k]
        assert want.shape == have.shape, (REF_ARCH, mesh, k)
        err = float(np.abs(want - have).max() / (np.abs(want).max() + 1e-30))
        assert err < ranks.FP32_RTOL, (REF_ARCH, mesh, k, err)
