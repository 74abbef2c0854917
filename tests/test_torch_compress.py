"""``repro_torch.optim.compress`` against the JAX package's
``optim/compress.py``: the int8 quantizer bit for bit, the error-feedback
round trip (the twin of ``tests/test_train.py``'s), and ``compress_psum``
executed on four ``gloo`` ranks against a numpy sum, against the
reference's ``compress_psum`` under ``shard_map`` on four forced host
devices (a JAX subprocess, passed across as numpy) and against itself
over three calls: error feedback loses nothing.

Each rank draws its gradients from its own seed, a new draw a call; the
ranks reduce them through a process group (the world), through
``(DeviceMesh, "data")`` on a (4,) mesh, and as DTensors on a (2, 2)
mesh of ("data", "model") whose leaves the model axis shards, each
device's draw its block of a gradient Partial over ``data``, summed over
``data``. A gradient that autograd leaves Partial over ``data`` (a loss
over a batch sharded there) is summed too, and a reduced or misplaced
DTensor is refused. Every rank saves what it got as an npz file, which
the tests read."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as jcompress
from repro_torch.optim import compress

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SRC = os.path.join(ROOT, "src")
WORLD, CALLS = 4, 3
RED_TOL = 1e-6     # a sum of four fp32 values, relative to the leaf's max
EF_TOL = 1e-5      # three calls' sums, relative to the leaf's max

GRADS = r'''
import numpy as np

SHAPES = {"w": (24, 40), "b": (40,), "e": (3, 8, 16), "h": (8, 12),
          "t": (20, 12)}
BF16 = ("h",)      # leaves reduced as bf16 gradients
STRIDED = ("t",)   # leaves the port takes as a transposed (strided) view


def grads(rank, call):
    """One rank's fp32 gradients at one call; ``h`` is cast to bf16 by
    each side (round to nearest even on both); ``t`` is the transpose of
    a (12, 20) draw."""
    rng = np.random.default_rng(1000 * call + rank)
    out = {k: (rng.standard_normal(s[::-1] if k in STRIDED else s)
               * (1 + rank)).astype(np.float32) for k, s in SHAPES.items()}
    return {k: v.T if k in STRIDED else v for k, v in out.items()}
'''
exec(GRADS)

REFERENCE = GRADS + r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from repro.optim import compress
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

mesh = jax.make_mesh((4,), ("data",))
spec = {k: PS("data") for k in SHAPES}


def body(g, r):
    g = {k: v[0] for k, v in g.items()}
    r = {k: v[0] for k, v in r.items()}
    red, ef = compress.compress_psum(g, compress.EFState(residual=r), "data")
    return ({k: v[None] for k, v in red.items()},
            {k: v[None] for k, v in ef.residual.items()})


step = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec),
                         out_specs=(spec, spec)))
r = {k: jnp.zeros((4,) + s, jnp.float32) for k, s in SHAPES.items()}
out = {}
for call in range(3):
    per = [grads(rank, call) for rank in range(4)]
    g = {k: jnp.stack([np.ascontiguousarray(p[k]) for p in per])
         for k in SHAPES}
    g = {k: v.astype(jnp.bfloat16) if k in BF16 else v for k, v in g.items()}
    red, r = step(g, r)
    for k in SHAPES:
        out[f"red.{call}.{k}"] = np.asarray(red[k].astype(jnp.float32))
        out[f"res.{call}.{k}"] = np.asarray(r[k])
np.savez(sys.argv[1], **out)
'''

RANKS = GRADS + r'''
import sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from repro_torch.optim import compress

rank, store, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)


def mine(call):
    """This rank's gradients; ``t`` a strided view, as a gradient that
    elementwise ops made from a transposed one may be."""
    out = {}
    for k, v in grads(rank, call).items():
        t = torch.from_numpy(np.ascontiguousarray(v.T)).T \
            if k in STRIDED else torch.from_numpy(v)
        out[k] = t.to(torch.bfloat16) if k in BF16 else t
    assert not out["t"].is_contiguous()
    return out


out = {}
line = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
for form, group in (("world", dist.group.WORLD), ("mesh", (line, "data"))):
    ef = compress.ef_init(mine(0))
    for call in range(3):
        g = mine(call)
        red, new = compress.compress_psum(g, ef, group)
        for k in SHAPES:
            out[f"{form}.g.{call}.{k}"] = g[k].float().numpy()
            out[f"{form}.r.{call}.{k}"] = ef.residual[k].numpy()
            out[f"{form}.red.{call}.{k}"] = red[k].float().numpy()
            out[f"{form}.res.{call}.{k}"] = new.residual[k].numpy()
            out[f"{form}.dtype.{call}.{k}"] = np.array(str(red[k].dtype))
        ef = new

# DTensors on (2, 2): each leaf's dim 0 over "model", each device's own
# gradient of its data shard as its block, unreduced: Partial over
# "data" (from_local of the block, as a data-parallel gradient is), then
# summed over "data"
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
pl = (Partial(), Shard(0))
g = {k: DTensor.from_local(v, mesh, pl, run_check=False)
     for k, v in mine(0).items()}
assert not g["t"].to_local().is_contiguous()
ef = compress.ef_init(g)
assert all(r.placements == pl and not r.to_local().any()
           for r in ef.residual.values())
red, new = compress.compress_psum(g, ef, (mesh, "data"))
for k in SHAPES:
    out[f"dt.local.{k}"] = g[k].to_local().float().numpy()
    out[f"dt.red.{k}"] = red[k].to_local().float().numpy()
    out[f"dt.res.{k}"] = new.residual[k].to_local().numpy()
    out[f"dt.layout.{k}"] = np.array(
        red[k].placements == (Replicate(), Shard(0))
        and new.residual[k].placements == pl
        and tuple(red[k].shape) == tuple(g[k].shape))

# the gradient of a loss over a batch sharded over "data", as autograd
# leaves it (Partial over "data"): the sum plus the residual's sum (each
# a collective over the ranks) is the whole gradient
wrng = np.random.default_rng(77)
W = torch.from_numpy(wrng.standard_normal((24, 40)).astype(np.float32))
X = torch.from_numpy(wrng.standard_normal((8, 24)).astype(np.float32))
w = distribute_tensor(W, mesh, (Replicate(), Shard(1)),
                      src_data_rank=None).requires_grad_()
x = distribute_tensor(X, mesh, (Shard(0), Replicate()), src_data_rank=None)
(x @ w).square().sum().backward()
out["ag.placements"] = np.array(str(w.grad.placements))
ag, agef = compress.compress_psum({"w": w.grad},
                                  compress.ef_init({"w": w.grad}),
                                  (mesh, "data"))
out["ag.local"] = w.grad.to_local().numpy()
out["ag.red_placements"] = np.array(str(ag["w"].placements))
out["ag.red"] = ag["w"].full_tensor().numpy()
out["ag.res"] = agef.residual["w"].full_tensor().numpy()
out["ag.true"] = (2 * X.T @ (X @ W)).numpy()

# a reduced (Replicate) DTensor, or a DTensor over a process group, is
# refused: summing it again would count it once a rank
for name, leaf, grp in (
        ("replicate", DTensor.from_local(mine(0)["w"], mesh,
                                         (Replicate(), Shard(0)),
                                         run_check=False), (mesh, "data")),
        ("group", g["w"], dist.group.WORLD)):
    try:
        compress.compress_psum({"w": leaf}, compress.ef_init({"w": leaf}),
                               grp)
        out[f"refused.{name}"] = np.array("")
    except ValueError as e:
        out[f"refused.{name}"] = np.array(str(e))
out["coord"] = np.array(mesh.get_coordinate())
dist.destroy_process_group()
np.savez(f"{outdir}/rank{rank}.npz", **out)
'''


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(var, None)
    return env


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    """(the reference's npz, [each rank's npz]): the JAX subprocess and
    the four ranks run at once."""
    tmp = tmp_path_factory.mktemp("compress")
    ref = str(tmp / "reference.npz")
    jproc = subprocess.Popen([sys.executable, "-c", REFERENCE, ref],
                             env=dict(_env(), JAX_PLATFORMS="cpu"),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    procs = [subprocess.Popen([sys.executable, "-c", RANKS, str(r),
                               str(tmp / "store"), str(tmp)],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    outs = []
    for p in [jproc, *procs]:
        try:
            outs.append(p.communicate(timeout=300))
        finally:
            p.kill()
    for name, p, (_, err) in zip(["reference", *range(WORLD)],
                                 [jproc, *procs], outs):
        assert p.returncode == 0, (name, err[-4000:])
    return (dict(np.load(ref)),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)])


def _quantize_np(x):
    """The reference's arithmetic in numpy fp32."""
    scale = np.float32(np.abs(x).max()) / np.float32(127) + np.float32(1e-12)
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return q, scale


def _sent_np(x):
    q, scale = _quantize_np(x)
    return q.astype(np.float32) * scale


def _rel(want, got):
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-30))


def _bf16_close(want, got):
    """``got``, a bf16 leaf, is the fp32 sum ``want`` rounded to bf16:
    within one bf16 ulp (2^-7 relative) of each element, since the ranks
    may add the four values in another order than numpy or XLA does."""
    return bool(np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -7))


def test_int8_error_feedback_roundtrip():
    """The twin of ``tests/test_train.py``'s, on its numpy input."""
    g = {"w": torch.from_numpy(
        np.random.default_rng(0).normal(0, 1, (64,)).astype(np.float32))}
    ef = compress.ef_init(g)
    assert ef.residual["w"].dtype == torch.float32
    assert torch.equal(ef.residual["w"], torch.zeros(64))
    q, scale = compress.quantize_int8(g["w"])
    deq = compress.dequantize_int8(q, scale)
    assert float((deq - g["w"]).abs().max()) < float(scale) + 1e-6
    gf = g["w"] + ef.residual["w"]
    new_r = gf - deq
    np.testing.assert_allclose(new_r.numpy(), (g["w"] - deq).numpy(),
                               atol=1e-6)


CASES = {
    "normal": lambda: np.random.default_rng(3).standard_normal(
        (16, 33)).astype(np.float32),
    "wide": lambda: (np.random.default_rng(4).standard_normal(500)
                     * np.logspace(-6, 3, 500)).astype(np.float32),
    # max 127: scale rounds to 1.0, so x / scale lands on the halves,
    # rounded to even (64, -0, 2, 2, -2), and past ±127 clips
    "ties": lambda: np.array([127, 63.5, -0.5, 1.5, 2.5, -2.5, 126.5,
                              -127], np.float32),
    "zeros": lambda: np.zeros(7, np.float32),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_quantize_int8_is_the_references_bit_for_bit(case, dtype):
    """q and scale of ``quantize_int8`` and the dequantized values equal
    the reference's bit for bit, on fp32 and on bf16 input (each side
    casts the same fp32 numpy to bf16, rounding to nearest even)."""
    x = CASES[case]()
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jcompress.quantize_int8(jx)
    tq, ts = compress.quantize_int8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == tx.dtype
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    js32 = np.asarray(js.astype(jnp.float32))
    assert ts.float().numpy().tobytes() == js32.tobytes(), (ts, js32)
    jd = np.asarray(jcompress.dequantize_int8(jq, js))
    td = compress.dequantize_int8(tq, ts)
    assert td.dtype == torch.float32
    assert td.numpy().tobytes() == jd.tobytes()


@pytest.mark.parametrize("form", ["world", "mesh"])
def test_compress_psum_sums_each_ranks_dequantized_value(executed, form):
    """Each call's reduced leaves, on every rank, equal the numpy sum over
    the ranks of each rank's dequantized g + r, at RED_TOL of the leaf's
    max, in the gradient's dtype; and each rank's new residual is its
    (g + r) − sent, within one fp32 rounding of the subtraction (a bf16
    leaf's sum within a bf16 ulp, ``_bf16_close``)."""
    _, ranks = executed
    for call in range(CALLS):
        for k in SHAPES:
            sent = []
            for r, out in enumerate(ranks):
                gf = out[f"{form}.g.{call}.{k}"] + out[f"{form}.r.{call}.{k}"]
                sent.append(_sent_np(gf))
                res = out[f"{form}.res.{call}.{k}"]
                err = np.abs(res - (gf - sent[-1])).max()
                assert err <= np.spacing(np.abs(gf).max()), (
                    form, call, k, r, float(err))
            want = np.sum(sent, axis=0)
            for r, out in enumerate(ranks):
                got = out[f"{form}.red.{call}.{k}"]
                dt = "torch.bfloat16" if k in BF16 else "torch.float32"
                assert str(out[f"{form}.dtype.{call}.{k}"]) == dt
                if k in BF16:
                    assert _bf16_close(want, got), (form, call, k, r)
                else:
                    assert _rel(want, got) < RED_TOL, (form, call, k, r)


@pytest.mark.parametrize("form", ["world", "mesh"])
def test_compress_psum_matches_the_reference_under_shard_map(executed, form):
    """Three calls, residual carried: the port's reduced leaves and every
    rank's residual equal the reference's ``compress_psum`` under
    ``shard_map`` over 4 host devices, at RED_TOL of each leaf's max (a
    bf16 leaf within a bf16 ulp of each element, ``_bf16_close``; the
    residual at RED_TOL of the max of g + r)."""
    ref, ranks = executed
    for call in range(CALLS):
        for k in SHAPES:
            for r, out in enumerate(ranks):
                want = ref[f"red.{call}.{k}"][r]
                got = out[f"{form}.red.{call}.{k}"]
                if k in BF16:
                    assert _bf16_close(want, got), (form, call, k, r)
                else:
                    assert _rel(want, got) < RED_TOL, (form, call, k, r,
                                                       _rel(want, got))
                # the residual at RED_TOL of g + r: XLA fuses the
                # dequantize into the subtraction, so its product q·scale
                # may round otherwise than the sent value's (an ulp of g)
                want = ref[f"res.{call}.{k}"][r]
                got = out[f"{form}.res.{call}.{k}"]
                gf = out[f"{form}.g.{call}.{k}"] + out[f"{form}.r.{call}.{k}"]
                err = np.abs(want - got).max() / np.abs(gf).max()
                assert err < RED_TOL, (form, call, k, r, float(err))


def test_the_two_group_forms_are_the_same_bits(executed):
    """A process group and ``(mesh, "data")`` on a (4,) mesh reduce the
    same values to the same bits."""
    _, ranks = executed
    for out in ranks:
        for call in range(CALLS):
            for k in SHAPES:
                for what in ("red", "res"):
                    assert np.array_equal(out[f"world.{what}.{call}.{k}"],
                                          out[f"mesh.{what}.{call}.{k}"])


def test_error_feedback_loses_nothing_over_three_calls(executed):
    """Per rank, the sum over three calls of what was sent plus the last
    residual equals the sum of the true gradients; over the ranks, the
    sum of the reduced leaves plus every last residual equals the sum of
    every gradient: each at EF_TOL of its max."""
    _, ranks = executed
    for k in SHAPES:
        total_g, total_red = 0.0, 0.0
        for r, out in enumerate(ranks):
            g = [out[f"world.g.{c}.{k}"] for c in range(CALLS)]
            sent = [out[f"world.g.{c}.{k}"] + out[f"world.r.{c}.{k}"]
                    - out[f"world.res.{c}.{k}"] for c in range(CALLS)]
            last = out[f"world.res.{CALLS - 1}.{k}"]
            assert np.abs(last).max() > 0
            want = np.sum(g, axis=0)
            assert _rel(want, np.sum(sent, axis=0) + last) < EF_TOL, (k, r)
            total_g = total_g + want
            total_red = total_red + last
        if k not in BF16:     # a bf16 reduced leaf rounds each call's sum
            total_red = total_red + np.sum(
                [ranks[0][f"world.red.{c}.{k}"] for c in range(CALLS)],
                axis=0)
            assert _rel(total_g, total_red) < EF_TOL, k


def test_compress_psum_reduces_a_dtensor_shard_by_shard(executed):
    """Partial gradients on a (2, 2) mesh, dim 0 over ``model``, each
    device's block its own draw, reduced over ``(mesh, "data")``: each
    device's reduced shard is the sum over the two ``data`` coordinates
    of the same model shard's dequantized blocks, quantized block by
    block (each device's own scale), and comes back Replicate over
    ``data``; the residual is the block's own g − sent and stays
    Partial over ``data``."""
    _, ranks = executed
    coords = [tuple(out["coord"]) for out in ranks]
    for k in SHAPES:
        for r, out in enumerate(ranks):
            assert bool(out[f"dt.layout.{k}"]), (k, r)
            peers = [q for q, c in enumerate(coords) if c[1] == coords[r][1]]
            assert len(peers) == 2 and r in peers
            sent = [_sent_np(ranks[q][f"dt.local.{k}"]) for q in peers]
            want = np.sum(sent, axis=0)
            got = out[f"dt.red.{k}"]
            if k in BF16:
                assert _bf16_close(want, got), (k, r)
            else:
                assert _rel(want, got) < RED_TOL, (k, r)
            mine = sent[peers.index(r)]
            assert _rel(out[f"dt.local.{k}"] - mine, out[f"dt.res.{k}"]) \
                < RED_TOL, (k, r)


def test_compress_psum_of_an_autograd_gradient_loses_nothing(executed):
    """The gradient of a loss over a batch sharded over ``data`` comes
    from autograd Partial over ``data``; ``compress_psum`` sums it to a
    Replicate gradient, within half a quantization step a block of the
    whole gradient, and the sum plus the residual's (still Partial) sum
    is the whole gradient at RED_TOL of its max."""
    _, ranks = executed
    coords = [tuple(out["coord"]) for out in ranks]
    true = ranks[0]["ag.true"]
    for r, out in enumerate(ranks):
        assert str(out["ag.placements"]) == "(Partial(sum), Shard(dim=1))"
        assert str(out["ag.red_placements"]) == "(Replicate(), Shard(dim=1))"
        np.testing.assert_array_equal(out["ag.true"], true)
        assert _rel(true, out["ag.red"] + out["ag.res"]) < RED_TOL, r
        # each element of the sum is off by at most half a step of each
        # of the two blocks summed into it
        for col in (0, 1):
            peers = [q for q, c in enumerate(coords) if c[1] == col]
            half = sum(_quantize_np(ranks[q]["ag.local"])[1] / 2
                       for q in peers)
            cut = slice(20 * col, 20 * col + 20)
            gap = np.abs(out["ag.red"][:, cut] - true[:, cut]).max()
            assert gap <= half * (1 + 1e-5), (r, col, float(gap), half)


@pytest.mark.parametrize("case", ["replicate", "group"])
def test_compress_psum_refuses_a_reduced_or_misplaced_dtensor(executed, case):
    """A Replicate DTensor (already summed: summing it again would count
    it once a rank) and a DTensor given a process group instead of its
    mesh's dim raise, naming what to pass."""
    _, ranks = executed
    for r, out in enumerate(ranks):
        msg = str(out[f"refused.{case}"])
        assert msg, (case, r)
        assert ("Partial(sum)" if case == "replicate" else "DeviceMesh") \
            in msg, (case, r, msg)
