"""The port's dry run (``repro_torch.launch.dryrun``), roofline and report
against the reference's ``launch/dryrun.py``, ``benchmarks/roofline.py``
and ``benchmarks/dryrun_report.py``.

A process group is global to its process, so every trace on a ``fake``
group runs in one subprocess (``traced``, once for the module), which
prints one JSON object of what the tests here read: a sharded einsum's
recorded FLOPs beside its local and global counts; a shard-to-shard
redistribute's collectives in the trace and outside it; the reduced
internlm2's train, prefill and decode cells (2 layers, no remat) on a
fake (4, 4) mesh; and the reduced step traced on a world-1 mesh beside
the same step run for real on the CPU under the same counting function
(phase 6g's check on the card)."""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro.launch.dryrun import collective_bytes_from_hlo
from repro_torch.launch import dryrun as tdryrun, dryrun_report, roofline

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SRC = os.path.join(ROOT, "src")

TRACES = r'''
import dataclasses, json, sys
import numpy as np, torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode
from repro_torch import configs
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import dryrun, shapes
from repro_torch.models.params import NamedSharding
from repro_torch.train import steps
torch.manual_seed(0)
out = {}
M, K, N = 64, 48, 32
with dryrun.fake_group(16):
    mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    meta = lambda *shape: torch.empty(shape, device="meta")
    c = dryrun.trace_step(lambda a, b: torch.einsum("mk,kn->mn", a, b),
                          (meta(M, K), meta(K, N)),
                          (NamedSharding(mesh, ("data", None)),
                           NamedSharding(mesh, (None, "model"))), mesh)
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(M // 4, K), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(K, N // 4), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        with FlopCounterMode(display=False) as fc:
            torch.einsum("mk,kn->mn", x, w)
    out["einsum"] = {"recorded": c.flops, "local": 2 * (M // 4) * K * (N // 4),
                     "global": 2 * M * K * N, "flop_counter": fc.get_total_flops()}
    # a shard-to-shard redistribute over "data": one all-to-all in the
    # trace, the all-gather fallback of a cpu mesh outside it, and the
    # patched attributes back as they were after it
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    before = (cu.local_tensor_mode, dict(vars(ShardingPropagator)))
    seen = {}

    def move(a):
        b = a.redistribute(mesh, [Shard(1), Replicate()])
        seen.update(placements=str(b.placements),
                    local=list(b.to_local().shape), shape=list(b.shape))
        return b

    c = dryrun.trace_step(move, (meta(M, K),),
                          (NamedSharding(mesh, ("data", None)),), mesh)
    after = (cu.local_tensor_mode, dict(vars(ShardingPropagator)))
    with FakeTensorMode():
        a = DTensor.from_local(torch.empty(M // 4, K), mesh,
                               [Shard(0), Replicate()], run_check=False)
        _, plain = dryrun.count_step(
            lambda a: a.redistribute(mesh, [Shard(1), Replicate()]), a)
    out["alltoall"] = dict(
        seen, collectives=[[k, str(d), list(s), g] for k, d, s, g
                           in c.collectives], flops=c.flops,
        outside=[k for k, *_ in plain.collectives],
        restored=before[0] is after[0] and before[1] == after[1])
    # run_cell resolves the arch by name: the reduced config, 2 layers
    small = dataclasses.replace(configs.reduced(configs.get("internlm2-1.8b")),
                                num_layers=2)
    # the MoE archs (moe_impl "shard_map", their configs') at 2 layers,
    # jamba at one group of 4, mamba2 at 2 layers, one microbatch each
    smalls = {"internlm2-1.8b": small}
    for name, layers in (("granite-moe-1b-a400m", 2), ("qwen2-moe-a2.7b", 2),
                         ("jamba-v0.1-52b", 4), ("mamba2-130m", 2)):
        smalls[name] = dataclasses.replace(configs.reduced(configs.get(name)),
                                           num_layers=layers, grad_accum=1)
    configs.get = smalls.__getitem__
    cells = {}
    for name, kw in (("train_4k", dict(seq=64, batch=8)),
                     ("prefill_32k", dict(seq=64, batch=8)),
                     ("decode_32k", dict(seq=64, batch=8))):
        old = shapes.SHAPES[name]
        shapes.SHAPES[name] = dataclasses.replace(old, **kw)
        try:
            rec = dryrun.run_cell("internlm2-1.8b", name, multi_pod=False,
                                  remat="none", out_dir=sys.argv[1],
                                  mesh=mesh)
        finally:
            shapes.SHAPES[name] = old
        cells[name] = {k: rec.get(k) for k in (
            "ok", "error", "n_devices", "cost_analysis", "memory_analysis",
            "collectives", "arg_bytes_per_device", "trace_s")}
    out["cells"] = cells
    moe_cells = {}
    for arch in ("granite-moe-1b-a400m", "qwen2-moe-a2.7b", "jamba-v0.1-52b"):
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            old = shapes.SHAPES[name]
            shapes.SHAPES[name] = dataclasses.replace(old, seq=32, batch=8)
            try:
                rec = dryrun.run_cell(arch, name, multi_pod=False,
                                      remat="none", out_dir=sys.argv[2],
                                      mesh=mesh)
            finally:
                shapes.SHAPES[name] = old
            moe_cells[f"{arch}.{name}"] = {k: rec.get(k) for k in (
                "ok", "error", "cost_analysis", "collectives")}
    out["moe_cells"] = moe_cells
# the reduced mamba2's train on a fake (2, 4, 4) mesh: the batch over
# (pod, data) and the heads over model fold into one batch dim of the SSD
# products, which activation.einsum keeps apart
with dryrun.fake_group(32):
    mesh = init_device_mesh("cpu", (2, 4, 4),
                            mesh_dim_names=("pod", "data", "model"))
    old = shapes.SHAPES["train_4k"]
    shapes.SHAPES["train_4k"] = dataclasses.replace(old, seq=32, batch=16)
    try:
        rec = dryrun.run_cell("mamba2-130m", "train_4k", multi_pod=True,
                              remat="none", out_dir=sys.argv[2], mesh=mesh)
    finally:
        shapes.SHAPES["train_4k"] = old
    out["mamba2_3d"] = {k: rec.get(k) for k in ("ok", "error", "n_devices",
                                                "cost_analysis")}
# the reduced step on a world-1 mesh: the trace against a real CPU step
cfg = small
B, S = 4, 32
old = shapes.SHAPES["train_4k"]
shapes.SHAPES["train_4k"] = dataclasses.replace(old, batch=B, seq=S)
try:
    with dryrun.fake_group(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        fn, args, in_sh, _, _ = shapes.build_step(cfg, "train_4k", mesh)
        tr = dryrun.trace_step(fn, args, in_sh, mesh)
        arg_bytes = dryrun._arg_bytes_per_device(args, in_sh, 1)
finally:
    shapes.SHAPES["train_4k"] = old
state = steps.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
tok = torch.from_numpy(np.random.default_rng(0).integers(
    0, cfg.vocab_size, (B, S)).astype(np.int32))
_, real = dryrun.count_step(lambda st, b: steps.train_step(cfg, st, b),
                            state, {"tokens": tok})
out["world1"] = {"traced_flops": tr.flops, "real_flops": real.flops,
                 "traced_temp": tr.temp_bytes, "real_temp": real.temp_bytes,
                 "arg_bytes": arg_bytes,
                 "state_bytes": sum(t.numel() * t.element_size()
                                    for t in tree_leaves((state, tok)))}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("dryrun"))
    moe_dir = str(tmp_path_factory.mktemp("dryrun_moe"))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", TRACES, out_dir, moe_dir],
                          env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res["out_dir"] = out_dir
    return res


def test_sharded_einsum_flops_are_local(traced):
    """A (4, 4)-sharded einsum records its local 2·m·n·k; FlopCounterMode
    around the DTensor program counts the global product."""
    e = traced["einsum"]
    assert e["recorded"] == e["local"] == e["global"] // 16
    assert e["flop_counter"] == e["global"]


def test_shard_to_shard_redistribute_is_one_alltoall(traced):
    """``trace_step`` records a (4, 4) mesh's Shard(0) → Shard(1) over
    "data" as the one all-to-all a GPU mesh runs, of the local result's
    shape over a group of 4, with nothing else: the result is laid out
    and shaped as DTensor lays it out. ``count_step``, which patches
    nothing, sees the cpu mesh's all-gather fallback, and both patched
    attributes of torch are back as they were after the trace."""
    a = traced["alltoall"]
    assert a["collectives"] == [["all-to-all", "torch.float32", [64, 12], 4]]
    assert a["flops"] == 0
    assert a["placements"] == "(Shard(dim=1), Replicate())"
    assert a["local"] == [64, 12] and a["shape"] == [64, 48]
    assert a["outside"] == ["all-gather"]
    assert a["restored"]


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k"])
def test_reduced_internlm2_traces_on_fake_4x4_mesh(traced, cell):
    rec = traced["cells"][cell]
    assert rec["ok"], rec["error"]
    assert rec["n_devices"] == 16
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["cost_analysis"]["bytes accessed"] > 0
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    assert rec["arg_bytes_per_device"] > 0
    counts = rec["collectives"]["counts"]
    assert set(counts) == set(tdryrun._COLLECTIVES)
    if cell == "train_4k":     # FSDP gathers, the gradients' reductions
        assert counts["all-gather"] > 0
        assert counts["reduce-scatter"] + counts["all-reduce"] > 0


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-moe-a2.7b",
                                  "jamba-v0.1-52b"])
@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k"])
def test_reduced_moe_archs_trace_on_fake_4x4_mesh(traced, arch, cell):
    """The MoE configs' cells (``moe_impl="shard_map"``: routing on each
    device's tokens) trace ``ok`` on a fake (4, 4) mesh, with the expert
    TP's reductions among the collectives: per MoE layer at least the sum
    of the partial outputs over "model" and the aux loss's mean."""
    rec = traced["moe_cells"][f"{arch}.{cell}"]
    assert rec["ok"], rec["error"]
    assert rec["cost_analysis"]["flops"] > 0
    n_moe = {"granite-moe-1b-a400m": 2, "qwen2-moe-a2.7b": 2,
             "jamba-v0.1-52b": 2}[arch]
    assert rec["collectives"]["counts"]["all-reduce"] >= 2 * n_moe


def test_reduced_mamba2_train_traces_on_fake_2x4x4_mesh(traced):
    """The batch over (pod, data) and the heads over "model": the SSD
    products' batch dims stay apart (``activation.einsum``) and the
    in-projection's gradient keeps its layout (``grad_laid_out``)."""
    rec = traced["mamba2_3d"]
    assert rec["ok"], rec["error"]
    assert rec["n_devices"] == 32 and rec["cost_analysis"]["flops"] > 0


def test_record_file_and_report(traced):
    """Each cell's record is written as the reference names it, and the
    report renders one row a record with a "trace s" column."""
    names = sorted(os.listdir(traced["out_dir"]))
    assert names == sorted(f"internlm2-1.8b_{c}_pod16x16.json"
                           for c in ("train_4k", "prefill_32k", "decode_32k"))
    md = dryrun_report.markdown(traced["out_dir"])
    assert "| trace s |" in md.splitlines()[0]
    rows = md.splitlines()[2:]
    assert len(rows) == 3 and all("| ✓ |" in r for r in rows)


def test_world1_trace_counts_a_real_step(traced):
    """Phase 6g's check at a reduced size on the CPU: the step traced on
    fake tensors on a world-1 mesh and the same step run for real under
    the same counting function record the same FLOPs and the same peak
    of live bytes; the arguments' bytes are the state's and the batch's."""
    w = traced["world1"]
    assert w["traced_flops"] == w["real_flops"] > 0
    assert w["traced_temp"] == w["real_temp"] > 0
    assert w["arg_bytes"] == w["state_bytes"]


# ------------------------------------------------------------- collectives
RECORDS = [
    ("all-gather", torch.bfloat16, (16, 4096, 1536), 16,
     "%ag = bf16[16,4096,1536]{2,1,0} all-gather(%p1), channel_id=1, "
     "replica_groups=[16,16]<=[16,16]T(1,0), dimensions={0}"),
    ("all-reduce", torch.float32, (1024,), 32,
     "%ar = f32[1024]{0} all-reduce(%x), replica_groups=[8,32]<=[256], "
     "to_apply=%sum"),
    ("reduce-scatter", torch.float32, (64,), 4,
     "%rs = f32[64]{0} reduce-scatter(%y), replica_groups={{0,1,2,3}}, "
     "dimensions={0}"),
    ("collective-permute", torch.bfloat16, (8, 128), 1,
     "%cp = bf16[8,128]{1,0} collective-permute(%z), "
     "source_target_pairs={{0,1}}"),
    ("all-to-all", torch.bfloat16, (32, 64), 16,
     "%aa = bf16[32,64]{1,0} all-to-all(%w), replica_groups=[16,16]<=[256], "
     "dimensions={0}"),
    ("all-reduce", torch.bfloat16, (16, 4096, 2048), 16,
     "%ar2 = bf16[16,4096,2048]{2,1,0} all-reduce(%h), "
     "replica_groups=[16,16]<=[256], to_apply=%sum"),
]


@pytest.mark.parametrize("n", range(1, len(RECORDS) + 1))
def test_collective_accounting_matches_reference(n):
    """The same (kind, dtype, shape, group size) list, as the port's
    records and as the reference's HLO lines (``test_collective_parser``'s
    and an all-to-all): equal counts, operand bytes and wire bytes."""
    recs = RECORDS[:n]
    want = collective_bytes_from_hlo(
        "\n".join(line for *_, line in recs) + "\n  %dot = f32[32,64]{1,0} "
        "dot(%a, %b)\n")
    got = tdryrun.collective_bytes([r[:4] for r in recs])
    assert got == want


# ------------------------------------------------------------- roofline
def _reference_roofline():
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    try:
        import roofline as jroofline
    finally:
        sys.path.pop(0)
    return jroofline


def _records():
    coll = tdryrun.collective_bytes([r[:4] for r in RECORDS])
    base = {"ok": True, "n_devices": 256, "mesh": "pod16x16", "tag": "",
            "collectives": coll, "memory_analysis": {
                "temp_size_in_bytes": 7.5e9}}
    return [
        dict(base, arch="internlm2-1.8b", shape="train_4k", accum_scale=1,
             overrides={}, cost_analysis={"flops": 1.0114e14,
                                          "bytes accessed": 8.2e12},
             arg_bytes_per_device=1.3e8, model_flops_global=1.19e16,
             param_count=1.9e9),
        dict(base, arch="yi-9b", shape="train_4k", accum_scale=2,
             overrides={"unroll": True, "grad_accum": 1},
             cost_analysis={"flops": 3.1e14, "bytes accessed": 2.0e13},
             arg_bytes_per_device=6.6e8, model_flops_global=5.6e16,
             param_count=8.8e9),
        dict(base, arch="mamba2-130m", shape="prefill_32k", accum_scale=1,
             overrides={}, cost_analysis={"flops": 2.2e12,
                                          "bytes accessed": 3.0e11},
             arg_bytes_per_device=2.0e7, model_flops_global=2.7e14,
             param_count=1.3e8),
        dict(base, arch="qwen2-moe-a2.7b", shape="decode_32k", accum_scale=1,
             overrides={}, cost_analysis={"flops": 6.4e9,
                                          "bytes accessed": 1.2e11},
             arg_bytes_per_device=2.0e9, model_flops_global=6.9e11,
             param_count=1.4e10),
        dict(base, arch="gemma3-4b", shape="train_4k", ok=False),
        dict(base, arch="gemma3-4b", shape="decode_32k",
             cost_analysis="unavailable"),
    ]


@pytest.mark.parametrize("i", range(6))
def test_roofline_rows_match_reference_on_its_constants(i):
    """With the reference's TPU constants passed in, ``analyze_record``
    gives the reference's row (floats at 1e-12), deployment record and
    all; a failed record and one without FLOPs give None in both."""
    jroofline = _reference_roofline()
    rec = _records()[i]
    deploy = dict(rec, arg_bytes_per_device=rec.get(
        "arg_bytes_per_device", 0) * 2) if i == 1 else None
    want = jroofline.analyze_record(rec, deploy=deploy)
    got = roofline.analyze_record(
        rec, deploy=deploy, peak_flops=jroofline.PEAK_FLOPS,
        hbm_bw=jroofline.HBM_BW, link_bw=jroofline.LINK_BW, hbm_gb=16.0)
    if want is None:
        assert got is None
        return
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert math.isclose(got[k], v, rel_tol=1e-12), k
        else:
            assert got[k] == v, k


def test_roofline_defaults_are_h100():
    rec = _records()[0]
    row = roofline.analyze_record(rec)
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9 and roofline.HBM_GB == 80.0
    assert row["compute_s"] == rec["cost_analysis"]["flops"] / 989e12
    assert row["ideal_s"] == max(rec["model_flops_global"] / (256 * 989e12),
                                 rec["arg_bytes_per_device"] / 3.35e12)
    assert "fits_hbm80" in row and "fits_hbm16" not in row
    table = roofline.markdown_table([row])
    assert table.count("\n") == 2 and "internlm2-1.8b" in table
