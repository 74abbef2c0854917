"""Multi-pod dry run on the host (twin of the JAX package's
``launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch internlm2-1.8b --mesh both
    python -m repro_torch.launch.dryrun --all --probe --out results/probe

The reference forces 512 host devices and lowers and compiles each
(arch × shape) cell with XLA for the 16×16 pod and the 2×16×16 two-pod
mesh. Here ``main`` starts a ``fake`` process group of 256 or 512 ranks
in its own process (no data moves, no card is touched: a collective on
it returns at once), makes the production mesh of ``cpu`` devices on it,
and traces each cell's step once on DTensors whose local tensors are
fake (``FakeTensorMode``): each rank's shard of every argument, laid out
by ``launch/shapes.py`` ``build_step``'s in-shardings, inside
``use_mesh``. Nothing runs a kernel; the kernels' wrappers see CPU
tensors and take their plain versions.

``trace_step`` watches the trace below DTensor (``_StepCounter``, a
dispatch mode that lets DTensor turn each op into its local ops and
collectives first), so every number is per device, at local shapes:

* ``cost_analysis.flops``: the FLOPs of the local products
  (``torch.utils.flop_counter``'s formulas: matmuls, convolutions,
  attention), per device. ``FlopCounterMode`` around a DTensor program
  counts global shapes, once per op, which is not a device's count.
* ``cost_analysis["bytes accessed"]``: the bytes each local op that is
  not a view reads and writes (its tensor operands and results), summed.
* ``memory_analysis.temp_size_in_bytes``: the peak of live local bytes
  made during the step (storages the arguments do not hold), tracked by
  weak references to each new storage.
* ``collectives``: each ``_c10d_functional`` collective (and DTensor's
  all-to-all) that DTensor issues, as (kind, dtype, result shape, group
  size), summed under the reference's conventions
  (``collective_bytes``). DTensor falls back from all-to-all to an
  all-gather on a ``cpu`` mesh; the trace turns that fallback off, so it
  records the all-to-all a GPU mesh runs.

Only ``trace_step`` patches torch's DTensor internals, and it checks them
first. ``count_step`` counts a step on plain tensors with the same mode
and patches nothing: phase 6g's measured step on the card is an example.

A cell that fails is recorded as the reference records one: ``ok``
false, the error and the end of its traceback. ``trace_s`` stands for
the reference's ``lower_s`` and ``compile_s``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import configs
from ..core.tree import tree_flatten, tree_leaves, tree_unflatten
from ..sharding.activation import use_mesh
from . import shapes as shapes_lib

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def collective_bytes(records) -> dict:
    """Collective traffic per device from (kind, dtype, result shape,
    group size) records, under the reference's conventions
    (``collective_bytes_from_hlo``): with R the result's bytes and g the
    group size,

      operand bytes: all-gather R/g; all-reduce R; reduce-scatter R·g;
        all-to-all R; collective-permute R.
      wire bytes (ring-algorithm estimate actually crossing links):
        all-gather R·(g−1)/g; all-reduce 2R·(g−1)/g; reduce-scatter
        R·(g−1); all-to-all R·(g−1)/g; collective-permute R.
    """
    operand = {k: 0.0 for k in _COLLECTIVES}
    wire = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for op, dtype, shape, g in records:
        r = math.prod(shape) * dtype.itemsize
        g = max(int(g), 1)
        counts[op] += 1
        if op == "all-gather":
            operand[op] += r / g
            wire[op] += r * (g - 1) / g
        elif op == "all-reduce":
            operand[op] += r
            wire[op] += 2 * r * (g - 1) / g
        elif op == "reduce-scatter":
            operand[op] += r * g
            wire[op] += r * (g - 1)
        elif op == "all-to-all":
            operand[op] += r
            wire[op] += r * (g - 1) / g
        else:  # collective-permute
            operand[op] += r
            wire[op] += r
    return {"operand_bytes": operand, "wire_bytes": wire, "counts": counts}


def _collective_kind(func) -> str | None:
    """The reference's name of a collective op, or None for another op."""
    if func.namespace not in ("_c10d_functional", "_c10d_functional_autograd",
                              "_dtensor"):
        return None
    name = func._opname
    for key, kind in (("all_gather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_reduce", "all-reduce"),
                      ("all_to_all", "all-to-all"),
                      ("alltoall", "all-to-all"),
                      ("broadcast", "collective-permute"),
                      ("permute", "collective-permute")):
        if key in name:
            return kind
    return None


def _group_size(func, args, kwargs) -> int:
    """The group size of a functional collective: its ``group_size``
    argument, or the size of the group its ``group_name`` names."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a, value in zip(func._schema.arguments, args):
        if a.name == "group_size":
            return int(value)
    name = kwargs.get("group_name")
    if name is None:
        for a, value in zip(func._schema.arguments, args):
            if a.name == "group_name":
                name = value
    return _resolve_process_group(name).size()


def _readers(module, name: str) -> list[str]:
    """The functions defined in ``module`` whose code reads the global
    ``name``."""
    return sorted(
        k for k, f in vars(module).items()
        if inspect.isfunction(f) and f.__module__ == module.__name__
        and name in f.__code__.co_names)


@contextlib.contextmanager
def _gpu_alltoall():
    """DTensor's shard-to-shard redistribute as the all-to-all a GPU mesh
    runs: on a ``cpu`` mesh DTensor gathers the whole tensor instead
    (gloo has no all-to-all), a collective g times larger. The fake group
    takes either. The switch is ``_collective_utils``' global
    ``local_tensor_mode``, which ``shard_dim_alltoall`` alone reads; any
    other layout of this private module raises rather than change what
    else reads it."""
    from torch.distributed.tensor import _collective_utils as cu
    prev = getattr(cu, "local_tensor_mode", None)
    readers = _readers(cu, "local_tensor_mode")
    if (not callable(prev) or inspect.signature(prev).parameters
            or readers != ["shard_dim_alltoall"]):
        raise RuntimeError(
            f"torch {torch.__version__}: DTensor's _collective_utils does "
            f"not read local_tensor_mode() in shard_dim_alltoall alone "
            f"(readers {readers}): the dry run cannot count its all-to-all")
    cu.local_tensor_mode = lambda: True
    try:
        yield
    finally:
        cu.local_tensor_mode = prev


@contextlib.contextmanager
def _paused_in_propagation(counter: "_StepCounter"):
    """The counter paused while DTensor derives an op's output metadata:
    it runs the op once more on fake tensors of the global shapes, which
    no device computes. Raises where this torch's ``ShardingPropagator``
    has no such method of (self, op_schema)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if hasattr(ShardingPropagator, n)), None)
    inner = getattr(ShardingPropagator, name) if name else None
    if inner is None or list(inspect.signature(inner).parameters) != [
            "self", "op_schema"]:
        raise RuntimeError(
            f"torch {torch.__version__}: ShardingPropagator has no "
            f"_propagate_tensor_meta(_non_cached)(self, op_schema): the dry "
            f"run cannot keep DTensor's global-shape rerun out of its counts")

    def paused(self, *args, **kwargs):
        was, counter.paused = counter.paused, True
        try:
            return inner(self, *args, **kwargs)
        finally:
            counter.paused = was

    setattr(ShardingPropagator, name, paused)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, inner)


# ---------------------------------------------------------------------------
# the counting mode
# ---------------------------------------------------------------------------
class _StepCounter(TorchDispatchMode):
    """Counts the local ops of a step: FLOPs of the products, bytes read
    and written by the ops that are not views, collectives, and the peak
    of live bytes in storages made during the step. An op on DTensors is
    handed back (``NotImplemented``) so that DTensor runs it as local ops
    and collectives, which come back here."""

    def __init__(self, known: list[torch.Tensor] = ()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: list = []
        self.live = 0
        self.peak = 0
        self._known = {t.untyped_storage()._cdata for t in known}
        self._seen: set = set()
        self.paused = False

    def _free(self, key: int, nbytes: int) -> None:
        self._seen.discard(key)
        self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known or key in self._seen:
            return
        # the tensor's own bytes: a storage first seen through a view was
        # made inside an op's fake kernel (DTensor's all-to-all narrows a
        # g-times larger buffer) where the device allocates the result only
        nbytes = t.numel() * t.element_size()
        self._seen.add(key)
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            return out
        packet = func._overloadpacket
        if packet in self.flop_registry:
            self.flops += int(self.flop_registry[packet](*args, **kwargs,
                                                         out_val=out))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        kind = _collective_kind(func)
        if kind is not None:
            for t in outs:
                self.collectives.append((kind, t.dtype, tuple(t.shape),
                                         _group_size(func, args, kwargs)))
        if not func.is_view and "wait_tensor" not in func._opname:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


@dataclasses.dataclass
class TraceCounts:
    flops: int
    bytes_accessed: int
    temp_bytes: int
    collectives: list
    trace_s: float


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _counted(fn: Callable, args: tuple, traced: bool) -> tuple:
    """``fn(*args)`` under the counting mode, and, for a trace on
    DTensors (``traced``), DTensor's all-to-all and metadata rerun
    handled as ``_gpu_alltoall`` and ``_paused_in_propagation`` say.
    Storages of the arguments are not the step's."""
    held = [_local(t) for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    counter = _StepCounter(held)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as patched:
        if traced:
            patched.enter_context(_gpu_alltoall())
            patched.enter_context(_paused_in_propagation(counter))
        with counter:
            out = fn(*args)
    trace_s = time.perf_counter() - t0
    return out, TraceCounts(counter.flops, counter.bytes, counter.peak,
                            counter.collectives, trace_s)


def count_step(fn: Callable, *args) -> tuple:
    """``fn(*args)`` on plain tensors (a measured step on the card, or on
    the CPU) under the counting mode that ``trace_step`` uses, with
    nothing of DTensor patched; returns (its result, ``TraceCounts``).
    Storages of the arguments are not the step's."""
    return _counted(fn, args, traced=False)


def fake_args(args: Any, in_shardings: Any, fake_mode) -> Any:
    """Each ``meta`` tensor of ``args`` as a DTensor laid out by its
    ``NamedSharding`` (a tree of the same structure), its local tensor a
    fake one of the local shard's shape: nothing is allocated. Host
    values (the cache's ``pos``) stay as they are."""
    from torch.distributed.tensor import DTensor

    flat, treedef = tree_flatten(args)
    shards = tree_leaves(in_shardings)
    if len(shards) != len(flat):
        raise ValueError(f"{len(shards)} shardings for {len(flat)} arguments")
    out = []
    with fake_mode:
        for t, sh in zip(flat, shards):
            if not isinstance(t, torch.Tensor):
                out.append(t)
                continue
            local = torch.empty(_local_shape(t.shape, sh), dtype=t.dtype,
                                device=sh.mesh.device_type)
            out.append(DTensor.from_local(local, sh.mesh, sh.placements,
                                          run_check=False))
    return tree_unflatten(treedef, out)


def _local_shape(shape: tuple, sh) -> tuple:
    sizes = dict(zip(sh.mesh.mesh_dim_names, sh.mesh.shape))
    out = list(shape)
    for d, entry in enumerate(sh.spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[d] //= sizes[a]
    return tuple(out)


def _arg_bytes_per_device(args: Any, in_shardings: Any, n_devices: int
                          ) -> int:
    """The bytes of one device's shard of every tensor argument."""
    total = 0
    for t, sh in zip(tree_leaves(args), tree_leaves(in_shardings)):
        if not isinstance(t, torch.Tensor):
            continue
        nbytes = t.numel() * t.element_size()
        if sh is not None:
            sizes = dict(zip(sh.mesh.mesh_dim_names, sh.mesh.shape))
            used = 1
            for entry in sh.spec:
                if entry is None:
                    continue
                for a in (entry if isinstance(entry, tuple) else (entry,)):
                    used *= sizes[a]
            nbytes //= used
        total += nbytes
    return total


def model_flops(cfg, shape_name: str, sh=None) -> float:
    """Analytic 6·N·D (train) / 2·N·D (inference) model FLOPs, global."""
    sh = sh or shapes_lib.SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if sh.kind == "train":
        tokens = sh.batch * sh.seq
        return 6.0 * n_active * tokens
    if sh.kind == "prefill":
        tokens = sh.batch * sh.seq
        return 2.0 * n_active * tokens
    return 2.0 * n_active * sh.batch  # decode: one token per sequence


# ---------------------------------------------------------------------------
# meshes and cells
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks, this process rank
    0, for the block (the twin of the reference's forced host device
    count): collectives on it return at once and move nothing. Refuses to
    run beside another group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is running; the dry run "
                           "starts its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _probe_overrides(cfg, probe: bool, overrides: dict) -> tuple:
    accum_scale = 1
    if probe:
        # one microbatch; roofline scales the per-microbatch terms back up
        # by the real grad_accum (the port's layer loop is unrolled
        # already, so nothing else changes)
        overrides["unroll"] = True
        accum_scale = overrides.get("grad_accum", cfg.grad_accum)
        overrides["grad_accum"] = 1
    return overrides, accum_scale


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             ruleset: str | None = None, remat: str | None = None,
             grad_accum: int | None = None, attn_impl: str | None = None,
             embed_impl: str | None = None, xent_impl: str | None = None,
             moe_impl: str | None = None, window_cache: bool = False,
             probe: bool = False, out_dir: str = "results/dryrun",
             tag: str = "", mesh) -> dict:
    """Trace one cell on ``mesh`` (the production mesh of ``multi_pod``,
    made by the caller on a running process group: ``main`` makes it on
    the fake group it starts) and write its record to ``out_dir``."""
    cfg = configs.get(arch)
    overrides = {}
    for key, value in (("remat", remat), ("grad_accum", grad_accum),
                       ("attn_impl", attn_impl), ("embed_impl", embed_impl),
                       ("xent_impl", xent_impl), ("moe_impl", moe_impl)):
        if value is not None:
            overrides[key] = value
    if window_cache:
        overrides["window_cache"] = True
    overrides, accum_scale = _probe_overrides(cfg, probe, overrides)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "ruleset": ruleset, "overrides": overrides, "tag": tag,
        "probe": probe, "accum_scale": accum_scale,
        "ok": False,
    }
    sh0 = shapes_lib.SHAPES[shape_name]
    patched = sh0
    if probe and sh0.kind == "train" and accum_scale > 1:
        patched = dataclasses.replace(sh0, batch=sh0.batch // accum_scale)
    t0 = time.perf_counter()
    try:
        shapes_lib.SHAPES[shape_name] = patched
        rec["n_devices"] = mesh.size()
        fn, args, in_sh, out_sh, donate = shapes_lib.build_step(
            cfg, shape_name, mesh, ruleset_name=ruleset)
        rec["build_s"] = time.perf_counter() - t0
        counts = trace_step(fn, args, in_sh, mesh)
        rec["trace_s"] = counts.trace_s
        rec["cost_analysis"] = {"flops": float(counts.flops),
                                "bytes accessed": float(counts.bytes_accessed)}
        rec["memory_analysis"] = {
            "temp_size_in_bytes": counts.temp_bytes,
            "argument_size_in_bytes": _arg_bytes_per_device(
                args, in_sh, rec["n_devices"])}
        rec["collectives"] = collective_bytes(counts.collectives)
        rec["arg_bytes_per_device"] = rec["memory_analysis"][
            "argument_size_in_bytes"]
        rec["model_flops_global"] = model_flops(cfg, shape_name, sh=sh0)
        rec["param_count"] = cfg.param_count()
        rec["active_param_count"] = cfg.active_param_count()
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        shapes_lib.SHAPES[shape_name] = sh0
    rec["total_s"] = time.perf_counter() - t0

    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    path = os.path.join(out_dir,
                        f"{arch}_{shape_name}_{mesh_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def trace_step(fn: Callable, args: Any, in_shardings: Any, mesh
               ) -> TraceCounts:
    """``fn`` traced once on fake DTensors laid out by ``in_shardings``
    (``fake_args``) inside ``use_mesh(mesh)``, under the counting mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake_mode = FakeTensorMode()
    dargs = fake_args(args, in_shardings, fake_mode)
    with fake_mode, use_mesh(mesh):
        _, counts = _counted(fn, dargs, traced=True)
    return counts


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--ruleset", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--attn-impl", default=None)
    ap.add_argument("--embed-impl", default=None)
    ap.add_argument("--xent-impl", default=None)
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--window-cache", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="single-microbatch cost probe (see roofline.py)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    from .mesh import make_production_mesh
    archs = configs.ASSIGNED if (args.all or args.arch is None) \
        else [args.arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for multi in meshes:
        mesh_name = "pod2x16x16" if multi else "pod16x16"
        with fake_group(math.prod(MESHES[mesh_name][0])):
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
            for arch in archs:
                cfg = configs.get(arch)
                shp = shapes_lib.cells(cfg) \
                    if (args.all or args.shape is None) else [args.shape]
                for shape_name in shp:
                    suffix = f"_{args.tag}" if args.tag else ""
                    path = os.path.join(
                        args.out,
                        f"{arch}_{shape_name}_{mesh_name}{suffix}.json")
                    if args.skip_existing and os.path.exists(path):
                        with open(path) as f:
                            if json.load(f).get("ok"):
                                print(f"[skip] {path}")
                                continue
                    rec = run_cell(
                        arch, shape_name, multi_pod=multi,
                        ruleset=args.ruleset, remat=args.remat,
                        grad_accum=args.grad_accum,
                        attn_impl=args.attn_impl, embed_impl=args.embed_impl,
                        xent_impl=args.xent_impl, moe_impl=args.moe_impl,
                        window_cache=args.window_cache, probe=args.probe,
                        out_dir=args.out, tag=args.tag, mesh=mesh)
                    status = ("ok" if rec["ok"]
                              else f"FAIL: {rec.get('error')}"[:300])
                    print(f"[{arch} × {shape_name} × {mesh_name}] {status} "
                          f"(build {rec.get('build_s', 0):.1f}s, trace "
                          f"{rec.get('trace_s', 0):.1f}s)", flush=True)


if __name__ == "__main__":
    main()
