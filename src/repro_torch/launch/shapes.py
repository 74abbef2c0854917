"""Assigned input shapes × per-arch input specs + sharding policies (twin
of the JAX package's ``launch/shapes.py``).

``input_specs(cfg, shape_name)`` returns ``meta``-device tensors with the
shapes and dtypes of every input of the step (the twin of
``jax.eval_shape``: nothing is allocated), and ``build_step`` the step
with the matching ``NamedSharding`` trees (``models/params.py``). A
sharding resolves against a ``DeviceMesh`` or, for its spec alone, a
``{axis name: size}`` mapping.

Sharding policy summary (the reference's):
  train    params+opt 2D (FSDP over data × TP over model); batch over
           (pod, data)
  prefill  params TP; batch over (pod, data)
  decode   params TP; batch over (pod, data); KV-cache *sequence* over
           model (32k·128 caches don't fit otherwise)
  long     batch=1 → KV-cache sequence over (data, model); SSM state
           replicated (it is O(1) per sequence)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.tree import tree_map
from ..models import params as params_lib, registry
from ..models.config import ArchConfig
from ..models.params import NamedSharding
from ..optim import adamw
from ..sharding import rules as rules_lib
from ..sharding.activation import (axis_sizes, cache_axes, resolve_entries,
                                   use_batch_axes)
from ..train import steps


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# long_500k policy: only sub-quadratic families.
LONG_OK_FAMILIES = ("ssm", "hybrid")


def long_ok(cfg: ArchConfig) -> bool:
    return cfg.family in LONG_OK_FAMILIES or cfg.window is not None


def cells(cfg: ArchConfig) -> list[str]:
    """The assigned (runnable) shapes for this arch."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if long_ok(cfg):
        out.append("long_500k")
    return out


# ---------------------------------------------------------------------------
# input specs: meta tensors
# ---------------------------------------------------------------------------
_VLM_PATCHES = 1024          # stubbed vision prefix length (train/prefill)
_AUDIO_DEC_LEN = 448         # whisper decoder target length


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_sds(cfg: ArchConfig, sh: ShapeSpec) -> dict:
    i32, bf16 = torch.int32, torch.bfloat16
    b, s = sh.batch, sh.seq
    batch: dict = {}
    if cfg.family == "audio":
        batch["frames"] = _meta((b, s, cfg.d_model), bf16)
        batch["tokens"] = _meta((b, _AUDIO_DEC_LEN), i32)
        return batch
    batch["tokens"] = _meta((b, s), i32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = _meta((b, _VLM_PATCHES, cfg.d_model), bf16)
        batch["mrope_positions"] = _meta((3, b, s), i32)
    return batch


def _params_sds(cfg: ArchConfig) -> Any:
    return params_lib.tree_map(lambda p: _meta(p.shape, p.dtype),
                               registry.param_defs(cfg))


def input_specs(cfg: ArchConfig, shape_name: str) -> tuple:
    """``meta`` stand-ins for the step's arguments: (state, batch) for
    train, (params, batch) for prefill, (params, token, cache) for
    decode. The cache's ``pos`` is a host int, as the port's caches
    keep it."""
    sh = SHAPES[shape_name]
    params = _params_sds(cfg)
    if sh.kind == "train":
        return (steps.TrainState(params=params, opt=adamw.init(params)),
                _batch_sds(cfg, sh))
    if sh.kind == "prefill":
        return (params, _batch_sds(cfg, sh))
    # decode: one new token against a seq-sized cache
    cache = registry.init_cache(cfg, sh.batch, sh.seq, device="meta")
    return (params, _meta((sh.batch, 1), torch.int32), cache)


def shapes(fn: Callable, *args) -> Any:
    """``fn(*args)`` evaluated for its shapes alone, the twin of
    ``jax.eval_shape``: the ``meta`` tensors of ``args`` become fake CPU
    tensors (``FakeTensorMode``: nothing is allocated, and the kernels'
    wrappers take their plain versions), and each tensor of the result
    comes back as a ``meta`` tensor; other leaves as they are."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def fake(t):
        if isinstance(t, torch.Tensor):
            return torch.empty(t.shape, dtype=t.dtype, device="cpu")
        return t

    with FakeTensorMode():
        out = fn(*tree_map(fake, args))
    return tree_map(lambda t: _meta(t.shape, t.dtype)
                    if isinstance(t, torch.Tensor) else t, out)


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------
def _filter_spec(shape: tuple, entries, mesh) -> tuple:
    """Drop axes that don't exist / don't divide (every entry kept, as a
    ``PartitionSpec`` of the reference keeps them)."""
    return resolve_entries(tuple(shape), tuple(entries), axis_sizes(mesh))


def _named(mesh, shape, entries) -> NamedSharding:
    return NamedSharding(mesh, _filter_spec(shape, entries, mesh))


def _batch_shardings(cfg: ArchConfig, sh: ShapeSpec, mesh, batch_sds: dict,
                     bd: tuple = ("pod", "data")) -> dict:
    out = {}
    for k, sds in batch_sds.items():
        if k == "mrope_positions":
            out[k] = _named(mesh, sds.shape, [None, bd, None])
        else:
            out[k] = _named(mesh, sds.shape,
                            [bd] + [None] * (len(sds.shape) - 1))
    return out


def _params_shardings(cfg: ArchConfig, mesh, params_sds, ruleset: dict):
    return params_lib.shardings_for(registry.param_defs(cfg), mesh, ruleset)


def _cache_shardings(cfg: ArchConfig, sh: ShapeSpec, mesh, cache_sds: dict
                     ) -> dict:
    """KV cache: seq over model (decode_32k) or (data, model) (long_500k,
    batch=1); batch over (pod, data); SSM states: batch over (pod, data)
    (``sharding/activation.py`` ``cache_axes``, the layout the cache is
    made in on a mesh of several devices)."""
    long_ctx = sh.batch == 1
    out = {}
    for name, sds in cache_sds.items():
        shape = tuple(sds.shape) if isinstance(sds, torch.Tensor) else ()
        out[name] = _named(mesh, shape,
                           cache_axes(name, len(shape), long_ctx))
    return out


# ---------------------------------------------------------------------------
# the traceable step per cell
# ---------------------------------------------------------------------------
def _replicating(fn: Callable) -> Callable:
    """``fn`` with DTensor's implicit replication on: a plain tensor that
    the step makes (a scalar, a mask) meets the DTensors as a replicated
    one, as a constant of a jitted function meets sharded operands."""
    def run(*args):
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            return fn(*args)
    return run


def build_step(cfg: ArchConfig, shape_name: str, mesh,
               ruleset_name: str | None = None):
    """Returns (fn, args, in_shardings, out_shardings, donate) for one
    (arch × shape) cell on ``mesh``: ``args`` are ``meta`` tensors, and
    ``fn`` runs on them laid out by ``in_shardings`` as DTensors (under
    ``use_mesh(mesh)``). ``donate`` names the arguments the reference
    donates; torch has no donation, so it is data only."""
    sh = SHAPES[shape_name]
    args = input_specs(cfg, shape_name)
    if sh.kind == "train":
        rname = ruleset_name or cfg.train_ruleset or "train_2d"
        ruleset = rules_lib.RULESETS[rname]
        bd = rules_lib.BATCH_AXES_BY_RULESET.get(rname, ("pod", "data"))
        state_sds, batch_sds = args
        pshard = _params_shardings(cfg, mesh, state_sds.params, ruleset)
        state_shard = steps.TrainState(
            params=pshard,
            opt=adamw.AdamWState(m=pshard, v=pshard,
                                 step=NamedSharding(mesh, ())))
        in_shardings = (state_shard,
                        _batch_shardings(cfg, sh, mesh, batch_sds, bd=bd))
        out_shardings = (state_shard, None)

        def fn(state, batch):
            with use_batch_axes(bd):
                return steps.train_step(cfg, state, batch)
        return _replicating(fn), args, in_shardings, out_shardings, (0,)
    ruleset = rules_lib.RULESETS[ruleset_name or "serve"]
    if sh.kind == "prefill":
        params_sds, batch_sds = args
        pshard = _params_shardings(cfg, mesh, params_sds, ruleset)
        in_shardings = (pshard, _batch_shardings(cfg, sh, mesh, batch_sds))
        # shapes alone: through the plain attention, which takes a few ops
        # a layer where the chunked loop takes hundreds at 32k
        plain = dataclasses.replace(cfg, attn_impl="reference")
        cache_sds = shapes(
            lambda p, b: steps.prefill_step(plain, p, b, max_len=sh.seq)[1],
            params_sds, batch_sds)
        out_shardings = (None, _cache_shardings(cfg, sh, mesh, cache_sds))
        fn = lambda p, b: steps.prefill_step(cfg, p, b, max_len=sh.seq)
        return _replicating(fn), args, in_shardings, out_shardings, ()
    # decode
    params_sds, token_sds, cache_sds = args
    pshard = _params_shardings(cfg, mesh, params_sds, ruleset)
    cshard = _cache_shardings(cfg, sh, mesh, cache_sds)
    tshard = _named(mesh, token_sds.shape, [("pod", "data"), None])
    in_shardings = (pshard, tshard, cshard)
    out_shardings = (None, cshard)
    fn = lambda p, t, c: steps.decode_step(cfg, p, t, c)
    return _replicating(fn), args, in_shardings, out_shardings, (2,)
