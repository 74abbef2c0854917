"""The sharded steps of one family executed on four ``gloo`` ranks: the
rank side and the launcher of ``tests/test_torch_sharded_*.py`` (not a
test file itself).

Each rank runs, for each arch at ``configs.reduced`` and on a (2, 2) and
a (1, 4) mesh of ("data", "model"), the train step (``grad_accum`` 2),
the prefill and a decode at position 40 of a 64-long cache, each from
``launch/shapes.py`` ``build_step`` on DTensors laid out by its
in-shardings, and ``steps.value_and_grad`` on the train step's layout.
Rank 0 runs the same steps with no mesh on the same weights and inputs
and prints one JSON object of the comparisons, which the tests read.

The MoE and hybrid families run twice. In bf16 their logits are held
with the meshless step taking the mesh's top-k picks (gathered from the
ranks: each routes its own batch shard), and the picks' agreement with
the meshless step's own apart. In fp32 (every weight cast, the embedding
kept in fp32 on both sides) the loss, the aux loss and every gradient
are held against the meshless step, which on a mesh with ``data`` > 1
takes the reference's per-shard aux loss (``models/moe.py``: each
device's Switch loss over its own batch shard, averaged over the
devices): the meshless loss plus 0.01 × the mean of the aux over each
data shard's rows.

For the MoE and hybrid families rank 0 also saves, in ``<arch>.npz`` in
the output directory, the fp32 weights and batch and what the fp32 step
gave on each mesh (every gradient of ``value_and_grad``, its loss and
aux loss; the train step's loss, aux loss, grad norm and first
moments), which ``tests/test_torch_sharded_moe.py`` holds against the
reference's sharded step (``reference_group``).

Run a group by hand: ``PYTHONPATH=src python tests/torch_sharded_ranks.py
<rank> <store file> <output directory> <arch> [<arch> ...]`` in four
processes, rank 0 to 3.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SRC = os.path.join(ROOT, "src")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
WORLD = 4
B, S, MAX, POS = 4, 32, 64, 40
PATCHES, DEC_LEN = 8, 16          # vlm vision prefix, whisper decoder tokens
MOE_FAMILIES = ("moe", "hybrid")
WRITTEN = {                       # decode: the dim of POS in each K/V leaf
    "k": 2, "v": 2, "kg": 3, "vg": 3, "kl": 3, "vl": 3, "kt": 2, "vt": 2}
RINGS = ("kl", "vl", "kt", "vt")  # ring buffers: POS lands in slot POS % W
STATES = ("conv", "h")            # SSM state: the whole leaf is written

# the bounds of tests/test_torch_launch.py's bf16 steps
REL_TOL = 3e-2
LOSS_RTOL = 1e-3
GNORM_RTOL = 1e-2
FP32_RTOL = 1e-5                  # the MoE families' fp32 steps
UPDATE_TOL = 0.25                 # tests/test_torch_moe_train.py's
PICKS_AGREE = 0.9                 # tests/test_torch_moe.py's


def run_group(tmp_path, archs) -> dict:
    """Start the four ranks on ``archs`` and return rank 0's JSON object,
    {arch: {mesh: {step: comparisons}}}; rank 0's npz files go to
    ``tmp_path``."""
    store = str(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, __file__, str(r), store,
                               str(tmp_path), *archs], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=600))
        finally:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, p.returncode, err[-4000:])
    return json.loads(outs[0][0].strip().splitlines()[-1])


def update_error(a0, a1, m0, m1, b0, b1, bits: int, tol: float, lr: float
                 ) -> tuple:
    """One step's update of a leaf against the oracle's, in units of
    ``lr``, element by element, past one ulp of the larger new param in
    its dtype (``bits`` of mantissa: each side rounds its new params
    once): (the errors, the elements whose oracle gradient is resolved,
    above 4·``tol`` of its leaf's max |g|, so that rounding cannot flip
    its sign). ``a`` are the oracle's params before and after, ``b`` the
    checked side's, ``m`` the oracle's first moments; the gradient is read
    from them as (m1 − b1·m0) / (1 − b1) with AdamW's b1 of 0.9. Numpy in,
    numpy out: ``tests/test_torch_moe_train.py`` ``_assert_updates_close``
    and the ranks' ``update_errs`` share it."""
    import numpy as np
    g = (m1 - 0.9 * m0) / 0.1
    now = np.abs(g) > 4 * tol * np.abs(g).max()
    big = np.maximum(np.maximum(np.abs(a1), np.abs(b1)), 1e-30)
    ulp = 2.0 ** (np.floor(np.log2(big)) - bits)
    return (np.abs((a1 - a0) - (b1 - b0)) - ulp) / lr, now


def worst(errs: dict) -> tuple:
    """(leaf, error) of the largest error of ``{leaf: error}``."""
    name = max(errs, key=errs.get)
    return name, errs[name]


# ---------------------------------------------------------------------------
# the checks the tests make on rank 0's comparisons; each assertion names
# the arch, the mesh, the step and the leaf, and the error it read
# ---------------------------------------------------------------------------
def check_train(r: dict, where: str, rtol: float = REL_TOL,
                loss_rtol: float = LOSS_RTOL,
                gnorm_rtol: float = GNORM_RTOL) -> None:
    """Loss (of the step and of ``value_and_grad``), grad norm, every
    gradient and both moments after the step, each leaf at ``rtol`` of
    its max (v, ~g², at twice that), and every gradient laid out as its
    param."""
    assert r["loss"] < loss_rtol and r["grad_loss"] < loss_rtol, (where, r)
    assert r["grad_norm"] < gnorm_rtol, (where, r["grad_norm"])
    assert r["n_grads"] > 0 and r["grads_laid_out_as_params"], (where, r)
    for what, bound in (("grads", rtol), ("m", rtol), ("v", 2 * rtol)):
        leaf, e = worst(r[what])
        assert e < bound, (where, what, leaf, e)


def check_updates(r: dict, where: str) -> None:
    """Each leaf's update in units of the step's lr (``update_errs``): on
    the elements whose gradient no rounding can flip within UPDATE_TOL,
    on every element within 2·lr (a sign flip at the first step)."""
    ups = r["updates"]
    held = {k: v[0] for k, v in ups.items()}
    leaf, e = worst(held)
    assert e < UPDATE_TOL, (where, "update held", leaf, e, r["lr"])
    leaf, e = worst({k: v[1] for k, v in ups.items()})
    assert e <= 2 + 1e-3, (where, "update", leaf, e, r["lr"])
    assert sum(v[2] for v in ups.values()) > 0, (where, ups)


def check_serve(r: dict, where: str, step: str) -> None:
    """The logits and every cache leaf at REL_TOL, finite, ``pos`` as the
    meshless step's, every cache leaf laid out as ``build_step``'s
    out-shardings say; after a decode the written position of each K/V
    leaf (or the SSM state) holds the new values, not the old ones."""
    assert r["finite"] and r["logits"] < REL_TOL, (where, step, r["logits"])
    leaf, e = worst(r["cache"])
    assert e < REL_TOL, (where, step, "cache", leaf, e)
    assert r["pos"][0] == r["pos"][1], (where, step, r["pos"])
    assert r["layout"] and all(r["layout"].values()), (where, step,
                                                       r["layout"])
    if step == "decode":
        assert r["pos"][0] == POS + 1, (where, r["pos"])
        assert r["written"].keys() == r["moved"].keys() and r["written"]
        leaf, e = worst(r["written"])
        assert e < REL_TOL, (where, "written", leaf, e)
        leaf = min(r["moved"], key=r["moved"].get)
        assert r["moved"][leaf] > REL_TOL, (where, "moved", leaf,
                                            r["moved"][leaf])


def check_picks(res: dict, where: str) -> None:
    """The mesh's top-k picks of the prefill and the decode against the
    meshless step's own: at least PICKS_AGREE of the (token, layer) rows,
    as ``tests/test_torch_moe.py`` holds them over a served run."""
    (a, n), (b, m) = res["prefill"]["agree"], res["decode"]["agree"]
    assert n > 0 and m > 0
    assert (a + b) / (n + m) >= PICKS_AGREE, (where, a, n, b, m)


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------
def _main(rank: int, store: str, outdir: str, archs: list) -> None:
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch import configs
    from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
    from repro_torch.launch import shapes
    from repro_torch.models import lm, moe, registry
    from repro_torch.optim import adamw
    from repro_torch.sharding.activation import (distributed, model_axis,
                                                 on_mesh, use_batch_axes,
                                                 use_mesh)
    from repro_torch.train import steps

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    for name, kw in (("train_4k", dict(batch=B, seq=S)),
                     ("prefill_32k", dict(batch=B, seq=S)),
                     ("decode_32k", dict(batch=B, seq=MAX))):
        shapes.SHAPES[name] = dataclasses.replace(shapes.SHAPES[name], **kw)
    shapes._VLM_PATCHES, shapes._AUDIO_DEC_LEN = PATCHES, DEC_LEN

    # -- helpers ------------------------------------------------------------
    def clone(tree):
        flat, treedef = tree_flatten(tree)
        return tree_unflatten(treedef, [
            t.clone() if isinstance(t, torch.Tensor) else t for t in flat])

    def on(args, in_sh):
        """Each tensor of ``args`` as a DTensor laid out by its sharding,
        each rank cutting its shard from its own copy (every rank made
        the same inputs): c10d's scatter and broadcast beside DTensor's
        functional collectives on one group can crash gloo under CPU
        contention (ROADMAP, "Reference behaviours")."""
        flat, treedef = tree_flatten(args)
        shs = tree_leaves(in_sh)
        assert len(flat) == len(shs), (len(flat), len(shs))
        return tree_unflatten(treedef, [
            distribute_tensor(t.clone(), sh.mesh, sh.placements,
                              src_data_rank=None)
            if isinstance(t, torch.Tensor) else t
            for t, sh in zip(flat, shs)])

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def named(tree, prefix=""):
        """{dotted path: leaf} of a tree of dicts and lists."""
        if isinstance(tree, (dict, list, tuple)):
            items = tree.items() if isinstance(tree, dict) else enumerate(tree)
            out = {}
            for k, v in items:
                out.update(named(v, f"{prefix}{k}."))
            return out
        return {prefix[:-1]: tree}

    def err(want, got):
        a, b = want.float(), got.float()
        return float((a - b).abs().max() / (a.abs().max() + 1e-9))

    def errs(want: dict, got: dict) -> dict:
        """{leaf: ``err``} of every leaf that has elements."""
        assert want.keys() == got.keys(), (sorted(want), sorted(got))
        return {k: err(want[k], got[k]) for k in want if want[k].numel()}

    def update_errs(old, want, got, m_want, lr, tol):
        """Each leaf's update (new − old) against the meshless step's at
        the first step, whose moments start at 0 (``update_error``):
        {leaf: [the largest error on the resolved elements, the largest
        on any element, the count of resolved elements]}."""
        out = {}
        for k in old:
            bits = {torch.bfloat16: 7, torch.float32: 23}[want[k].dtype]
            a0, a1, b1, m1 = (t.double().numpy() for t in (
                old[k], want[k], got[k], m_want[k]))
            e, now = update_error(a0, a1, 0.0, m1, a0, b1, bits, tol, lr)
            out[k] = [float(e[now].max(initial=0.0)), float(e.max()),
                      int(now.sum())]
        return out

    def inputs(cfg, rng):
        """The train/prefill batch, the decode token and the decode cache
        (random K/V and SSM states, ring slots holding positions
        POS − W .. POS − 1, ``pos`` POS), from ``rng``."""
        def normal(*shape, dtype=torch.bfloat16):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dtype)

        def ints(*shape):
            return torch.from_numpy(
                rng.integers(0, cfg.vocab_size, shape).astype(np.int32))

        if cfg.family == "audio":
            batch = {"frames": normal(B, S, cfg.d_model),
                     "tokens": ints(B, DEC_LEN)}
        else:
            batch = {"tokens": ints(B, S)}
        if cfg.family == "vlm":
            # a 2 x 4 patch grid at t = 0 (h = row, w = col), then text
            # from 4 in all three streams
            r = np.arange(PATCHES)
            vis = np.stack([np.zeros(PATCHES), r // 4, r % 4])
            text = np.broadcast_to(4 + np.arange(S - PATCHES),
                                   (3, S - PATCHES))
            pos = np.concatenate([vis, text], 1).astype(np.int32)
            batch["vision_embeds"] = normal(B, PATCHES, cfg.d_model)
            batch["mrope_positions"] = torch.from_numpy(
                np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                     (3, B, S))))
        cache = registry.init_cache(cfg, B, MAX, "cpu")
        for k, t in cache.items():
            if not isinstance(t, torch.Tensor) or not t.numel():
                continue
            if t.dtype == torch.int32:     # a ring's absolute positions
                w = t.shape[-1]
                slot = torch.arange(w, dtype=torch.int32)
                cache[k] = (POS - w + (slot - (POS - w)) % w).expand(
                    t.shape).contiguous()
            else:
                cache[k] = normal(*t.shape, dtype=t.dtype)
        cache["pos"] = POS
        return batch, ints(B, 1), cache

    def written(cache, k):
        """The part of cache leaf ``k`` a decode at POS writes."""
        t = cache[k]
        if k in STATES:
            return t
        dim = WRITTEN[k]
        at = POS % t.shape[dim] if k in RINGS else POS
        return t.narrow(dim, at, 1)

    def n_data(mesh):
        return mesh.size(mesh.mesh_dim_names.index("data"))

    class Picks:
        """Record each MoE call's top-k experts, in call order, or with
        ``forced`` (a list in call order) take those."""

        def __init__(self, forced=None):
            self.forced, self.calls = forced, []

        def __enter__(self):
            real = self.real = moe.top_k

            def top_k(probs, k):
                if self.forced is None:
                    _, idx = real(probs, k)
                else:
                    idx = torch.from_numpy(self.forced[len(self.calls)])
                self.calls.append(idx.numpy().copy())
                return probs.gather(1, idx), idx

            moe.top_k = top_k
            return self

        def __exit__(self, *exc):
            moe.top_k = self.real

    def gathered(mesh, calls):
        """The whole batch's picks of each call: each rank's own rows,
        the batch shards of the ranks at model coordinate 0 in the order
        of their data coordinate."""
        mine = (tuple(mesh.get_coordinate()), calls)
        every = [None] * WORLD
        dist.all_gather_object(every, mine)
        shards = sorted((c[0], picks) for c, picks in every if c[1] == 0)
        return [np.concatenate([p[i] for _, p in shards])
                for i in range(len(calls))]

    def agreement(a, b):
        """[(token, layer) rows whose k picks agree, in order, rows]."""
        assert len(a) == len(b) and all(x.shape == y.shape
                                        for x, y in zip(a, b))
        return [sum(int((x == y).all(1).sum()) for x, y in zip(a, b)),
                sum(len(x) for x in a)]

    def fp32_embed(cfg, table, tokens):
        """``lm.embed_lookup`` keeping the table in fp32 (the mesh's
        one-hot product too)."""
        if distributed(table):
            vocab = on_mesh(torch.arange(table.shape[0],
                                         device=table.device), model_axis())
            hit = (tokens[..., None] == vocab).to(torch.float32)
            return torch.einsum("bsv,vd->bsd", hit, table.float())
        return table.float()[tokens.long()]

    def shard_aux(n):
        """``steps.loss_fn`` with the reference's per-shard aux loss over
        ``n`` data shards: the loss plus 0.01 × the mean over each shard's
        rows of the aux loss (the batch's leaves split on their batch
        dim: dim 1 of ``mrope_positions``, dim 0 of the rest)."""
        real = steps.loss_fn

        def loss_fn(cfg, params, batch):
            _, met = real(cfg, params, batch)
            rows = batch["tokens"].shape[0] // n
            auxes = []
            for i in range(n):
                cut = {k: v.narrow(1 if k == "mrope_positions" else 0,
                                   i * rows, rows) for k, v in batch.items()}
                auxes.append(real(cfg, params, cut)[1]["aux_loss"])
            aux = sum(auxes) / n
            return met["loss"] + 0.01 * aux, {"loss": met["loss"],
                                              "aux_loss": aux}
        return loss_fn

    # -- the steps on a mesh and with none ------------------------------------
    def train(cfg, params, batch, mesh, *, full, rtol, saved=None):
        """The train step (grad_accum 2) and ``value_and_grad``: on the
        mesh on every rank; rank 0 also with no mesh and compares, and
        puts the mesh's values in the dict ``saved`` if it is given."""
        tcfg = dataclasses.replace(cfg, grad_accum=2)
        fn, _, in_sh, _, _ = shapes.build_step(tcfg, "train_4k", mesh)
        state = steps.TrainState(params=params, opt=adamw.init(params))
        with use_mesh(mesh):
            new, met = fn(*on((state, batch), in_sh))
        pshard = in_sh[0].params
        vg = shapes._replicating(
            lambda p, b: steps.value_and_grad(tcfg, p, b))
        with use_mesh(mesh), use_batch_axes(("pod", "data")):
            gmet, grads = vg(*on((params, batch), (pshard, in_sh[1])))
        layout = all(g.placements == sh.placements for g, sh in
                     zip(tree_leaves(grads), tree_leaves(pshard)))
        got = dict(met={k: whole(v) for k, v in met.items()},
                   gmet={k: whole(v) for k, v in gmet.items()},
                   params={k: whole(v) for k, v in named(new.params).items()},
                   m={k: whole(v) for k, v in named(new.opt.m).items()},
                   v={k: whole(v) for k, v in named(new.opt.v).items()},
                   grads={k: whole(v) for k, v in named(grads).items()})
        if rank:
            return None
        if saved is not None:
            saved.update({f"grads.{k}": v for k, v in got["grads"].items()})
            saved.update({f"m.{k}": v for k, v in got["m"].items()})
            saved.update({f"gmet.{k}": got["gmet"][k]
                          for k in ("loss", "aux_loss")})
            saved.update({f"met.{k}": got["met"][k]
                          for k in ("loss", "aux_loss", "grad_norm")})
        real = steps.loss_fn
        per_shard = cfg.family in MOE_FAMILIES and n_data(mesh) > 1
        if per_shard:
            steps.loss_fn = shard_aux(n_data(mesh))
        try:
            wnew, wmet = steps.train_step(tcfg, state, batch)
            wgm, wgrads = steps.value_and_grad(tcfg, params, batch)
        finally:
            steps.loss_fn = real
        res = dict(loss=err(wmet["loss"], got["met"]["loss"]),
                   grad_loss=err(wgm["loss"], got["gmet"]["loss"]),
                   oracle="per-shard aux" if per_shard else "meshless")
        if cfg.family in MOE_FAMILIES:
            res.update(aux=err(wmet["aux_loss"], got["met"]["aux_loss"]),
                       grad_aux=err(wgm["aux_loss"], got["gmet"]["aux_loss"]))
        if not full:
            return res
        old = named(params)
        res.update(
            grad_norm=err(wmet["grad_norm"], got["met"]["grad_norm"]),
            grads=errs(named(wgrads), got["grads"]),
            m=errs(named(wnew.opt.m), got["m"]),
            v=errs(named(wnew.opt.v), got["v"]),
            updates=update_errs(old, named(wnew.params), got["params"],
                                named(wnew.opt.m), float(wmet["lr"]), rtol),
            lr=float(wmet["lr"]), grads_laid_out_as_params=layout,
            n_grads=len(got["grads"]))
        return res

    def serve(cfg, params, batch, tok1, cache0, mesh, moe_picks):
        """Prefill of S into a cache of S and a decode at POS of MAX: on
        the mesh on every rank; rank 0 also with no mesh (on the mesh's
        picks for the MoE families) and compares."""
        out = {}
        fn, _, in_sh, out_sh, _ = shapes.build_step(cfg, "prefill_32k", mesh)
        with use_mesh(mesh), Picks() as pk:
            plog, pcache = fn(*on((params, batch), in_sh))
        ppicks = gathered(mesh, pk.calls) if moe_picks else None
        p_layout = {k: str(v.placements) == str(out_sh[1][k].placements)
                    for k, v in pcache.items() if isinstance(v, DTensor)}
        p_placed = {k: str(v.placements) for k, v in pcache.items()
                    if isinstance(v, DTensor)}
        pgot = {k: whole(v) for k, v in pcache.items() if k != "pos"}
        plog = whole(plog)
        fn, _, in_sh, out_sh, _ = shapes.build_step(cfg, "decode_32k", mesh)
        with use_mesh(mesh), Picks() as pk:
            dlog, dcache = fn(*on((params, tok1, clone(cache0)), in_sh))
        dpicks = gathered(mesh, pk.calls) if moe_picks else None
        d_layout = {k: str(v.placements) == str(out_sh[1][k].placements)
                    for k, v in dcache.items() if isinstance(v, DTensor)}
        d_placed = {k: str(v.placements) for k, v in dcache.items()
                    if isinstance(v, DTensor)}
        dgot = {k: whole(v) for k, v in dcache.items() if k != "pos"}
        dlog = whole(dlog)
        if rank:
            return None
        with Picks(ppicks if moe_picks else None) as forced:
            wlog, wcache = steps.prefill_step(cfg, params, batch, max_len=S)
        dwant = clone(cache0)
        with Picks(dpicks if moe_picks else None):
            dwlog, dwcache = steps.decode_step(cfg, params, tok1, dwant)
        out["prefill"] = dict(
            logits=err(wlog, plog), finite=bool(torch.isfinite(
                plog.float()).all()),
            cache=errs({k: v for k, v in wcache.items() if k != "pos"}, pgot),
            pos=[pcache["pos"], wcache["pos"]], layout=p_layout,
            placements=p_placed)
        wants = {k: v for k, v in dwcache.items() if k != "pos"}
        out["decode"] = dict(
            logits=err(dwlog, dlog), finite=bool(torch.isfinite(
                dlog.float()).all()),
            cache=errs(wants, dgot),
            written={k: err(written(dwcache, k), written(dgot, k))
                     for k in wants if k in WRITTEN or k in STATES
                     if written(dwcache, k).numel()},
            moved={k: err(written(dwcache, k), written(cache0, k))
                   for k in wants if k in WRITTEN or k in STATES
                   if written(dwcache, k).numel()},
            pos=[dcache["pos"], dwcache["pos"]], layout=d_layout,
            placements=d_placed)
        if moe_picks:
            with Picks() as own:
                steps.prefill_step(cfg, params, batch, max_len=S)
            with Picks() as own_d:
                steps.decode_step(cfg, params, tok1, clone(cache0))
            out["prefill"]["agree"] = agreement(ppicks, own.calls)
            out["decode"]["agree"] = agreement(dpicks, own_d.calls)
            out["prefill"]["n_calls"] = len(forced.calls)
        return out

    result = {}
    for arch in archs:
        cfg = configs.reduced(configs.get(arch))
        rng = np.random.default_rng(2)
        params = registry.init(cfg, torch.Generator().manual_seed(1), "cpu")
        batch, tok1, cache0 = inputs(cfg, rng)
        is_moe = cfg.family in MOE_FAMILIES
        result[arch], dump = {}, {}
        for label, shape in MESHES.items():
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            res = {"train": train(cfg, params, batch, mesh, full=not is_moe,
                                  rtol=REL_TOL)}
            res.update(serve(cfg, params, batch, tok1, cache0, mesh, is_moe)
                       or {})
            if is_moe:
                flat, treedef = tree_flatten(params)
                p32 = tree_unflatten(treedef, [t.float() for t in flat])
                real = lm.embed_lookup
                lm.embed_lookup = fp32_embed
                saved = {}
                try:
                    res["train_fp32"] = train(cfg, p32, batch, mesh,
                                              full=True, rtol=FP32_RTOL,
                                              saved=saved)
                finally:
                    lm.embed_lookup = real
                if rank == 0:
                    dump.update({f"{label}.{k}": v for k, v in saved.items()})
                    dump.update({f"params.{k}": v
                                 for k, v in named(p32).items()})
                    dump.update({f"batch.{k}": v for k, v in batch.items()})
            result[arch][label] = res
        if dump:
            np.savez(os.path.join(outdir, f"{arch}.npz"),
                     **{k: v.numpy() for k, v in dump.items()})
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(result))


if __name__ == "__main__":
    _main(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4:])
