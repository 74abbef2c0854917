"""Where the audio and vlm train twins' tolerances come from, on the CPU.

Not a test (pytest collects ``test_*.py`` only); run it from the repo's
root::

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_twin_tolerance.py encdec 0 64
    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_twin_tolerance.py vlm 0 64
    PYTHONHASHSEED=23 PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_twin_tolerance.py encdec hash

It reads ``test_encdec_train_step_at_grad_accum_2_matches_reference``
(``tests/test_torch_encdec.py``) and
``test_vlm_train_step_at_grad_accum_2_matches_reference``
(``tests/test_torch_vlm.py``) over many inits. The reference's initial
state follows the interpreter's hash seed (``repro.models.params._leaf_key``
folds ``hash(str(key))`` into each leaf's key), so each pytest process
trains other weights; here each init replaces that hash by sha256 of
``"{salt}/{key}"`` (``torch_train_tolerance.salted_leaf_key``, patched in
this process only); ``hash`` in place of the range reads the one init of
the process's own hash seed, as the test draws it. Each init runs the test's one step at ``grad_accum`` 2
from the same state and batch, read two ways:

- ``port``: the port against the reference (the reference's default
  ``attn_impl``, ``"chunked"``);
- ``floor``: the reference against itself with ``attn_impl="reference"``,
  which computes the same function and differs only in where bf16
  rounds.

For each it prints, per init, the largest first-moment error over the
leaves (max |a - b| / max |a|) and the leaf that reads it, the second
moment's likewise, and the port's update held element by element in
units of the step's lr (``test_torch_moe_train._assert_updates_close``'s
reading on the resolved elements). Then, over the inits, the largest and
the 99th percentile of each, and how many inits read at or above
GRAD_RTOL.
"""
import dataclasses
import sys

import numpy as np

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import params as jparams
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.core.tree import tree_leaves
from repro_torch.models import convert
from repro_torch.train import steps as tsteps
from test_torch_moe_train import _leaf_names, _np
from torch_train_tolerance import salted_leaf_key

GRAD_RTOL = 3e-2


def rel_err(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9))


def batches(which):
    """(arch name, reference batch, port batch) of the test's step."""
    if which == "encdec":
        import test_torch_encdec as t
        toks, frames = t._inputs(jconfigs.reduced(jconfigs.get(t.NAME)), 16,
                                 seed=8, batch=4)
        jf, tf = t._bf16(frames)
        return t.NAME, {"tokens": jnp.asarray(toks), "frames": jf}, \
            {"tokens": torch.from_numpy(toks), "frames": tf}
    import test_torch_vlm as t
    toks, vis = t._inputs(jconfigs.reduced(jconfigs.get(t.NAME)), 32,
                          seed=6, batch=4)
    jvis, tvis = t._bf16(vis)
    pos = t.grid_positions(4, 32, t.GRID)
    pos[:, 2:] += 7
    return t.NAME, {"tokens": jnp.asarray(toks), "vision_embeds": jvis,
                    "mrope_positions": jnp.asarray(pos)}, \
        {"tokens": torch.from_numpy(toks), "vision_embeds": tvis,
         "mrope_positions": torch.from_numpy(pos)}


def worst(names, want, got):
    errs = [(rel_err(a, b), n) for n, a, b in zip(names, want, got)
            if np.abs(_np(a)).max() > 0]
    return max(errs)


def update_err(names, j0, j1, t0, t1, lr):
    """The largest update error, in lr units past one ulp, over the
    elements whose reference gradient is above 4·GRAD_RTOL of its leaf's
    max (``_assert_updates_close`` at the first step), and the leaf."""
    out = []
    rows = zip(names, *(jax.tree_util.tree_leaves(t) for t in (
        j0.params, j1.params, j0.opt.m, j1.opt.m)),
        tree_leaves(t0.params), tree_leaves(t1.params))
    for name, a0, a1, m0, m1, b0, b1 in rows:
        bits = {torch.bfloat16: 7, torch.float32: 23}[b1.dtype]
        a0, a1, m0, m1, b0, b1 = map(_np, (a0, a1, m0, m1, b0, b1))
        g = (m1 - 0.9 * m0) / 0.1
        now = np.abs(g) > 4 * GRAD_RTOL * np.abs(g).max()
        big = np.maximum(np.maximum(np.abs(a1), np.abs(b1)), 1e-30)
        ulp = 2.0 ** (np.floor(np.log2(big)) - bits)
        err = (np.abs((a1 - a0) - (b1 - b0)) - ulp) / lr
        out.append((float(err[now].max(initial=0.0)), name))
    return max(out)


def main(which, lo, hi=None):
    torch.set_num_threads(2)
    name, jbatch, tbatch = batches(which)
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(name)),
                               grad_accum=2)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get(name)),
                               grad_accum=2)
    alt = dataclasses.replace(jcfg, attn_impl="reference")
    step = jax.jit(lambda s, b: jsteps.train_step(jcfg, s, b))
    alt_step = jax.jit(lambda s, b: jsteps.train_step(alt, s, b))
    runs = []
    for salt in (["hash"] if lo == "hash" else range(lo, hi)):
        if salt != "hash":
            jparams._leaf_key = salted_leaf_key(salt)
        j0 = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0))
        t0 = convert.train_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, j0))
        names = _leaf_names(j0.opt.m)
        j1, jm = step(j0, jbatch)
        a1, _ = alt_step(j0, jbatch)
        t1, _ = tsteps.train_step(tcfg, t0, tbatch)
        row = {}
        for tree in ("m", "v"):
            want = jax.tree_util.tree_leaves(getattr(j1.opt, tree))
            row[f"port.{tree}"] = worst(names, want,
                                        tree_leaves(getattr(t1.opt, tree)))
            row[f"floor.{tree}"] = worst(names, want, jax.tree_util.tree_leaves(
                getattr(a1.opt, tree)))
        row["port.update"] = update_err(names, j0, j1, t0, t1,
                                        float(jm["lr"]))
        row["floor.update"] = update_err(
            names, j0, j1, t0, convert.train_state_from_numpy(
                jax.tree_util.tree_map(np.asarray, a1)), float(jm["lr"]))
        runs.append(row)
        print(salt, {k: (round(v, 5), n) for k, (v, n) in row.items()},
              flush=True)
    if lo == "hash":
        return
    print(f"{which}: over {len(runs)} inits (salts {lo}..{hi - 1}): max / "
          f"p99 / inits at or above {GRAD_RTOL:g}")
    for key in runs[0]:
        vals = np.array([r[key][0] for r in runs])
        at = max(runs, key=lambda r: r[key][0])[key][1]
        print(f"  {key:14s} {vals.max():.4g} ({at}) / "
              f"{np.quantile(vals, 0.99):.4g} / "
              f"{int((vals >= GRAD_RTOL).sum())}")


if __name__ == "__main__":
    if sys.argv[2] == "hash":
        main(sys.argv[1], "hash")
    else:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
