"""Where ``test_three_train_steps_match_reference``'s tolerances come from,
on the CPU.

Not a test (pytest collects ``test_*.py`` only); run it from the repo's
root (about 1-2 s an init on two cores)::

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_train_tolerance.py 0 600

The reference's initial state follows the interpreter's hash seed
(``repro.models.params._leaf_key`` folds ``hash(str(key))`` into each
leaf's key), so each pytest process trains other weights. Here each init
of the range replaces that hash by sha256 of ``"{salt}/{key}"`` (patched
in this process only), and runs three steps of the test's config
(``tests/test_torch_train.py``: the reduced internlm2 at 2 layers, peak lr
1e-3, tokens from seeds 10, 11, 12), read two ways:

- ``port``: the port against the reference;
- ``floor``: the reference against itself with ``attn_impl="reference"``
  and ``xent_impl="gather"``, which compute the same function and differ
  only in where bf16 rounds.

For each step it prints, over the inits, the largest and the 99th
percentile of each reading (the loss and grad norm relative to the
reference's; m and v as the largest over the leaves of
max |a - b| / max |a|), and how many inits read at or above the test
module's tolerance for it (LOSS_RTOL, GNORM_RTOL, GRAD_RTOL for m and v).
"""
import dataclasses
import hashlib
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
from test_torch_train import (GNORM_RTOL, GRAD_RTOL, LOSS_RTOL, _tokens,
                              rel_err, tiny)

STEPS, PEAK_LR = 3, 1e-3
TOL = {"loss": LOSS_RTOL, "grad_norm": GNORM_RTOL, "m": GRAD_RTOL,
       "v": GRAD_RTOL}


def salted_leaf_key(salt):
    """``_leaf_key`` with ``hash(str(token))`` replaced by a salted sha256."""
    def leaf_key(root, path):
        k = root
        for part in path:
            token = getattr(part, "key", getattr(part, "idx",
                                                 getattr(part, "name", part)))
            h = hashlib.sha256(f"{salt}/{token}".encode()).hexdigest()
            k = jax.random.fold_in(k, int(h, 16) % (2**31))
        return k
    return leaf_key


def worst(want_tree, got_leaves):
    return max(rel_err(a, b) for a, b in
               zip(jax.tree_util.tree_leaves(want_tree), got_leaves))


def readings(salt, step, alt_step, tcfg):
    jparams._leaf_key = salted_leaf_key(salt)
    j0 = jsteps.init_train_state(tiny(jconfigs), jax.random.PRNGKey(0))
    tstate = convert.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, j0))
    js = ja = j0
    rows = []
    for i in range(STEPS):
        tok = _tokens(10 + i)
        js, jm = step(js, {"tokens": jnp.asarray(tok)})
        ja, am = alt_step(ja, {"tokens": jnp.asarray(tok)})
        tstate, tm = tsteps.train_step(
            tcfg, tstate, {"tokens": torch.from_numpy(tok)},
            peak_lr=PEAK_LR, warmup_steps=2, total_steps=4)
        row = {}
        for who, met, opt in (
                ("port", tm, tstate.opt),
                ("floor", am, jax.tree_util.tree_map(np.asarray, ja.opt))):
            row[f"{who}.loss"] = rel_err(jm["loss"], met["loss"])
            row[f"{who}.grad_norm"] = rel_err(jm["grad_norm"],
                                              met["grad_norm"])
            for tree in ("m", "v"):
                got = (tree_leaves(getattr(opt, tree)) if who == "port" else
                       jax.tree_util.tree_leaves(getattr(opt, tree)))
                row[f"{who}.{tree}"] = worst(getattr(js.opt, tree), got)
        rows.append(row)
    return rows


def main(lo, hi):
    torch.set_num_threads(2)
    jcfg, tcfg = tiny(jconfigs), tiny(tconfigs)
    alt = dataclasses.replace(jcfg, attn_impl="reference", xent_impl="gather")

    def jit(cfg):
        return jax.jit(lambda s, b: jsteps.train_step(
            cfg, s, b, peak_lr=PEAK_LR, warmup_steps=2, total_steps=4))

    step, alt_step = jit(jcfg), jit(alt)
    runs = []
    for salt in range(lo, hi):
        runs.append(readings(salt, step, alt_step, tcfg))
        print(salt, runs[-1], flush=True)
    print(f"over {len(runs)} inits (salts {lo}..{hi - 1}): max / p99 / "
          f"inits at or above the tolerance")
    for key in runs[0][0]:
        tol = TOL[key.split(".")[1]]
        for i in range(STEPS):
            vals = np.array([r[i][key] for r in runs])
            print(f"  step {i + 1} {key:16s} {vals.max():.4g} / "
                  f"{np.quantile(vals, 0.99):.4g} / {int((vals >= tol).sum())}"
                  f" >= {tol:g}")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]))
