"""Where the reduced jamba's gradient tolerance comes from, on the CPU.

Not a test (pytest collects ``test_*.py`` only); run it from the repo's
root, about 15 minutes on one core::

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_hybrid_tolerance.py

For each token seed and capacity factor, on the port's seeded ``init``
(``tests/test_torch_moe_train.py``'s ``port_init``), each reading the
largest over the leaves of max |a - b| / max |a|:

- ``floor``: the reference against itself in bf16, its chunked scan
  against its sequential oracle ``ssd_ref``, the oracle run forced onto the
  chunked run's top-k picks. The two differ only in the SSD's rounding.
- ``port``: the port in bf16 against the reference's chunked scan, on its
  picks (what ``test_loss_and_every_gradient_match_reference`` holds).
- ``fp32``: the same with the whole model in fp32 on both sides
  (``fp32_embeddings``).

Then planted faults, at the first seed: a leaf's gradient scaled by
1 + e (forward unchanged: ``t + e·(t - t.detach())``) for ``dt_bias`` and
``d_skip`` (every Mamba-2 layer) and the routers, and the SSD backward's
dt cotangent scaled so; each read in bf16 and in fp32 as above.
"""
import contextlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import io_callback

from repro.kernels.ssd.ref import ssd_ref
from repro.models import ssd as jssd
from repro.train import steps as jsteps
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels.ssd import ops as tssd_ops
from repro_torch.models import moe as tmoe, ssd as tssd
from repro_torch.models.params import tree_map
from repro_torch.train import steps as tsteps
from test_torch_moe import port_picks, reference_picks
from test_torch_moe_train import (_leaf_names, fp32_embeddings, port_init,
                                  rel_err, tokens)

NAME = "jamba-v0.1-52b"
SEEDS = (7, 0, 1, 2, 3, 4)
CFS = (1.25, None)
FAULTS = ("dt_bias", "d_skip", "router", "ssd_ddt")
B, S = 2, 24


@contextlib.contextmanager
def forced_reference_picks(picks):
    """The reference's ``top_k`` takes ``picks`` (in call order) through an
    ordered callback, which runs once a call inside the jitted scan over
    groups (a constant would be traced once for every group)."""
    real, n = jax.lax.top_k, [0]

    def nxt(_):
        n[0] += 1
        return np.asarray(picks[n[0] - 1], np.int32)

    def top_k(x, k):
        idx = io_callback(nxt, jax.ShapeDtypeStruct(x.shape[:-1] + (k,),
                                                    jnp.int32),
                          jax.lax.stop_gradient(x), ordered=True)
        return jnp.take_along_axis(x, idx, -1), idx

    jax.lax.top_k = top_k
    try:
        yield n
    finally:
        jax.lax.top_k = real


@contextlib.contextmanager
def sequential_oracle():
    real = jssd.ssd_scan_reference
    jssd.ssd_scan_reference = (
        lambda x, dt, a, Bm, Cm, chunk, h0=None: ssd_ref(x, dt, a, Bm, Cm,
                                                         h0=h0))
    try:
        yield
    finally:
        jssd.ssd_scan_reference = real


def reference_grads(jcfg, jparams, tok):
    (_, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.loss_fn(jcfg, p, b), has_aux=True))(
        jparams, {"tokens": jnp.asarray(tok)})
    jax.effects_barrier()
    return grads


def worst(jgrads, tgrads):
    """(max over leaves of the relative error, the leaf)."""
    other = (tree_leaves(tgrads) if isinstance(tree_leaves(tgrads)[0],
                                               torch.Tensor)
             else jax.tree_util.tree_leaves(tgrads))
    return max((rel_err(a, b), n) for n, a, b in zip(
        _leaf_names(jgrads), jax.tree_util.tree_leaves(jgrads), other))


def _scaled(t, e):
    return t + e * (t - t.detach())


@contextlib.contextmanager
def planted(fault, e):
    """The port with one leaf's gradient (or the SSD's dt cotangent) scaled
    by 1 + e, its forward as it was."""
    mp = pytest.MonkeyPatch()
    if fault in ("dt_bias", "d_skip"):
        real = tssd.ssm_block

        def ssm_block(cfg, scfg, p, *a, **kw):
            return real(cfg, scfg, dict(p, **{fault: _scaled(p[fault], e)}),
                        *a, **kw)
        mp.setattr(tssd, "ssm_block", ssm_block)
    elif fault == "router":
        real = tmoe.route
        mp.setattr(tmoe, "route", lambda mcfg, router, xt: real(
            mcfg, _scaled(router, e), xt))
    else:
        real = tssd_ops.SSDChunkFn.backward

        def backward(ctx, *grads):
            out = list(real(ctx, *grads))
            out[1] = out[1] * (1 + e)
            return tuple(out)
        mp.setattr(tssd_ops.SSDChunkFn, "backward", staticmethod(backward))
    try:
        yield
    finally:
        mp.undo()


def planted_faults(seed):
    return ([(f, e) for f in FAULTS for e in (0.03, 0.1)]
            if seed == SEEDS[0] else [])


def port_grads(tcfg, tparams, tok, picks):
    with port_picks(picks):
        return tsteps.value_and_grad(
            tcfg, tparams, {"tokens": torch.from_numpy(tok)})[1]


def main():
    torch.set_num_threads(1)
    print("cf, seed: floor (reference chunked vs sequential, bf16) | port "
          "bf16 | port fp32; the leaf")
    faults = {}
    for cf in CFS:
        for seed in SEEDS:
            jcfg, tcfg, jparams, tparams = port_init(NAME, cf)
            tok = tokens(jcfg, (B, S), seed)
            with reference_picks() as picks:
                chunked = reference_grads(jcfg, jparams, tok)
            with sequential_oracle(), forced_reference_picks(picks) as n:
                oracle = reference_grads(jcfg, jparams, tok)
            assert n[0] == len(picks)
            port = port_grads(tcfg, tparams, tok, picks)
            j32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                         jparams)
            t32 = tree_map(lambda t: t.float(), tparams)
            with pytest.MonkeyPatch.context() as mp:
                fp32_embeddings(mp)
                with reference_picks() as picks32:
                    ref32 = reference_grads(jcfg, j32, tok)
                port32 = port_grads(tcfg, t32, tok, picks32)
                for fault, e in planted_faults(seed):
                    with planted(fault, e):
                        faults[cf, fault, e] = [None, worst(
                            ref32, port_grads(tcfg, t32, tok, picks32))]
            for fault, e in planted_faults(seed):
                with planted(fault, e):
                    faults[cf, fault, e][0] = worst(
                        chunked, port_grads(tcfg, tparams, tok, picks))
            print(f"{cf}, {seed}: floor {worst(chunked, oracle)} | port "
                  f"{worst(chunked, port)} | fp32 {worst(ref32, port32)}",
                  flush=True)
    print(f"planted faults at seed {SEEDS[0]}: cf, fault, e: bf16 | fp32")
    for (cf, fault, e), (bf, f32) in faults.items():
        print(f"{cf}, {fault}, {e}: {bf} | {f32}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
