"""``remat="dots"`` on the port, on the CPU at ``configs.reduced``: the
twin of the reference's ``jax.checkpoint`` under
``dots_with_no_batch_dims_saveable``, built with ``torch.utils.checkpoint``'s
selective activation checkpointing (``models/lm.py`` ``_dots_policy``).

- Every family's gradients under ``"dots"`` are bitwise its gradients
  under ``"block"``: both run the same arithmetic, and ``"dots"`` hands the
  backward the saved products' outputs where ``"block"`` computes them
  again. The policy saves one product a projection weight a layer
  (``projections``), so ``"dots"`` is not ``"block"`` under another name.
- The dense, ssm and moe families' loss and every leaf's gradient under
  ``"dots"`` against ``jax.value_and_grad`` of the reference's ``loss_fn``
  under ``"dots"``, at the tolerances of their train tests
  (``tests/test_torch_{train,ssd_train,moe_train}.py``). The port's seeded
  ``init`` crosses to JAX in-process; the MoE config runs on the
  reference's top-k picks, forced by layer, since each recompute routes
  again.
- What is saved: the reference's per-layer residuals under ``"dots"``
  (``jax.ad_checkpoint.print_saved_residuals``: the products with no batch
  dimension that its backward needs, and the layer carries) are all among
  the outputs the port saves, found by shape and dtype, each the output of
  a product of a named projection weight; no batched product (attention's
  logits and PV, the experts, the SSD scan's einsums) is saved, and the
  policy sees them.
"""
import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.ad_checkpoint import print_saved_residuals

from repro.train import steps as jsteps
from repro_torch.core.tree import tree_leaves
from repro_torch.models import lm as tlm, moe as tmoe
from repro_torch.train import steps as tsteps
from test_torch_moe import reference_picks
from test_torch_moe_train import port_init, rel_err, routes_by_layer
from test_torch_vlm import grid_positions

# every family, and qwen2-moe for its shared expert and shared gate
FAMILIES = ["internlm2-1.8b", "gemma3-4b", "qwen2-vl-7b", "mamba2-130m",
            "granite-moe-1b-a400m", "qwen2-moe-a2.7b", "jamba-v0.1-52b",
            "whisper-medium"]
# each family's train test: (loss, every leaf's gradient relative to its
# max |g|), bf16 on both sides
TOLS = {"internlm2-1.8b": (1e-4, 3e-2),          # test_torch_train.py
        "mamba2-130m": (2e-3, 8e-2),             # test_torch_ssd_train.py
        "granite-moe-1b-a400m": (1e-3, 3e-2)}    # test_torch_moe_train.py
B, S, S_ENC, GRID = 2, 24, 16, 2
PROJECTIONS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "in_proj",
               "out_proj", "router", "shared_gate"}
EXPERTS = {"w_gate", "w_up", "w_down"}   # under "moe": (E, ...) stacks
BODIES = ("blocks", "groups", "enc", "dec")
SAVE = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: with several test processes sharing the
    cores, torch's OpenMP pool spins at the small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batch_for(cfg, seed):
    """Tokens, and the frames (audio) or the vision prefix and M-RoPE
    streams (vlm) the family's forward takes."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(B, S_ENC, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(rng.normal(
            size=(B, GRID * GRID, cfg.d_model)).astype(np.float32)).bfloat16()
        batch["mrope_positions"] = torch.from_numpy(grid_positions(B, S, GRID))
    return batch


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def projections(params):
    """{address of one layer's weight: (layer, leaf)} for each projection
    weight of the checkpointed bodies, the products with no batch
    dimension (the MoE experts' stacked weights are batched): the layer as
    (body, sublayer..., index), the leaf as its dotted path in the layer
    ("attn.wq", "moe.router", "xattn.wk")."""
    out = {}
    for body in BODIES:
        for path, leaf in _walk(params.get(body, {})):
            if path[-1] not in PROJECTIONS or (
                    path[-2] == "moe" and path[-1] in EXPERTS):
                continue
            sub = tuple(k for k in path if isinstance(k, int))
            name = ".".join(k for k in path if isinstance(k, str))
            for i, layer in enumerate(leaf.unbind(0)):
                out[layer.data_ptr()] = ((body,) + sub + (i,), name)
    return out


@contextlib.contextmanager
def policy_log():
    """Every op the ``"dots"`` policy sees in a forward (not in a
    recompute): (op, its decision, its tensor arguments)."""
    log, real = [], tlm._dots_policy

    def policy(ctx, op, *args, **kwargs):
        out = real(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            log.append((op, out, [a for a in args if torch.is_tensor(a)]))
        return out

    tlm._dots_policy = policy
    try:
        yield log
    finally:
        tlm._dots_policy = real


def saved_products(log, params):
    """The saved ops of ``log`` as (layer, leaf, (rows, columns), dtype)
    of their output, each found by its weight operand's address."""
    where = projections(params)
    out = []
    for op, decision, args in log:
        if decision != SAVE:
            continue
        assert op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        x, w = args[-2:]
        assert w.data_ptr() in where, (op, [tuple(a.shape) for a in args])
        out.append((*where[w.data_ptr()], (x.shape[0], w.shape[1]), w.dtype))
    return out


# ------------------------------------------------------- "dots" is "block"
@pytest.mark.parametrize("arch", FAMILIES)
def test_dots_gives_the_gradients_of_block(arch):
    """The same loss and gradients bit for bit; one saved product a
    projection weight a layer (the encoder's and the decoder's, the
    cross-attention's and the shared expert's included); each MoE layer
    routes twice, its recompute as its forward, so the combine read's
    backward sees the forward's routing."""
    _, tcfg, _, tparams = port_init(arch, remat="block")
    batch = batch_for(tcfg, seed=3)
    m_block, g_block = tsteps.value_and_grad(tcfg, tparams, batch)
    with policy_log() as log, routes_by_layer() as by_layer:
        m_dots, g_dots = tsteps.value_and_grad(
            dataclasses.replace(tcfg, remat="dots"), tparams, batch)
    n_moe = sum(tcfg.layer_is_moe(i) for i in range(tcfg.num_layers))
    assert len(by_layer) == n_moe
    for picks in by_layer.values():
        assert len(picks) == 2 and torch.equal(picks[0], picks[1])
    assert torch.equal(m_dots["loss"], m_block["loss"])
    assert torch.equal(m_dots["aux_loss"], m_block["aux_loss"])
    for a, b in zip(tree_leaves(g_dots), tree_leaves(g_block), strict=True):
        assert torch.equal(a, b)
    saved = [(layer, name) for layer, name, *_ in saved_products(log, tparams)]
    assert sorted(saved) == sorted(projections(tparams).values())


def test_dots_without_selective_checkpointing_raises(monkeypatch):
    """No fallback to ``"block"``: a torch without
    ``create_selective_checkpoint_contexts`` refuses ``"dots"``."""
    _, tcfg, _, tparams = port_init("internlm2-1.8b", remat="dots")
    monkeypatch.delattr(torch.utils.checkpoint,
                        "create_selective_checkpoint_contexts")
    with pytest.raises(NotImplementedError, match="dots"):
        tsteps.value_and_grad(tcfg, tparams, batch_for(tcfg, seed=4))


# ----------------------------------------------------- against the reference
@contextlib.contextmanager
def picks_by_layer(forced):
    """The port's top-k picks forced to ``forced[i]`` in the ``i``-th MoE
    layer, the layer told by its router's address (the stacked router's
    ``unbind`` view), so that each recompute routes as its forward."""
    layer, real_route, real_top_k = {}, tmoe.route, tmoe.top_k
    current = []

    def route(mcfg, router, xt):
        current.append(layer.setdefault(router.data_ptr(), len(layer)))
        try:
            return real_route(mcfg, router, xt)
        finally:
            current.pop()

    def top_k(probs, k):
        idx = torch.from_numpy(np.array(forced[current[-1]])).long()
        return probs.gather(1, idx), idx

    tmoe.route, tmoe.top_k = route, top_k
    try:
        yield layer
    finally:
        tmoe.route, tmoe.top_k = real_route, real_top_k


def reference_value_and_grad(jcfg, jparams, tok):
    """The reference's jitted ``value_and_grad`` of ``loss_fn`` and, for
    a MoE config, its picks in the forward's layer order. Under
    ``"dots"`` its backward routes again, layer by layer in reverse: the
    recorded picks are the forward's, then the same picks reversed."""
    with reference_picks() as picks:
        (_, jmet), jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: jsteps.loss_fn(jcfg, p, b), has_aux=True))(
            jparams, {"tokens": jnp.asarray(tok)})
        jax.effects_barrier()
    n = len(picks) // 2
    assert len(picks) == (2 * jcfg.num_layers if jcfg.moe else 0)
    assert all((a == b).all() for a, b in zip(picks[n:], picks[:n][::-1]))
    return jmet, jgrads, picks[:n]


@pytest.mark.parametrize("arch", list(TOLS))
def test_dots_gradients_match_reference_under_dots(arch):
    loss_tol, grad_tol = TOLS[arch]
    jcfg, tcfg, jparams, tparams = port_init(arch, remat="dots")
    tok = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    jmet, jgrads, picks = reference_value_and_grad(jcfg, jparams, tok)
    with picks_by_layer(picks) as layers_routed:
        tmet, tgrads = tsteps.value_and_grad(
            tcfg, tparams, {"tokens": torch.from_numpy(tok)})
    assert len(layers_routed) == len(picks)
    assert rel_err(jmet["loss"], tmet["loss"]) < loss_tol
    if jcfg.moe:
        assert rel_err(jmet["aux_loss"], tmet["aux_loss"]) < 1e-3
    leaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for (path, a), b in zip(leaves, tree_leaves(tgrads), strict=True):
        name = jax.tree_util.keystr(path)
        assert bool(torch.isfinite(b).all()) and float(b.abs().max()) > 0, name
        assert rel_err(a, b) < grad_tol, (name, rel_err(a, b))


# ------------------------------------------------------------- what is saved
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def reference_residuals(jcfg, jparams, tok):
    """The reference's per-layer residuals under ``"dots"``, from
    ``print_saved_residuals``: each output of its layer scan as (shape
    less the stacked layer dim, dtype)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        print_saved_residuals(
            lambda p: jsteps.loss_fn(jcfg, p, {"tokens": jnp.asarray(tok)})[0],
            jparams)
    found = []
    for line in out.getvalue().splitlines():
        m = re.match(r"(\w+)\[([\d,]+)\] output of scan ", line)
        if m:
            shape = tuple(int(d) for d in m.group(2).split(","))[1:]
            found.append((shape, DTYPES[m.group(1)]))
    return found


def as_rows(shape, dtype):
    """A residual as the port's 2-D product output: (rows, columns,
    dtype), the rows B·S (its batch and sequence dims) or its first dim
    (the router's token rows)."""
    rows = B * S if shape[:2] == (B, S) else shape[0]
    return rows, int(np.prod(shape)) // rows, dtype


# (reference residuals a layer, of which layer carries (B, S, d_model) in
# bf16; the products the reference keeps, by the port's leaf names)
KEPT = {"internlm2-1.8b": (7, 2, {"attn.wq", "attn.wk", "attn.wv",
                                  "mlp.w_gate", "mlp.w_up"}),
        "mamba2-130m": (2, 1, {"ssm.in_proj"}),
        "granite-moe-1b-a400m": (6, 2, {"attn.wq", "attn.wk", "attn.wv",
                                        "moe.router"})}


@pytest.mark.parametrize("arch", list(KEPT))
def test_dots_saves_the_references_residuals_and_no_batched_product(arch):
    n_res, n_carry, kept = KEPT[arch]
    jcfg, tcfg, jparams, tparams = port_init(arch, remat="dots")
    tok = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    ref = reference_residuals(jcfg, jparams, tok)
    carry = ((B, S, tcfg.d_model), torch.bfloat16)
    assert len(ref) == n_res and ref.count(carry) == n_carry, ref
    products = sorted((as_rows(*r) for r in ref if r != carry), key=str)
    with policy_log() as log:
        tsteps.value_and_grad(tcfg, tparams, {"tokens": torch.from_numpy(tok)})
    saved = saved_products(log, tparams)
    for layer in range(tcfg.num_layers):
        mine = {name: (*shape, dtype) for where, name, shape, dtype in saved
                if where == ("blocks", layer)}
        assert kept <= set(mine), (layer, sorted(mine))
        # the kept products are the reference's residuals, less its carries
        assert sorted((mine[name] for name in kept), key=str) == products, (
            layer, mine)
    # the batched products reach the policy and are recomputed
    batched = [(op, d) for op, d, _ in log if op == torch.ops.aten.bmm.default]
    assert batched and all(d != SAVE for _, d in batched)
    assert all(op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
               for op, d, _ in log if d == SAVE)
