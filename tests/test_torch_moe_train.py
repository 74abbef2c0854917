"""Training the MoE family: ``moe_block``'s backward and the reduced
granite-moe and qwen2-moe train steps vs the JAX package's, on the CPU.

Block level. ``moe_block``'s two row reads are ``autograd.Function``s whose
backward is a gather (``models/moe.py``): the dispatch's gives the bits of
the reference's transpose (``jax.vjp`` of ``xt[token_for_slot]``, a
scatter-add that visits the slots in ascending order) given the same
cotangent, and so does the combine's read; the graph holds no index
backward (an accumulating index write, float atomics on the card). The
block's gradients in x, the router, every expert tensor, the shared expert
and its gate, under a random cotangent on the output and 0.5 on the aux
loss, against ``jax.vjp`` of ``repro.models.moe.moe_block``, with the port
on the reference's top-k picks: fp32 at 1e-5 and bf16 at 3e-2 of each
gradient's max |g|, the reference's own tolerances.

Model level, the reduced configs (4 layers, d_model 128, 8 experts top 2,
vocab 512): weights from the port's seeded ``init`` carried to JAX bit for
bit (the reference's own init follows the process's hash seed), numpy
tokens from a seed, at ``reduced()``'s drop-free capacity factor (the
expert count) and at the published 1.25, where assignments drop. Routing
is discrete and near-ties flip between two bf16 programs
(``tests/test_torch_moe.py``), so the port takes the reference's picks,
in call order; both run ``remat="none"``, so each MoE layer routes once a
forward. The loss and every leaf's gradient of ``loss_fn`` (with its
``0.01 · aux_loss``) against ``jax.value_and_grad``: in bf16, as the
models train, at 3e-2 of each leaf's max |g|; and with the whole model in
fp32 on both sides (``fp32_embeddings``) at 1e-5, which holds the wiring
apart from bf16 rounding (a leaf's gradient 3% off reads 3e-2 there).
Three ``train_step``s at ``grad_accum`` 1 and 2, each step's update held
element by element in units of its lr (``_assert_updates_close``); remat
``"block"`` against ``"none"`` in the port (the same bits, and each
recompute routes as its forward), and the train CLI. The hybrid family's
twins are in ``tests/test_torch_hybrid_train.py``.
"""
import ast
import contextlib
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm, moe as jmoe
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.core.tree import tree_leaves, tree_map as tree_map_n
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.ssd import ops as tssd_ops
from repro_torch.launch import train as ttrain
from repro_torch.models import (convert, lm as tlm, moe as tmoe,
                                registry as tregistry)
from repro_torch.models.config import MoECfg as TMoECfg
from repro_torch.models.params import tree_map
from repro_torch.train import steps as tsteps
from torch_sharded_ranks import update_error
from test_torch_moe import (CASES, _bits, _moe_case, _reference_trace,
                            port_picks, reference_picks)

MOE_ARCHS = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"]
BLOCK_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
GRAD_RTOL = 3e-2       # bf16 gradients, relative to each leaf's max |g|
LOSS_RTOL = 1e-3       # the fp32 loss of bf16 logits
AUX_RTOL = 1e-3        # on the same picks the mean router probabilities
#                        differ only by the bf16 hidden state
GNORM_RTOL = 1e-2      # the fp32 norm over every bf16 gradient
FP32_RTOL = 1e-5       # the whole model in fp32 (``fp32_embeddings``)
UPDATE_TOL = 0.25      # a step's update, in units of its lr, past one ulp
INDEX_NODES = {"IndexBackward0", "IndexPutBackward0", "IndexPutImplBackward0",
               "IndexAddBackward0", "IndexCopyBackward0"}
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: several test processes share
    the cores, and torch's OpenMP pool would spin at each small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_err(want, got) -> float:
    want, got = _np(want), _np(got)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _leaf_names(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


# ------------------------------------------------------------ the block
def _block_case(arch, dtype, cf, seed=0):
    """(reference MoECfg, port MoECfg, numpy weights, numpy x, numpy
    cotangent): the arch's reduced MoE layer (granite: 8 experts top 2;
    qwen2-moe: the same and one shared expert) at capacity factor ``cf``,
    or the expert count (no drops) for None; weights at the model's dtypes
    (bf16 experts, fp32 router and shared gate) or all fp32, the router
    wider than the init's 0.02 so that routing is clear of rounding."""
    mcfg = jconfigs.reduced(jconfigs.get(arch)).moe
    jm = dataclasses.replace(mcfg, capacity_factor=(
        float(mcfg.num_experts) if cf is None else cf))
    tm = TMoECfg(**dataclasses.asdict(jm))
    d, e, f = 128, jm.num_experts, jm.expert_d_ff
    rng = np.random.default_rng(seed)
    wdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def w(*shape, scale=0.1, dt=wdt):
        return np.array(jnp.asarray(rng.standard_normal(shape) * scale, dt))

    p = {"router": w(d, e, scale=0.5, dt=jnp.float32),
         "w_gate": w(e, d, f), "w_up": w(e, d, f), "w_down": w(e, f, d)}
    if jm.num_shared:
        fs = jm.shared_d_ff
        p["shared"] = {"w_gate": w(d, fs), "w_up": w(d, fs),
                       "w_down": w(fs, d)}
        p["shared_gate"] = w(d, 1, dt=jnp.float32)
    x = rng.standard_normal((B, 16, d)).astype(np.float32)
    g = rng.standard_normal((B, 16, d)).astype(np.float32)
    return jm, tm, p, x, g


def _block_grads(arch, dtype, cf):
    """{name: (reference gradient, port gradient)} of ``0.5 · aux + Σ out
    · g`` over x and every weight, the port on the reference's picks; and
    how many assignments the reference dropped."""
    jm, tm, p, x, g = _block_case(arch, dtype, cf)
    jdt = getattr(jnp, dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jx = jnp.asarray(x, jdt)
    trace = _reference_trace(jm, jp, jx)
    (out, aux), vjp = jax.vjp(lambda p, x: jmoe.moe_block(jm, p, x), jp, jx)
    jg_p, jg_x = vjp((jnp.asarray(g, out.dtype), jnp.float32(0.5)))

    tp = tree_map(lambda t: t.requires_grad_(), convert.params_from_numpy(p))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    with port_picks([np.asarray(trace["expert_idx"])]):
        tout, taux = tmoe.moe_block(tm, tp, tx)
    tg = torch.from_numpy(g).to(tout.dtype)
    (tout.float() * tg.float()).sum().add(0.5 * taux).backward()
    pairs = {"x": (jg_x, tx.grad)}
    for name, want, leaf in zip(_leaf_names(jg_p),
                                jax.tree_util.tree_leaves(jg_p),
                                tree_leaves(tp)):
        pairs[name] = (want, leaf.grad)
    return pairs, int((~np.asarray(trace["keep"])).sum())


@pytest.mark.parametrize("cf", [1.25, None], ids=["cf1.25", "drop_free"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_gradients_match_reference(arch, dtype, cf):
    pairs, dropped = _block_grads(arch, dtype, cf)
    assert (dropped > 0) == (cf is not None)
    want_names = {"x", "['router']", "['w_down']", "['w_gate']", "['w_up']"}
    if arch == "qwen2-moe-a2.7b":
        want_names |= {"['shared_gate']", "['shared']['w_down']",
                       "['shared']['w_gate']", "['shared']['w_up']"}
    assert set(pairs) == want_names
    for name, (want, got) in pairs.items():
        assert got.dtype == convert.tensor_from_numpy(np.asarray(want)).dtype
        assert bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0
        assert rel_err(want, got) < BLOCK_TOL[dtype], (
            name, rel_err(want, got))


def _routing(name, dtype):
    """The case's weights, x as the port's dtype, and the port's routing
    (its integers are the reference's bit for bit: test_torch_moe.py)."""
    jm, tm, p, x = _moe_case(name, dtype)
    tp = convert.params_from_numpy(p)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    xt = tx.reshape(-1, x.shape[-1])
    return jm, tm, xt, tmoe.route(tm, tp["router"], xt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_dispatch_backward_is_the_references_transpose_bit_for_bit(name,
                                                                   dtype):
    """``_Dispatch``'s backward against the transpose of the reference's
    ``xt[token_for_slot]``, given the same cotangent (zero on unfilled
    slots, as ``xe · filled`` makes it): the same bits, drops, capacity 1,
    top 8 and tied routers included."""
    _, _, xt, rt = _routing(name, dtype)
    rng = np.random.default_rng(1)
    filled = rt.filled.numpy()
    g = (rng.standard_normal((filled.size, xt.shape[1]))
         * filled[:, None]).astype(np.float32)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda a: a[rt.token_for_slot.numpy()],
                     jnp.asarray(xt.float().numpy(), jdt))
    want, = vjp(jnp.asarray(g, jdt))
    leaf = xt.detach().requires_grad_()
    got, = torch.autograd.grad(tmoe._Dispatch.apply(leaf, rt), leaf,
                               torch.from_numpy(g).to(xt.dtype))
    assert np.array_equal(_bits(want), _bits(got))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["no_drops", "drops_cf1.25",
                                  "decode_cap1_granite", "top8"])
def test_slot_read_backward_is_the_references_transpose_bit_for_bit(name,
                                                                    dtype):
    """``_SlotRead``'s backward against the transpose of the reference's
    combine read ``ye[clip(slot)] · keep`` (in sorted order), given the
    same cotangent: each filled slot gets its one assignment's, the dropped
    rows' zeros leave the last slot as it is."""
    _, tm, _, rt = _routing(name, dtype)
    nk, d = rt.flat_slot.numel(), 32
    n_slots = rt.filled.numel()
    rng = np.random.default_rng(2)
    ye = rng.standard_normal((n_slots, d)).astype(np.float32)
    c = rng.standard_normal((nk, d)).astype(np.float32)   # sorted order
    order, keep = rt.order.numpy(), rt.keep.numpy()
    slot = rt.flat_slot.numpy()[order]
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(
        lambda a: a[np.clip(slot, 0, n_slots - 1)] * keep[:, None].astype(jdt),
        jnp.asarray(ye, jdt))
    want, = vjp(jnp.asarray(c, jdt))
    ct = np.zeros_like(c)
    ct[order] = c * keep[:, None]                  # to (token, k) order
    leaf = torch.from_numpy(ye).to(getattr(torch, dtype)).requires_grad_()
    got, = torch.autograd.grad(tmoe._SlotRead.apply(leaf, rt), leaf,
                               torch.from_numpy(ct).to(leaf.dtype))
    assert np.array_equal(_bits(want), _bits(got))


def _graph_nodes(*roots) -> set:
    seen, names, todo = set(), set(), [r.grad_fn for r in roots]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(fn.name())
        todo.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_graph_has_no_index_backward(arch):
    """The autograd graph of ``moe_block`` (drops, shared experts) holds no
    node whose backward writes through an index with accumulation; the two
    row reads are the gather-only Functions."""
    _, tm, p, x, _ = _block_case(arch, "bfloat16", 1.25)
    tp = tree_map(lambda t: t.requires_grad_(), convert.params_from_numpy(p))
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    out, aux = tmoe.moe_block(tm, tp, tx)
    names = _graph_nodes(out, aux)
    assert not names & INDEX_NODES, names & INDEX_NODES
    assert {"_DispatchBackward", "_SlotReadBackward"} <= names


# ------------------------------------------------------------ the model
def port_init(name, cf=None, **kw):
    """(reference cfg, port cfg, reference params, port params): the
    reduced config at ``reduced()``'s drop-free capacity factor or ``cf``,
    ``remat="none"`` unless ``kw`` says otherwise; the port's seeded
    ``init`` carried to JAX bit for bit."""
    jcfg = jconfigs.reduced(jconfigs.get(name))
    tcfg = tconfigs.reduced(tconfigs.get(name))
    kw.setdefault("remat", "none")
    jcfg, tcfg = (dataclasses.replace(c, **kw) for c in (jcfg, tcfg))
    if cf is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
    tparams = tregistry.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    jparams = tree_map(lambda t: jnp.asarray(
        t.float().numpy(), getattr(jnp, str(t.dtype).removeprefix("torch."))),
        tparams)
    return jcfg, tcfg, jparams, tparams


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def loss_and_grads(jcfg, tcfg, jparams, tparams, tok):
    """The reference's ``value_and_grad`` of ``loss_fn`` (jitted) and its
    top-k picks; the port's on those picks."""
    with reference_picks() as picks:
        (_, jmet), jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: jsteps.loss_fn(jcfg, p, b), has_aux=True))(
            jparams, {"tokens": jnp.asarray(tok)})
        jax.effects_barrier()
    with port_picks(picks) as used:
        tmet, tgrads = tsteps.value_and_grad(
            tcfg, tparams, {"tokens": torch.from_numpy(tok)})
    assert len(used) == len(picks)
    return (jmet, jgrads), (tmet, tgrads), picks


def assert_grads_close(jgrads, tgrads, tol):
    names = _leaf_names(jgrads)
    assert len(names) == len(tree_leaves(tgrads))
    for name, a, b in zip(names, jax.tree_util.tree_leaves(jgrads),
                          tree_leaves(tgrads)):
        assert b.dtype == convert.tensor_from_numpy(np.asarray(a)).dtype, name
        assert bool(torch.isfinite(b).all()) and float(b.abs().max()) > 0, name
        assert rel_err(a, b) < tol, (name, rel_err(a, b))


def assert_metrics_close(jmet, tmet, loss_tol=LOSS_RTOL, aux_tol=AUX_RTOL):
    assert rel_err(jmet["loss"], tmet["loss"]) < loss_tol
    assert rel_err(jmet["aux_loss"], tmet["aux_loss"]) < aux_tol


@pytest.mark.parametrize("cf", [1.25, None], ids=["cf1.25", "drop_free"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_every_gradient_match_reference(arch, cf):
    jcfg, tcfg, jparams, tparams = port_init(arch, cf)
    (jmet, jgrads), (tmet, tgrads), picks = loss_and_grads(
        jcfg, tcfg, jparams, tparams, tokens(jcfg, (B, S), seed=7))
    assert len(picks) == jcfg.num_layers
    # the aux loss is in the loss: about 1 a layer when balanced
    assert float(tmet["aux_loss"]) > 0.5 * tcfg.num_layers
    assert_metrics_close(jmet, tmet)
    assert_grads_close(jgrads, tgrads, GRAD_RTOL)


def fp32_embeddings(monkeypatch):
    """Both packages' model in fp32: each ``embed_lookup`` casts the table
    to bf16, and every later op follows its operands' dtype; patched on
    each module to keep fp32 (no file edited). With every weight cast to
    fp32 the whole forward and backward then run in fp32."""
    monkeypatch.setattr(jlm, "embed_lookup",
                        lambda cfg, table, tok: table.astype(jnp.float32)[tok])
    monkeypatch.setattr(tlm, "embed_lookup",
                        lambda cfg, table, tok: table.float()[tok.long()])


def check_fp32_model(name, cf, monkeypatch, seed=7):
    """The loss, the aux loss and every leaf's gradient with the whole
    model in fp32 on both sides, the port on the reference's picks, at
    FP32_RTOL: the wiring of every leaf (routers, norms, the Mamba-2
    layers' ``dt_bias`` and ``d_skip``) held apart from bf16 rounding."""
    jcfg, tcfg, jparams, tparams = port_init(name, cf)
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams)
    tparams = tree_map(lambda t: t.float(), tparams)
    fp32_embeddings(monkeypatch)
    (jmet, jgrads), (tmet, tgrads), _ = loss_and_grads(
        jcfg, tcfg, jparams, tparams, tokens(jcfg, (B, S), seed=seed))
    assert_metrics_close(jmet, tmet, FP32_RTOL, FP32_RTOL)
    assert_grads_close(jgrads, tgrads, FP32_RTOL)


@pytest.mark.parametrize("cf", [1.25, None], ids=["cf1.25", "drop_free"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_fp32_loss_and_every_gradient_match_reference(arch, cf, monkeypatch):
    check_fp32_model(arch, cf, monkeypatch)


@contextlib.contextmanager
def routes_by_layer():
    """Every ``route`` call's top-k picks, by the router's address (one a
    layer: the stacked router's ``unbind`` views), in call order."""
    by_layer, real = {}, tmoe.route

    def route(mcfg, router, xt):
        rt = real(mcfg, router, xt)
        by_layer.setdefault(router.data_ptr(), []).append(rt.expert_idx)
        return rt

    tmoe.route = route
    try:
        yield by_layer
    finally:
        tmoe.route = real


@contextlib.contextmanager
def counting_calls():
    """Calls of the RMSNorm and SSD Functions' forward and backward (on
    the CPU the wrappers count no launch)."""
    calls = dict.fromkeys(("rms", "rms_bwd", "ssd", "ssd_bwd"), 0)
    saved = {}
    for cls, attr, key in ((rn_ops.RMSNormFn, "forward", "rms"),
                           (rn_ops.RMSNormFn, "backward", "rms_bwd"),
                           (tssd_ops.SSDChunkFn, "forward", "ssd"),
                           (tssd_ops.SSDChunkFn, "backward", "ssd_bwd")):
        fn = saved[(cls, attr)] = getattr(cls, attr)

        def wrapped(ctx, *a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(ctx, *a)
        setattr(cls, attr, staticmethod(wrapped))
    try:
        yield calls
    finally:
        for (cls, attr), fn in saved.items():
            setattr(cls, attr, staticmethod(fn))


def remat_calls(cfg, remat):
    """The calls one ``value_and_grad`` makes: norms (ln1 and ln2 a layer,
    and the gated norm of each Mamba-2 mixer) and SSD chunks, each layer's
    forward twice under remat, once a backward."""
    n_ssm = (cfg.num_layers - cfg.num_layers // cfg.attn_every
             if cfg.family == "hybrid" else 0)
    norms = 2 * cfg.num_layers + n_ssm
    k = 2 if remat == "block" else 1
    return {"rms": k * norms + 1, "rms_bwd": norms + 1,
            "ssd": k * n_ssm, "ssd_bwd": n_ssm}


def check_remat(name, cf, seed):
    """Remat ``"block"`` against ``"none"`` in the port, each on its own
    routing: the same loss and gradients, bit for bit; under ``"block"``
    each MoE layer routes twice, the recompute as its forward; the calls
    are the remat arithmetic."""
    _, tcfg, _, tparams = port_init(name, cf)
    batch = {"tokens": torch.from_numpy(tokens(tcfg, (B, S), seed))}
    n_moe = sum(tcfg.layer_is_moe(i) for i in range(tcfg.num_layers))
    out = {}
    for remat in ("block", "none"):
        with routes_by_layer() as by_layer, counting_calls() as calls:
            out[remat] = tsteps.value_and_grad(
                dataclasses.replace(tcfg, remat=remat), tparams, batch)
        assert calls == remat_calls(tcfg, remat), (remat, calls)
        assert len(by_layer) == n_moe
        k = 2 if remat == "block" else 1
        for picks in by_layer.values():
            assert len(picks) == k and all(torch.equal(picks[0], p)
                                           for p in picks)
    (m_b, g_b), (m_n, g_n) = out["block"], out["none"]
    assert torch.equal(m_b["loss"], m_n["loss"])
    assert torch.equal(m_b["aux_loss"], m_n["aux_loss"])
    for a, b in zip(tree_leaves(g_b), tree_leaves(g_n)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cf", [1.25, None], ids=["cf1.25", "drop_free"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_block_gives_the_gradients_of_none(arch, cf):
    check_remat(arch, cf, seed=11)


def _assert_moments_close(jstate, tstate, tol):
    names = _leaf_names(jstate.params)
    for tree, t in (("m", tol), ("v", 2 * tol)):
        for name, a, b in zip(names,
                              jax.tree_util.tree_leaves(getattr(jstate.opt, tree)),
                              tree_leaves(getattr(tstate.opt, tree))):
            assert bool(torch.isfinite(b).all()), (tree, name)
            assert rel_err(a, b) < t, (tree, name, rel_err(a, b))


def _assert_updates_close(j_old, j_new, t_old, t_new, lr, tol, resolved):
    """One step's update of each leaf (new params minus old) against the
    reference's, in units of the step's ``lr``, past one ulp of the larger
    new param in its dtype (each side rounds its new params once). On every
    element whose reference gradient was resolved at this step and every
    earlier one (|g| above 4·``tol`` of its leaf's max |g|, so that the
    bf16 gradients' error cannot flip its sign) within UPDATE_TOL. Any
    other element's gradient may flip sign: at the first step, where AdamW
    moves an element by lr·g/(|g| + eps), at most lr either way, it may move
    by 2·lr; after that its moments differ and it is not held. The
    reference's gradient is read from its first moment, (m_new - b1·m_old)
    / (1 - b1), with AdamW's b1 of 0.9. ``resolved`` (a list, empty before
    the first step) keeps each leaf's mask from step to step."""
    first = not resolved
    rows = zip(_leaf_names(j_old.params),
               *(jax.tree_util.tree_leaves(t) for t in (
                   j_old.params, j_new.params, j_old.opt.m, j_new.opt.m)),
               tree_leaves(t_old.params), tree_leaves(t_new.params))
    for i, (name, a0, a1, m0, m1, b0, b1) in enumerate(rows):
        bits = {torch.bfloat16: 7, torch.float32: 23}[b1.dtype]
        err, now = update_error(*map(_np, (a0, a1, m0, m1, b0, b1)),
                                bits, tol, lr)
        if first:
            resolved.append(now)
        else:
            resolved[i] &= now
        held = float(err[resolved[i]].max(initial=0.0))
        assert held < UPDATE_TOL, (name, held)
        if first:
            assert float(err.max()) <= 2 + 1e-3, (name, float(err.max()))
    assert sum(int(r.sum()) for r in resolved) > 0


def check_train_steps(name, accum, tol, loss_tol=LOSS_RTOL, aux_tol=AUX_RTOL,
                      n_steps=3, seq=S):
    """``n_steps`` optimizer steps of the reduced config from the same
    state at ``grad_accum`` ``accum``, the port on the reference's picks
    (in call order: microbatch by microbatch, layer by layer): each step's
    loss, aux loss, grad norm, lr and step, and its update element by
    element (``_assert_updates_close``: an update skipped reads about 1,
    one of the wrong sign about 2); after the first, the first moments at
    ``tol`` and the second (~g²) at twice it (later steps start from params
    that already differ)."""
    jcfg, tcfg, jparams, tparams = port_init(name, 1.25, grad_accum=accum)
    peak_lr = 1e-3
    jstep = jax.jit(lambda s, b: jsteps.train_step(
        jcfg, s, b, peak_lr=peak_lr, warmup_steps=2, total_steps=4))
    jstate = jsteps.TrainState(params=jparams, opt=jadamw.init(jparams))
    tstate = tsteps.TrainState(params=tparams, opt=tsteps.adamw.init(tparams))
    n_moe = sum(tcfg.layer_is_moe(i) for i in range(tcfg.num_layers))
    resolved = []
    # one list for every step: the jitted step's callback appends to the
    # list it was traced with
    with reference_picks() as all_picks:
        for step in range(n_steps):
            tok = tokens(jcfg, (4, seq), seed=20 + step)
            j_new, jmet = jstep(jstate, {"tokens": jnp.asarray(tok)})
            jax.effects_barrier()
            picks = all_picks[step * accum * n_moe:]
            assert len(picks) == accum * n_moe
            with port_picks(picks) as used:
                t_new, tmet = tsteps.train_step(
                    tcfg, tstate, {"tokens": torch.from_numpy(tok)},
                    peak_lr=peak_lr, warmup_steps=2, total_steps=4)
            assert len(used) == len(picks)
            assert_metrics_close(jmet, tmet, loss_tol, aux_tol)
            assert rel_err(jmet["grad_norm"], tmet["grad_norm"]) < GNORM_RTOL
            assert rel_err(jmet["lr"], tmet["lr"]) < 1e-6
            assert float(tmet["step"]) == float(jmet["step"]) == step + 1
            _assert_updates_close(jstate, j_new, tstate, t_new,
                                  float(jmet["lr"]), tol, resolved)
            if step == 0:
                _assert_moments_close(j_new, t_new, tol)
            jstate, tstate = j_new, t_new


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_steps_match_reference(arch, accum):
    """Twin of ``tests/test_smoke_archs.py``'s ``test_one_train_step``:
    three steps at capacity factor 1.25 (drops)."""
    check_train_steps(arch, accum, GRAD_RTOL)


@pytest.mark.parametrize("fault", ["skipped", "wrong_sign"])
def test_train_step_check_catches_a_faulty_update(fault, monkeypatch):
    """``check_train_steps`` with the port's second update skipped, or
    applied with the wrong sign: the update check fails (it reads about 1
    and 2 lr)."""
    real = tsteps.adamw.update

    def update(params, grads, state, **kw):
        new, opt = real(params, grads, state, **kw)
        if int(state.step) == 1:
            new = params if fault == "skipped" else tree_map_n(
                lambda p, q: (2 * p.float() - q.float()).to(p.dtype),
                params, new)
        return new, opt

    monkeypatch.setattr(tsteps.adamw, "update", update)
    with pytest.raises(AssertionError) as err:
        check_train_steps(MOE_ARCHS[0], 1, GRAD_RTOL)
    # the update check's message, (leaf, its reading), on the first line
    name, held = ast.literal_eval(str(err.value).splitlines()[0])
    assert held > {"skipped": 0.9, "wrong_sign": 1.8}[fault], (name, held)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cpu_training_counts_no_kernel_launch(arch):
    """On the CPU every wrapper takes its plain version: a train step of
    the reduced config counts no launch."""
    _, tcfg, _, tparams = port_init(arch)
    counts = [(rn_ops.rmsnorm, "launches"), (rn_ops.rmsnorm_bwd, "launches")]
    before = [getattr(w, a) for w, a in counts]
    state = tsteps.TrainState(params=tparams, opt=tsteps.adamw.init(tparams))
    _, met = tsteps.train_step(
        tcfg, state, {"tokens": torch.from_numpy(tokens(tcfg, (2, 20), 14))})
    assert bool(torch.isfinite(met["loss"]))
    assert [getattr(w, a) for w, a in counts] == before


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_cli_trains_reduced_moe_on_cpu(arch, tmp_path):
    res = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--steps", "3", "--batch", "4", "--seq", "24",
                       "--workdir", str(tmp_path)])
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert all(m["aux_loss"] > 0 for m in res.metrics)
    assert all(t.device.type == "cpu" for t in tree_leaves(res.state.params))

