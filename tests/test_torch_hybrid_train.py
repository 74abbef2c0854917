"""Training the hybrid family: the reduced jamba-v0.1-52b's train step vs
the JAX package's, on the CPU.

``configs.reduced`` gives jamba 8 layers in 2 groups of ``attn_every`` 4
(3 Mamba-2 layers, then attention; MoE on sublayers 1 and 3, 8 experts top
2), SSD head_dim 16 and chunk 8, where the reference's chunked scan is
finite. The port checkpoints each group as the reference wraps its group
body (``models/lm.py`` ``_hybrid_stack``). Weights, tokens and picks as in
``tests/test_torch_moe_train.py``: the port's seeded ``init`` carried to
JAX, the port on the reference's top-k picks, both at ``remat="none"``,
at ``reduced()``'s drop-free capacity factor and at 1.25.

With the whole model in fp32 on both sides (``check_fp32_model``) the
loss and every leaf's gradient are held at 1e-5: the port reaches 2.8e-6
to 6.0e-6 over 6 token seeds x 2 capacity factors, and a leaf's gradient
3% off (``dt_bias``, ``d_skip``, a router, or the SSD backward's dt
cotangent) reads 3.0e-2 to 3.5e-2 there. That case holds the wiring.

In bf16, as the model trains, gradients and first moments are held at
8e-2 of each leaf's max |g|, second moments at twice that, the loss at
2e-3. The MoE configs' 3e-2 sits below the reference's own floor here:
its chunked scan against its sequential oracle, on the same picks, two
programs that differ only in the SSD's rounding, disagree by 0.030 to
0.050 over the same 12 cases (6 Mamba-2 layers integrate every upstream
rounding). The port, whose SSD computes in fp32, reads 0.039 to 0.066
against the chunked scan, and a leaf's gradient 10% off reads 0.101 to
0.130; 8e-2 lies between the two (a 3% fault does not show above the
bf16 noise: the fp32 case catches it). All these readings come from
``tests/torch_hybrid_tolerance.py``.

At chunk 128 (jamba-v0.1-52b's own) the reference's gradients go through
its sequential oracle (``monkeypatch`` on the reference module, no file
edited), as ``tests/test_torch_ssd_train.py`` does for mamba2.
"""
import dataclasses

import numpy as np
import pytest

import torch

from repro.kernels.ssd.ref import ssd_ref as jssd_ref
from repro.models import ssd as jssd
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.ssd import ops as tssd_ops
from repro_torch.launch import train as ttrain
from repro_torch.train import steps as tsteps
from test_torch_moe_train import (assert_grads_close, assert_metrics_close,
                                  check_fp32_model, check_remat,
                                  check_train_steps, counting_calls,
                                  loss_and_grads, port_init, remat_calls,
                                  tokens)

NAME = "jamba-v0.1-52b"
GRAD_RTOL = 8e-2       # see the module docstring
LOSS_RTOL = 2e-3
AUX_RTOL = 3e-2        # on the same picks the mean router probabilities
#                        differ by the bf16 hidden state, 8 layers deep
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: several test processes share
    the cores, and torch's OpenMP pool would spin at each small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cf", [1.25, None], ids=["cf1.25", "drop_free"])
def test_loss_and_every_gradient_match_reference(cf):
    jcfg, tcfg, jparams, tparams = port_init(NAME, cf)
    assert jcfg.grad_accum == tcfg.grad_accum == 4   # jamba's, kept
    (jmet, jgrads), (tmet, tgrads), picks = loss_and_grads(
        jcfg, tcfg, jparams, tparams, tokens(jcfg, (B, S), seed=7))
    assert len(picks) == sum(jcfg.layer_is_moe(i)
                             for i in range(jcfg.num_layers)) == 4
    assert_metrics_close(jmet, tmet, LOSS_RTOL, AUX_RTOL)
    assert_grads_close(jgrads, tgrads, GRAD_RTOL)


@pytest.mark.parametrize("cf", [1.25, None], ids=["cf1.25", "drop_free"])
def test_fp32_loss_and_every_gradient_match_reference(cf, monkeypatch):
    check_fp32_model(NAME, cf, monkeypatch)


@pytest.mark.parametrize("cf", [1.25, None], ids=["cf1.25", "drop_free"])
def test_remat_block_gives_the_gradients_of_none(cf):
    """One checkpoint a group: each MoE layer routes again in its group's
    recompute, as its forward did; the same bits as no remat; the calls a
    ``value_and_grad`` makes: 45 norms forward (22 a forward, twice, and the
    final norm), 23 backward, 12 SSD forwards and 6 backwards."""
    check_remat(NAME, cf, seed=11)
    _, tcfg, _, _ = port_init(NAME)
    assert remat_calls(tcfg, "block") == {"rms": 45, "rms_bwd": 23,
                                          "ssd": 12, "ssd_bwd": 6}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(accum):
    """Twin of ``tests/test_smoke_archs.py``'s ``test_one_train_step``:
    three steps at capacity factor 1.25 (drops)."""
    check_train_steps(NAME, accum, GRAD_RTOL, LOSS_RTOL, AUX_RTOL)


def test_grad_accum_4_runs_four_microbatches_a_step():
    """jamba's own ``grad_accum`` of 4: a step of batch 4 runs each
    microbatch's forward twice (remat) and its backward once."""
    _, tcfg, _, tparams = port_init(NAME, 1.25, remat="block")
    state = tsteps.TrainState(params=tparams, opt=tsteps.adamw.init(tparams))
    with counting_calls() as calls:
        _, met = tsteps.train_step(
            tcfg, state, {"tokens": torch.from_numpy(tokens(tcfg, (4, 20), 3))})
    assert bool(torch.isfinite(met["loss"]))
    assert calls == {k: 4 * v for k, v in remat_calls(tcfg, "block").items()}


def test_model_gradients_at_chunk_128_match_reference_with_sequential_oracle(
        monkeypatch):
    """At jamba's own chunk of 128 (reduced widths, a ragged S of 150):
    the reference with its chunked scan swapped for its sequential oracle,
    the port through ``SSDChunkFn``, on the reference's picks."""
    jcfg, tcfg, jparams, tparams = port_init(NAME, 1.25)
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, chunk=128))
    tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, chunk=128))

    def sequential(x, dt, a, Bm, Cm, chunk, h0=None):
        return jssd_ref(x, dt, a, Bm, Cm, h0=h0)

    monkeypatch.setattr(jssd, "ssd_scan_reference", sequential)
    (jmet, jgrads), (tmet, tgrads), _ = loss_and_grads(
        jcfg, tcfg, jparams, tparams, tokens(jcfg, (B, 150), seed=13))
    assert_metrics_close(jmet, tmet, LOSS_RTOL, AUX_RTOL)
    assert_grads_close(jgrads, tgrads, GRAD_RTOL)


def test_cpu_training_counts_no_kernel_launch():
    _, tcfg, _, tparams = port_init(NAME)
    counts = [(tssd_ops.ssd, "launches"), (tssd_ops.ssd, "launches_bwd"),
              (rn_ops.rmsnorm, "launches"), (rn_ops.rmsnorm_bwd, "launches")]
    before = [getattr(w, a) for w, a in counts]
    state = tsteps.TrainState(params=tparams, opt=tsteps.adamw.init(tparams))
    _, met = tsteps.train_step(
        tcfg, state, {"tokens": torch.from_numpy(tokens(tcfg, (4, 20), 14))})
    assert bool(torch.isfinite(met["loss"]))
    assert [getattr(w, a) for w, a in counts] == before


def test_train_cli_trains_reduced_jamba_on_cpu(tmp_path):
    res = ttrain.main(["--arch", NAME, "--reduced", "--device", "cpu",
                       "--steps", "3", "--batch", "4", "--seq", "24",
                       "--workdir", str(tmp_path)])
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert all(m["aux_loss"] > 0 for m in res.metrics)
    assert all(t.device.type == "cpu" for t in tree_leaves(res.state.params))


def test_prefill_after_training_writes_the_caches_as_before():
    """The serving path still writes every cache leaf (the SSM states are
    copied in after each group, outside any checkpoint): a prefill with
    grad mode on and one under ``inference_mode`` give the same cache."""
    _, tcfg, _, tparams = port_init(NAME, remat="block")
    tok = {"tokens": torch.from_numpy(tokens(tcfg, (2, 12), 5))}
    caches = []
    for ctx in (torch.enable_grad, torch.inference_mode):
        with ctx():
            _, cache = tsteps.prefill_step(tcfg, tparams, tok, max_len=16)
        caches.append(cache)
    for key in ("k", "v", "conv", "h"):
        assert float(caches[0][key].abs().max()) > 0, key
        assert torch.equal(caches[0][key].detach(), caches[1][key]), key
