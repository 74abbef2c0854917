"""The port's serve entry point vs the JAX package's serve loop, the
device rule, and the import boundary of ``repro_torch``."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.data import synth as jsynth
from repro.models import registry as jregistry
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.data import synth as tsynth
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.train import steps as tsteps

REL_TOL = 3e-2     # as tests/test_torch_model.py: bf16 in both packages
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SRC = os.path.join(ROOT, "src")


def _reference_serve(cfg, params, prompts, gen_tokens):
    """The greedy loop of the JAX package's ``launch/serve.py:main``:
    returns the tokens and each step's logits."""
    max_len = prompts.shape[1] + gen_tokens
    prefill = jax.jit(lambda p, b: jsteps.prefill_step(cfg, p, b,
                                                      max_len=max_len))
    decode = jax.jit(lambda p, t, c: jsteps.decode_step(cfg, p, t, c),
                     donate_argnums=(2,))
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompts)})
    out, all_logits = [jnp.argmax(logits, -1)[:, None]], [logits]
    for _ in range(gen_tokens - 1):
        logits, cache = decode(params, out[-1].astype(jnp.int32), cache)
        out.append(jnp.argmax(logits, -1)[:, None].astype(jnp.int32))
        all_logits.append(logits)
    return (np.asarray(jnp.concatenate(out, 1)),
            np.stack([np.asarray(x, np.float32) for x in all_logits], 1))


def _teacher_forced_logits(cfg, params, prompts, ref_tokens, max_len):
    """Every step's logits of the port's own prefill and decode, fed the
    reference's greedy tokens (not its own), so each step sees the
    reference's input: (B, steps, V) fp32, step 0 the prefill's."""
    with torch.inference_mode():
        logits, cache = tsteps.prefill_step(
            cfg, params, {"tokens": torch.as_tensor(np.asarray(prompts))},
            max_len=max_len)
        out = [logits]
        for i in range(ref_tokens.shape[1] - 1):
            token = torch.tensor(np.asarray(ref_tokens[:, i:i + 1]),
                                 dtype=torch.int32)
            logits, cache = tsteps.decode_step(cfg, params, token, cache)
            out.append(logits)
    return np.stack([t.float().numpy() for t in out], 1)


def assert_every_step_and_clear_tokens_match(ref_tokens, ref_logits, forced,
                                             got_tokens):
    """The weight-independent verdict of a greedy serving run: every
    step's teacher-forced logits within REL_TOL of the reference's, relative
    to the step's max |logit|; and per row, the run's own greedy tokens
    equal the reference's up to the first step where the reference's
    top-1/top-2 gap is within REL_TOL (there bf16 rounding may pick the
    other token, and the two continuations part)."""
    for step in range(ref_logits.shape[1]):
        want = ref_logits[:, step]
        err = np.abs(want - forced[:, step]).max() / np.abs(want).max()
        assert err < REL_TOL, (step, err)
    top2 = np.sort(ref_logits, -1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0]) / np.abs(ref_logits).max(-1)
    for row in range(ref_tokens.shape[0]):
        for step in range(ref_tokens.shape[1]):
            if margin[row, step] <= REL_TOL:
                break
            assert int(got_tokens[row, step]) == int(ref_tokens[row, step]), (
                row, step)


def test_lm_tokens_match_reference():
    assert np.array_equal(tsynth.lm_tokens(3, 1000, 512),
                          jsynth.lm_tokens(3, 1000, 512))


def test_serve_run_on_cpu_gives_the_reference_tokens():
    """Every step's logits, teacher-forced on the reference's tokens, agree
    with the reference's; per sequence, tokens agree up to the first step
    where the reference's top-1/top-2 gap is within the tolerance."""
    jcfg = jconfigs.reduced(jconfigs.get("internlm2-1.8b"))
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get("internlm2-1.8b")),
                               attn_impl="flash")
    b, s, gen = 4, 32, 12
    prompts = tsynth.lm_tokens(0, b * s + 1, jcfg.vocab_size)[:b * s].reshape(b, s)
    jparams = jregistry.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")

    ref_tokens, ref_logits = _reference_serve(jcfg, jparams, prompts, gen)
    res = serve.run(tcfg, tparams, prompts, gen, device="cpu")
    assert res.tokens.shape == (b, gen) and res.tokens.dtype == torch.int32
    assert res.prefill_s > 0 and res.decode_s > 0
    forced = _teacher_forced_logits(tcfg, tparams, prompts, ref_tokens,
                                    s + gen)
    assert_every_step_and_clear_tokens_match(ref_tokens, ref_logits, forced,
                                             res.tokens.numpy())
    first = ref_logits[:, 0]
    err = np.abs(first - res.prefill_logits.float().numpy()).max()
    assert err / np.abs(first).max() < REL_TOL


def test_serve_entry_points_refuse_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("the rule under test is for machines without a card")
    cfg = tconfigs.reduced(tconfigs.get("internlm2-1.8b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(cfg, {}, np.zeros((1, 4), np.int32), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--gen-tokens", "2"])


def test_serve_cli_runs_reduced_on_cpu(capsys):
    serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                "--gen-tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=internlm2-1.8b-smoke" in out and "attn_impl=flash" in out
    assert "first sequence:" in out


CORE_MODULES = ("tree", "dag", "workflow", "signature", "oep", "omp", "costs",
                "pruning", "config", "locking", "eviction", "remote",
                "faults", "chunks", "memtier", "store", "executor",
                "session")


TRAIN_MODULES = ("repro_torch.optim.adamw", "repro_torch.optim.schedules",
                 "repro_torch.train.steps", "repro_torch.data.pipeline",
                 "repro_torch.checkpoint.ckpt", "repro_torch.launch.train",
                 "repro_torch.launch.bench_tier", "repro_torch.workflows")


WORKFLOW_MODULES = ("repro_torch.data.synth", "repro_torch.data.tabular",
                    "repro_torch.launch.bench_workflows")


FLEET_MODULES = tuple(f"repro_torch.serve.{m}" for m in (
    "protocol", "pool", "scheduler", "tenancy", "server", "client",
    "router")) + ("repro_torch.serve", "repro_torch.core.sweep",
                  "repro_torch.core.search",
                  "repro_torch.launch.bench_fleet")


BENCH_MODULES = ("repro_torch.launch._blas", "repro_torch.launch.bench_engine",
                 "repro_torch.launch.bench") + tuple(
    f"repro_torch.examples.{m}" for m in (
        "quickstart", "genomics_iterate", "incremental_census",
        "session_server", "sweep_census", "tune_census", "serve_lm",
        "train_lm")) + ("repro_torch.examples",)


MODEL_MODULES = ("repro_torch.models.lm", "repro_torch.models.moe",
                 "repro_torch.models.layers", "repro_torch.models.ssd",
                 "repro_torch.models.encdec", "repro_torch.models.registry",
                 "repro_torch.launch.serve")


def test_port_imports_no_jax_ml_dtypes_or_reference():
    """Import every module of ``repro_torch`` (walked, so a new module
    cannot slip past; the Helix core's, the training slice's and the
    paper workflows' modules are named so that none is missed) and
    ``chip_smoke`` (without running it), then check that no JAX,
    ml_dtypes or reference module was loaded. The serving and fleet
    layer, the sweep and search drivers and their bench are named too, and
    the model modules (the MoE block, M-RoPE, the hybrid stack and the
    encoder-decoder among them) and the serving entry point, and the
    engine benches, the by-name bench CLI and the eight examples."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert 'repro_torch.kernels.ssd.ops' in mods, mods\n"
        f"core = {['repro_torch.core.' + m for m in CORE_MODULES]!r}\n"
        "assert set(core) <= set(mods), sorted(set(core) - set(mods))\n"
        f"train = {list(TRAIN_MODULES)!r}\n"
        "assert set(train) <= set(mods), sorted(set(train) - set(mods))\n"
        f"flows = {list(WORKFLOW_MODULES)!r}\n"
        "assert set(flows) <= set(mods), sorted(set(flows) - set(mods))\n"
        f"fleet = {list(FLEET_MODULES)!r}\n"
        "assert set(fleet) <= set(mods), sorted(set(fleet) - set(mods))\n"
        f"benches = {list(BENCH_MODULES)!r}\n"
        "assert set(benches) <= set(mods), sorted(set(benches) - set(mods))\n"
        f"models = {list(MODEL_MODULES)!r}\n"
        "assert set(models) <= set(mods), sorted(set(models) - set(mods))\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")


def test_profile_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the rule under test is for machines without a card")
    from repro_torch.launch import profile_serve
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_serve.main([])
