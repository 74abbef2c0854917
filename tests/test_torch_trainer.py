"""The port's single-card trainer (``repro_torch.launch.train``), its
checkpoint manager and its batcher, on the CPU at reduced size, against
the JAX package's twins where they have one: the checkpoint signatures and
the batches are the reference's bit for bit, a run restarted from a
checkpoint ends on the same state as an uninterrupted one, and the
trainer refuses to run without a card unless ``--device cpu`` is passed.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.data import pipeline as jpipeline, synth as jsynth
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager, ckpt as tckpt
from repro_torch.core.store import Store
from repro_torch.core.tree import tree_flatten
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import train
from repro_torch.train import steps as tsteps

ARGS = ["--device", "cpu", "--reduced", "--arch", "internlm2-1.8b",
        "--batch", "2", "--seq", "16", "--log-every", "1"]


def _same_bits(a, b) -> bool:
    (la, da), (lb, db) = tree_flatten(a), tree_flatten(b)
    return da == db and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def test_trainer_runs_reduced_on_cpu(tmp_path, capsys):
    res = train.main(ARGS + ["--steps", "3", "--segment-steps", "2",
                             "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=internlm2-1.8b-smoke" in out and "devices=1" in out
    assert "step     2" in out and "done: loss" in out
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert int(res.state.opt.step) == 3
    assert [m["step"] for m in res.metrics] == [1.0, 2.0, 3.0]
    # the segment boundary at step 2 was saved, the last step (3) was not
    mgr = CheckpointManager(Store(os.path.join(tmp_path, "store")),
                            "internlm2-1.8b-smoke-s0")
    assert mgr.latest_step() == 2


def test_resume_ends_on_the_same_state_as_an_uninterrupted_run(tmp_path):
    """4 steps with a segment at 2; then the job is taken as preempted
    after its step-2 checkpoint landed (step 4's checkpoint is removed) and
    restarted with ``--resume``: it restores step 2, replays batches 2 and
    3, and ends on the uninterrupted run's state, bit for bit."""
    args = ARGS + ["--steps", "4", "--segment-steps", "2",
                   "--workdir", str(tmp_path)]
    full = train.main(args)
    store = Store(os.path.join(tmp_path, "store"))
    run = "internlm2-1.8b-smoke-s0"
    assert CheckpointManager(store, run).latest_step() == 4
    assert store.delete(tckpt._sig(run, 4)) > 0
    resumed = train.main(args + ["--resume"])
    assert resumed.start_step == 2 and len(resumed.losses) == 2
    assert resumed.losses == full.losses[2:]
    assert _same_bits(resumed.state, full.state)
    # and the checkpoint it saved at the end is that state too
    restored = CheckpointManager(Store(os.path.join(tmp_path, "store")),
                                 run).restore(4)
    assert isinstance(restored, tsteps.TrainState)
    assert _same_bits(restored, full.state)


def test_checkpoint_roundtrip(tmp_path):
    cfg = tconfigs.reduced(tconfigs.get("internlm2-1.8b"))
    state = tsteps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    mgr = CheckpointManager(Store(str(tmp_path)), "run1")
    mgr.save(10, state, async_=False)
    mgr.save(20, state)
    mgr.wait()
    assert mgr.latest_step() == 20
    assert _same_bits(mgr.restore(20), state)
    assert _same_bits(mgr.restore(10), state)


@pytest.mark.parametrize("run,step", [("run1", 0), ("internlm2-1.8b-s0", 50),
                                      ("x/y", 123456)])
def test_checkpoint_signature_is_the_references(run, step):
    assert tckpt._sig(run, step) == jckpt._sig(run, step)


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7), (11, 299)])
def test_token_batcher_is_the_references_bit_for_bit(seed, step):
    tokens = jsynth.lm_tokens(seed, 10_000, 100)
    want = jpipeline.TokenBatcher(tokens, 4, 16, seed=seed).batch_at(step)
    got = tpipeline.TokenBatcher(tokens, 4, 16, seed=seed).batch_at(step)
    assert set(got) == set(want) == {"tokens"}
    assert got["tokens"].dtype == want["tokens"].dtype == np.int32
    assert np.array_equal(got["tokens"], want["tokens"])
    moved = tpipeline.batch_to(got, "cpu")
    assert moved["tokens"].dtype == torch.int32
    assert np.array_equal(moved["tokens"].numpy(), want["tokens"])


def test_watchdog_flags_a_straggler():
    dog = train.Watchdog(z_thresh=4.0)
    assert all(dog.observe(0.1 + 0.001 * (i % 3)) is None for i in range(20))
    assert "straggler" in dog.observe(1.0)


def test_trainer_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the rule under test is for machines without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1", "--workdir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="item 9"):
        train.main(ARGS + ["--production-mesh", "--workdir", str(tmp_path)])


def test_full_flag_selects_the_published_config(monkeypatch, tmp_path):
    """``--full`` trains the published config: checked up to the point
    where the state would be made, without making it."""
    seen = {}

    def stop(cfg, generator, device):
        seen["cfg"] = cfg
        raise KeyboardInterrupt

    monkeypatch.setattr(tsteps, "init_train_state", stop)
    with pytest.raises(KeyboardInterrupt):
        train.main(["--device", "cpu", "--full", "--arch", "internlm2-1.8b",
                    "--workdir", str(tmp_path)])
    assert seen["cfg"] == dataclasses.replace(tconfigs.get("internlm2-1.8b"))
