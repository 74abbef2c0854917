"""Workflows on the port (twin of the JAX package's
``benchmarks/workflows.py``): for now the LM training workflow
(``LMKnobs``, ``_lm_arch``, ``build_lm``, ``mutate_lm``; reference lines
599-698). The paper's four survey workflows come next (ROADMAP queue 1
item 6).

Node names and config tuples are the reference's, so a workflow built here
signs exactly as its twin does. The expensive reusable artifact is a
``TrainState`` of tensors (params and AdamW moments), which the store's
memory tier serves zero-copy to a warm iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .core import Workflow
from .core.tree import tree_map
from .device import resolve
from .models.config import ArchConfig
from .train import steps as train_steps


@dataclasses.dataclass(frozen=True)
class LMKnobs:
    """A small-config LM training loop on the model zoo's dense family."""

    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    d_ff: int = 512
    vocab: int = 512
    seq_len: int = 64
    batch: int = 8
    steps: int = 4                # train batches (halving resource, LI)
    peak_lr: float = 1e-3
    seed: int = 0
    report_percentiles: bool = False   # PPR knob (loss-report formatting)


def _lm_arch(k: LMKnobs) -> ArchConfig:
    # attn_impl="chunked": plain attention, as the reference trains (the
    # FlashAttention kernel has no backward yet)
    return ArchConfig(
        name="bench-lm", family="dense", num_layers=k.n_layers,
        d_model=k.d_model, num_heads=k.n_heads, num_kv_heads=k.n_heads,
        d_ff=k.d_ff, vocab_size=k.vocab, attn_impl="chunked")


def build_lm(k: LMKnobs, *, device: str | torch.device | None = None,
             make_state: Callable[[], train_steps.TrainState] | None = None
             ) -> Workflow:
    """The LM workflow: tokens and an initial state → ``train`` (``k.steps``
    train steps) → ``evalLoss`` on a held-out batch, on ``device`` (default
    ``cuda``). ``make_state`` makes the initial ``TrainState`` (a test hands
    over the reference's); by default the params are drawn on the host from
    ``torch.Generator().manual_seed(k.seed)`` and moved to ``device``, so
    every device starts from the same state."""
    cfg = _lm_arch(k)
    dev = resolve(device)
    wf = Workflow("lm")

    def make_tokens():
        rng = np.random.default_rng(k.seed + 101)
        # steps train batches + 1 held-out eval batch
        return rng.integers(0, k.vocab, (k.steps + 1, k.batch, k.seq_len),
                            dtype=np.int32)

    def init_state():
        if make_state is not None:
            return make_state()
        state = train_steps.init_train_state(
            cfg, torch.Generator().manual_seed(k.seed), "cpu")
        return tree_map(lambda t: t.to(dev), state)

    tokens = wf.source("tokens", make_tokens,
                       config=("tok", k.vocab, k.seq_len, k.batch, k.steps,
                               k.seed))
    state0 = wf.source(
        "initState", init_state,
        config=("init", k.n_layers, k.d_model, k.n_heads, k.d_ff, k.vocab,
                k.seed))

    def train(tok, state):
        # operators must not mutate their inputs: the memory tier hands the
        # stored state itself to a warm iteration
        state = tree_map(lambda t: t.clone(), state)
        losses = []
        for i in range(k.steps):
            state, metrics = train_steps.train_step(
                cfg, state, {"tokens": torch.as_tensor(tok[i]).to(dev)},
                peak_lr=k.peak_lr, warmup_steps=2,
                total_steps=max(k.steps, 3), clip_norm=1.0)
            losses.append(float(metrics["loss"]))
        return {"state": state, "losses": np.asarray(losses, np.float64)}

    trained = wf.learner(
        "train", train, [tokens, state0],
        config=("train", k.n_layers, k.d_model, k.n_heads, k.d_ff, k.vocab,
                k.seq_len, k.batch, k.steps, k.peak_lr))

    def eval_loss(tok, tr):
        with torch.no_grad():
            loss, _ = train_steps.loss_fn(
                cfg, tr["state"].params,
                {"tokens": torch.as_tensor(tok[-1]).to(dev)})
        out = {"eval_loss": float(loss),
               "train_losses": tr["losses"].tolist()}
        if k.report_percentiles:
            qs = np.percentile(tr["losses"], [0, 50, 100])
            out["loss_percentiles"] = {"p0": float(qs[0]),
                                       "p50": float(qs[1]),
                                       "p100": float(qs[2])}
        return out

    out = wf.reducer("evalLoss", eval_loss, [tokens, trained],
                     config=("eval", k.report_percentiles))
    wf.output(out)
    return wf


def mutate_lm(k: LMKnobs, kind: str, rng) -> LMKnobs:
    if kind == "DPR":
        if rng.random() < 0.5:
            return dataclasses.replace(k, seq_len=int(rng.choice(
                [48, 64, 96])))
        return dataclasses.replace(k, batch=int(rng.choice([4, 8])))
    if kind == "LI":
        if rng.random() < 0.5:
            return dataclasses.replace(k, peak_lr=float(rng.choice(
                [3e-4, 1e-3, 3e-3])))
        return dataclasses.replace(k, steps=int(rng.choice([3, 4, 6])))
    return dataclasses.replace(
        k, report_percentiles=not k.report_percentiles)
