"""Deterministic synthetic token streams (numpy).

A copy of ``lm_tokens`` from the JAX package's ``data/synth.py``: the same
(seed, size, vocab) gives the same tokens in both packages.
"""
from __future__ import annotations

import numpy as np


def lm_tokens(seed: int, num_tokens: int, vocab_size: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # Zipf-ish unigram distribution.
    ranks = np.arange(1, vocab_size + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    base = rng.choice(vocab_size, size=num_tokens, p=probs)
    # Inject deterministic bigram structure: token t is often followed by
    # (a*t + b) mod V — gives the model something learnable.
    a, b = 31, 7
    follow = rng.random(num_tokens) < 0.5
    base[1:] = np.where(follow[1:], (a * base[:-1] + b) % vocab_size,
                        base[1:])
    return base.astype(np.int32)
