"""Deterministic synthetic data sources (numpy).

A copy of the JAX package's ``data/synth.py``: ``lm_tokens`` for the LM
paths, ``census_rows``, ``documents`` and ``images`` for the paper's
workflows. The same seed and size give the same bytes in both packages,
which is what makes data nodes equivalent across Helix iterations (paper
Def. 2 requires inputs to be reproducible).
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


def census_rows(seed: int, n: int) -> dict[str, np.ndarray]:
    """Synthetic census-income-like table (the paper's running example)."""
    rng = np.random.default_rng(seed)
    age = rng.integers(17, 90, n)
    education = rng.integers(0, 16, n)
    occupation = rng.integers(0, 15, n)
    hours = rng.integers(1, 99, n)
    capital_gain = (rng.pareto(3.0, n) * 1000).astype(np.int64)
    marital = rng.integers(0, 7, n)
    race = rng.integers(0, 5, n)
    sex = rng.integers(0, 2, n)
    # Ground-truth income rule with noise (so LR has signal).
    score = (0.03 * (age - 40) + 0.25 * (education - 8)
             + 0.15 * (occupation % 5) + 0.02 * (hours - 40)
             + 0.0004 * capital_gain + 0.3 * sex
             + rng.normal(0, 1.0, n))
    target = (score > 0.8).astype(np.int32)
    return dict(age=age, education=education, occupation=occupation,
                hours=hours, capital_gain=capital_gain, marital=marital,
                race=race, sex=sex, target=target)


def documents(seed: int, n_docs: int, doc_len: int, vocab: int
              ) -> np.ndarray:
    """Synthetic 'articles' (token matrices) for the genomics/NLP workflows."""
    rng = np.random.default_rng(seed)
    topics = rng.integers(0, 16, n_docs)
    docs = np.empty((n_docs, doc_len), np.int32)
    for i, t in enumerate(topics):
        center = (t * vocab) // 16
        spread = vocab // 8
        docs[i] = (center + rng.integers(0, spread, doc_len)) % vocab
    return docs


def images(seed: int, n: int, side: int = 28) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic MNIST-like images: class = dominant frequency pattern."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    xs = np.linspace(0, 1, side)
    xx, yy = np.meshgrid(xs, xs)
    imgs = np.empty((n, side, side), np.float32)
    for c in range(10):
        idx = labels == c
        k = idx.sum()
        if k == 0:
            continue
        pattern = np.sin(2 * np.pi * (c + 1) * xx) * np.cos(
            2 * np.pi * ((c % 3) + 1) * yy)
        imgs[idx] = pattern + rng.normal(0, 0.3, (k, side, side))
    return imgs.astype(np.float32), labels.astype(np.int32)
