"""Synthetic data streams for the paper's experiments.

A copy of the reference's numpy generators (``repro/data/streams.py``):
the same ``np.random.default_rng(seed)`` draws in the same order, so
the arrays are byte-identical to the reference's
(tests/test_torch_core.py pins it).  The port keeps its own copy
because it imports nothing of the JAX package.

- ``susy_stream``: binary classification with a non-linear
  (radial/XOR-ish) Bayes boundary.
- ``separable_stream``: linearly separable, for quiescence.
- ``drifting_stream``: a rotating boundary (concept drift).
- ``stock_stream``: AR(1) market with a non-linear target.
- ``token_stream``: Zipfian token batches for LM protocol training.

All return (X, Y) shaped (T, m, d) / (T, m) as float32 numpy arrays;
the engine moves them to the device.
"""
from __future__ import annotations

import numpy as np


def susy_stream(T: int, m: int, d: int = 8, seed: int = 0, noise: float = 0.05):
    """Non-linearly separable binary stream (SUSY-like)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(T, m, d)).astype(np.float32)
    # radial boundary in the first 4 dims + XOR term: non-linear Bayes rule
    r = np.sum(X[..., :4] ** 2, axis=-1)
    xor = X[..., 4] * X[..., 5]
    score = (r - 4.0) + 2.0 * xor
    flip = rng.random((T, m)) < noise
    Y = np.where((score > 0) ^ flip, 1.0, -1.0).astype(np.float32)
    return X, Y


def separable_stream(T: int, m: int, d: int = 8, seed: int = 0, margin: float = 0.5):
    """Linearly separable stream — lets linear learners reach zero loss,
    used to demonstrate quiescence of the dynamic protocol."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d,)); w /= np.linalg.norm(w)
    X = rng.normal(size=(T, m, d)).astype(np.float32)
    s = X @ w
    # enforce a margin by pushing points away from the boundary
    X += (np.sign(s) * margin)[..., None] * w
    Y = np.sign(X @ w).astype(np.float32)
    return X, Y


def drifting_stream(T: int, m: int, d: int = 8, seed: int = 0,
                    drift_every: int = 500, angle: float = 0.5):
    """Rotating linear boundary: concept drift forces re-synchronization."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(T, m, d)).astype(np.float32)
    Y = np.zeros((T, m), np.float32)
    w = rng.normal(size=(d,)); w /= np.linalg.norm(w)
    for t in range(T):
        if t > 0 and t % drift_every == 0:
            # rotate w in a random plane
            v = rng.normal(size=(d,)); v -= (v @ w) * w; v /= np.linalg.norm(v)
            w = np.cos(angle) * w + np.sin(angle) * v
        Y[t] = np.sign(X[t] @ w)
    return X, Y


def stock_stream(T: int, m: int, d: int = 10, seed: int = 0):
    """Multi-asset AR(1) market with a non-linear target response:
    sin(2 f0) * f1 + 0.3 tanh(2 * factor) + noise."""
    rng = np.random.default_rng(seed)
    X = np.zeros((T, m, d), np.float32)
    Y = np.zeros((T, m), np.float32)
    market = np.zeros((m,), np.float32)
    prev = rng.normal(size=(m, d)).astype(np.float32) * 0.1
    for t in range(T):
        market = 0.9 * market + 0.1 * rng.normal(size=(m,)).astype(np.float32)
        eps = rng.normal(size=(m, d)).astype(np.float32) * 0.3
        feats = 0.5 * prev + market[:, None] + eps
        X[t] = feats
        Y[t] = (
            np.sin(2.0 * feats[:, 0]) * feats[:, 1]
            + 0.3 * np.tanh(2.0 * market)
            + 0.05 * rng.normal(size=(m,)).astype(np.float32)
        )
        prev = feats
    return X, Y


def token_stream(T: int, batch: int, seq_len: int, vocab: int, seed: int = 0):
    """Integer token batches for LM-scale protocol training (synthetic
    Zipfian unigram text with local repetition structure): T pairs of
    (tokens, labels), each (batch, seq_len) int32."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    p = 1.0 / ranks
    p /= p.sum()
    for _ in range(T):
        toks = rng.choice(vocab, size=(batch, seq_len + 1), p=p).astype(np.int32)
        # inject copy structure so there is something to learn
        half = seq_len // 2
        toks[:, half + 1 : 2 * half + 1] = toks[:, 1 : half + 1]
        yield toks[:, :-1], toks[:, 1:]
