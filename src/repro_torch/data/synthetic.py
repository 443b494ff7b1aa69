"""Deterministic synthetic datasets: a copy of the NumPy code of
``repro/data/synthetic.py``, so the port makes the same arrays from the
same seed without importing the JAX package.

- ``synthetic_mnist``: 28x28 grayscale "digits" built from per-class
  stroke templates + jitter + pixel noise: learnable by the paper's
  784-64-10 MLP, and available with no network access.
- ``token_stream``: integer token streams for the LM trainer.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_TEMPLATES = {}  # class -> (28,28) float template


def _digit_template(c: int) -> np.ndarray:
    """Procedural stroke template per class (deterministic)."""
    if c in _TEMPLATES:
        return _TEMPLATES[c]
    img = np.zeros((28, 28), np.float32)
    rng = np.random.default_rng(1000 + c)
    yy, xx = np.mgrid[0:28, 0:28]
    # class-specific arcs/strokes
    n_strokes = 2 + c % 3
    for s in range(n_strokes):
        cx, cy = rng.uniform(8, 20, 2)
        r = rng.uniform(4, 9)
        a0, a1 = sorted(rng.uniform(0, 2 * np.pi, 2))
        ang = np.arctan2(yy - cy, xx - cx)
        dist = np.hypot(yy - cy, xx - cx)
        arc = (np.abs(dist - r) < 1.6) & (ang > a0) & (ang < a1)
        img[arc] = 1.0
        if c % 2 == s % 2:  # add a bar
            x0 = int(rng.uniform(6, 18))
            img[6:22, x0:x0 + 2] = np.maximum(img[6:22, x0:x0 + 2], 0.9)
    img = img / max(img.max(), 1e-6)
    _TEMPLATES[c] = img
    return img


def synthetic_mnist(n_train: int = 60000, n_test: int = 10000,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray, np.ndarray]:
    """Returns (x_train (N,784) in [0,1], y_train, x_test, y_test)."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    y = rng.integers(0, 10, n).astype(np.int32)
    x = np.zeros((n, 28, 28), np.float32)
    shifts = rng.integers(-2, 3, (n, 2))
    noise = rng.normal(0, 0.15, (n, 28, 28)).astype(np.float32)
    scale = rng.uniform(0.8, 1.2, n).astype(np.float32)
    for c in range(10):
        idx = np.where(y == c)[0]
        t = _digit_template(c)
        x[idx] = t[None]
    # per-sample jitter: roll + scale + noise
    for i in range(n):
        x[i] = np.roll(np.roll(x[i], shifts[i, 0], 0), shifts[i, 1], 1)
    x = np.clip(x * scale[:, None, None] + noise, 0.0, 1.0)
    x = x.reshape(n, 784)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def token_stream(n_seqs: int, seq_len: int, vocab: int,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Markov-ish token streams: (tokens, targets=next-token)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, (n_seqs, seq_len + 1), dtype=np.int64)
    # inject local structure: every other token repeats with offset
    base[:, 2::2] = (base[:, 1:-1:2] + 1) % vocab
    return base[:, :-1].astype(np.int32), base[:, 1:].astype(np.int32)
