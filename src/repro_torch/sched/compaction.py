"""Pow2 convergence-compaction bucketing; port of
``repro/sched/compaction.py``.

Host-side callers gather the lanes that still need device work (the
unconverged ADMM instances, the polish-active ones) into the next power of
two, padded by repeating the first entry:

- **Bounded shapes.** Bucket sizes are powers of two floored at
  ``MIN_BUCKET``, so however the active set shrinks, the solver sees at
  most log2(B) batch sizes.
- **Collision-safe scatters.** Pad lanes duplicate the first real index;
  a deterministic solver maps identical inputs to identical outputs, so a
  scatter of a bucket's results writes the same value through every
  duplicate. ``valid`` marks the real lanes for callers that treat pads
  apart (the ADMM loop pre-freezes them).
"""
from __future__ import annotations

from dataclasses import fields, is_dataclass, replace
from typing import Tuple

import numpy as np
import torch

MIN_BUCKET = 8     # smallest compaction bucket


def bucket(n: int, min_bucket: int = MIN_BUCKET) -> int:
    """Smallest power of two ≥ ``n``, floored at ``min_bucket``."""
    if n <= 0:
        raise ValueError(f"bucket needs n >= 1, got {n}")
    return max(min_bucket, 1 << (n - 1).bit_length())


def take(tree, idx):
    """Gather every tensor of ``tree`` at ``idx`` along its first axis
    (a lane gather): a tensor, a tuple or NamedTuple of them (``None``
    entries stay ``None``), or a dataclass such as ``BatchedProblem``,
    whose non-tensor fields are kept."""
    if isinstance(tree, torch.Tensor):
        return tree[torch.as_tensor(idx, device=tree.device)]
    if is_dataclass(tree):
        return replace(tree, **{
            f.name: take(getattr(tree, f.name), idx) for f in fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    if isinstance(tree, tuple):
        out = [None if leaf is None else take(leaf, idx) for leaf in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    raise TypeError(f"take: cannot gather a {type(tree).__name__}")


def pad_to_bucket(idx: np.ndarray, min_bucket: int = MIN_BUCKET
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad an active-lane index set to its pow2 bucket.

    Returns ``(pad, valid)``: ``pad`` is ``idx`` followed by repeats of
    ``idx[0]`` up to ``bucket(len(idx))`` entries, ``valid`` marks the
    real (non-duplicate) lanes."""
    idx = np.asarray(idx)
    if idx.size == 0:
        raise ValueError("pad_to_bucket needs at least one active lane")
    size = bucket(int(idx.size), min_bucket)
    pad = np.concatenate([idx, np.repeat(idx[:1], size - idx.size)])
    valid = np.zeros(size, bool)
    valid[:idx.size] = True
    return pad, valid
