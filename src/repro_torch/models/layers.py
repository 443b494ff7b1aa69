"""Initialisers shared by the port's models (port of the ``he_init`` of
``repro/models/layers.py``)."""
from __future__ import annotations

import math

import torch


def he_init(generator: torch.Generator, shape, fan_in=None, device=None,
            dtype=torch.float32) -> torch.Tensor:
    """N(0, 2/fan_in) weights; ``fan_in`` defaults to ``shape[0]`` (the
    JAX ``x @ w`` layout: inputs on the first axis)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = math.sqrt(2.0 / max(1, fan_in))
    return (torch.randn(shape, generator=generator, device=device) * std
            ).to(dtype)
