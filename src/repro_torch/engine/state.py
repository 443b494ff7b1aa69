"""Round state and per-round stats; port of ``EngineState`` and
``RoundStats`` of ``repro/engine/state.py`` for the ported slice (the
warm-start, error-feedback and ADMM-dual leaves wait with their
features)."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class EngineState(NamedTuple):
    """What one round hands to the next."""
    params: Any                # dict of tensors
    opt_state: Any             # optimizer state
    fade: torch.Tensor         # (U,) complex64 Gauss-Markov state
    prev_beta: torch.Tensor    # (U,) f32; -1 before round 0


class RoundStats(NamedTuple):
    """Per-round scheduling stats. ``budget`` (the Theorem-1 error budget)
    is ``None`` until ``theory`` is ported."""
    n_scheduled: torch.Tensor  # int32: Σβ_t
    b_t: torch.Tensor          # f32: power scaling factor
    budget: Any = None
