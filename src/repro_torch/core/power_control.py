"""Power control (paper eq. 10-11), port of ``repro/core/power_control.py``.

p_{i,t} = β_{i,t} K_i b_t / h_{i,t}; every symbol is ±1, so the peak
constraint (11) bounds b_t ≤ h_i √(P_i^Max) / K_i for each scheduled i.
"""
from __future__ import annotations

import math

import torch


def power_factors(beta, k_weights, b_t, h) -> torch.Tensor:
    """Eq. (10)."""
    return beta * k_weights * b_t / h


def tx_power(beta, k_weights, b_t, h) -> torch.Tensor:
    """Per-worker transmit power |p_i c_i|² (eq. 11, symbol-independent)."""
    return (beta * k_weights * b_t) ** 2 / h ** 2


def max_bt(beta, k_weights, h, p_max) -> torch.Tensor:
    """Largest b_t satisfying (11) for all scheduled workers. ``p_max``
    may be a tensor on h's device (an arm's P^Max), which stays there."""
    root = (torch.sqrt(p_max) if isinstance(p_max, torch.Tensor)
            else math.sqrt(float(p_max)))
    per_worker = h * root / k_weights
    caps = torch.where(beta > 0, per_worker,
                       torch.full_like(per_worker, float("inf")))
    return caps.min()


def feasible(beta, k_weights, b_t, h, p_max) -> torch.Tensor:
    # relative slack: b_t on the exact boundary must test feasible in f32
    return torch.all(tx_power(beta, k_weights, b_t, h)
                     <= p_max * (1.0 + 1e-5) + 1e-9)
