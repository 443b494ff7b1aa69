"""The closed-form P2 quantities of the ``all`` scheduler; port of
``caps`` and ``optimal_bt`` from ``repro/sched/problem.py``.

Per-instance arrays reduce over the last axis, so (U,) and (B, U) inputs
both work."""
from __future__ import annotations

import torch


def caps(h: torch.Tensor, k_weights: torch.Tensor,
         p_max: torch.Tensor) -> torch.Tensor:
    """Per-worker b_t ceiling h_i √(P_i^Max) / K_i (eq. 11)."""
    return h * torch.sqrt(p_max) / k_weights


def optimal_bt(h: torch.Tensor, k_weights: torch.Tensor, p_max: torch.Tensor,
               beta: torch.Tensor) -> torch.Tensor:
    """R_t strictly decreases in b_t ⇒ b_t* = min scheduled cap; 0 where
    nothing is scheduled."""
    sel = beta > 0
    c = caps(h, k_weights, p_max)
    b = torch.where(sel, c, torch.full_like(c, float("inf"))).amin(dim=-1)
    return torch.where(sel.any(dim=-1), b, torch.zeros_like(b))
