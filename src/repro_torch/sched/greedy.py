"""Vectorized greedy prefix scheduler: sort + cumsum + argmin, no loop.

Port of ``repro/sched/greedy.py``. R_t depends on a schedule β only
through the prefix length, the prefix weight mass ΣK_i and the prefix
min-cap when β is a prefix of the descending-cap order, so the sweep over
all prefixes is one batched expression over the sorted arrays:

    s2 = cumsum(K_sorted);  R_j = R(s1 = j+1, s2_j, caps_sorted_j);  argmin

exact for equal K_i (the optimum is a prefix of this ordering). With
``SchedConfig.use_kernel`` the (B, U) sweep runs through the prefix_eval
kernel (K7), otherwise through its plain version.

The sort is stable (``jnp.argsort`` is), so tied caps keep their index
order, and ``torch.argmin`` takes the first minimum, as ``jnp.argmin``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.prefix_eval import (N_COEF, prefix_eval,
                                             prefix_eval_plain)
from repro_torch.sched.config import SchedConfig
from repro_torch.sched.problem import BatchedProblem

_DEFAULT = SchedConfig()

#: The plain prefix sweep (full-row cumsum), the kernel's oracle.
prefix_sweep = prefix_eval_plain


def pack_coefs(prob: BatchedProblem) -> torch.Tensor:
    """(B, 8) f32 [Ktot, ρ1, A, E, N, 0, 0, 0]: ρ1, A and E are rounded
    from float64 to f32 once, as ``jnp.float32`` does in the reference."""
    ktot, rho1, A, E, N = prob.rt_coefs()
    coefs = torch.zeros((prob.B, N_COEF), dtype=torch.float32,
                        device=ktot.device)
    for col, v in enumerate((ktot, rho1, A, E, N)):
        coefs[:, col] = v       # a Python float is filled as f32(v)
    return coefs


def greedy_solve_batched(prob: BatchedProblem,
                         cfg: Optional[SchedConfig] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Schedule B instances with the prefix solver.

    Returns (β (B, U), b_t (B,), R_t (B,))."""
    cfg = cfg or _DEFAULT
    caps = prob.caps()                                   # (B, U)
    B, U = caps.shape
    order = torch.sort(-caps, dim=-1, stable=True).indices
    caps_s = torch.gather(caps, -1, order)
    k_s = torch.gather(prob.k_weights, -1, order)
    coefs = pack_coefs(prob)
    sweep = prefix_eval if cfg.use_kernel else prefix_sweep
    r = sweep(caps_s, k_s, coefs)
    j = torch.argmin(r, dim=-1, keepdim=True)            # (B, 1)
    b_t = torch.gather(caps_s, -1, j)[:, 0]
    r_best = torch.gather(r, -1, j)[:, 0]
    ranks = torch.arange(U, device=caps.device)
    beta_sorted = (ranks[None, :] <= j).to(caps.dtype)
    beta = torch.zeros_like(caps).scatter(-1, order, beta_sorted)
    return beta, b_t, r_best
