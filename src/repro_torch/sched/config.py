"""Solver knobs shared by the batched P2 schedulers; port of
``repro/sched/config.py``.

The ADMM knobs are kept so that a config means the same in both packages;
they are inert until ADMM is ported. ``use_kernel`` routes the greedy
prefix sweep through the CUDA kernel (``kernels/prefix_eval.py``). The
reference's ``interpret`` and ``kernel_tiles`` have no counterpart: the
port dispatches on the tensor's device, and its kernel picks its own
tiling."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SchedConfig:
    """ADMM (Algorithm 2) + flip-polish + prefix-sweep configuration."""
    c_step: float = 1.0          # ADMM penalty c
    max_iters: int = 200         # outer ADMM iterations (upper bound)
    inner_iters: int = 16        # step-1 projected-gradient iterations
    abs_tol: float = 1e-4        # primal residual Σ|q−b| tolerance
    rel_tol: float = 1e-5        # b_t drift tolerance
    polish_sweeps: int = 3       # flip-polish sweep cap
    # greedy prefix sweep: the (B, U) evaluation through the prefix_eval
    # kernel instead of the plain cumsum path
    use_kernel: bool = False
