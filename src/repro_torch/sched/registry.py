"""P2 scheduler registry; port of ``repro/sched/registry.py`` for batched
problems.

``schedule(problem, method, cfg)`` looks ``method`` up and solves the
``BatchedProblem``, returning tensors ``(β (B, U), b_t (B,), R_t (B,))``.
Registered here:

  all              schedule everyone; b_t on the power boundary
  greedy_batched   the vectorized prefix sweep (``sched/greedy.py``)

The reference's other entries (``enum``, ``admm``, ``greedy``,
``admm_batched``, ``admm_batched_jit``) and its NumPy ``Problem`` inputs
wait for ``sched/reference.py`` and ADMM: asking for them raises
``NotImplementedError``; a name neither package knows raises
``ValueError``, as in the reference.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.sched.config import SchedConfig
from repro_torch.sched.greedy import greedy_solve_batched
from repro_torch.sched.problem import BatchedProblem

#: Registered in the reference, not ported yet.
NOT_PORTED = ("enum", "admm", "greedy", "admm_batched", "admm_batched_jit")


_REGISTRY: Dict[str, Callable] = {}


def register_scheduler(name: str):
    """Register ``fn(problem, cfg) -> (beta, b_t, r)`` under ``name``;
    ``problem`` is a ``BatchedProblem``."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_scheduler(name: str) -> Callable:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"scheduler {name!r} is not ported yet; ported: "
            f"{', '.join(list_schedulers())}")
    raise ValueError(f"unknown scheduling method {name!r}; registered: "
                     f"{', '.join(list_schedulers())}")


def list_schedulers():
    return sorted(_REGISTRY)


def schedule(problem: BatchedProblem, method: str = "greedy_batched",
             cfg: Optional[SchedConfig] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve P2 with the scheduler registered under ``method``."""
    solve = get_scheduler(method)
    if not isinstance(problem, BatchedProblem):
        raise NotImplementedError(
            "schedule takes a BatchedProblem; the NumPy reference Problem "
            "is not ported yet")
    return solve(problem, cfg)


# --- built-ins -----------------------------------------------------------

@register_scheduler("all")
def _all(prob: BatchedProblem, cfg):
    beta = torch.ones_like(prob.h)
    b_t = prob.optimal_bt(beta)
    return beta, b_t, prob.rt(beta, b_t)


@register_scheduler("greedy_batched")
def _greedy_batched(prob: BatchedProblem, cfg):
    return greedy_solve_batched(prob, cfg)
