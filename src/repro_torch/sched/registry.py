"""P2 scheduler registry; port of ``repro/sched/registry.py``.

``schedule(problem, method, cfg)`` dispatches on a registry name and on
the problem's batching:

- a NumPy reference ``Problem`` returns NumPy ``(β (U,), b_t, R_t)``;
- a ``BatchedProblem`` returns ``(β (B, U), b_t (B,), R_t (B,))``: tensors
  on its device from the batched entries, NumPy stacks from the others.

Built-ins:

  all              schedule everyone; b_t on the power boundary
  enum             Algorithm 1, exact O(2^U) (NumPy oracle, small U)
  admm             Algorithm 2 + flip-polish (NumPy oracle)
  greedy           prefix search, loop form (NumPy oracle)
  admm_batched     Algorithm 2 over a batch, compacted between chunks (the
                   fleet path, ``sched/admm.py``)
  admm_batched_jit Algorithm 2 over a batch without compaction, what the
                   FL engine runs inside its round
  greedy_batched   the vectorized prefix sweep (``sched/greedy.py``)

A single ``Problem`` lifts to B = 1 for the batched entries (on
``device``, ``None`` meaning CUDA); a ``BatchedProblem`` goes instance by
instance through the NumPy entries.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.sched import reference as ref
from repro_torch.sched.admm import admm_solve_batched, admm_solve_batched_jit
from repro_torch.sched.config import SchedConfig
from repro_torch.sched.greedy import greedy_solve_batched
from repro_torch.sched.problem import BatchedProblem
from repro_torch.sched.reference import Problem


@dataclass(frozen=True)
class Scheduler:
    """Registry entry: the solver and whether it takes batched problems."""
    fn: Callable
    batched: bool = False


_REGISTRY: Dict[str, Scheduler] = {}


def register_scheduler(name: str, *, batched: bool = False):
    """Register ``fn(problem, cfg) -> (beta, b_t, r)`` under ``name``;
    ``batched=True`` entries take a ``BatchedProblem``, the others the
    NumPy reference ``Problem``."""
    def deco(fn):
        _REGISTRY[name] = Scheduler(fn=fn, batched=batched)
        return fn
    return deco


def get_scheduler(name: str) -> Scheduler:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown scheduling method {name!r}; registered: "
                         f"{', '.join(list_schedulers())}") from None


def list_schedulers():
    return sorted(_REGISTRY)


def _unbatch(beta, b_t, r):
    return (beta[0].detach().cpu().numpy().astype(np.float64),
            float(b_t[0]), float(r[0]))


def schedule(problem: Union[Problem, BatchedProblem], method: str = "greedy",
             cfg: Optional[SchedConfig] = None, *, device=None
             ) -> Tuple:
    """Solve P2 with the scheduler registered under ``method`` (see the
    module docstring for what comes out). ``device`` places a single ``Problem`` lifted to a batched
    entry."""
    sched = get_scheduler(method)
    single = isinstance(problem, Problem)
    if sched.batched:
        bp = BatchedProblem.single(problem, device=device) if single \
            else problem
        out = sched.fn(bp, cfg)
        return _unbatch(*out) if single else out
    if single:
        return sched.fn(problem, cfg)
    # a batched problem through a per-instance NumPy solver
    outs = [sched.fn(problem.instance(b), cfg) for b in range(problem.B)]
    return (np.stack([o[0] for o in outs]),
            np.asarray([o[1] for o in outs]),
            np.asarray([o[2] for o in outs]))


# --- built-ins -----------------------------------------------------------

@register_scheduler("all")
def _all(prob: Problem, cfg):
    beta = np.ones(prob.U)
    b_t = ref.optimal_bt(prob, beta)
    return beta, b_t, ref._rt(prob, beta, b_t)


@register_scheduler("enum")
def _enum(prob: Problem, cfg):
    return ref.enumerate_solve(prob)


@register_scheduler("admm")
def _admm(prob: Problem, cfg):
    kw = {}
    if cfg is not None:
        kw = dict(c_step=cfg.c_step, max_iters=cfg.max_iters,
                  abs_tol=cfg.abs_tol, rel_tol=cfg.rel_tol)
    return ref.admm_solve(prob, **kw)


@register_scheduler("greedy")
def _greedy(prob: Problem, cfg):
    return ref.greedy_solve(prob)


@register_scheduler("admm_batched", batched=True)
def _admm_batched(prob: BatchedProblem, cfg):
    return admm_solve_batched(prob, cfg)


@register_scheduler("admm_batched_jit", batched=True)
def _admm_batched_jit(prob: BatchedProblem, cfg):
    return admm_solve_batched_jit(prob, cfg)


@register_scheduler("greedy_batched", batched=True)
def _greedy_batched(prob: BatchedProblem, cfg):
    return greedy_solve_batched(prob, cfg)

