"""FL round orchestration; port of ``repro/fl/rounds.py``.

Each round t: the PS draws this round's block-fading channels, schedules
(β = 1 and the closed-form b_t under ``all``), the workers compute their
full-batch gradients (eq. 3), compress (eq. 6-7) and transmit; the MAC
superposes, the PS adds AWGN, post-processes (eq. 13), decodes (eq. 43)
and everyone applies the update (eq. 14). Metrics are evaluated after
round t when ``t % eval_every == 0`` and after the last round, the
reference trainer's cadence.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.sparsify import flatten_pytree
from repro_torch.device import resolve_device
from repro_torch.engine.config import FLConfig
from repro_torch.engine.core import build_engine
from repro_torch.optim.optimizers import Optimizer, sgd


@dataclass
class RoundLog:
    """Eval-cadence metrics (loss/accuracy stream)."""
    round: int
    loss: float
    accuracy: float
    n_scheduled: int
    b_t: float


@dataclass
class SchedLog:
    """Per-round scheduling stats (the Theorem-1 ``rt_bound`` waits for
    the ``theory`` port)."""
    round: int
    n_scheduled: int
    b_t: float


def _to(tree, device):
    return {k: v.to(device) for k, v in tree.items()}


class FederatedTrainer:
    """Drives FL rounds for any (loss_fn, params) pair + stacked worker
    data (dict leaves (U, ...)) on one device.

    ``device=None`` means CUDA and raises without a card; pass
    ``device="cpu"`` to run the plain versions of the kernels. ``phi``
    injects the (S_c, D_c) measurement matrix, else it is drawn from
    ``cfg.obcsaa.phi_seed``."""

    def __init__(self, cfg: FLConfig, loss_fn: Callable, params,
                 worker_data, k_weights, eval_fn: Optional[Callable] = None,
                 optimizer: Optional[Optimizer] = None, *,
                 phi: Optional[torch.Tensor] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.worker_data = _to(worker_data, self.device)
        self.k_weights = torch.as_tensor(k_weights, dtype=torch.float32,
                                         device=self.device)
        self.opt = optimizer or sgd()
        params = _to(params, self.device)
        flat, unflatten = flatten_pytree(params)
        self.D = int(flat.shape[0])
        U = int(self.k_weights.shape[0])
        ob = cfg.obcsaa
        self.phi = (ob.phi(self.device) if phi is None
                    else phi.to(self.device, torch.float32).contiguous())
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self.fns = build_engine(cfg, loss_fn, self.opt, self.D, U,
                                unflatten, phi=self.phi,
                                generator=self.generator)
        self.state = self.fns.init_state(params)
        self.logs: List[RoundLog] = []
        self.sched_logs: List[SchedLog] = []

    @property
    def params(self):
        return self.state.params

    def run_round(self, t: int, *, fade_w: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> Dict:
        """One round. ``fade_w`` (U,) complex and ``noise`` (n_chunks, S_c)
        replace this round's draws."""
        self.state, stats, info = self.fns.full_round(
            self.state, self.worker_data, self.k_weights, fade_w=fade_w,
            noise=noise)
        self.sched_logs.append(SchedLog(t, int(stats.n_scheduled),
                                        float(stats.b_t)))
        return info

    def run(self, rounds: Optional[int] = None, verbose: bool = False
            ) -> List[RoundLog]:
        rounds = rounds or self.cfg.rounds
        for t in range(rounds):
            info = self.run_round(t)
            if self.eval_fn and (t % self.cfg.eval_every == 0
                                 or t == rounds - 1):
                loss, acc = self.eval_fn(self.params)
                n_sched = int(info["beta"].sum())
                self.logs.append(RoundLog(t, float(loss), float(acc),
                                          n_sched, float(info["b_t"])))
                if verbose:
                    print(f"round {t:4d} loss={float(loss):.4f} "
                          f"acc={float(acc):.4f} "
                          f"sched={n_sched}/{len(info['h'])}")
        return self.logs
