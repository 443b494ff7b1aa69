"""FL round orchestration, a thin host wrapper over ``repro_torch.engine``;
port of ``repro/fl/rounds.py``.

Each round t: the PS draws this round's block-fading channels, schedules
(β and b_t), the workers compute their full-batch gradients (eq. 3),
compress (eq. 6-7) and transmit; the MAC superposes, the PS adds AWGN,
post-processes (eq. 13), decodes (eq. 43) and everyone applies the update
(eq. 14).

Two modes over one round body (``engine/core.py``):

- ``scan``: the rounds run in chunks cut at the eval cadence
  (``EngineRun.run_chunk``); on the card each round is a replay of the
  arm's CUDA graph, and the stats come back at the chunk's end.
- ``host``: the per-round eager loop, with the stats read every round.
  The schedulers that do not run inside the round (the NumPy oracles
  ``enum``, ``admm`` and ``greedy``) run here only: the round's h comes to
  the host, ``fl.server.schedule_round`` solves P2 in float64, and β and
  b_t go back to the card as f32.

Both modes carry the same state through the round: the optimizer's
(``opt_state``), the EF residuals (``FLConfig.error_feedback``) and the
decoder's warm start (``OBCSAAConfig.warm_start``).

Metrics are evaluated after round t when ``t % eval_every == 0`` and after
the last round, the reference trainer's cadence.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.engine.config import FLConfig
from repro_torch.engine.runner import EngineRun, chunk_spans
from repro_torch.fl.server import schedule_round
from repro_torch.optim.optimizers import Optimizer


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
    """Per-round scheduling and theory stats. ``rt_bound`` is the
    predicted Theorem-1 R_t at the round's operating point (NaN unless the
    aggregator is ``obcsaa``); ``agg_err`` the measured ‖ĝ−ḡ‖² (NaN
    unless ``FLConfig.probe_agg_error``)."""
    round: int
    n_scheduled: int
    b_t: float
    rt_bound: float = float("nan")
    agg_err: float = float("nan")


class FederatedTrainer:
    """Drives FL rounds for any (loss_fn, params) pair + stacked worker
    data (dict leaves (U, ...)) on one device, through ``EngineRun``.

    ``device=None`` means CUDA and raises without a card; pass
    ``device="cpu"`` to run the plain versions of the kernels. ``phi``
    injects the (S_c, D_c) measurement matrix, else it is drawn from
    ``cfg.obcsaa.phi_seed``. In scan mode on the card, ``state`` holds the
    CUDA graph's static buffers, which the next chunk overwrites."""

    def __init__(self, cfg: FLConfig, loss_fn: Callable, params,
                 worker_data, k_weights, eval_fn: Optional[Callable] = None,
                 optimizer: Optional[Optimizer] = None, *,
                 phi: Optional[torch.Tensor] = None, device=None):
        self.cfg = cfg
        self.engine = EngineRun(cfg, loss_fn, params, worker_data,
                                k_weights, optimizer=optimizer, phi=phi,
                                device=device)
        e = self.engine
        self.device, self.loss_fn, self.eval_fn = e.device, loss_fn, eval_fn
        self.worker_data, self.k_weights = e.worker_data, e.k_weights
        self._k_host = np.asarray(k_weights, np.float64)
        # P2 on the host, between the fade draw and the round body
        self._host_sched = not cfg.engine_capable()
        self.opt, self.D, self.phi, self.fns = e.opt, e.D, e.phi, e.fns
        self.state, self.arm = e.init()
        self.generator = self.state.generator
        self.logs: List[RoundLog] = []
        self.sched_logs: List[SchedLog] = []

    @property
    def params(self):
        return self.state.params

    @property
    def opt_state(self):
        return self.state.opt_state

    @property
    def sched_trajectory(self) -> Dict[str, np.ndarray]:
        """Dense (rounds,) scheduling and theory trajectories."""
        return {name: np.asarray([getattr(s, name) for s in self.sched_logs])
                for name in ("round", "n_scheduled", "b_t", "rt_bound",
                             "agg_err")}

    def run_round(self, t: int, *, fade_w: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> Dict:
        """One eager round (the host path). ``fade_w`` (U,) complex and
        ``noise`` (n_chunks, S_c) replace this round's draws."""
        if self._host_sched:
            stats, info = self._host_scheduled_round(fade_w, noise)
        else:
            self.state, stats, info = self.fns.full_round(
                self.state, self.arm, self.worker_data, self.k_weights,
                fade_w=fade_w, noise=noise)
        self.sched_logs.append(SchedLog(
            t, int(stats.n_scheduled), float(stats.b_t),
            float(stats.budget.rt()) if stats.budget is not None
            else float("nan"),
            float(stats.agg_err) if stats.agg_err is not None
            else float("nan")))
        return info

    def _host_scheduled_round(self, fade_w, noise):
        """Fade draw, P2 by a NumPy oracle on the host, the round body."""
        cfg, st = self.cfg, self.state
        h, fade = self.fns.fade_step(st.fade, st.generator, fade_w)
        beta_np, bt = schedule_round(
            cfg.scheduler, h.cpu().numpy().astype(np.float64), self._k_host,
            cfg.obcsaa, cfg.const, self.D, cfg.sched_cfg, device=self.device)
        beta = torch.as_tensor(beta_np, dtype=torch.float32,
                               device=self.device)
        b_t = torch.tensor(bt, dtype=torch.float32, device=self.device)
        self.state, stats = self.fns.round_given_schedule(
            st, self.arm, self.worker_data, self.k_weights, h, fade, beta,
            b_t, noise)
        return stats, {"h": h, "beta": beta, "b_t": b_t}

    def _run_scan(self, rounds: int, verbose: bool) -> None:
        ee = self.cfg.eval_every if self.eval_fn else None
        for t0, n in chunk_spans(rounds, ee):
            self.state, stats = self.engine.run_chunk(self.state, self.arm,
                                                      t0, n)
            ns = stats.n_scheduled.cpu().numpy()
            bt = stats.b_t.cpu().numpy()
            nan = np.full(n, np.nan)
            rt = (stats.budget.rt().cpu().numpy()
                  if stats.budget is not None else nan)
            err = (stats.agg_err.cpu().numpy()
                   if stats.agg_err is not None else nan)
            self.sched_logs.extend(
                SchedLog(t0 + i, int(ns[i]), float(bt[i]), float(rt[i]),
                         float(err[i])) for i in range(n))
            if self.eval_fn:
                self._eval(t0 + n - 1, int(ns[-1]), float(bt[-1]), verbose)

    def _eval(self, t: int, n_sched: int, b_t: float, verbose: bool):
        loss, acc = self.eval_fn(self.params)
        self.logs.append(RoundLog(t, float(loss), float(acc), n_sched, b_t))
        if verbose:
            print(f"round {t:4d} loss={float(loss):.4f} "
                  f"acc={float(acc):.4f} "
                  f"sched={n_sched}/{len(self.k_weights)}")

    def run(self, rounds: Optional[int] = None, verbose: bool = False
            ) -> List[RoundLog]:
        rounds = rounds or self.cfg.rounds
        if self.engine.mode == "scan":
            self._run_scan(rounds, verbose)
            return self.logs
        for t in range(rounds):
            info = self.run_round(t)
            if self.eval_fn and (t % self.cfg.eval_every == 0
                                 or t == rounds - 1):
                self._eval(t, int(info["beta"].sum()), float(info["b_t"]),
                           verbose)
        return self.logs
