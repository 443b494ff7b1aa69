"""FL parameter server: scheduling (P2), post-processing, reconstruction
(paper eq. 13-14, §IV); port of ``repro/fl/server.py``."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.obcsaa import OBCSAAConfig, reconstruct_chunks
from repro_torch.sched import Problem, SchedConfig, schedule
from repro_torch.theory.bounds import AnalysisConstants


def schedule_round(method: str, h: np.ndarray, k_weights: np.ndarray,
                   cfg: OBCSAAConfig, const: AnalysisConstants, D: int,
                   sched_cfg: Optional[SchedConfig] = None, *, device=None
                   ) -> Tuple[np.ndarray, float]:
    """Solve P2 for this round's channels through the ``sched`` registry
    (any registered name; a batched entry runs at B = 1 on ``device``,
    ``None`` meaning CUDA). Returns (β float64 (U,), b_t)."""
    prob = Problem(h=h, k_weights=k_weights, p_max=cfg.p_max,
                   noise_var=cfg.noise_var, D=D, S=cfg.measure,
                   kappa=cfg.topk, const=const)
    beta, bt, _ = schedule(prob, method, sched_cfg, device=device)
    return beta, bt


def _floor(x):
    return torch.clamp(x, min=1e-12) if isinstance(x, torch.Tensor) \
        else max(x, 1e-12)


def receive_and_reconstruct(cfg: OBCSAAConfig, y_sum: torch.Tensor,
                            mags_sum: torch.Tensor, *, ksum_beta, b_t, noise,
                            D: int, phi: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """PS receive side: add the AWGN, post-process (eq. 13), decode
    (eq. 43). ``phi`` is the (S_c, D_c) measurement matrix, by default
    the config's on ``y_sum``'s device."""
    phi = cfg.phi(y_sum.device) if phi is None else phi
    y = (y_sum + noise) / _floor(ksum_beta * b_t)
    mbar = mags_sum / _floor(ksum_beta)
    ghat = reconstruct_chunks(cfg, y, mbar if cfg.magnitude_tracking
                              else None, phi)
    return ghat[:D]
