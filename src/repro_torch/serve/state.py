"""Serve-loop configuration and state; port of ``repro/serve/state.py``.

``ServeConfig`` is the static side of the service: fleet geometry and
fade model (a ``ScenarioConfig``), the solver, the P2 constants, and the
caching policy (staleness threshold, CSI report fraction, warm-start
switch). ``ServeState`` is what evolves tick to tick: the fade process
(its ``torch.Generator`` draws the innovations and the report masks), the
newest channel estimates beside the channels each cached schedule was
solved for (their gap is the staleness metric), the served schedules, and
the ADMM exit multipliers that warm-start each cell's next solve.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.sched.compaction import MIN_BUCKET
from repro_torch.sched.config import SchedConfig
from repro_torch.sched.scenario import FadeState, ScenarioConfig
from repro_torch.theory.bounds import AnalysisConstants

# Solvers the serve loop dispatches a dirty bucket to (both fleet-batched
# registry names)
SERVE_SCHEDULERS = ("admm_batched", "greedy_batched")


@dataclass(frozen=True)
class ServeConfig:
    """Static service parameters: one frozen config per deployment."""
    scenario: ScenarioConfig = field(default_factory=ScenarioConfig)
    scheduler: str = "admm_batched"     # SERVE_SCHEDULERS
    # The solvers' constants; the service ignores its ``use_kernel`` and
    # always sweeps greedy prefixes through prefix_eval (``solver``)
    sched_cfg: Optional[SchedConfig] = None
    # A cell re-solves only when its worst-worker relative channel
    # movement since its last solve exceeds this. 0 = any change re-solves
    # (the cache-parity setting); cells without a report moved exactly 0
    # and stay cached.
    stale_threshold: float = 0.05
    # Seed each ADMM solve with the cell's previous exit multipliers
    # (admm_batched only; β is bit for bit the cold solve's)
    warm_duals: bool = True
    # Fraction of cells whose CSI report arrives each tick (1.0 = all)
    update_frac: float = 1.0
    min_bucket: int = MIN_BUCKET
    # P2 constants shared by every cell (the paper's §V operating point)
    k_weights: float = 3000.0
    p_max: float = 10.0
    noise_var: float = 1e-4
    D: int = 50890
    S: int = 1000
    kappa: int = 1000
    const: AnalysisConstants = field(
        default_factory=lambda: AnalysisConstants(rho1=200.0, G=1.0))

    def __post_init__(self):
        if self.scheduler not in SERVE_SCHEDULERS:
            raise ValueError(f"serve scheduler {self.scheduler!r} not in "
                             f"{SERVE_SCHEDULERS}")
        if not 0.0 <= self.update_frac <= 1.0:
            raise ValueError(f"update_frac must be in [0, 1], got "
                             f"{self.update_frac}")
        if self.stale_threshold < 0:
            raise ValueError(f"stale_threshold must be >= 0, got "
                             f"{self.stale_threshold}")

    @property
    def solver(self) -> SchedConfig:
        """The config every solve of the service takes: ``sched_cfg``
        with the greedy sweep through the prefix_eval kernel (K7), which
        takes its plain version only on CPU tensors."""
        return replace(self.sched_cfg or SchedConfig(), use_kernel=True)

    @property
    def warm(self) -> bool:
        """Dual warm-starting actually active (admm only)."""
        return self.warm_duals and self.scheduler == "admm_batched"


class ServeState(NamedTuple):
    """What the service carries tick to tick: (cells, U) tensors except
    where noted; ``duals`` an ``AdmmDuals`` of (cells, U) tensors, or None
    when warm-starting is off."""
    fades: FadeState                   # the incremental fade process
    gain: torch.Tensor                 # static large-scale gain
    h_seen: torch.Tensor               # newest reported |h| per cell
    h_solved: torch.Tensor             # |h| each cached schedule used
    beta: torch.Tensor                 # served schedules
    b_t: torch.Tensor                  # (cells,) served power scalings
    rt: torch.Tensor                   # (cells,) served R_t
    duals: Any                         # AdmmDuals | None
    tick: int                          # host-side tick counter


class TickStats(NamedTuple):
    """Host-side accounting for one tick (latency is timed by the caller
    around ``tick``)."""
    tick: int
    n_reported: int                    # cells whose CSI arrived
    n_dirty: int                       # cells past the staleness threshold
    n_solved: int                      # bucket size dispatched (pads incl.)
    hit_rate: float                    # 1 - dirty/cells
    mean_iters: float                  # ADMM outer iters (nan for greedy)
