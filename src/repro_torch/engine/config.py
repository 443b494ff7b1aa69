"""FL experiment configuration; port of ``repro/engine/config.py``:
aggregators ``obcsaa``, ``topk_aa`` and ``perfect`` under every scheduler
of ``sched/registry.py``, in ``scan`` or ``host`` mode, with or without
the ADMM dual warm start, error feedback, warm-start decoding
(``OBCSAAConfig.warm_start``) and sweep checkpoints."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.obcsaa import OBCSAAConfig
from repro_torch.sched.config import SchedConfig
from repro_torch.theory.bounds import AnalysisConstants

AGGREGATORS = ("obcsaa", "topk_aa", "perfect")
SCHEDULERS = ("all", "enum", "admm", "greedy", "admm_batched",
              "admm_batched_jit", "greedy_batched")
# Schedulers whose decision runs inside the round on the device, so the
# round can be captured ("admm_batched" runs the in-round form
# ``admm_solve_batched_jit`` there). The NumPy oracles (enum, admm,
# greedy) run on the host path of ``fl.FederatedTrainer``.
ENGINE_SCHEDULERS = ("all", "greedy_batched", "admm_batched",
                     "admm_batched_jit")
MODES = ("auto", "scan", "host")


@dataclass
class FLConfig:
    aggregator: str = "obcsaa"       # perfect | topk_aa | obcsaa
    scheduler: str = "all"
    learning_rate: float = 0.1       # paper §V
    rounds: int = 300
    eval_every: int = 10
    seed: int = 0                    # seeds the fade and AWGN generator
    obcsaa: OBCSAAConfig = field(default_factory=OBCSAAConfig)
    const: AnalysisConstants = field(default_factory=AnalysisConstants)
    # topk_aa baseline: the κ budget over the FULL vector
    topk_dense: int = 1000
    # per-worker error feedback (Stich et al., the paper's ref. [37]): each
    # worker adds the residual of its top-κ sparsification to the next
    # round's gradient before compression
    error_feedback: bool = False
    # Fading temporal correlation ρ of the Gauss-Markov recursion
    # (core/channel.py); 0 is the paper's i.i.d. block fading
    channel_rho: float = 0.0
    # "scan": the rounds of a chunk replayed from a CUDA graph on the card
    # (eagerly on the CPU); "host": the per-round eager loop; "auto": scan
    # when the scheduler runs inside the round
    mode: str = "auto"
    # Solver knobs of the batched P2 schedulers (None -> defaults)
    sched_cfg: Optional[SchedConfig] = None
    # run_sweep saves a SweepCheckpoint here at every chunk boundary; with
    # ckpt_resume it restores the latest step and continues bit for bit
    ckpt_dir: Optional[str] = None
    ckpt_resume: bool = False
    # carry the ADMM multipliers of round t's schedule to seed round t+1's
    # solve (admm_batched*); the primal re-initialises every round, so β is
    # bit for bit the cold solve's
    sched_warm_duals: bool = False
    # emit the measured ‖ĝ−ḡ‖² every round next to the predicted budget;
    # off, the round is exactly the probe-free one
    probe_agg_error: bool = False

    def __post_init__(self):
        if self.aggregator not in AGGREGATORS:
            raise ValueError(f"unknown aggregator {self.aggregator!r}; one "
                             f"of {AGGREGATORS}")
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {self.scheduler!r}; one of "
                             f"{SCHEDULERS}")
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r}; one of {MODES}")

    def engine_capable(self) -> bool:
        """Does every per-round decision run inside the round itself?"""
        return (self.aggregator == "perfect"
                or self.scheduler in ENGINE_SCHEDULERS)

    def resolved_mode(self) -> str:
        if self.mode == "auto":
            return "scan" if self.engine_capable() else "host"
        if self.mode == "scan" and not self.engine_capable():
            raise ValueError(
                f"mode='scan' but scheduler {self.scheduler!r} does not run "
                f"inside the round (engine schedulers: {ENGINE_SCHEDULERS});"
                " use mode='host'")
        return self.mode
