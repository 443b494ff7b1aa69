"""FL experiment configuration; port of ``repro/engine/config.py`` for the
slice the port runs: aggregators ``obcsaa`` and ``perfect`` under the
``all`` and ``greedy_batched`` schedulers. The other schedulers, error
feedback, warm start, the theory budget, sweeps and checkpoints are not
ported yet; asking for them raises ``NotImplementedError`` instead of
running something else."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.obcsaa import OBCSAAConfig
from repro_torch.sched.config import SchedConfig
from repro_torch.theory.bounds import AnalysisConstants

AGGREGATORS = ("obcsaa", "perfect")
SCHEDULERS = ("all", "greedy_batched")


@dataclass
class FLConfig:
    aggregator: str = "obcsaa"       # perfect | obcsaa
    scheduler: str = "all"
    learning_rate: float = 0.1       # paper §V
    rounds: int = 300
    eval_every: int = 10
    seed: int = 0                    # seeds the fade and AWGN generator
    obcsaa: OBCSAAConfig = field(default_factory=OBCSAAConfig)
    const: AnalysisConstants = field(default_factory=AnalysisConstants)
    # Fading temporal correlation ρ of the Gauss-Markov recursion
    # (core/channel.py); 0 is the paper's i.i.d. block fading
    channel_rho: float = 0.0
    # Solver knobs of the batched P2 schedulers (None -> defaults)
    sched_cfg: Optional[SchedConfig] = None

    def __post_init__(self):
        if self.aggregator not in AGGREGATORS:
            raise NotImplementedError(
                f"aggregator {self.aggregator!r} is not ported yet; one of "
                f"{AGGREGATORS}")
        if self.scheduler not in SCHEDULERS:
            raise NotImplementedError(
                f"scheduler {self.scheduler!r} is not ported yet; one of "
                f"{SCHEDULERS}")
        if self.obcsaa.warm_start:
            raise NotImplementedError("warm-start decoding across rounds "
                                      "is not ported yet")
