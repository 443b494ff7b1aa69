"""The paper's convergence analysis (§III): the analysis constants and the
Theorem-1 error budget, and the bound-driven design tuner
(``theory/tune.py``)."""
from repro_torch.theory.bounds import (DELTA_MAX, AnalysisConstants,
                                       ErrorBudget, bt_term, error_budget,
                                       error_floor_asymptote,
                                       lemma1_error_bound,
                                       reconstruction_constant_traced,
                                       rt_objective, theorem1_rate,
                                       theorem1_trajectory)
from repro_torch.theory.tune import (calibrate_delta, delta_model,
                                     pareto_mask, tune_design)

__all__ = [
    "AnalysisConstants", "DELTA_MAX", "ErrorBudget", "bt_term",
    "error_budget", "error_floor_asymptote", "lemma1_error_bound",
    "reconstruction_constant_traced", "rt_objective", "theorem1_rate",
    "theorem1_trajectory", "calibrate_delta", "delta_model", "pareto_mask",
    "tune_design",
]
