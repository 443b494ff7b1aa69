"""The paper's convergence analysis (§III): the analysis constants and the
Theorem-1 error budget. The design tuner (``theory/tune.py``) is not
ported yet."""
from repro_torch.theory.bounds import (DELTA_MAX, AnalysisConstants,
                                       ErrorBudget, bt_term, error_budget,
                                       error_floor_asymptote,
                                       lemma1_error_bound,
                                       reconstruction_constant_traced,
                                       rt_objective, theorem1_rate,
                                       theorem1_trajectory)

__all__ = [
    "AnalysisConstants", "DELTA_MAX", "ErrorBudget", "bt_term",
    "error_budget", "error_floor_asymptote", "lemma1_error_bound",
    "reconstruction_constant_traced", "rt_objective", "theorem1_rate",
    "theorem1_trajectory",
]
