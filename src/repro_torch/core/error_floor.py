"""Re-export of the convergence analysis, which lives in
``repro_torch.theory``; port of ``repro/core/error_floor.py``."""
from repro_torch.theory.bounds import (AnalysisConstants, ErrorBudget,
                                       bt_term, error_budget,
                                       lemma1_error_bound, rt_objective,
                                       theorem1_rate, theorem1_trajectory)

__all__ = [
    "AnalysisConstants", "ErrorBudget", "bt_term", "error_budget",
    "lemma1_error_bound", "rt_objective", "theorem1_rate",
    "theorem1_trajectory",
]
