"""Analysis constants of the convergence bound (paper §III); port of
``AnalysisConstants`` from ``repro/theory/bounds.py``. The schedulers'
R_t objective (eq. 24) reads them. ``error_budget``/``ErrorBudget`` are
not ported yet."""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.measurement import reconstruction_constant

# Candès RIP condition: eq. (46)'s C(δ) is finite for δ < √2 − 1.
DELTA_MAX = math.sqrt(2.0) - 1.0


@dataclass(frozen=True)
class AnalysisConstants:
    """Paper's analysis constants (Assumptions 1-4 + RIP)."""
    L: float = 10.0          # Lipschitz smoothness
    rho1: float = 1.0        # sample-gradient bound, eq. (17)
    rho2: float = 0.5        # sample-gradient slope, 0 <= rho2 < 1
    G: float = 10.0          # local gradient bound, eq. (18)
    delta: float = 0.2       # RIP constant (< sqrt(2)-1)

    @property
    def C(self) -> float:
        """Reconstruction constant C(δ) of eq. (46)."""
        return reconstruction_constant(self.delta)
