"""The paper's analysis constants (§III). Only ``AnalysisConstants`` is
ported; the Theorem-1 error budget and the tuner are not yet."""
from repro_torch.theory.bounds import DELTA_MAX, AnalysisConstants

__all__ = ["AnalysisConstants", "DELTA_MAX"]
