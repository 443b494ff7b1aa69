"""The paper's aggregation pipeline (OBCSAA, simulation mode) in PyTorch.

The convergence analysis lives in ``repro_torch.theory``; its names are
re-exported here, as the reference does. ``core.obcsaa`` is not imported
here: it imports ``repro_torch.decode``, which imports ``core.sparsify``,
so importing it from this package would be a cycle. Import the modules
themselves (``repro_torch.core.obcsaa``, ...)."""
from repro_torch.theory.bounds import (AnalysisConstants, bt_term,
                                       lemma1_error_bound, rt_objective,
                                       theorem1_rate)

__all__ = ["AnalysisConstants", "bt_term", "lemma1_error_bound",
           "rt_objective", "theorem1_rate"]
