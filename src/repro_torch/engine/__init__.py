"""The FL round engine of the port: ``FLConfig``, the round body, the
arms, and the chunked runner whose rounds replay from a CUDA graph on the
card (``engine/graph.py``). ``fl.FederatedTrainer`` is the thin wrapper;
sweeps call ``run_sweep``."""
from repro_torch.engine.config import ENGINE_SCHEDULERS, FLConfig
from repro_torch.engine.core import (EngineFns, budget_geometry,
                                     build_engine, perfect_aggregate,
                                     stacked_grads, topk_aa_aggregate)
from repro_torch.engine.graph import RoundGraph
from repro_torch.engine.runner import (Draws, EngineRun, chunk_spans,
                                       eval_points, run_sweep)
from repro_torch.engine.state import (Arms, EngineState, RoundStats,
                                      make_arms, n_arms, single_arm)

__all__ = [
    "Arms", "Draws", "ENGINE_SCHEDULERS", "EngineFns", "EngineRun",
    "EngineState", "FLConfig", "RoundGraph", "RoundStats",
    "budget_geometry", "build_engine", "chunk_spans", "eval_points",
    "make_arms", "n_arms", "perfect_aggregate", "run_sweep", "single_arm",
    "stacked_grads", "topk_aa_aggregate",
]
