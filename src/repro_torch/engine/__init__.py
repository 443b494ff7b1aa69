"""The FL round engine of the port: ``FLConfig`` + the round body."""
from repro_torch.engine.config import FLConfig
from repro_torch.engine.core import (EngineFns, build_engine,
                                     perfect_aggregate, stacked_grads)
from repro_torch.engine.state import EngineState, RoundStats

__all__ = ["EngineFns", "EngineState", "FLConfig", "RoundStats",
           "build_engine", "perfect_aggregate", "stacked_grads"]
