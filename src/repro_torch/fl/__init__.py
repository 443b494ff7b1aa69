from repro_torch.engine.config import FLConfig
from repro_torch.fl.rounds import FederatedTrainer, RoundLog, SchedLog
from repro_torch.fl.server import receive_and_reconstruct, schedule_round
from repro_torch.fl.worker import (local_gradient, stacked_local_gradients,
                                   transmit)

__all__ = ["FederatedTrainer", "FLConfig", "RoundLog", "SchedLog",
           "receive_and_reconstruct", "schedule_round", "local_gradient",
           "stacked_local_gradients", "transmit"]
