from repro_torch.fl.rounds import FederatedTrainer, RoundLog, SchedLog
from repro_torch.fl.server import receive_and_reconstruct, schedule_round
from repro_torch.fl.worker import local_gradient, stacked_local_gradients

__all__ = ["FederatedTrainer", "RoundLog", "SchedLog", "local_gradient",
           "receive_and_reconstruct", "schedule_round",
           "stacked_local_gradients"]
