from repro_torch.optim.optimizers import Optimizer, sgd

__all__ = ["Optimizer", "sgd"]
