from repro_torch.optim.optimizers import (OPTIMIZERS, Optimizer, adam,
                                          ef_step, make, momentum, sgd,
                                          with_error_feedback)
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine

__all__ = ["OPTIMIZERS", "Optimizer", "adam", "ef_step", "make", "momentum",
           "sgd", "with_error_feedback", "constant", "cosine_decay",
           "warmup_cosine"]
