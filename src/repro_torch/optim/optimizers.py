"""Optimizers on dicts of tensors; port of ``sgd`` from
``repro/optim/optimizers.py`` (the paper uses plain GD, eq. 14).
Momentum, Adam and the error-feedback step are not ported yet."""
from __future__ import annotations

from typing import Callable, NamedTuple


class Optimizer(NamedTuple):
    init: Callable        # params -> state
    update: Callable      # (grads, state, params, lr) -> (new_params, state)


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        new = {k: p - lr * grads[k].to(p.dtype) for k, p in params.items()}
        return new, state

    return Optimizer(init, update)
