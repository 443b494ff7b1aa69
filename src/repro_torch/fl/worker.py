"""FL worker: local full-batch gradients (eq. 3); port of the gradient half
of ``repro/fl/worker.py``."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.engine.core import stacked_grads


def local_gradient(loss_fn: Callable, params, data) -> Dict[str, torch.Tensor]:
    """Full-batch GD gradient on one worker's local dataset (eq. 3)."""
    keys = sorted(params)
    leaves = [params[k].detach().requires_grad_() for k in keys]
    grads = torch.autograd.grad(loss_fn(dict(zip(keys, leaves)), data),
                                leaves)
    return dict(zip(keys, grads))


def stacked_local_gradients(loss_fn: Callable, params,
                            stacked_data) -> torch.Tensor:
    """Every worker's gradient in one batched pass: leaves (U, ...) ->
    flat (U, D); ``loss_fn`` returns one loss per worker
    (see ``engine.core.stacked_grads``)."""
    return stacked_grads(loss_fn, params, stacked_data)
