"""FL worker: local full-batch gradients (eq. 3) and the OBCSAA transmit
side (eq. 6-7, 10); port of ``repro/fl/worker.py``."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core.obcsaa import OBCSAAConfig, compress_chunks
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


def transmit(cfg: OBCSAAConfig, flat_grad: torch.Tensor, *, k_weight,
             beta_i, b_t, phi: Optional[torch.Tensor] = None):
    """Worker-side pipeline: sparse_κ -> Φ -> sign -> power scale (eq. 10).
    ``phi`` defaults to the config's on the gradient's device.

    Channel inversion makes the effective transmitted weight K_i β_i b_t
    (the h_i cancels at the receiver, eq. 12)."""
    phi = cfg.phi(flat_grad.device) if phi is None else phi
    pad = (-flat_grad.shape[0]) % cfg.chunk
    gpad = torch.nn.functional.pad(flat_grad, (0, pad))
    signs, mags = compress_chunks(cfg, gpad, phi)
    w = torch.as_tensor(k_weight * beta_i * b_t).to(signs.dtype)
    return signs * w, mags
