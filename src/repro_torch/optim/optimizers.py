"""Optimizers on trees of tensors (a dict of parameters, or one tensor);
port of ``repro/optim/optimizers.py``.

The paper uses plain GD (``sgd``, eq. 14); ``momentum`` and ``adam`` are
substrate options. Moments are f32 whatever the parameter dtype, as in
the reference. Adam's step counter ``t`` is a 0-d int32 tensor on the
parameters' device, so a captured CUDA graph increments it on the card.

``ef_step`` is the error-feedback correction (Stich et al., the paper's
ref. [37]): the one implementation behind ``with_error_feedback`` and the
engine's fused EF split (``engine/core.py``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import leaves, tree_map

_F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable        # params -> state
    update: Callable      # (grads, state, params, lr) -> (new_params, state)


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        new = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
        return new, state

    return Optimizer(init, update)


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=_F32), params)


def momentum(beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return _zeros_f32(params)

    def update(grads, state, params, lr):
        new_m = tree_map(lambda m, g: beta * m + g.to(_F32), state, grads)
        step = (tree_map(lambda m, g: beta * m + g.to(_F32), new_m, grads)
                if nesterov else new_m)
        new = tree_map(lambda p, s: p - lr * s.to(p.dtype), params, step)
        return new, new_m

    return Optimizer(init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        z = _zeros_f32(params)
        dev = leaves(params)[0].device
        return {"m": z, "v": tree_map(torch.clone, z),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(_F32),
                     state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
            g.to(_F32)), state["v"], grads)
        tf = t.to(_F32)
        bc1 = 1 - torch.pow(b1, tf)
        bc2 = 1 - torch.pow(b2, tf)
        new = tree_map(
            lambda p, m_, v_: p - (lr * (m_ / bc1)
                                   / (torch.sqrt(v_ / bc2) + eps)).to(
                                       p.dtype), params, m, v)
        return new, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adam": adam}


def make(name: str, **kw) -> Optimizer:
    """Build a registered optimizer by name."""
    if name not in OPTIMIZERS:
        raise ValueError(
            f"optimizer {name!r} is not registered; choose one of "
            f"{' | '.join(sorted(OPTIMIZERS))}")
    return OPTIMIZERS[name](**kw)


def ef_step(grads, residual, approx_fn: Callable) -> Tuple:
    """One error-feedback step: corrected = g + e; (out, approx) =
    approx_fn(corrected); e' = corrected − approx.

    ``approx_fn`` maps the corrected gradient to ``(out, approx)``: ``out``
    is what the caller transmits, ``approx`` the lossy approximation
    actually applied, in the corrected gradient's space, so the residual
    accumulates exactly what the uplink dropped. Returns
    ``(out, new_residual, corrected)``."""
    corrected = grads + residual
    out, approx = approx_fn(corrected)
    return out, corrected - approx, corrected


def with_error_feedback(compress_fn: Callable) -> Callable:
    """EF wrapper for the aggregation path: keeps a per-worker residual e,
    transmits compress(g + e), e' = (g + e) − decompressed.

    compress_fn: flat -> (wire_repr, decompressed_flat). Returns a function
    (flat_grad, residual) -> (wire_repr, new_residual)."""
    def apply(flat_grad, residual):
        wire, new_residual, _ = ef_step(flat_grad, residual, compress_fn)
        return wire, new_residual

    return apply
