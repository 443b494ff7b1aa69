"""1-bit CS decoders (eq. 43), plain PyTorch; port of ``repro/decode/iht.py``.

- ``iht``: x ← η_κ(x + τ Φᵀ(ŷ − Φx)) on the real post-processed aggregate.
- ``biht_sign``: x ← η_κ(x + (τ/S) Φᵀ(y − sign(Φx))), unit-normalized.

Both take ``x0``, the warm-start iterate. ``niht`` and the restricted
spectral estimate behind ``DecodeConfig.validate`` are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparsify import topk_sparsify, topk_sparsify_bisect
from repro_torch.kernels.sign import sign_pm1


def hard_threshold(x: torch.Tensor, k: int) -> torch.Tensor:
    """η_κ: keep the k largest-|.| entries along the last axis (eq. 6),
    exactly k, ties to the lowest index (``lax.top_k``'s rule)."""
    return topk_sparsify(x, k)[0]


def hard_threshold_bisect(x: torch.Tensor, k: int,
                          iters: int = 40) -> torch.Tensor:
    """η_κ by magnitude-threshold bisection (``iters`` rounds)."""
    return topk_sparsify_bisect(x, k, iters=iters)[0]


def iht(y: torch.Tensor, phi: torch.Tensor, k: int, iters: int = 10,
        tau: float = 1.0, ht_fn=None, x0=None) -> torch.Tensor:
    """Fixed-step IHT on real measurements (eq. 43). y: (..., S);
    phi: (S, D) -> (..., D). ``x0`` defaults to zeros (cold start)."""
    ht = ht_fn or hard_threshold
    x = (torch.zeros(y.shape[:-1] + (phi.shape[1],), dtype=y.dtype,
                     device=y.device) if x0 is None else x0)
    for _ in range(iters):
        resid = y - x @ phi.T
        x = ht(x + tau * (resid @ phi), k)
    return x


def biht_sign(y_sign: torch.Tensor, phi: torch.Tensor, k: int,
              iters: int = 30, tau: float = 1.0, ht_fn=None,
              x0=None) -> torch.Tensor:
    """Classic BIHT (sign-consistency), unit-norm output. ``x0`` defaults
    to the thresholded back-projection η_κ(Φᵀy/S)."""
    s = phi.shape[0]
    ht = ht_fn or hard_threshold
    x = ht((y_sign @ phi) / s, k) if x0 is None else x0
    for _ in range(iters):
        resid = y_sign - sign_pm1(x @ phi.T)
        x = ht(x + (tau / s) * (resid @ phi), k)
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-12)
