"""1-bit CS decoders (eq. 43), plain PyTorch; port of ``repro/decode/iht.py``.

- ``iht``: x ← η_κ(x + τ Φᵀ(ŷ − Φx)) on the real post-processed aggregate.
- ``niht``: normalized IHT, the step μ = ‖g_Λ‖²/‖Φ g_Λ‖² recomputed every
  iteration on the support-restricted gradient.
- ``biht_sign``: x ← η_κ(x + (τ/S) Φᵀ(y − sign(Φx))), unit-normalized.

All take ``x0``, the warm-start iterate. ``restricted_spectral_estimate``
is the λ̂ behind ``DecodeConfig.validate``: fixed-step IHT diverges where
τ·λ̂ ≥ ``IHT_STABILITY_BOUND``.
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


#: Divergence edge of the fixed-step update x ← η_κ(x + τΦᵀ(y − Φx)): on
#: the iterate support the map is I − τΦ_TᵀΦ_T, whose spectrum stays in
#: (−1, 1] iff τ·λ(Φ_TᵀΦ_T) < 2.
IHT_STABILITY_BOUND = 2.0


def restricted_spectral_estimate(phi: torch.Tensor, k: int,
                                 iters: int = 20) -> torch.Tensor:
    """λ̂ ≈ max λ(Φ_TᵀΦ_T) over k-sparse supports T: the hard-thresholded
    power iteration v ← η_k(ΦᵀΦ v)/‖·‖ from the all-ones start 1/√D (no
    random draw). Returns a 0-d tensor on phi's device."""
    d = phi.shape[1]
    s = min(k, d)
    # 1/√D rounded in f32, as the reference's jnp.sqrt(float32(D))
    start = float(1.0 / torch.sqrt(torch.tensor(float(d))))
    v = torch.full((d,), start, dtype=phi.dtype, device=phi.device)
    for _ in range(iters):
        w = hard_threshold(phi.T @ (phi @ v), s)
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    pv = phi @ v
    return torch.sum(pv * pv) / torch.clamp(torch.sum(v * v), min=1e-30)


def iht_step_stable(phi: torch.Tensor, k: int, tau: float,
                    iters: int = 20) -> torch.Tensor:
    """Bool 0-d tensor: is τ·λ̂ below ``IHT_STABILITY_BOUND``?"""
    return (restricted_spectral_estimate(phi, k, iters) * tau
            < IHT_STABILITY_BOUND)


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


def niht(y: torch.Tensor, phi: torch.Tensor, k: int, iters: int = 10,
         ht_fn=None, x0=None) -> torch.Tensor:
    """Normalized IHT (eq. 43 with an adaptive step): per iteration the
    exact line search μ = ‖g_Λ‖²/‖Φ g_Λ‖² along the gradient restricted to
    Λ = supp(x), the full gradient while the support is empty."""
    ht = ht_fn or hard_threshold
    x = (torch.zeros(y.shape[:-1] + (phi.shape[1],), dtype=y.dtype,
                     device=y.device) if x0 is None else x0)
    for _ in range(iters):
        g = (y - x @ phi.T) @ phi
        nz = x != 0
        gs = torch.where(nz.any(dim=-1, keepdim=True), g * nz, g)
        num = torch.sum(gs * gs, dim=-1, keepdim=True)
        pg = gs @ phi.T
        den = torch.sum(pg * pg, dim=-1, keepdim=True)
        x = ht(x + num / torch.clamp(den, min=1e-30) * g, k)
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
