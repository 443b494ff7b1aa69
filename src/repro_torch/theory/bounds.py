"""The Theorem-1 convergence bound (paper §III); port of
``repro/theory/bounds.py``.

- Lemma 1 (eq. 19) bounds the aggregation error
  E‖e_t‖² ≤ C²(1 + (1+δ)(D−κ)/(SD)·G² + σ²/(ΣK_iβ_ib_t)²)
           + Σ_iβ_i(1+δ)(D−κ)/D·G².
- Theorem 1 (eq. 20-21) turns the per-round B_t into a rate; the descent
  recursion Δ_{t+1} = ρ₂Δ_t + B_t tends to the floor B/(1−ρ₂).
- Eq. (24) regroups 2L·B_t into the R_t objective the schedulers minimize.

``error_budget`` returns an ``ErrorBudget``, one named field per error
source, which the engine emits every round next to the scheduling stats.
Every function reduces over the last axis only, so one call covers a
round, a trajectory or an (arms, rounds) grid. The arithmetic is f32 in
the reference's order; Python scalars (D, S, κ, the constants) become 0-d
CPU tensors, which PyTorch takes as scalars beside tensors on the card, so
a round that emits its budget uploads nothing and can be captured in a
CUDA graph. The fields sum in field order, bit for bit, to
``lemma1_error_bound``, because that function is the sum.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

# Candès RIP condition: eq. (46)'s C(δ) is finite for δ < √2 − 1.
DELTA_MAX = math.sqrt(2.0) - 1.0


@dataclass(frozen=True)
class AnalysisConstants:
    """Paper's analysis constants (Assumptions 1-4 + RIP)."""
    L: float = 10.0          # Lipschitz smoothness
    rho1: float = 1.0        # sample-gradient bound, eq. (17)
    rho2: float = 0.5        # sample-gradient slope, 0 <= rho2 < 1
    G: float = 10.0          # local gradient bound, eq. (18)
    delta: float = 0.2       # RIP constant (< sqrt(2)-1)

    @property
    def C(self) -> float:
        """Reconstruction constant C(δ) of eq. (46)."""
        # deferred: repro_torch.core re-exports this module's names, so a
        # module-scope import of core.measurement would be a cycle
        from repro_torch.core.measurement import reconstruction_constant
        return reconstruction_constant(self.delta)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def reconstruction_constant_traced(delta) -> torch.Tensor:
    """Tensor-valued eq. (46): C(δ) = 2ϖ/(1−ϱ), +inf where δ ≥ √2 − 1
    (the scalar ``reconstruction_constant`` raises there instead)."""
    delta = _f32(delta)
    d = torch.clamp(delta, 0.0, 0.99)          # keep the square roots defined
    varpi = 2.0 * torch.sqrt(1.0 + d) / torch.sqrt(1.0 - d)
    varrho = _f32(math.sqrt(2.0)) * d / (1.0 - d)
    c = 2.0 * varpi / torch.clamp(1.0 - varrho, min=1e-9)
    return torch.where(delta < DELTA_MAX, c, torch.full_like(c, math.inf))


class ErrorBudget(NamedTuple):
    """Per-round error budget: eq. (19)/(21)/(24) split into the five
    aggregation-error sources plus the scheduling penalty. The five error
    fields sum, in field order, to the Lemma-1 bound; ``scheduling`` is
    eq. (21)'s (1−β) penalty on the R_t = 2L·B_t scale, not part of
    eq. (19). The methods use operators only, so they work on tensors and
    on NumPy arrays alike."""
    quantization: torch.Tensor      # 1, the unit sign-quantization floor
    dim_reduction: torch.Tensor     # (1+δ)(D−κ)/(SD)·G²
    noise: torch.Tensor             # σ²/(ΣK_iβ_ib_t)²
    reconstruction: torch.Tensor    # (C²(δ)−1)·(the three terms above)
    sparsification: torch.Tensor    # Σβ_i(1+δ)(D−κ)/D·G²
    scheduling: torch.Tensor        # ΣK_iρ₁(1−β_i)/ΣK_i  (eq. 21 × 2L)

    def total_error(self):
        """Eq. (19): the Lemma-1 bound, the field-order sum."""
        return (self.quantization + self.dim_reduction + self.noise
                + self.reconstruction + self.sparsification)

    def rt(self):
        """Eq. (24): R_t = 2L·B_t."""
        return self.scheduling + self.total_error()

    def bt(self, L: float):
        """Eq. (21): B_t."""
        return self.rt() / (2.0 * L)


def error_budget(c: AnalysisConstants, *, D, S, kappa, beta, k_weights,
                 b_t, noise_var, delta=None) -> ErrorBudget:
    """Eq. (19)/(21) as an ``ErrorBudget``. ``beta``/``k_weights`` are
    (..., U) and reduce over the last axis; everything else broadcasts
    against the leading axes. ``delta=None`` uses ``c.delta``/``c.C``; a
    tensor δ goes through ``reconstruction_constant_traced``."""
    beta = _f32(beta)
    k_weights = _f32(k_weights)
    D, S, kappa = _f32(D), _f32(S), _f32(kappa)
    if delta is None:
        delta = _f32(c.delta)
        C2 = _f32(c.C ** 2)
    else:
        delta = _f32(delta)
        C2 = reconstruction_constant_traced(delta) ** 2
    G2 = _f32(c.G ** 2)

    s_beta = torch.sum(beta, dim=-1)
    s_k = torch.sum(k_weights * beta, dim=-1)
    K = torch.sum(k_weights, dim=-1)
    denom = s_k * _f32(b_t)

    quant = torch.ones_like(C2 * denom)       # the output's shape and device
    dim_red = (1.0 + delta) * (D - kappa) / (S * D) * G2 * quant
    noise = _f32(noise_var) / torch.clamp(denom ** 2, min=1e-30)
    recon = (C2 - 1.0) * (quant + dim_red + noise)
    sparse = s_beta * (1.0 + delta) * (D - kappa) / D * G2
    sched = torch.sum(k_weights * c.rho1 * (1.0 - beta), dim=-1) / K
    # broadcast_tensors, not broadcast_shapes: the latter imports sympy
    # (through torch._refs) on its first call, 3.5 s of host time
    return ErrorBudget(*torch.broadcast_tensors(quant, dim_red, noise, recon,
                                                sparse, sched))


def lemma1_error_bound(c: AnalysisConstants, *, D, S, kappa, beta,
                       k_weights, b_t, noise_var, delta=None):
    """Eq. (19): by definition the field-order sum of the budget."""
    return error_budget(c, D=D, S=S, kappa=kappa, beta=beta,
                        k_weights=k_weights, b_t=b_t, noise_var=noise_var,
                        delta=delta).total_error()


def bt_term(c: AnalysisConstants, *, D, S, kappa, beta, k_weights, b_t,
            noise_var, delta=None):
    """Eq. (21): B_t."""
    return error_budget(c, D=D, S=S, kappa=kappa, beta=beta,
                        k_weights=k_weights, b_t=b_t, noise_var=noise_var,
                        delta=delta).bt(c.L)


def rt_objective(c: AnalysisConstants, *, D, S, kappa, beta, k_weights,
                 b_t, noise_var, delta=None):
    """Eq. (24): R_t = 2L·B_t, the joint-optimization objective."""
    return error_budget(c, D=D, S=S, kappa=kappa, beta=beta,
                        k_weights=k_weights, b_t=b_t, noise_var=noise_var,
                        delta=delta).rt()


def theorem1_rate(c: AnalysisConstants, *, T: int, f0_minus_fstar,
                  bt_sum):
    """Eq. (20): bound on (1/T) Σ ‖∇F‖²."""
    lead = 2.0 * c.L / (T * (1.0 - c.rho2))
    return lead * f0_minus_fstar + lead * bt_sum


def theorem1_trajectory(c: AnalysisConstants, f0_minus_fstar,
                        bt_series) -> torch.Tensor:
    """Unroll Δ_{t+1} = ρ₂·Δ_t + B_t from Δ_0 = F(w_0) − F(w*): the
    per-round bound on E[F(w_t) − F(w*)]. ``bt_series`` is (..., T) with
    time on the last axis, as the reference's scan carries it; leading
    axes are carried elementwise."""
    bt_series = _f32(bt_series)
    delta = _f32(f0_minus_fstar).expand(bt_series.shape[:-1])
    rho2 = _f32(c.rho2)
    out = []
    for t in range(bt_series.shape[-1]):
        delta = rho2 * delta + bt_series[..., t]
        out.append(delta)
    return torch.stack(out, dim=-1) if out else bt_series.clone()


def error_floor_asymptote(c: AnalysisConstants, bt) -> torch.Tensor:
    """lim_t Δ_t = B/(1−ρ₂) for constant B_t = B: the error floor."""
    return _f32(bt) / (1.0 - c.rho2)
