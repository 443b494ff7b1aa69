"""Batched P2 instances; port of ``repro/sched/problem.py``.

``BatchedProblem`` holds B independent P2 instances as stacked ``(B, U)``
tensors: channels, weights K_i, per-worker power budgets P_i^Max (paper
eq. 10) and the noise variances (B,); the analysis constants (D, S, κ,
``AnalysisConstants``) are plain attributes. ``caps``/``optimal_bt``/``rt``
reduce over the last axis only, so the module functions below also take
(U,) inputs; the methods call them. ``from_problems``/``single`` stack the
float64 NumPy ``Problem``s of ``sched/reference.py`` into f32 tensors on a
device, ``instance`` takes one back out.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.prefix_eval import prefix_rt
from repro_torch.sched.reference import Problem
from repro_torch.theory.bounds import AnalysisConstants

__all__ = ["BatchedProblem", "caps", "optimal_bt", "rt_from_stats"]


def caps(h: torch.Tensor, k_weights: torch.Tensor,
         p_max: torch.Tensor) -> torch.Tensor:
    """Per-worker b_t ceiling h_i √(P_i^Max) / K_i (eq. 11)."""
    return h * torch.sqrt(p_max) / k_weights


def optimal_bt(h: torch.Tensor, k_weights: torch.Tensor, p_max: torch.Tensor,
               beta: torch.Tensor) -> torch.Tensor:
    """R_t strictly decreases in b_t ⇒ b_t* = min scheduled cap; 0 where
    nothing is scheduled."""
    sel = beta > 0
    c = caps(h, k_weights, p_max)
    b = torch.where(sel, c, torch.full_like(c, float("inf"))).amin(dim=-1)
    return torch.where(sel.any(dim=-1), b, torch.zeros_like(b))


@dataclass(frozen=True)
class BatchedProblem:
    """B stacked P2 instances; all per-worker tensors are (B, U)."""
    h: torch.Tensor            # (B, U) channel magnitudes
    k_weights: torch.Tensor    # (B, U) K_i
    p_max: torch.Tensor        # (B, U) per-worker P_i^Max (eq. 10)
    noise_var: torch.Tensor    # (B,) σ² per instance
    D: int
    S: int
    kappa: int
    const: AnalysisConstants

    @property
    def B(self) -> int:
        return self.h.shape[0]

    @property
    def U(self) -> int:
        return self.h.shape[-1]

    @classmethod
    def from_arrays(cls, h, k_weights, p_max, noise_var, *, D: int, S: int,
                    kappa: int, const: AnalysisConstants,
                    dtype=torch.float32, device=None) -> "BatchedProblem":
        """Normalise broadcastable inputs: ``h`` fixes (B, U); ``k_weights``
        and ``p_max`` accept scalars / (U,) / (B, U); ``noise_var`` accepts
        a scalar or (B,). The tensors land on ``device``, else on ``h``'s
        device when ``h`` is a tensor, else on CUDA."""
        if device is None and isinstance(h, torch.Tensor):
            device = h.device
        dev = resolve_device(device)

        def as_t(a):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        h = as_t(h)
        if h.ndim < 2:
            h = h.reshape(1, -1)
        B, U = h.shape
        # materialised, so a lane gather and the full batch reduce rows of
        # the same layout
        k = as_t(k_weights).expand(B, U).contiguous()
        p = as_t(p_max).expand(B, U).contiguous()
        nv = as_t(noise_var).expand(B).contiguous()
        return cls(h=h, k_weights=k, p_max=p, noise_var=nv, D=int(D),
                   S=int(S), kappa=int(kappa), const=const)

    @classmethod
    def from_problems(cls, problems: Sequence[Problem], dtype=torch.float32,
                      device=None) -> "BatchedProblem":
        """Stack NumPy reference instances (shared D/S/κ/constants) on
        ``device`` (``None`` means CUDA)."""
        p0 = problems[0]
        for p in problems[1:]:
            if (p.D, p.S, p.kappa, p.const) != (p0.D, p0.S, p0.kappa,
                                                p0.const):
                raise ValueError("from_problems requires shared "
                                 "D/S/kappa/const across instances")
        return cls.from_arrays(
            np.stack([p.h for p in problems]),
            np.stack([p.k_weights for p in problems]),
            np.stack([p.p_max_vec for p in problems]),
            np.asarray([p.noise_var for p in problems]),
            D=p0.D, S=p0.S, kappa=p0.kappa, const=p0.const, dtype=dtype,
            device=resolve_device(device))

    @classmethod
    def single(cls, prob: Problem, dtype=torch.float32,
               device=None) -> "BatchedProblem":
        """Lift one reference instance to B = 1."""
        return cls.from_problems([prob], dtype=dtype, device=device)

    def instance(self, b: int) -> Problem:
        """Instance ``b`` back as a float64 NumPy reference ``Problem``."""
        def f64(t):
            return t[b].detach().cpu().numpy().astype(np.float64)

        return Problem(h=f64(self.h), k_weights=f64(self.k_weights),
                       p_max=f64(self.p_max),
                       noise_var=float(self.noise_var[b]), D=self.D,
                       S=self.S, kappa=self.kappa, const=self.const)

    # -- P2 quantities (last-axis reductions) -------------------------------
    def caps(self) -> torch.Tensor:
        return caps(self.h, self.k_weights, self.p_max)

    def optimal_bt(self, beta: torch.Tensor) -> torch.Tensor:
        return optimal_bt(self.h, self.k_weights, self.p_max, beta)

    def rt(self, beta: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
        """Eq. (24) objective R_t per instance; +inf on empty schedules."""
        c = self.const
        K = torch.sum(self.k_weights, dim=-1)
        denom = torch.sum(self.k_weights * beta, dim=-1) * b_t
        safe = torch.where(denom > 0, denom, torch.ones_like(denom))
        C2 = c.C ** 2
        r = torch.sum(self.k_weights * c.rho1 * (1.0 - beta), dim=-1) / K
        r = r + C2 * (1.0 + (1.0 + c.delta) * (self.D - self.kappa)
                      / (self.S * self.D) * c.G ** 2
                      + self.noise_var / safe ** 2)
        r = r + torch.sum(beta, dim=-1) * (1.0 + c.delta) \
            * (self.D - self.kappa) / self.D * c.G ** 2
        return torch.where(denom > 0, r, torch.full_like(r, float("inf")))

    def rt_coefs(self):
        """Sufficient-statistic coefficients of R_t:
        R(s1, s2, b) = ρ1(Ktot − s2)/Ktot + A + N/(s2·b)² + s1·E.
        Returns (Ktot (B,), ρ1, A, E as Python floats, N (B,)). As in the
        reference, A, E and ρ1 are float64 and N is f32(C²)·σ² in f32."""
        c = self.const
        C2 = c.C ** 2
        ktot = torch.sum(self.k_weights, dim=-1)
        A = C2 * (1.0 + (1.0 + c.delta) * (self.D - self.kappa)
                  / (self.S * self.D) * c.G ** 2)
        E = (1.0 + c.delta) * (self.D - self.kappa) / self.D * c.G ** 2
        # a Python scalar enters an f32 product as f32, as in JAX
        return ktot, c.rho1, A, E, self.noise_var * C2


def rt_from_stats(s1, s2, b, *, ktot, rho1, A, E, N):
    """R_t from the sufficient statistics: the formula the prefix_eval
    kernel (K7) evaluates, in its op order, so the two agree bit for bit
    where every prefix sum is exact."""
    return prefix_rt(s1, s2, b, ktot=ktot, rho1=rho1, A=A, E=E, N=N)
