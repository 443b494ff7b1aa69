"""Measurement matrix Φ (paper §II-B.2).

Port of ``repro/core/measurement.py``. Φ ∈ R^{S×D} has i.i.d. N(0, 1/S)
entries, drawn with a seeded ``torch.Generator``: the same seed gives the
same Φ in the port, but not JAX's threefry bits, so parity tests inject
the reference's Φ.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.device import resolve_device


def make_phi(seed: int, s_dim: int, d_dim: int, device=None,
             generator: Optional[torch.Generator] = None,
             dtype=torch.float32) -> torch.Tensor:
    """Φ with entries N(0, 1/S) — the paper's normalization (§V).
    ``generator`` overrides the one seeded from ``seed``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    phi = torch.randn((s_dim, d_dim), generator=generator, device=dev,
                      dtype=torch.float32)
    return (phi / torch.sqrt(torch.tensor(float(s_dim), device=dev))).to(
        dtype)


def project_chunked(phi: torch.Tensor, g_chunks: torch.Tensor
                    ) -> torch.Tensor:
    """Block-diagonal Φ-projection, the linear half of C(g) (eq. 7):
    g_chunks (n, D_c) -> (n, S_c)."""
    return g_chunks @ phi.T


def rip_constant_estimate(phi: torch.Tensor, sparsity: int,
                          n_trials: int = 64, seed: int = 1, *,
                          supports: Optional[torch.Tensor] = None,
                          values: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Monte-Carlo estimate of the RIP constant δ for κ-sparse vectors
    (eq. 41): the largest |‖Φx‖²/‖x‖² − 1| over ``n_trials`` random
    κ-sparse x. ``supports`` (n_trials, κ) indices without repeats and
    ``values`` (n_trials, κ) replace the draws; otherwise both come from a
    ``torch.Generator`` seeded with ``seed`` on phi's device (not JAX's
    bits, so parity tests inject the reference's draws)."""
    d_dim = phi.shape[1]
    dev = phi.device
    if supports is None or values is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        if supports is None:
            supports = torch.argsort(
                torch.rand((n_trials, d_dim), generator=gen, device=dev),
                dim=-1)[:, :sparsity]
        if values is None:
            values = torch.randn((n_trials, sparsity), generator=gen,
                                 device=dev)
    x = torch.zeros((supports.shape[0], d_dim), dtype=phi.dtype, device=dev)
    x.scatter_(1, supports.to(dev, torch.int64), values.to(dev, phi.dtype))
    r = torch.sum((x @ phi.T) ** 2, dim=-1) / torch.sum(x ** 2, dim=-1)
    return torch.max(torch.abs(r - 1.0))


def reconstruction_constant(delta: float) -> float:
    """Paper eq. (46): C = 2ϖ/(1−ϱ), ϖ = 2√(1+δ)/√(1−δ), ϱ = √2·δ/(1−δ).

    Valid for δ ≤ √2 − 1 (Candès RIP condition); raises otherwise."""
    varpi = 2.0 * math.sqrt(1.0 + delta) / math.sqrt(1.0 - delta)
    varrho = math.sqrt(2.0) * delta / (1.0 - delta)
    if varrho >= 1.0:
        raise ValueError(f"delta={delta} violates RIP reconstruction bound")
    return 2.0 * varpi / (1.0 - varrho)
