"""Wireless MAC model (paper §II-B.4), port of ``repro/core/channel.py``.

Block Rayleigh fading h_{i,t} = |g_{i,t}| stepped by the Gauss-Markov
recursion g_t = ρ g_{t−1} + √(1−ρ²) w_t, w ~ CN(0, 1) (ρ = 0 is the
paper's i.i.d. redraw), clamped at ``H_MIN`` so channel inversion (eq. 10)
stays bounded; AWGN z ~ N(0, σ²I) at the PS. Every draw takes an explicit
``torch.Generator`` (where the reference takes a key), and the caller
can pass the draw itself instead (``w=`` / ``noise=``): that is how tests
feed both packages the same numbers. ``mac_aggregate`` and
``post_process`` are the centralized forms of eq. (8) and eq. (13).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

H_MIN = 1e-3  # clamp |h| to keep 1/h bounded (worker would be unscheduled)


def _draw_device(generator: Optional[torch.Generator], device
                 ) -> torch.device:
    """Where a draw lands: ``device`` when given, else the generator's
    device, else CUDA (``resolve_device``), never the CPU by default."""
    if device is not None:
        return torch.device(device)
    if generator is not None:
        return generator.device
    return resolve_device(None)


def draw_cn(generator: torch.Generator, shape, device) -> torch.Tensor:
    """w ~ CN(0, 1): unit-variance circularly-symmetric complex Gaussian."""
    re = torch.randn(shape, generator=generator, device=device)
    im = torch.randn(shape, generator=generator, device=device)
    return torch.complex(re, im) / math.sqrt(2.0)


def gauss_markov_step(g: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      rho: float = 0.0, *,
                      w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """g_t = ρ g_{t−1} + √(1−ρ²) w_t, stationary at CN(0, 1), so the
    magnitude marginal stays Rayleigh for every ρ ∈ [0, 1). ``w`` is the
    CN(0, 1) innovation; when it is not given it is drawn from
    ``generator`` on ``g``'s device."""
    if w is None:
        w = draw_cn(generator, g.shape, g.device)
    w = w.to(torch.complex64)
    # √(1−ρ²) in f32, as the reference computes it: g is then its bits
    r = np.float32(rho)
    innov = np.sqrt(np.maximum(np.float32(1.0) - r * r, np.float32(0)))
    return float(r) * g + float(innov) * w


def draw_fades(generator: Optional[torch.Generator] = None, shape=None, *,
               rho: float = 0.0, prev: Optional[torch.Tensor] = None,
               w: Optional[torch.Tensor] = None, device=None,
               clamp: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round of block-fading magnitudes. Returns ``(|h| f32, g
    complex64)``. ``prev=None`` starts from the stationary g ~ CN(0, 1);
    otherwise g steps ``gauss_markov_step`` from ``prev``. ``w`` is the
    CN(0, 1) draw; when it is not given it is drawn from ``generator`` on
    ``device``, which defaults to ``prev``'s device, else the
    generator's, else CUDA."""
    if prev is None:
        if w is None:
            w = draw_cn(generator, shape, _draw_device(generator, device))
        g = w.to(torch.complex64)
    else:
        g = gauss_markov_step(prev, generator, rho, w=w)
    g = g.to(torch.complex64)
    h = g.abs().to(torch.float32)
    if clamp:
        h = torch.clamp(h, min=H_MIN)
    return h, g


def rayleigh_cdf(x) -> torch.Tensor:
    """F(x) = 1 − exp(−x²) for |CN(0, 1)|, in f32: the KS-test reference
    for the fade marginal."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return 1.0 - torch.exp(-x ** 2)


def draw_channels(generator: Optional[torch.Generator], n_workers: int,
                  clamp: bool = True, *, device=None) -> torch.Tensor:
    """|h_{i,t}| for one round (i.i.d. Rayleigh; ``draw_fades`` without
    the carried complex state)."""
    return draw_fades(generator, (n_workers,), clamp=clamp,
                      device=device)[0]


def draw_noise(generator: Optional[torch.Generator], shape,
               noise_var: float, device=None) -> torch.Tensor:
    """AWGN z_t ~ N(0, σ²I) added at the PS receiver (eq. 12), on
    ``device``, else the generator's device, else CUDA. ``noise_var`` may
    be a 0-d f32 tensor on that device (an arm's σ²): it is not read back
    to the host, so the draw can be captured in a CUDA graph."""
    z = torch.randn(shape, generator=generator,
                    device=_draw_device(generator, device))
    if not isinstance(noise_var, torch.Tensor):
        noise_var = torch.tensor(float(noise_var), dtype=torch.float32,
                                 device=z.device)
    return z * torch.sqrt(noise_var)


def mac_aggregate(symbols: torch.Tensor, h: torch.Tensor, p: torch.Tensor,
                  noise: torch.Tensor) -> torch.Tensor:
    """Centralized (simulation) form of eq. (8):
    y = Σ_i h_i p_i c_i + z, symbols (U, S)."""
    return torch.einsum("u,us->s", h * p, symbols) + noise


def post_process(y: torch.Tensor, k_weights: torch.Tensor,
                 beta: torch.Tensor, b_t) -> torch.Tensor:
    """Eq. (13): divide by Σ_i K_i β_i b_t."""
    denom = torch.sum(k_weights * beta) * b_t
    return y / torch.clamp(denom, min=1e-12)
