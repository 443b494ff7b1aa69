"""Time-correlated fading scenarios for fleet-scale scheduling; port of
``repro/sched/scenario.py``.

Produces (rounds, cells, U) channel-magnitude trajectories for the batched
P2 solvers: each round is B = cells independent instances, each cell a
parameter server with U workers.

- **Small-scale fading**: first-order Gauss-Markov on the complex fade,
  g_t = ρ g_{t−1} + √(1−ρ²) w_t with w ~ CN(0, 1), stationary at CN(0, 1);
  ``model="jakes"`` takes ρ = J₀(2π f_d T_s) from the Doppler spread,
  ``model="iid"`` (ρ = 0) is the paper's per-round redraw.
- **Large-scale gain**: static per (cell, worker), log-normal shadowing
  (σ dB) and a disk layout with distance path loss.

The fade process is ``init_fades``/``step_fades`` on a ``FadeState``, one
round at a time, and ``generate_fades`` chains that very step, so a
stepped trajectory equals the whole-trajectory draw bit for bit. The step
is ``core/channel.draw_fades``, the engine's own fade recursion. Every
draw comes from the state's ``torch.Generator`` in a fixed order (the
initial fade, then one innovation per step), or is passed in (``g0=``,
``w=``, ``shadow=``, ``radius_u=``): the port does not replicate the
reference's counter-based keys, so tests feed both the same numbers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.core import channel as chan
from repro_torch.core.channel import H_MIN
from repro_torch.sched.problem import BatchedProblem
from repro_torch.theory.bounds import AnalysisConstants


def bessel_j0(x: float) -> float:
    """J₀ for the Jakes correlation coefficient (host-side scalar;
    Abramowitz & Stegun 9.4.1 / 9.4.3, |err| < 2e-7)."""
    ax = abs(x)
    if ax <= 3.0:
        y = (ax / 3.0) ** 2
        return (1.0 + y * (-2.2499997 + y * (1.2656208 + y * (-0.3163866
                + y * (0.0444479 + y * (-0.0039444 + y * 0.0002100))))))
    z = 3.0 / ax
    f0 = (0.79788456 + z * (-0.00000077 + z * (-0.00552740 + z * (
        -0.00009512 + z * (0.00137237 + z * (-0.00072805
                                             + z * 0.00014476))))))
    t0 = (ax - 0.78539816 + z * (-0.04166397 + z * (-0.00003954 + z * (
        0.00262573 + z * (-0.00054125 + z * (-0.00029333
                                             + z * 0.00013558))))))
    return f0 * math.cos(t0) / math.sqrt(ax)


@dataclass(frozen=True)
class ScenarioConfig:
    """A fleet of ``cells`` cells × ``workers`` workers over ``rounds``
    temporally correlated fading rounds."""
    rounds: int = 100
    cells: int = 16
    workers: int = 64
    model: str = "gauss_markov"   # gauss_markov | jakes | iid
    corr: float = 0.9             # ρ (gauss_markov)
    doppler_hz: float = 10.0      # f_d (jakes)
    slot_s: float = 0.01          # round duration T_s (jakes)
    shadowing_db: float = 0.0     # log-normal shadowing σ (dB); 0 = off
    cell_radius: float = 0.0      # disk layout radius; 0 = unit gain
    ref_dist: float = 0.05        # path-loss reference distance
    pathloss_exp: float = 3.7     # path-loss exponent α
    h_min: float = H_MIN          # clamp (channel-inversion boundedness)

    @property
    def rho(self) -> float:
        if self.model == "gauss_markov":
            return float(self.corr)
        if self.model == "jakes":
            return bessel_j0(2.0 * math.pi * self.doppler_hz * self.slot_s)
        if self.model == "iid":
            return 0.0
        raise ValueError(f"unknown fading model {self.model!r} "
                         "(gauss_markov|jakes|iid)")


class FadeState(NamedTuple):
    """The incremental fade process: the current complex fades ``g``
    ((cells, U) complex64), the generator of the innovations to come, and
    the index ``t`` of the round ``g`` belongs to."""
    g: torch.Tensor
    generator: Optional[torch.Generator]
    t: int


def init_fades(cfg: ScenarioConfig,
               generator: Optional[torch.Generator] = None, *,
               g0: Optional[torch.Tensor] = None, device=None) -> FadeState:
    """Round-0 state: one stationary CN(0, 1) draw per (cell, worker),
    from ``generator`` (on ``device``, else the generator's device, else
    CUDA) unless ``g0`` gives it."""
    if g0 is None:
        g0 = chan.draw_cn(generator, (cfg.cells, cfg.workers),
                          chan._draw_device(generator, device))
    return FadeState(g=g0.to(torch.complex64), generator=generator, t=0)


def step_fades(cfg: ScenarioConfig, state: FadeState,
               w: Optional[torch.Tensor] = None) -> FadeState:
    """One Gauss-Markov round, g_{t+1} = ρ g_t + √(1−ρ²) w, with the
    innovation ``w`` drawn from the state's generator unless given."""
    _, g = chan.draw_fades(state.generator, rho=cfg.rho, prev=state.g, w=w,
                           clamp=False)
    return FadeState(g=g, generator=state.generator, t=state.t + 1)


def magnitudes(state_or_g, gain: Optional[torch.Tensor] = None,
               h_min: float = H_MIN) -> torch.Tensor:
    """Channel magnitudes |h| f32 from a ``FadeState`` (or raw complex
    fades), scaled by the static large-scale ``gain`` and clamped to
    ``h_min``."""
    g = state_or_g.g if isinstance(state_or_g, FadeState) else state_or_g
    h = torch.abs(g)
    if gain is not None:
        h = h * gain
    return torch.clamp(h.to(torch.float32), min=h_min)


def generate_fades(cfg: ScenarioConfig,
                   generator: Optional[torch.Generator] = None, *,
                   g0: Optional[torch.Tensor] = None,
                   w: Optional[torch.Tensor] = None,
                   device=None) -> torch.Tensor:
    """Complex small-scale fades, (rounds, cells, U) complex64: ``step_fades``
    chained from ``init_fades``. ``w`` (rounds − 1, cells, U) gives the
    innovations."""
    st = init_fades(cfg, generator, g0=g0, device=device)
    gs = [st.g]
    for t in range(cfg.rounds - 1):
        st = step_fades(cfg, st, None if w is None else w[t])
        gs.append(st.g)
    return torch.stack(gs, dim=0)


def large_scale_gain(cfg: ScenarioConfig,
                     generator: Optional[torch.Generator] = None, *,
                     shadow: Optional[torch.Tensor] = None,
                     radius_u: Optional[torch.Tensor] = None,
                     device=None) -> torch.Tensor:
    """Static per-(cell, worker) amplitude gain, (cells, U) f32: log-normal
    shadowing (``shadow`` the N(0, 1) draw) × disk-layout path loss
    (``radius_u`` the U(0, 1) draw of the squared radius); ones when both
    are off."""
    shape = (cfg.cells, cfg.workers)
    given = shadow if shadow is not None else radius_u
    dev = given.device if device is None and given is not None \
        else chan._draw_device(generator, device)
    gain = torch.ones(shape, dtype=torch.float32, device=dev)
    if cfg.shadowing_db > 0:
        if shadow is None:
            shadow = torch.randn(shape, generator=generator, device=dev)
        db = cfg.shadowing_db * shadow
        gain = gain * 10.0 ** (db / 20.0)
    if cfg.cell_radius > 0:
        if radius_u is None:
            radius_u = torch.rand(shape, generator=generator, device=dev)
        d = cfg.cell_radius * torch.sqrt(radius_u)
        d = torch.clamp(d, min=cfg.ref_dist)
        gain = gain * (d / cfg.ref_dist) ** (-cfg.pathloss_exp / 2.0)
    return gain


def generate(cfg: ScenarioConfig,
             generator: Optional[torch.Generator] = None, *,
             g0: Optional[torch.Tensor] = None,
             w: Optional[torch.Tensor] = None,
             shadow: Optional[torch.Tensor] = None,
             radius_u: Optional[torch.Tensor] = None,
             device=None) -> torch.Tensor:
    """Channel-magnitude trajectories |h|, (rounds, cells, U) f32, clamped
    to ``h_min``: the fades first, then the gain, from one generator."""
    h = torch.abs(generate_fades(cfg, generator, g0=g0, w=w, device=device))
    h = h * large_scale_gain(cfg, generator, shadow=shadow,
                             radius_u=radius_u, device=h.device)[None]
    return torch.clamp(h.to(torch.float32), min=cfg.h_min)


def round_problems(traj: torch.Tensor, t, *, k_weights, p_max, noise_var,
                   D: int, S: int, kappa: int,
                   const: AnalysisConstants) -> BatchedProblem:
    """Round ``t`` of a (rounds, cells, U) trajectory as a B = cells
    ``BatchedProblem`` on the trajectory's device."""
    return BatchedProblem.from_arrays(traj[t], k_weights, p_max, noise_var,
                                      D=D, S=S, kappa=kappa, const=const)
