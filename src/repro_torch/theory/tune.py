"""Bound-driven design-parameter tuning (paper eq. 24); port of
``repro/theory/tune.py``.

``tune_design`` sweeps (κ_c, S_c, decode-iteration) candidates over the
closed-form objective R_t = 2L·B_t in one broadcast evaluation (the
candidate axis rides ``error_budget``'s tensor support) and returns the
Pareto frontier over (R_t, uplink symbols, decode FLOPs).

R_t alone is monotone: more measurements and a larger κ always shrink
eq. (19). The tradeoff enters through the RIP constant: ``delta_model``
carries the Gaussian-RIP scaling δ ∝ √(κ·ln(e·D_c/κ)/S_c), one-point
calibrated against the Monte-Carlo ``rip_constant_estimate`` at a
reference design (``calibrate_delta``), and C(δ) in eq. (46) blows up as
δ → √2 − 1, so for a fixed symbol budget there is an interior optimal κ_c.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.theory.bounds import AnalysisConstants, error_budget


def delta_model(kappa, s_c, d_chunk, *, calib: float = 1.0) -> torch.Tensor:
    """Gaussian-RIP scaling δ(κ, S_c) = calib·√(κ·ln(e·D_c/κ)/S_c), in f32.

    The sufficient condition for RIP-δ of an S_c×D_c i.i.d. Gaussian
    ensemble at sparsity κ is S_c ≳ δ⁻²·κ·ln(e·D_c/κ); solving for δ gives
    the model. ``calib`` absorbs the unknown universal constant."""
    kappa = torch.as_tensor(kappa, dtype=torch.float32)
    s_c = torch.as_tensor(s_c, dtype=torch.float32)
    d_chunk = torch.as_tensor(d_chunk, dtype=torch.float32)
    return calib * torch.sqrt(kappa * torch.log(math.e * d_chunk / kappa)
                              / s_c)


def calibrate_delta(d_chunk: int, *, kappa_ref: int, s_ref: int,
                    n_trials: int = 32, seed: int = 1, phi=None,
                    supports=None, values=None, device="cpu") -> float:
    """One-point calibration of ``delta_model``: Monte-Carlo δ at a
    reference (κ_ref, S_ref) through ``rip_constant_estimate`` (eq. 41),
    divided by the model's uncalibrated value there.

    ``phi`` (S_ref, D_c) and the RIP draws ``supports``/``values``
    (n_trials, κ_ref) replace the port's own (seeded generators, not
    JAX's bits), so a test can feed both packages the same numbers."""
    from repro_torch.core.measurement import make_phi, rip_constant_estimate
    if phi is None:
        phi = make_phi(0, s_ref, d_chunk, device=device)
    delta_ref = float(rip_constant_estimate(phi, kappa_ref,
                                            n_trials=n_trials, seed=seed,
                                            supports=supports,
                                            values=values))
    raw = float(delta_model(kappa_ref, s_ref, d_chunk, calib=1.0))
    return delta_ref / raw


def pareto_mask(objectives: np.ndarray) -> np.ndarray:
    """Boolean non-dominated mask for an (N, M) minimize-all objective
    matrix. A candidate is on the frontier iff no other candidate is ≤ in
    every objective and < in at least one; non-finite rows never
    qualify."""
    obj = np.asarray(objectives, np.float64)
    finite = np.all(np.isfinite(obj), axis=1)
    # [j, i]: candidate j weakly/strictly better than candidate i
    le = np.all(obj[:, None, :] <= obj[None, :, :], axis=-1)
    lt = np.any(obj[:, None, :] < obj[None, :, :], axis=-1)
    dominated = np.any(le & lt, axis=0)
    return finite & ~dominated


def tune_design(c: AnalysisConstants, *, D: int, d_chunk: int,
                kappas: Sequence[int], measures: Sequence[int],
                decode_iters: Sequence[int] = (10,),
                k_weights, noise_var, b_t, beta=None,
                calib: Optional[float] = None,
                max_symbols: Optional[float] = None) -> Dict:
    """Sweep the (κ_c, S_c, decode-iteration) design grid over the
    closed-form R_t (eq. 24) in one broadcast evaluation.

    The channel context is a nominal operating point: β (default: everyone
    scheduled), per-worker ``k_weights``, the power scale ``b_t`` and the
    receiver ``noise_var``. ``calib=None`` runs ``calibrate_delta`` at
    (κ_0, S_last) with the port's own draws.

    Returns a dict of (N,) arrays over the flattened grid: ``kappa``,
    ``measure``, ``iters``, the modeled ``delta``, the predicted ``rt``
    (+inf where δ breaks eq. 46), per-round uplink ``symbols`` (S_c + 1
    magnitude symbol per chunk) and decode ``flops``, the ``pareto`` mask
    over (rt, symbols, flops), and ``best``, the argmin-R_t index within
    ``symbols ≤ max_symbols`` when a budget is given. Raises
    ``ValueError`` when no candidate is both RIP-feasible and within
    budget."""
    k_weights = torch.as_tensor(np.asarray(k_weights), dtype=torch.float32)
    beta = (torch.ones_like(k_weights) if beta is None
            else torch.as_tensor(np.asarray(beta), dtype=torch.float32))
    if calib is None:
        calib = calibrate_delta(d_chunk, kappa_ref=int(kappas[0]),
                                s_ref=int(measures[-1]))
    kg, sg, ig = np.meshgrid(np.asarray(kappas, np.float32),
                             np.asarray(measures, np.float32),
                             np.asarray(decode_iters, np.float32),
                             indexing="ij")
    kappa = torch.from_numpy(kg.ravel())
    s_c = torch.from_numpy(sg.ravel())
    iters = ig.ravel()

    n_chunks = -(-D // d_chunk)
    # RIP is a per-chunk property of the block-diagonal Φ; the error terms
    # see the effective whole-vector totals n·κ_c / n·S_c
    delta = delta_model(kappa, s_c, d_chunk, calib=calib)
    budget = error_budget(c, D=D, S=n_chunks * s_c,
                          kappa=torch.clamp(n_chunks * kappa, max=float(D)),
                          beta=beta, k_weights=k_weights, b_t=b_t,
                          noise_var=noise_var, delta=delta)
    rt = budget.rt().numpy().astype(np.float64)
    symbols = n_chunks * (s_c.numpy().astype(np.float64) + 1.0)
    # per decode iteration: one projection + one back-projection GEMM
    flops = (iters.astype(np.float64) * 4.0
             * s_c.numpy().astype(np.float64) * d_chunk * n_chunks)
    mask = pareto_mask(np.stack([rt, symbols, flops], axis=1))
    feasible = np.isfinite(rt)
    if max_symbols is not None:
        feasible &= symbols <= float(max_symbols)
    if not feasible.any():
        raise ValueError(
            "tune_design: no candidate is RIP-feasible"
            + (f" within max_symbols={max_symbols}"
               if max_symbols is not None else "")
            + " — widen the grid or raise the budget")
    best = int(np.argmin(np.where(feasible, rt, np.inf)))
    return {"kappa": kappa.numpy().astype(np.int64),
            "measure": s_c.numpy().astype(np.int64),
            "iters": iters.astype(np.int64),
            "delta": delta.numpy(),
            "rt": rt, "symbols": symbols, "flops": flops,
            "pareto": mask, "best": best, "calib": float(calib),
            "budget": budget}
