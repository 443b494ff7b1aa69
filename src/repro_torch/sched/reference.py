"""NumPy float64 reference for P2 — joint worker scheduling and power
scaling (paper §IV); a copy of ``repro/sched/reference.py``.

P2:  min_{b_t, β_t} R_t   s.t.  β_i² K_i² b_t² / h_i² ≤ P_i^Max, β ∈ {0,1}^U.

It runs on the host, scalar and float64, one instance per call, with the
reference's op order, so that it equals ``repro.sched.reference`` bit for
bit; the batched solvers on the card (``sched/admm.py``,
``sched/greedy.py``) are tested against it instance by instance.

- Algorithm 1 (``enumerate_solve``): exact, enumerates the 2^U − 1
  schedules; for fixed β the optimal b_t is closed-form (R_t strictly
  decreases in b_t, so b_t* sits on the tightest power boundary).
- Algorithm 2 (``admm_solve``): O(U) ADMM on the P3 reformulation with
  auxiliaries r_i = β_i q_i, q_i = b_t and multipliers (ν, ξ, ς), followed
  by an O(U)-per-sweep flip-polish.
- ``greedy_solve``: prefix search over the channel-cap order, exact for
  equal K_i.

The power budget is per worker (paper eq. 10 is P_i^Max): ``Problem.p_max``
takes a (U,) array; a scalar broadcasts to all workers (the paper's §V).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np

from repro_torch.theory.bounds import AnalysisConstants

# Stall cut shared with the batched solver (sched/admm.py): stop when
# the primal residual has not improved by STALL_RTOL (relative) for
# STALL_PATIENCE consecutive iterations — float64 rarely triggers it, but
# the float32 device path needs it to retire oscillating instances, and
# the two implementations must share one convergence rule.
STALL_RTOL = 1e-3
STALL_PATIENCE = 10


@dataclass(frozen=True)
class Problem:
    """One round's P2 instance."""
    h: np.ndarray                        # (U,) channel magnitudes
    k_weights: np.ndarray                # (U,) K_i
    p_max: Union[float, np.ndarray]      # P_i^Max: scalar broadcast or (U,)
    noise_var: float                     # σ²
    D: int
    S: int
    kappa: int
    const: AnalysisConstants

    @property
    def U(self) -> int:
        return len(self.h)

    @property
    def p_max_vec(self) -> np.ndarray:
        """Per-worker P_i^Max (eq. 10); scalars broadcast to (U,)."""
        return np.broadcast_to(np.asarray(self.p_max, np.float64),
                               (self.U,))

    def caps(self) -> np.ndarray:
        """Per-worker b_t ceiling h_i √(P_i^Max) / K_i (eq. 11)."""
        return self.h * np.sqrt(self.p_max_vec) / self.k_weights


def _rt(prob: Problem, beta: np.ndarray, b_t: float) -> float:
    c = prob.const
    K = prob.k_weights.sum()
    denom = float((prob.k_weights * beta).sum()) * b_t
    if denom <= 0:
        return np.inf
    C2 = c.C ** 2
    r = (prob.k_weights * c.rho1 * (1.0 - beta)).sum() / K
    r += C2 * (1.0 + (1.0 + c.delta) * (prob.D - prob.kappa)
               / (prob.S * prob.D) * c.G ** 2
               + prob.noise_var / denom ** 2)
    r += beta.sum() * (1.0 + c.delta) * (prob.D - prob.kappa) / prob.D \
        * c.G ** 2
    return float(r)


def _rt_coefs(prob: Problem):
    """Sufficient-statistic form of R_t (DESIGN.md §10): R_t depends on β
    only through s1 = Σβ, s2 = ΣK_iβ_i and the min-cap b, as

        R(s1, s2, b) = ρ1 (Ktot − s2)/Ktot + A + N/(s2·b)² + s1·E

    with A the schedule-independent floor, N = C²σ², E the per-scheduled
    sparsification penalty. Returns (Ktot, rho1, A, E, N)."""
    c = prob.const
    C2 = c.C ** 2
    ktot = float(prob.k_weights.sum())
    A = C2 * (1.0 + (1.0 + c.delta) * (prob.D - prob.kappa)
              / (prob.S * prob.D) * c.G ** 2)
    E = (1.0 + c.delta) * (prob.D - prob.kappa) / prob.D * c.G ** 2
    return ktot, float(c.rho1), A, E, C2 * prob.noise_var


def _rt_from_stats(coefs, s1: float, s2: float, b: float) -> float:
    ktot, rho1, A, E, N = coefs
    if s2 <= 0 or b <= 0:
        return np.inf
    return rho1 * (ktot - s2) / ktot + A + N / (s2 * b) ** 2 + s1 * E


def optimal_bt(prob: Problem, beta: np.ndarray) -> float:
    """R_t strictly decreases in b_t ⇒ b_t* = min_i scheduled cap_i."""
    sel = beta > 0
    if not sel.any():
        return 0.0
    return float(prob.caps()[sel].min())


def enumerate_solve(prob: Problem) -> Tuple[np.ndarray, float, float]:
    """Algorithm 1. Returns (β*, b_t*, R_t*). O(2^U) — small U only."""
    U = prob.U
    best = (None, 0.0, np.inf)
    for bits in itertools.product((0, 1), repeat=U):
        beta = np.asarray(bits, np.float64)
        if beta.sum() == 0:
            continue
        b = optimal_bt(prob, beta)
        r = _rt(prob, beta, b)
        if r < best[2]:
            best = (beta, b, r)
    return best


def _step1_rb(prob: Problem, q, beta, nu, xi, zeta, b_prev, c_step,
              inner_iters=50):
    """Minimize L wrt (r, b): projected gradient on r (smooth convex) with
    per-coordinate curvature steps, closed form for b."""
    c2s2 = prob.const.C ** 2 * prob.noise_var
    K = prob.k_weights
    r = np.maximum(beta * q, 1e-8)
    # per-coordinate Lipschitz of the quadratic parts
    lip = 2.0 * nu * K ** 2 / prob.h ** 2 + c_step + 1e-6
    for _ in range(inner_iters):
        denom = max(float((K * r).sum()), 1e-9)
        gQ1 = -2.0 * c2s2 / denom ** 3 * K
        gpen = nu * 2.0 * K ** 2 * r / prob.h ** 2
        glin = xi + c_step * (r - beta * q)
        g = gQ1 + gpen + glin
        r = np.maximum(r - g / lip, 1e-9)
    b = float(np.mean(q) + np.mean(zeta) / c_step)
    b = max(b, 1e-9)
    return r, b


def _step2_qbeta(prob: Problem, r, b, nu, xi, zeta, c_step):
    """Per-worker closed forms for q under β=0 / β=1, pick the smaller
    objective (eq. 34-36)."""
    c = prob.const
    K = prob.k_weights
    Ksum = K.sum()
    # beta = 0: q = b - zeta/c
    q0 = np.maximum(b - zeta / c_step, 1e-9)
    obj0 = (K * c.rho1 / Ksum
            + xi * r + 0.5 * c_step * r ** 2
            + zeta * (q0 - b) + 0.5 * c_step * (q0 - b) ** 2)
    # beta = 1: q = (xi - zeta + c r + c b) / (2c)
    q1 = np.maximum((xi - zeta + c_step * (r + b)) / (2.0 * c_step), 1e-9)
    obj1 = ((1.0 + c.delta) * (prob.D - prob.kappa) / prob.D * c.G ** 2
            + xi * (r - q1) + 0.5 * c_step * (r - q1) ** 2
            + zeta * (q1 - b) + 0.5 * c_step * (q1 - b) ** 2)
    beta = (obj1 < obj0).astype(np.float64)
    q = np.where(beta > 0, q1, q0)
    return q, beta


def greedy_prefix_bound(prob: Problem) -> float:
    """Best prefix R_t over the channel-cap order (the ``greedy_solve``
    optimum), in O(U log U) via the sufficient-statistic form — the
    flip-polish early-exit bound (DESIGN.md §10)."""
    caps = prob.caps()
    order = np.argsort(-caps)
    ks = prob.k_weights[order]
    coefs = _rt_coefs(prob)
    ktot, rho1, A, E, N = coefs
    s2 = np.cumsum(ks)
    s1 = np.arange(1, prob.U + 1, dtype=np.float64)
    b = caps[order]
    r = rho1 * (ktot - s2) / ktot + A + N / (s2 * b) ** 2 + s1 * E
    return float(r.min())


def _flip_polish(prob: Problem, beta: np.ndarray, *, max_sweeps: int = 3
                 ) -> np.ndarray:
    """First-improvement flip local search on β, O(U) per sweep via
    incremental Δ-evaluation: each candidate R_t comes from the sufficient
    statistics (s1, s2, min-cap) in O(1) — the min-cap after dropping the
    boundary worker is the second-smallest scheduled cap, so only an
    *accepted* flip recomputes the O(U) min statistics."""
    caps = prob.caps()
    K = prob.k_weights
    coefs = _rt_coefs(prob)
    U = prob.U
    s1 = float(beta.sum())
    s2 = float((K * beta).sum())

    def min_stats():
        sel_caps = np.where(beta > 0, caps, np.inf)
        i1 = int(np.argmin(sel_caps))
        m1 = float(sel_caps[i1])
        sel_caps = sel_caps.copy()
        sel_caps[i1] = np.inf
        return i1, m1, float(sel_caps.min())

    i1, m1, m2 = min_stats()
    best_r = _rt_from_stats(coefs, s1, s2, m1)
    for _ in range(max_sweeps):
        improved = False
        for i in range(U):
            if beta[i] > 0:
                if s1 <= 1:
                    continue
                b_c = m2 if i == i1 else m1
                r_c = _rt_from_stats(coefs, s1 - 1.0, s2 - K[i], b_c)
            else:
                r_c = _rt_from_stats(coefs, s1 + 1.0, s2 + K[i],
                                     min(m1, caps[i]))
            if r_c < best_r - 1e-12:
                beta[i] = 1.0 - beta[i]
                s1 += 1.0 if beta[i] > 0 else -1.0
                s2 += K[i] if beta[i] > 0 else -K[i]
                i1, m1, m2 = min_stats()
                best_r = r_c
                improved = True
        if not improved:
            break
    return beta


def admm_solve(prob: Problem, *, c_step: float = 1.0, max_iters: int = 200,
               abs_tol: float = 1e-4,
               rel_tol: float = 1e-5) -> Tuple[np.ndarray, float, float]:
    """Algorithm 2. Returns (β*, b_t*, R_t*). O(U) per iteration."""
    U = prob.U
    p_max = prob.p_max_vec
    beta = np.ones(U)
    b = max(optimal_bt(prob, beta), 1e-6)   # feasible warm start
    q = np.full(U, b)
    nu = np.zeros(U)
    xi = np.zeros(U)
    zeta = np.zeros(U)
    prim_best, stall = np.inf, 0
    for it in range(max_iters):
        r, b_new = _step1_rb(prob, q, beta, nu, xi, zeta, b, c_step)
        q, beta = _step2_qbeta(prob, r, b_new, nu, xi, zeta, c_step)
        # Step 3: multiplier updates (37)-(39); ν projected to >= 0
        nu = np.maximum(
            nu + c_step * ((prob.k_weights * r / prob.h) ** 2 - p_max),
            0.0)
        xi = xi + c_step * (r - beta * q)
        zeta = zeta + c_step * (q - b_new)
        prim = float(np.abs(q - b_new).sum())
        drift = abs(b_new - b)
        b = b_new
        stall = 0 if prim < prim_best * (1.0 - STALL_RTOL) else stall + 1
        prim_best = min(prim_best, prim)
        if it > 5 and ((prim < abs_tol and drift < rel_tol)
                       or stall >= STALL_PATIENCE):
            break
    # project: final β from ADMM, b_t from the exact power boundary
    if beta.sum() == 0:
        beta[int(np.argmax(prob.caps()))] = 1.0
    # flip-polish (engineering refinement over the paper's raw ADMM output;
    # keeps the solver polynomial, DESIGN.md §10). Early-exit: when the
    # ADMM point already matches the greedy prefix bound (relative
    # tolerance — both sides evaluated through the same sufficient-stats
    # arithmetic), local flips cannot improve a prefix-family optimum.
    coefs = _rt_coefs(prob)
    r_admm = _rt_from_stats(coefs, float(beta.sum()),
                            float((prob.k_weights * beta).sum()),
                            optimal_bt(prob, beta))
    if r_admm > greedy_prefix_bound(prob) * (1.0 + 1e-6):
        beta = _flip_polish(prob, beta)
    b_final = optimal_bt(prob, beta)
    return beta, b_final, _rt(prob, beta, b_final)


def greedy_solve(prob: Problem) -> Tuple[np.ndarray, float, float]:
    """Beyond-paper baseline: sort workers by channel quality cap
    h_i √(P_i^Max)/K_i (descending); evaluate the U prefix schedules; pick
    best. O(U log U) and, because R_t depends on β only through Σβ, ΣK_iβ
    and the min-cap, the optimum is always a prefix of this ordering when
    K_i are equal — making it exact for the paper's §V setup. The loop form
    here is the oracle for the vectorized/Pallas prefix sweep
    (``sched/greedy.py``, DESIGN.md §10)."""
    caps = prob.caps()
    order = np.argsort(-caps)
    best = (None, 0.0, np.inf)
    beta = np.zeros(prob.U)
    for i in order:
        beta[i] = 1.0
        b = optimal_bt(prob, beta)
        r = _rt(prob, beta, b)
        if r < best[2]:
            best = (beta.copy(), b, r)
    return best
