"""Algorithm 2 (ADMM for P3) as a batched solver on the card; port of
``repro/sched/admm.py``.

The reference's ADMM (step 1 projected gradient on r with a closed-form
b, step 2 the per-worker β/q closed forms of eq. 34-36, step 3 the
multiplier updates (37)-(39)) runs over B independent P2 instances as
(B, U) tensors, in chunks of ``_CHUNK`` outer iterations with a per-lane
``done`` mask: a lane freezes at the scalar solver's break point
(it > 5 and Σ|q−b| < abs_tol and |Δb| < rel_tol, or no relative primal
improvement for ``STALL_PATIENCE`` iterations). Frozen lanes never change,
so running more chunks than a lane needs gives the same bits.

Two entry points, per lane bit for bit the same:

- ``admm_solve_batched`` (the fleet form): the host reads the ``done``
  mask after each chunk and gathers the lanes still running into the next
  power-of-two bucket (``sched/compaction.py``), so a fleet pays for the
  convergence distribution, not B × the straggler; the flip-polish runs
  on the gathered polish-active lanes only.
- ``admm_solve_batched_jit`` (the in-round form): chunks run on the whole
  batch while some lane runs, and the polish on every lane, masked, when
  some lane needs it. Both tests go through ``control.while_loop`` and
  ``control.cond``: host reads in an eager call, cuts between CUDA graphs
  in a captured round (``engine/graph.py``).

The reductions are last-axis sums, per row in an order that does not
depend on the number of rows, which is what lets a bucket and the full
batch give a lane the same bits. Dual warm starts: both solvers take and
return the multipliers ν (eq. 37), ξ (eq. 38) and ζ (eq. 39, the
reference's λ) as ``AdmmDuals``; by default the primal re-initialises from
the problem, so warm and cold solves reach the same β. ``warm_beta`` also
seeds the primal from a cached schedule projected to a feasible point
(no bitwise guarantee against cold; nothing in the engine passes it).

Algorithm 2 has no hand-written kernel here: it is plain PyTorch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import control
from repro_torch.device import resolve_device
from repro_torch.sched.compaction import bucket, pad_to_bucket, take
from repro_torch.sched.config import SchedConfig
from repro_torch.sched.problem import BatchedProblem, rt_from_stats
from repro_torch.sched.reference import STALL_PATIENCE, STALL_RTOL

_DEFAULT = SchedConfig()
_CHUNK = 8          # outer iterations per chunk


class AdmmDuals(NamedTuple):
    """The Algorithm-2 multipliers, (B, U) f32 (or (U,) in the engine's
    carry): ν ≥ 0 prices the power constraints (eq. 37), ξ couples
    r = βq (eq. 38), ζ enforces q = b (eq. 39)."""
    nu: torch.Tensor
    xi: torch.Tensor
    zeta: torch.Tensor

    @classmethod
    def zeros(cls, shape, dtype=torch.float32, device=None) -> "AdmmDuals":
        dev = resolve_device(device)
        return cls(*(torch.zeros(shape, dtype=dtype, device=dev)
                     for _ in range(3)))


class AdmmSolveInfo(NamedTuple):
    """Per-lane telemetry of ``return_duals=True``: the exit multipliers
    and the outer iterations each lane took."""
    duals: AdmmDuals
    iters: torch.Tensor         # (B,) int32


def _bcast(flag, leaf):
    """A (B,) lane mask against a (B, ...) state leaf."""
    return flag.reshape(flag.shape + (1,) * (leaf.ndim - flag.ndim))


def _greedy_prefix_bound(prob: BatchedProblem, caps) -> torch.Tensor:
    """Best prefix R_t over the channel-cap order, the polish's early-exit
    bound. Sort-free: worker i's prefix is {j : cap_j ≥ cap_i}, counted
    and weighed by an O(U²) mask (the reference's einsum, written as a
    product and a last-axis sum)."""
    ge = (caps[..., None, :] >= caps[..., :, None]).to(caps.dtype)
    s1 = torch.sum(ge, dim=-1)
    s2 = torch.sum(ge * prob.k_weights[..., None, :], dim=-1)
    ktot, rho1, A, E, N = prob.rt_coefs()
    r = rt_from_stats(s1, s2, caps, ktot=ktot[..., None], rho1=rho1,
                      A=A, E=E, N=N[..., None])
    return torch.amin(r, dim=-1)


# --- ADMM iteration (leaves (B, U), lane scalars (B,)) ----------------------

def _init_state(prob: BatchedProblem, duals: Optional[AdmmDuals] = None,
                warm_beta: Optional[torch.Tensor] = None):
    """Initial state (q, β, b, ν, ξ, ζ, done, it, prim_best, stall).
    ``duals`` seeds the multipliers only; ``warm_beta`` also seeds the
    primal, binarised with empty lanes falling back to all-on, b and q from
    the eq. 16 closed form."""
    caps = prob.caps()
    if warm_beta is None:
        beta0 = torch.ones_like(caps)
    else:
        wb = (warm_beta.to(caps.dtype) > 0.5).to(caps.dtype)
        empty = torch.sum(wb, dim=-1, keepdim=True) == 0
        beta0 = torch.where(empty, torch.ones_like(caps), wb)
    b0 = torch.clamp(prob.optimal_bt(beta0), min=1e-6)          # (B,)
    if duals is None:
        nu, xi, zeta = (torch.zeros_like(caps) for _ in range(3))
    else:
        nu, xi, zeta = (d.to(caps.dtype) for d in duals)
    B = caps.shape[:-1]
    dev = caps.device
    return (b0[..., None] * torch.ones_like(caps), beta0, b0, nu, xi, zeta,
            torch.zeros(B, dtype=torch.bool, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev),
            torch.full(B, float("inf"), dtype=torch.float32, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev))


class _Invariants(NamedTuple):
    """What stays fixed over a solve: K², h², −2C²σ² (B, 1), ΣK (B, 1)."""
    k2: torch.Tensor
    h2: torch.Tensor
    m2c2s2: torch.Tensor
    ksum: torch.Tensor


def _invariants(prob: BatchedProblem) -> _Invariants:
    c2s2 = (prob.const.C ** 2 * prob.noise_var)[..., None]
    return _Invariants(k2=prob.k_weights ** 2, h2=prob.h ** 2,
                       m2c2s2=-2.0 * c2s2,
                       ksum=torch.sum(prob.k_weights, dim=-1, keepdim=True))


def _outer_iter(prob: BatchedProblem, cfg: SchedConfig, inv: _Invariants,
                st):
    """One masked reference iteration: steps 1-3 and the convergence and
    stall test. The reference's loop invariants are computed once per
    solve (same values); the op order is the reference's."""
    q, beta, b, nu, xi, zeta, done, it, prim_best, stall = st
    c = prob.const
    cs = cfg.c_step
    h, K, p_max = prob.h, prob.k_weights, prob.p_max
    U = K.shape[-1]

    # step 1: projected gradient on r, closed form for b
    penc = 2.0 * nu * inv.k2 / inv.h2 + cs                  # pen + c
    inv_lip = 1.0 / (penc + 1e-6)
    bq = beta * q
    g0 = xi - cs * bq                           # loop-invariant linear part
    r = torch.clamp(bq, min=1e-8)
    for _ in range(cfg.inner_iters):
        denom = torch.clamp(torch.sum(K * r, dim=-1, keepdim=True),
                            min=1e-9)
        t = inv.m2c2s2 / denom ** 3
        r = torch.clamp(r - (t * K + penc * r + g0) * inv_lip, min=1e-9)
    b_new = torch.clamp(torch.sum(q, dim=-1) / U
                        + torch.sum(zeta, dim=-1) / U / cs, min=1e-9)
    bn = b_new[..., None]

    # step 2: per-worker closed forms for (q, β) (eq. 34-36)
    E_pen = (1.0 + c.delta) * (prob.D - prob.kappa) / prob.D * c.G ** 2
    q0 = torch.clamp(bn - zeta / cs, min=1e-9)
    obj0 = (K * c.rho1 / inv.ksum + xi * r + 0.5 * cs * r ** 2
            + zeta * (q0 - bn) + 0.5 * cs * (q0 - bn) ** 2)
    q1 = torch.clamp((xi - zeta + cs * (r + bn)) / (2.0 * cs), min=1e-9)
    obj1 = (E_pen + xi * (r - q1) + 0.5 * cs * (r - q1) ** 2
            + zeta * (q1 - bn) + 0.5 * cs * (q1 - bn) ** 2)
    beta_n = (obj1 < obj0).to(r.dtype)
    q_n = torch.where(beta_n > 0, q1, q0)

    # step 3: multiplier updates (37)-(39); ν projected to ≥ 0
    nu_n = torch.clamp(nu + cs * ((K * r / h) ** 2 - p_max), min=0.0)
    xi_n = xi + cs * (r - beta_n * q_n)
    zeta_n = zeta + cs * (q_n - bn)

    prim = torch.sum(torch.abs(q_n - bn), dim=-1)          # (B,)
    drift = torch.abs(b_new - b)
    improved = prim < prim_best * (1.0 - STALL_RTOL)
    stall_n = torch.where(improved, torch.zeros_like(stall), stall + 1)
    prim_best_n = torch.minimum(prim_best, prim)
    done_n = (it > 5) & (((prim < cfg.abs_tol) & (drift < cfg.rel_tol))
                         | (stall_n >= STALL_PATIENCE))

    new = (q_n, beta_n, b_new, nu_n, xi_n, zeta_n, done_n, it + 1,
           prim_best_n, stall_n)
    # convergence masking: frozen lanes carry their break-point state
    frozen = done | (it >= cfg.max_iters)
    return tuple(torch.where(_bcast(frozen, o), o, n)
                 for o, n in zip(st, new))


def _chunk(prob: BatchedProblem, cfg: SchedConfig, inv: _Invariants, st):
    for _ in range(_CHUNK):
        st = _outer_iter(prob, cfg, inv, st)
    return st


def _running(cfg: SchedConfig, st) -> torch.Tensor:
    """0-d bool: some lane is neither done nor at ``max_iters``."""
    return ~torch.all(st[6] | (st[7] >= cfg.max_iters))


# --- flip-polish + projection -------------------------------------------------

def _project_batched(prob: BatchedProblem, beta):
    """Empty-schedule fallback (the largest cap) and the greedy-prefix
    early exit: both sides of the test go through the same
    sufficient-statistics arithmetic. Returns (β, R_t of β, active)."""
    caps = prob.caps()
    empty = torch.sum(beta, dim=-1, keepdim=True) == 0
    iota = torch.arange(caps.shape[-1], device=caps.device)
    fallback = iota == torch.argmax(caps, dim=-1, keepdim=True)
    beta = torch.where(empty, fallback.to(beta.dtype), beta)
    ktot, rho1, A, E, N = prob.rt_coefs()
    best0 = rt_from_stats(torch.sum(beta, dim=-1),
                          torch.sum(prob.k_weights * beta, dim=-1),
                          prob.optimal_bt(beta), ktot=ktot, rho1=rho1,
                          A=A, E=E, N=N)
    active = best0 > _greedy_prefix_bound(prob, caps) * (1.0 + 1e-6)
    return beta, best0, active


def _polish(prob: BatchedProblem, cfg: SchedConfig, beta, best0):
    """First-improvement index-order flip search, every lane at once (the
    reference's ``_polish_one`` vmapped): ``polish_sweeps`` sweeps over
    the U coordinates, a lane stopping after a sweep that found nothing;
    each candidate R_t from the sufficient statistics."""
    U = prob.U
    K = prob.k_weights
    caps = prob.caps()
    inf = torch.full_like(caps, float("inf"))
    ktot, rho1, A, E, N = prob.rt_coefs()
    best_r = best0
    improved = torch.zeros_like(best0, dtype=torch.bool)
    active = torch.ones_like(improved)
    for step in range(cfg.polish_sweeps * U):
        i = step % U
        if i == 0 and step > 0:     # sweep boundary
            active = active & improved
            improved = torch.zeros_like(improved)
        beta_c = beta.clone()
        beta_c[..., i] = 1.0 - beta[..., i]
        s1c = torch.sum(beta_c, dim=-1)
        s2c = torch.sum(K * beta_c, dim=-1)
        bc = torch.amin(torch.where(beta_c > 0, caps, inf), dim=-1)
        r_c = rt_from_stats(s1c, s2c, bc, ktot=ktot, rho1=rho1, A=A, E=E,
                            N=N)
        accept = active & (s1c > 0) & (r_c < best_r - 1e-12)
        beta = torch.where(accept[..., None], beta_c, beta)
        best_r = torch.where(accept, r_c, best_r)
        improved = improved | accept
    return beta


def _results_batched(prob: BatchedProblem, beta):
    b_t = prob.optimal_bt(beta)
    return beta, b_t, prob.rt(beta, b_t)


def _info(st) -> AdmmSolveInfo:
    return AdmmSolveInfo(duals=AdmmDuals(nu=st[3], xi=st[4], zeta=st[5]),
                         iters=st[7])


def admm_solve_batched_jit(prob: BatchedProblem,
                           cfg: Optional[SchedConfig] = None,
                           duals: Optional[AdmmDuals] = None,
                           return_duals: bool = False,
                           warm_beta: Optional[torch.Tensor] = None):
    """The in-round form: chunks over the whole batch while some lane runs
    (the reference's ``lax.while_loop``), then the polish on every lane,
    kept where a lane's ADMM point misses the greedy-prefix bound. Returns
    (β (B, U), b_t (B,), R_t (B,)), and with ``return_duals=True`` also an
    ``AdmmSolveInfo``. The first chunk runs unconditionally (every lane
    starts running when ``max_iters`` > 0), so a captured round whose lanes
    converge within it makes one host read for the loop."""
    cfg = cfg or _DEFAULT
    inv = _invariants(prob)
    st = _init_state(prob, duals, warm_beta)
    if cfg.max_iters > 0 and prob.B > 0:
        st = _chunk(prob, cfg, inv, st)
    st = control.while_loop(lambda s: _running(cfg, s),
                            lambda s: _chunk(prob, cfg, inv, s), st)
    beta, best0, active = _project_batched(prob, st[1])
    beta = control.cond(
        torch.any(active),
        lambda: torch.where(active[..., None],
                            _polish(prob, cfg, beta, best0), beta),
        beta)
    out = _results_batched(prob, beta)
    return out + (_info(st),) if return_duals else out


def _finalize_batched(prob: BatchedProblem, cfg: SchedConfig, beta):
    """Project + polish, the polish on the gathered polish-active lanes."""
    beta, best0, active = _project_batched(prob, beta)
    act = np.flatnonzero(active.cpu().numpy())
    if act.size:
        pad, _ = pad_to_bucket(act)
        idx = torch.as_tensor(pad, device=beta.device)
        polished = _polish(take(prob, idx), cfg, beta[idx], best0[idx])
        beta[idx] = polished    # duplicates carry identical values
    return _results_batched(prob, beta)


def admm_solve_batched(prob: BatchedProblem,
                       cfg: Optional[SchedConfig] = None,
                       duals: Optional[AdmmDuals] = None,
                       return_duals: bool = False,
                       warm_beta: Optional[torch.Tensor] = None):
    """The fleet form: B instances, compacted between chunks.

    Returns (β (B, U), b_t (B,), R_t (B,)); with ``return_duals=True``
    also an ``AdmmSolveInfo`` of the exit multipliers and iterations.
    After each chunk the host reads which lanes still run; when they fit a
    smaller pow2 bucket, the finished lanes retire their state and the rest
    (padded by duplicates that arrive frozen) continue alone."""
    cfg = cfg or _DEFAULT
    B, U = prob.B, prob.U
    dev = prob.h.device
    beta_out = torch.zeros((B, U), dtype=torch.float32, device=dev)
    dual_out = [torch.zeros((B, U), dtype=torch.float32, device=dev)
                for _ in range(3)]
    iters_out = torch.zeros(B, dtype=torch.int32, device=dev)
    idx = np.arange(B)                       # original slot of each lane
    valid = np.ones(B, bool)                 # False for pad duplicates
    sub, st = prob, _init_state(prob, duals, warm_beta)
    inv = _invariants(sub)

    def retire(fin):
        lanes = torch.as_tensor(np.flatnonzero(fin), device=dev)
        slots = torch.as_tensor(idx[fin], device=dev)
        beta_out[slots] = st[1][lanes]
        for out, leaf in zip(dual_out, st[3:6]):
            out[slots] = leaf[lanes]
        iters_out[slots] = st[7][lanes]

    while B > 0:
        st = _chunk(sub, cfg, inv, st)
        done = (st[6] | (st[7] >= cfg.max_iters)).cpu().numpy()
        active = ~done & valid
        if not active.any():
            retire(done & valid)
            break
        if bucket(int(active.sum())) < idx.size:
            retire(done & valid)
            pad, valid = pad_to_bucket(np.flatnonzero(active))
            idx = idx[pad]
            lanes = torch.as_tensor(pad, device=dev)
            sub, st = take(sub, lanes), take(st, lanes)
            st = st[:6] + (st[6] | torch.as_tensor(~valid, device=dev),) \
                + st[7:]
            inv = _invariants(sub)
    out = _finalize_batched(prob, cfg, beta_out)
    if return_duals:
        return out + (AdmmSolveInfo(duals=AdmmDuals(*dual_out),
                                    iters=iters_out),)
    return out
