"""The round body: eq. (3)–(14); port of ``repro/engine/core.py``.

``build_engine`` closes an ``FLConfig`` + task (loss_fn, optimizer, D, U)
over the round functions, as the reference does:

- ``fade_step``            Gauss-Markov block-fading draw (core/channel.py)
- ``schedule``             P2 for one round's channels as a B = 1
                           ``BatchedProblem``: ``all`` (β = 1, b_t =
                           min_i h_i √P^Max / K_i), ``greedy_batched``
                           (the prefix sweep, sched/greedy.py) or
                           ``admm_batched``/``admm_batched_jit`` (Algorithm
                           2 in its in-round form, sched/admm.py), with the
                           dual warm start when ``sched_warm_duals``
- ``round_given_schedule`` local gradients (eq. 3), the error-feedback
                           split (``ef_split``), compress + MAC + decode
                           (eq. 6-13) with the decoder's warm start, the
                           top-κ analog baseline or the perfect mean, the
                           optimizer's update (eq. 14), and the Theorem-1
                           budget of the round (eq. 19)
- ``full_round``           fade draw + schedule + the round

σ², P^Max and the learning rate come from the arm (``engine/state.Arms``)
as 0-d tensors on the device, and nothing in the round reads a tensor
back to the host except ADMM's loop and polish tests, which go through
``control``, so ``engine/graph.py`` can capture ``full_round``: whole, or
cut at those two tests.
Random draws come from the carry's ``torch.Generator``, in order: the
initial fade, then per round the fade innovation and the AWGN. Both can
be passed in instead (``fade_w=``, ``noise=``), which is how tests replay
the reference's ``fold_in(key, t)`` draws.

With error feedback under ``obcsaa`` the round is the reference's fused
one: the EF split's top-κ (the plain ``topk_sparsify``, or its bisection
under ``spmd_topk``: the reference calls no kernel there either) is what
the workers compress, ``presparsified``, so the compression launches no
``topk_select``. The warm start's reset on a schedule change is a device
``where``, not a host read.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import channel as chan
from repro_torch.core.obcsaa import OBCSAAConfig, simulate_round
from repro_torch.core.sparsify import (flatten_pytree, topk_sparsify,
                                       topk_sparsify_bisect)
from repro_torch.decode.registry import resolve_validate
from repro_torch.engine.config import ENGINE_SCHEDULERS, FLConfig
from repro_torch.engine.state import Arms, EngineState, RoundStats
from repro_torch.optim.optimizers import ef_step
from repro_torch.sched.admm import AdmmDuals, admm_solve_batched_jit
from repro_torch.sched.greedy import greedy_solve_batched
from repro_torch.sched.problem import BatchedProblem
from repro_torch.theory.bounds import error_budget


def budget_geometry(ob: OBCSAAConfig, D: int):
    """(n_chunks, S_eff, κ_eff) of the block-diagonal Φ at dimension D:
    the chunked operator measures n_chunks·S_c symbols of an (up to)
    n_chunks·κ_c-sparse vector. The Theorem-1 budget's geometry."""
    n_chunks = -(-D // ob.chunk)
    return n_chunks, n_chunks * ob.measure, min(n_chunks * ob.topk, D)


class EngineFns(NamedTuple):
    """The built round functions + static geometry."""
    init_state: Callable            # (params, arm, fade0_w=None) -> state
    fade_step: Callable             # (fade, generator, w=None) -> (h, fade')
    # (h, k_weights, σ², P^Max, duals=None) -> (β, b_t, duals'); duals' is
    # the exit AdmmDuals under sched_warm_duals, else None
    schedule: Callable
    round_given_schedule: Callable
    full_round: Callable            # (state, arm, worker_data, k_weights)
    D: int
    U: int


def stacked_grads(loss_fn: Callable, params, stacked_data) -> torch.Tensor:
    """Every worker's full-batch gradient (eq. 3) in one batched pass:
    returns (U, D) in the JAX pytree order (sorted keys).

    The worker axis is written out in place of JAX's ``vmap``: each
    worker gets its own copy of the parameters, stacked (U, ...), and
    ``loss_fn(stacked_params, stacked_data)`` must return the U losses
    (``models.mlp_mnist.mlp_mnist_loss`` broadcasts over that axis). Their
    sum has gradient g_u on copy u. ``torch.func.vmap(grad)`` would keep a
    per-worker ``loss_fn`` but costs several times the host time per call
    and imports ``torch._dynamo`` on its first call. Lives here, not in
    ``repro_torch.fl``, so the engine does not import the trainer."""
    n = next(iter(stacked_data.values())).shape[0]
    keys = sorted(params)
    leaves = [params[k].detach().expand((n,) + params[k].shape).contiguous()
              .requires_grad_() for k in keys]
    losses = loss_fn(dict(zip(keys, leaves)), stacked_data)
    if tuple(losses.shape) != (n,):
        raise ValueError(f"stacked_grads: loss_fn must return one loss per "
                         f"worker, shape ({n},); got {tuple(losses.shape)}")
    grads = torch.autograd.grad(losses.sum(), leaves)
    return flatten_pytree(dict(zip(keys, grads)), batch_dims=1)[0]


def perfect_aggregate(grads_flat, k_weights, beta) -> torch.Tensor:
    """Error-free weighted mean (the paper's "perfect aggregation")."""
    w = (k_weights * beta)[:, None]
    return torch.sum(grads_flat * w, dim=0) / torch.clamp(
        torch.sum(k_weights * beta), min=1e-12)


def topk_aa_aggregate(grads_flat, k_weights, beta, b_t, kappa, noise_var, *,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sparsified analog aggregation (no CS, no 1-bit): the workers send
    their top-κ gradients over the full vector; AWGN at the PS. ``noise``
    (D,) replaces the draw from ``generator``. Plain PyTorch top-κ, as the
    reference's ``lax.top_k`` (no kernel)."""
    sp, _ = topk_sparsify(grads_flat, kappa)
    w = (k_weights * beta * b_t)[:, None]
    y = torch.sum(sp * w, dim=0)
    if noise is None:
        noise = chan.draw_noise(generator, y.shape, noise_var,
                                device=y.device)
    y = y + noise
    return y / torch.clamp(torch.sum(k_weights * beta) * b_t, min=1e-12)


def _resolve_decoder(ob: OBCSAAConfig, phi: torch.Tensor) -> OBCSAAConfig:
    """Make ``decode_validate``'s decision once per build (λ̂ depends only
    on Φ and the decode sparsity): the round then holds one decoder."""
    if ob.decode_validate == "off":
        return ob
    dc = resolve_validate(ob.decode_cfg(), phi, ob.decode_k)
    return replace(ob, decoder=dc.algorithm, decode_validate="off")


def build_engine(cfg: FLConfig, loss_fn: Callable, opt, D: int, U: int,
                 unflatten: Callable, *, phi: torch.Tensor) -> EngineFns:
    """``phi`` is the (S_c, D_c) measurement matrix shared by the workers
    and the PS; the round runs on its device."""
    ob = _resolve_decoder(cfg.obcsaa, phi)
    device = phi.device
    n_chunks, s_eff, kappa_eff = budget_geometry(ob, D)
    pad = n_chunks * ob.chunk - D
    warm = cfg.aggregator == "obcsaa" and ob.warm_start
    ef = cfg.error_feedback
    track_bound = cfg.aggregator == "obcsaa"    # eq. 19 models obcsaa
    probe = cfg.probe_agg_error
    all_in = torch.ones((U,), device=device)    # β of the perfect mean
    unit = torch.ones((), device=device)        # its b_t
    scfg = cfg.sched_cfg
    admm = cfg.scheduler in ("admm_batched", "admm_batched_jit")
    # the dual warm start applies where ADMM runs every round
    warm_duals = (cfg.sched_warm_duals and cfg.aggregator != "perfect"
                  and admm)

    def init_state(params, arm: Arms,
                   fade0_w: Optional[torch.Tensor] = None) -> EngineState:
        gen = torch.Generator(device=device).manual_seed(int(arm.seed))
        _, fade0 = chan.draw_fades(gen, (U,), w=fade0_w, device=device)
        return EngineState(params=params, opt_state=opt.init(params),
                           fade=fade0,
                           prev_beta=-torch.ones((U,), device=device),
                           decode_x0=torch.zeros((n_chunks, ob.chunk),
                                                 device=device)
                           if warm else None,
                           residual=torch.zeros((U, D), device=device)
                           if ef else None,
                           generator=gen,
                           sched_duals=AdmmDuals.zeros((U,), device=device)
                           if warm_duals else None)

    def fade_step(fade, generator, w: Optional[torch.Tensor] = None):
        return chan.draw_fades(generator, rho=cfg.channel_rho, prev=fade,
                               w=w)

    def schedule(h, k_weights, noise_var, p_max, duals=None):
        """P2 for one round's channels (B = 1) -> (β (U,), b_t, duals').
        ``duals`` (a (U,)-leaf ``AdmmDuals``) seeds ADMM's multipliers;
        duals' are its exit multipliers under the warm start, else None."""
        bp = BatchedProblem.from_arrays(
            h[None], k_weights[None], p_max, noise_var, D=D, S=ob.measure,
            kappa=ob.topk, const=cfg.const)
        duals_out = None
        if cfg.scheduler == "all":
            beta = torch.ones_like(bp.h)
            b_t = bp.optimal_bt(beta)
        elif cfg.scheduler == "greedy_batched":
            beta, b_t, _ = greedy_solve_batched(bp, scfg)
        elif admm:
            if warm_duals and duals is not None:
                d1 = AdmmDuals(*(leaf[None] for leaf in duals))
                beta, b_t, _, info = admm_solve_batched_jit(
                    bp, scfg, duals=d1, return_duals=True)
                duals_out = AdmmDuals(*(leaf[0] for leaf in info.duals))
            else:
                beta, b_t, _ = admm_solve_batched_jit(bp, scfg)
        else:
            raise ValueError(
                f"scheduler {cfg.scheduler!r} does not run inside the round "
                f"(engine schedulers: {ENGINE_SCHEDULERS}); it runs on the "
                "host path, FederatedTrainer in mode='host'")
        return beta[0], b_t[0], duals_out

    def _ef_sparse_approx(corrected):
        """approx_fn of ``ef_step``: per-chunk top-κ of the padded corrected
        gradient, by ``topk_sparsify`` or, under ``spmd_topk``, its
        bisection. Returns (sparse (U, D_pad), its unpadded view): the
        residual keeps exactly what the top-κ dropped."""
        gp = torch.nn.functional.pad(corrected, (0, pad))
        gc = gp.reshape(gp.shape[0], -1, ob.chunk)
        if ob.spmd_topk:
            sp, _ = topk_sparsify_bisect(gc, ob.topk, iters=ob.bisect_iters)
        else:
            sp, _ = topk_sparsify(gc, ob.topk)
        sp = sp.reshape(gp.shape)
        return sp, sp[:, :D]

    def ef_split(grads, residual):
        """EF correction and residual update through ``optim.ef_step``.
        Returns (corrected, residual', sparse (U, D_pad)): the sparse
        vector is sparse_κ of what obcsaa transmits, so the compression
        takes it as it is instead of selecting again."""
        sp, new_residual, corrected = ef_step(grads, residual,
                                              _ef_sparse_approx)
        return corrected, new_residual, sp

    def round_given_schedule(state: EngineState, arm: Arms, worker_data,
                             k_weights, h, fade, beta, b_t,
                             noise: Optional[torch.Tensor] = None,
                             sched_duals=None):
        """Eq. 3 → 6-7 → 10 → 13 → 43 → 14 with the schedule decided;
        ``sched_duals`` (the solve's exit multipliers) go into the carry."""
        grads = stacked_grads(loss_fn, state.params, worker_data)
        residual = state.residual
        presparse = False
        if ef:
            grads, residual, sparse = ef_split(grads, residual)
        dense = grads          # the probe's target: before compression
        if ef and cfg.aggregator == "obcsaa":
            grads, presparse = sparse, True
        x0 = state.decode_x0
        if warm:
            # a schedule change resets the warm start, on the device
            changed = torch.any(beta != state.prev_beta)
            x0 = torch.where(changed, torch.zeros_like(x0), x0)
        if cfg.aggregator == "perfect":
            ghat = perfect_aggregate(grads, k_weights, beta)
        elif cfg.aggregator == "topk_aa":
            ghat = topk_aa_aggregate(grads, k_weights, beta, b_t,
                                     cfg.topk_dense, arm.noise_var,
                                     generator=state.generator, noise=noise)
        else:
            ghat, diag = simulate_round(
                ob, grads, k_weights, beta, b_t, h, phi=phi,
                generator=state.generator, noise=noise, decode_x0=x0,
                noise_var=arm.noise_var, presparsified=presparse)
            if warm:
                x0 = diag["decode_xhat"]
        params, opt_state = opt.update(unflatten(ghat[:D]), state.opt_state,
                                       state.params, arm.lr)
        new_state = EngineState(params=params, opt_state=opt_state,
                                fade=fade, prev_beta=beta, decode_x0=x0,
                                residual=residual,
                                generator=state.generator,
                                sched_duals=sched_duals)
        budget = None
        if track_bound:
            budget = error_budget(cfg.const, D=D, S=s_eff, kappa=kappa_eff,
                                  beta=beta, k_weights=k_weights, b_t=b_t,
                                  noise_var=arm.noise_var)
        agg_err = None
        if probe:
            ideal = perfect_aggregate(dense, k_weights, beta)
            agg_err = torch.sum((ghat[:D] - ideal) ** 2)
        stats = RoundStats(n_scheduled=torch.sum(beta).to(torch.int32),
                           b_t=torch.as_tensor(b_t, dtype=torch.float32),
                           budget=budget, agg_err=agg_err)
        return new_state, stats

    def full_round(state: EngineState, arm: Arms, worker_data, k_weights, *,
                   fade_w: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None):
        """Fade draw + P2 + the round update. Returns (state', stats,
        {"h", "beta", "b_t"})."""
        h, fade = fade_step(state.fade, state.generator, fade_w)
        duals = None
        if cfg.aggregator == "perfect":
            beta, b_t = all_in, unit
        else:
            beta, b_t, duals = schedule(h, k_weights, arm.noise_var,
                                        arm.p_max, state.sched_duals)
        new_state, stats = round_given_schedule(
            state, arm, worker_data, k_weights, h, fade, beta, b_t, noise,
            duals)
        return new_state, stats, {"h": h, "beta": beta, "b_t": b_t}

    return EngineFns(init_state=init_state, fade_step=fade_step,
                     schedule=schedule,
                     round_given_schedule=round_given_schedule,
                     full_round=full_round, D=D, U=U)
