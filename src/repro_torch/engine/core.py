"""The round body: eq. (3)–(14); port of ``repro/engine/core.py``.

``build_engine`` closes an ``FLConfig`` + task (loss_fn, optimizer, D, U)
over the round functions, as the reference does:

- ``fade_step``            Gauss-Markov block-fading draw (core/channel.py)
- ``schedule``             P2 for one round's channels as a B = 1
                           ``BatchedProblem``: ``all`` (β = 1, b_t =
                           min_i h_i √P^Max / K_i) or ``greedy_batched``
                           (the prefix sweep, sched/greedy.py)
- ``round_given_schedule`` local gradients (eq. 3), compress + MAC +
                           decode (eq. 6-13) or the perfect mean, and the
                           SGD update (eq. 14)
- ``full_round``           fade draw + schedule + the round

PyTorch runs eagerly, so there is no scan: ``fl/rounds.py`` calls
``full_round`` once per round. Random draws come from one
``torch.Generator``, in order: the initial fade, then per round the fade
innovation and the receiver AWGN. Both draws can be passed in instead
(``fade_w=``, ``noise=``), which is how tests replay the reference's.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import channel as chan
from repro_torch.core.obcsaa import simulate_round
from repro_torch.core.sparsify import flatten_pytree
from repro_torch.engine.config import FLConfig
from repro_torch.engine.state import EngineState, RoundStats
from repro_torch.sched.greedy import greedy_solve_batched
from repro_torch.sched.problem import BatchedProblem


class EngineFns(NamedTuple):
    """The built round functions + static geometry."""
    init_state: Callable            # params -> EngineState
    fade_step: Callable             # (fade, w=None) -> (h, fade')
    schedule: Callable              # (h, k_weights) -> (β, b_t)
    round_given_schedule: Callable
    full_round: Callable            # (state, worker_data, k_weights, ...)
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


def build_engine(cfg: FLConfig, loss_fn: Callable, opt, D: int, U: int,
                 unflatten: Callable, *, phi: torch.Tensor,
                 generator: torch.Generator) -> EngineFns:
    """``phi`` is the (S_c, D_c) measurement matrix shared by the workers
    and the PS; ``generator`` draws the fades and the AWGN."""
    ob = cfg.obcsaa
    device = phi.device
    p_max = torch.tensor(ob.p_max, dtype=torch.float32, device=device)
    noise_var = torch.tensor(ob.noise_var, dtype=torch.float32,
                             device=device)

    def init_state(params) -> EngineState:
        _, fade0 = chan.draw_fades(generator, (U,), device=device)
        return EngineState(params=params, opt_state=opt.init(params),
                           fade=fade0,
                           prev_beta=-torch.ones((U,), device=device))

    def fade_step(fade, w: Optional[torch.Tensor] = None):
        return chan.draw_fades(generator, rho=cfg.channel_rho, prev=fade,
                               w=w)

    def schedule(h, k_weights):
        """P2 for one round's channels (B = 1) -> (β (U,), b_t)."""
        bp = BatchedProblem.from_arrays(
            h[None], k_weights[None], p_max, noise_var, D=D, S=ob.measure,
            kappa=ob.topk, const=cfg.const)
        if cfg.scheduler == "all":
            beta = torch.ones_like(bp.h)
            b_t = bp.optimal_bt(beta)
        else:   # greedy_batched (FLConfig admits no other)
            beta, b_t, _ = greedy_solve_batched(bp, cfg.sched_cfg)
        return beta[0], b_t[0]

    def round_given_schedule(state: EngineState, worker_data, k_weights,
                             h, fade, beta, b_t,
                             noise: Optional[torch.Tensor] = None):
        """Eq. 3 → 6-7 → 10 → 13 → 43 → 14 with the schedule decided."""
        grads = stacked_grads(loss_fn, state.params, worker_data)
        if cfg.aggregator == "perfect":
            ghat = perfect_aggregate(grads, k_weights, beta)
        else:
            ghat, _ = simulate_round(ob, grads, k_weights, beta, b_t, h,
                                     phi=phi, generator=generator,
                                     noise=noise)
        params, opt_state = opt.update(unflatten(ghat[:D]), state.opt_state,
                                       state.params, cfg.learning_rate)
        new_state = EngineState(params=params, opt_state=opt_state,
                                fade=fade, prev_beta=beta)
        stats = RoundStats(n_scheduled=torch.sum(beta).to(torch.int32),
                           b_t=torch.as_tensor(b_t, dtype=torch.float32))
        return new_state, stats

    def full_round(state: EngineState, worker_data, k_weights, *,
                   fade_w: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None):
        """Fade draw + P2 + the round update."""
        h, fade = fade_step(state.fade, fade_w)
        if cfg.aggregator == "perfect":
            beta = torch.ones((U,), device=device)
            b_t = torch.tensor(1.0, device=device)
        else:
            beta, b_t = schedule(h, k_weights)
        new_state, stats = round_given_schedule(
            state, worker_data, k_weights, h, fade, beta, b_t, noise)
        return new_state, stats, {"h": h, "beta": beta, "b_t": b_t}

    return EngineFns(init_state=init_state, fade_step=fade_step,
                     schedule=schedule,
                     round_given_schedule=round_given_schedule,
                     full_round=full_round, D=D, U=U)
