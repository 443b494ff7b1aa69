"""Round carry, per-round stats, sweep arms and the sweep checkpoint;
port of ``repro/engine/state.py``.

``Arms`` holds the per-arm sweep axes, the quantities an experiment grid
varies without rebuilding the engine: a seed, σ², P^Max and the learning
rate. Where the reference holds a threefry key, a port arm holds the seed
of its ``torch.Generator``; its draws are in the carry (``EngineState.
generator``), in the order initial fade, then per round the fade
innovation and the receiver AWGN. Static axes (κ, S, aggregator,
scheduler) live in ``FLConfig``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch


class EngineState(NamedTuple):
    """What one round hands to the next."""
    params: Any                    # dict of tensors
    opt_state: Any                 # optimizer state
    fade: torch.Tensor             # (U,) complex64 Gauss-Markov state
    prev_beta: torch.Tensor        # (U,) f32; -1 before round 0
    decode_x0: Optional[torch.Tensor]   # (n_chunks, D_c) warm start | None
    residual: Optional[torch.Tensor]    # (U, D) EF residuals | None
    generator: torch.Generator     # the arm's fade and AWGN draws
    # the ADMM multipliers of the last schedule, a (U,)-leaf AdmmDuals
    # that seeds the next round's solve (FLConfig.sched_warm_duals) | None
    sched_duals: Any = None


def with_generator_state(state: EngineState) -> EngineState:
    """The carry with its generator replaced by the generator's state (a
    uint8 tensor), so that every leaf is a tensor: what a checkpoint
    stores and what "bit for bit the same carry" compares."""
    return state._replace(generator=state.generator.get_state())


class RoundStats(NamedTuple):
    """Per-round scheduling and theory stats. ``budget`` is the predicted
    Theorem-1 ``ErrorBudget`` at the round's (β, b_t, σ²), ``None`` unless
    the aggregator is ``obcsaa`` (the pipeline eq. 19 models); ``agg_err``
    is the measured ‖ĝ−ḡ‖², ``None`` unless ``FLConfig.probe_agg_error``.
    Fields are 0-d for one round and (n,) for a chunk of n rounds."""
    n_scheduled: torch.Tensor      # int32: Σβ_t
    b_t: torch.Tensor              # f32: power scaling factor
    budget: Any = None             # ErrorBudget | None
    agg_err: Optional[torch.Tensor] = None   # f32 | None


class SweepCheckpoint(NamedTuple):
    """What ``run_sweep`` needs to continue bit for bit after a restart:
    the carry of every arm stacked (A, ...) — parameters, optimizer state,
    fade, previous β, decoder warm start, EF residuals, ADMM multipliers —
    with each arm's ``torch.Generator`` state as a uint8 leaf (A, n) in
    the place of the generator, the ``Arms`` it was advanced under, and
    ``t_next``, the first round not yet run. The reference folds its keys
    on the absolute round and saves no RNG state; the port's draws come
    from the generators, so their states are part of the carry."""
    state: Any                     # EngineState, (A, ...)-stacked
    arms: Any                      # Arms the carry was advanced under
    t_next: torch.Tensor           # int32 0-d: first round not run


class Arms(NamedTuple):
    """Per-arm sweep axes: 0-d tensors for one arm, (A,) for a sweep."""
    seed: torch.Tensor             # int64: seeds the arm's torch.Generator
    noise_var: torch.Tensor        # f32 σ² (mW)
    p_max: torch.Tensor            # f32 P^Max (mW)
    lr: torch.Tensor               # f32 learning rate α


def single_arm(cfg) -> Arms:
    """The one arm an ``FLConfig`` implies: its seed, the OBCSAA noise and
    power, and the learning rate."""
    f32 = torch.float32
    return Arms(seed=torch.tensor(cfg.seed, dtype=torch.int64),
                noise_var=torch.tensor(cfg.obcsaa.noise_var, dtype=f32),
                p_max=torch.tensor(cfg.obcsaa.p_max, dtype=f32),
                lr=torch.tensor(cfg.learning_rate, dtype=f32))


def make_arms(cfg, *, seeds=None, noise_var=None, p_max=None,
              lr=None) -> Arms:
    """Broadcast sweep axes to a common arm count A.

    Every argument takes a scalar or a sequence; unset axes default to the
    ``FLConfig`` values. At least one axis must be a sequence (that fixes
    A), and every sequence has length 1 or A."""
    axes = {"seeds": seeds, "noise_var": noise_var, "p_max": p_max,
            "lr": lr}
    lengths = [len(v) for v in axes.values()
               if v is not None and np.ndim(v) > 0]
    if not lengths:
        raise ValueError("make_arms needs at least one sequence axis "
                         "(seeds / noise_var / p_max / lr)")
    A = max(lengths)
    for name, v in axes.items():
        if v is not None and np.ndim(v) > 0 and len(v) not in (1, A):
            raise ValueError(f"arms axis {name!r} has length {len(v)}, "
                             f"expected 1 or {A}")

    def bcast(v, default, dtype):
        v = default if v is None else v
        return torch.from_numpy(np.broadcast_to(
            np.asarray(v, dtype).reshape(-1), (A,)).copy())

    return Arms(seed=bcast(seeds, cfg.seed, np.int64),
                noise_var=bcast(noise_var, cfg.obcsaa.noise_var, np.float32),
                p_max=bcast(p_max, cfg.obcsaa.p_max, np.float32),
                lr=bcast(lr, cfg.learning_rate, np.float32))


def n_arms(arms: Arms) -> int:
    return int(arms.noise_var.shape[0]) if arms.noise_var.ndim else 1


def arm_at(arms: Arms, a: int) -> Arms:
    """Arm ``a`` of a sweep, as 0-d fields."""
    return Arms(*(x[a] for x in arms))
