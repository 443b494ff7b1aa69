"""The continuous scheduling service loop; port of
``repro/serve/service.py``.

One tick = ingestion → dirty set → compaction → solve → cache:

1. **Ingest.** Advance the fleet's Gauss-Markov fades one round
   (``sched/scenario.step_fades``) and deliver CSI reports for an
   ``update_frac`` share of the cells; ``ingest`` takes out-of-band pushes.
2. **Dirty set.** A cell is dirty when its worst-worker relative channel
   movement since its last solve exceeds ``stale_threshold``. Cells
   without a new report moved exactly 0 and stay cached, so at threshold
   0 the cache serves exactly what a fresh solve of the current channels
   gives (``fresh_solve``). ``movement`` is read on the host: the dirty
   set picks the bucket's size.
3. **Compact + solve.** The dirty cells are padded into a pow2 bucket
   (``sched/compaction.py``) and solved by the fleet solver: the greedy
   prefix sweep, always through the prefix_eval kernel (K7, which takes
   its plain version only on CPU tensors), or Algorithm 2, seeded with
   each cell's previous exit multipliers (β unchanged bit for bit).
4. **Cache.** The results scatter back beside the channels they were
   solved for; the exit multipliers ride along for the next warm start.

Draws come from the fade state's ``torch.Generator``: the initial fade,
the large-scale gain's draws (when shadowing or a disk layout is on),
then each tick the fade innovation and, when ``update_frac < 1``, the
report mask. The reference keys them by ``fold_in``; ``init_service``
(``g0=``) and ``tick`` (``w=``, ``report=``) take them instead, which is
how tests feed both packages the same numbers.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sched.admm import AdmmDuals, admm_solve_batched
from repro_torch.sched.compaction import pad_to_bucket, take
from repro_torch.sched.greedy import greedy_solve_batched
from repro_torch.sched.problem import BatchedProblem
from repro_torch.sched.scenario import (init_fades, large_scale_gain,
                                        magnitudes, step_fades)
from repro_torch.serve.state import ServeConfig, ServeState, TickStats


def _problem(cfg: ServeConfig, h: torch.Tensor) -> BatchedProblem:
    return BatchedProblem.from_arrays(
        h, cfg.k_weights, cfg.p_max, cfg.noise_var, D=cfg.D, S=cfg.S,
        kappa=cfg.kappa, const=cfg.const)


def init_service(cfg: ServeConfig,
                 generator: Union[int, torch.Generator] = 0, *,
                 device=None, g0: Optional[torch.Tensor] = None
                 ) -> ServeState:
    """Fresh service state on ``device`` (``None`` = CUDA): stationary
    fades, static large-scale gains and an empty cache. ``generator`` is
    a seed or a ``torch.Generator`` on that device. ``h_solved`` starts
    at zero, so every cell is dirty on the first tick."""
    if isinstance(generator, torch.Generator):
        dev = generator.device if device is None else resolve_device(device)
    else:
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    fades = init_fades(cfg.scenario, generator, g0=g0, device=dev)
    gain = large_scale_gain(cfg.scenario, generator, device=dev)
    cells, U = gain.shape
    z = torch.zeros((cells, U), dtype=torch.float32, device=dev)
    return ServeState(
        fades=fades, gain=gain,
        h_seen=magnitudes(fades, gain, cfg.scenario.h_min),
        h_solved=z, beta=z.clone(),
        b_t=torch.zeros((cells,), dtype=torch.float32, device=dev),
        rt=torch.zeros((cells,), dtype=torch.float32, device=dev),
        duals=AdmmDuals.zeros((cells, U), device=dev) if cfg.warm else None,
        tick=0)


def movement(cfg: ServeConfig, state: ServeState) -> np.ndarray:
    """(cells,) worst-worker relative channel movement since each cell's
    last solve, max_i |h_seen − h_solved| / max(h_solved, h_min), read to
    the host. Exactly 0 for cells whose CSI has not changed."""
    rel = torch.abs(state.h_seen - state.h_solved) / torch.clamp(
        state.h_solved, min=cfg.scenario.h_min)
    return torch.amax(rel, dim=-1).cpu().numpy()


def ingest(state: ServeState, cell_ids: Sequence[int],
           h) -> ServeState:
    """Out-of-band CSI push: record measured channel magnitudes for
    ``cell_ids``. They become dirty on the next tick through the ordinary
    movement metric."""
    dev = state.h_seen.device
    ids = torch.as_tensor(np.asarray(cell_ids, np.int64), device=dev)
    h = torch.as_tensor(h, dtype=torch.float32, device=dev)
    return state._replace(h_seen=state.h_seen.index_copy(0, ids, h))


def _solve_dirty(cfg: ServeConfig, state: ServeState,
                 dirty: np.ndarray) -> Tuple[ServeState, int, float]:
    """Compact the dirty cells into a pow2 bucket, solve, scatter back.
    Returns (state', bucket size, mean ADMM iters). Pad lanes repeat the
    first dirty cell; the solvers are deterministic, so every duplicate
    writes the same value."""
    pad, _ = pad_to_bucket(dirty, cfg.min_bucket)
    idx = torch.as_tensor(pad, device=state.h_seen.device)
    h_sub = state.h_seen[idx]
    prob = _problem(cfg, h_sub)
    mean_iters = float("nan")
    duals = state.duals
    if cfg.scheduler == "greedy_batched":
        beta_s, bt_s, rt_s = greedy_solve_batched(prob, cfg.solver)
    else:
        duals_in = take(duals, idx) if cfg.warm else None
        beta_s, bt_s, rt_s, info = admm_solve_batched(
            prob, cfg.solver, duals=duals_in, return_duals=True)
        mean_iters = float(info.iters.to(torch.float32).mean())
        if cfg.warm:
            duals = AdmmDuals(*(leaf.index_copy(0, idx, new) for leaf, new
                                in zip(duals, info.duals)))
    state = state._replace(
        h_solved=state.h_solved.index_copy(0, idx, h_sub),
        beta=state.beta.index_copy(0, idx, beta_s),
        b_t=state.b_t.index_copy(0, idx, bt_s),
        rt=state.rt.index_copy(0, idx, rt_s),
        duals=duals)
    return state, len(pad), mean_iters


def tick(cfg: ServeConfig, state: ServeState, *,
         w: Optional[torch.Tensor] = None,
         report: Optional[torch.Tensor] = None
         ) -> Tuple[ServeState, TickStats]:
    """One tick: fade step → CSI reports → dirty set → bucketed solve →
    cache update. ``w`` ((cells, U) complex) replaces the fade innovation
    and ``report`` ((cells,) bool) the report mask."""
    cells = state.gain.shape[0]
    fades = step_fades(cfg.scenario, state.fades, w)
    h_now = magnitudes(fades, state.gain, cfg.scenario.h_min)
    if cfg.update_frac >= 1.0:
        n_reported, h_seen = cells, h_now
    else:
        if report is None:
            report = torch.rand((cells,), generator=fades.generator,
                                device=h_now.device) < cfg.update_frac
        report = report.to(h_now.device)
        n_reported = int(torch.sum(report))
        h_seen = torch.where(report[:, None], h_now, state.h_seen)
    state = state._replace(fades=fades, h_seen=h_seen)

    dirty = np.flatnonzero(movement(cfg, state) > cfg.stale_threshold)
    n_solved, mean_iters = 0, float("nan")
    if dirty.size:
        state, n_solved, mean_iters = _solve_dirty(cfg, state, dirty)
    stats = TickStats(tick=state.tick, n_reported=n_reported,
                      n_dirty=int(dirty.size), n_solved=n_solved,
                      hit_rate=1.0 - dirty.size / cells,
                      mean_iters=mean_iters)
    return state._replace(tick=state.tick + 1), stats


def fresh_solve(cfg: ServeConfig, state: ServeState
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cold full-fleet solve of the current ``h_seen``: the oracle the
    cache is held to. At ``stale_threshold=0`` the served (β, b_t, R_t)
    equal it bit for bit (both solvers give each lane the same bits in
    any batch)."""
    prob = _problem(cfg, state.h_seen)
    if cfg.scheduler == "greedy_batched":
        return greedy_solve_batched(prob, cfg.solver)
    return admm_solve_batched(prob, cfg.solver)


def run_ticks(cfg: ServeConfig, state: ServeState, n: int,
              timed: bool = False
              ) -> Tuple[ServeState, List[TickStats], List[float]]:
    """Drive ``n`` ticks; with ``timed`` each tick is wall-clocked to a
    device synchronise (the latency samples of ``slo_summary``)."""
    stats: List[TickStats] = []
    lat: List[float] = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, ts = tick(cfg, state)
        if timed:
            if state.beta.is_cuda:
                torch.cuda.synchronize(state.beta.device)
            lat.append(time.perf_counter() - t0)
        stats.append(ts)
    return state, stats, lat


def slo_summary(stats: Sequence[TickStats], lat: Sequence[float],
                cells: int) -> dict:
    """SLO aggregates of a timed run: p50/p99/mean tick latency, cache-hit
    rate, and throughput as schedules solved per second and as cells
    served per second (solved + cache hits)."""
    lat = np.asarray(lat, np.float64)
    total = lat.sum()
    solved = sum(s.n_dirty for s in stats)
    return {
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "mean_ms": float(lat.mean() * 1e3),
        "hit_rate": float(np.mean([s.hit_rate for s in stats])),
        "solved_per_s": float(solved / total) if total else float("nan"),
        "served_per_s": float(len(stats) * cells / total)
        if total else float("nan"),
    }
