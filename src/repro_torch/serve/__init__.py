"""repro_torch.serve — the continuous fleet-scheduling service; port of
``repro.serve``.

A service loop over ``repro_torch.sched``: it ingests streaming per-cell
channel state (``sched/scenario.step_fades``), keeps a schedule cache
keyed on channel movement, re-solves only the dirty cells — compacted
into pow2 buckets (``sched/compaction.py``) and solved by the batched P2
solvers, ADMM with its multipliers warm-started — and serves (β, b_t, R_t)
for the whole fleet every tick. Two invariants hold it: at
``stale_threshold=0`` the cache equals a fresh full-fleet solve bit for
bit, and the dual warm start never changes β. ``python -m
repro_torch.serve`` runs it.
"""
from repro_torch.serve.service import (fresh_solve, ingest, init_service,
                                       movement, run_ticks, slo_summary,
                                       tick)
from repro_torch.serve.state import (SERVE_SCHEDULERS, ServeConfig,
                                     ServeState, TickStats)

__all__ = [
    "SERVE_SCHEDULERS", "ServeConfig", "ServeState", "TickStats",
    "fresh_solve", "ingest", "init_service", "movement", "run_ticks",
    "slo_summary", "tick",
]
