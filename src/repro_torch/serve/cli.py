"""Scheduling-service CLI: ``python -m repro_torch.serve``; port of
``repro/serve/cli.py``, with the reference's flags and ``--device``.

Runs the continuous fleet-scheduling loop over a synthetic Gauss-Markov
fleet and prints per-tick telemetry and the SLO summary. The service runs
on CUDA unless ``--device cpu`` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.sched.scenario import ScenarioConfig
from repro_torch.serve.service import init_service, run_ticks, slo_summary
from repro_torch.serve.state import SERVE_SCHEDULERS, ServeConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.serve",
        description="continuous fleet-scheduling service")
    p.add_argument("--cells", type=int, default=1024,
                   help="fleet size B (cells)")
    p.add_argument("--workers", type=int, default=16,
                   help="workers per cell U")
    p.add_argument("--ticks", type=int, default=20,
                   help="service ticks to run")
    p.add_argument("--threshold", type=float, default=0.05,
                   help="staleness threshold (relative channel movement)")
    p.add_argument("--scheduler", choices=SERVE_SCHEDULERS,
                   default="admm_batched")
    p.add_argument("--model", choices=("gauss_markov", "jakes", "iid"),
                   default="gauss_markov", help="fade model")
    p.add_argument("--corr", type=float, default=0.99,
                   help="Gauss-Markov fade correlation rho")
    p.add_argument("--update-frac", type=float, default=1.0,
                   help="fraction of cells reporting CSI per tick")
    p.add_argument("--no-warm-duals", action="store_true",
                   help="disable ADMM dual warm-starting")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA; 'cpu' runs the plain "
                        "PyTorch versions)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = ServeConfig(
        scenario=ScenarioConfig(cells=args.cells, workers=args.workers,
                                model=args.model, corr=args.corr),
        scheduler=args.scheduler, stale_threshold=args.threshold,
        warm_duals=not args.no_warm_duals, update_frac=args.update_frac)
    state = init_service(cfg, args.seed, device=args.device)
    print(f"serve: {args.cells} cells x {args.workers} workers, "
          f"{args.scheduler}, threshold={args.threshold}, "
          f"update_frac={args.update_frac}, device={state.beta.device}")
    state, stats, lat = run_ticks(cfg, state, args.ticks, timed=True)
    for s in stats:
        print(f"  tick {s.tick:4d}: reported={s.n_reported} "
              f"dirty={s.n_dirty} solved={s.n_solved} "
              f"hit_rate={s.hit_rate:.3f}")
    slo = slo_summary(stats, lat, args.cells)
    print(f"SLO: p50={slo['p50_ms']:.2f}ms p99={slo['p99_ms']:.2f}ms "
          f"hit_rate={slo['hit_rate']:.3f} "
          f"solved/s={slo['solved_per_s']:.0f} "
          f"served/s={slo['served_per_s']:.0f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
