"""The LM trainer on one card; port of ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch gemma2-2b --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
        --steps 2 --agg obcsaa

One card is one FL worker. Each step takes the gradient of the LM loss on
fixed synthetic token streams and, under ``--agg obcsaa`` (the default),
sends it through the 1-bit CS uplink leaf by leaf and decodes it
(``launch/steps.py``). It runs on CUDA unless ``--device`` says otherwise;
without a card it raises rather than fall back to the CPU.

``--serve`` hands the remaining arguments to the scheduling service
(``repro_torch.serve.cli``). ``--zoo-train``, ``--arms``,
``--scan-rounds``, ``--data`` and ``--error-feedback`` belong to later
slices and exit non-zero naming them.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import torch

from repro_torch import tree
from repro_torch.configs import TrainConfig, get_config, get_smoke_config
from repro_torch.data.synthetic import token_stream
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models.registry import build_model

# flag -> (argparse dest, the later slice that ports it)
LATER_FLAGS = {
    "--zoo-train": ("zoo_train", "engine/zoo_train.py with dist/flat_layout "
                    "and dist/sharding (ROADMAP.md Queue 1, item 4)"),
    "--arms": ("arms", "engine/zoo_train.py's sweep (ROADMAP.md Queue 1, "
               "item 4)"),
    "--error-feedback": ("error_feedback", "engine/zoo_train.py's EF "
                         "residuals (ROADMAP.md Queue 1, item 4)"),
    "--data": ("data", "data/tokens.py with engine/zoo.py (ROADMAP.md "
               "Queue 1, item 3)"),
    "--scan-rounds": ("scan_rounds", "the scheduled round contexts and "
                      "--scan-rounds (ROADMAP.md Queue 1, item 6)"),
}


def make_batch(cfg, B, S, rng_seed=0, device=None):
    tokens, targets = token_stream(B, S, cfg.vocab_size, seed=rng_seed)
    dev = resolve_device(device)
    return {"tokens": torch.from_numpy(tokens).to(dev),
            "targets": torch.from_numpy(targets).to(dev)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of --arch")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--agg", default="obcsaa", choices=["mean", "obcsaa"])
    ap.add_argument("--optimizer", default="sgd",
                    help="sgd | momentum | adam")
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--cs-chunk", type=int, default=1024)
    ap.add_argument("--cs-measure", type=int, default=256)
    ap.add_argument("--cs-topk", type=int, default=64)
    ap.add_argument("--remat-policy", default=None,
                    choices=["off", "full", "dots", "dots_no_batch"],
                    help="per-layer checkpoint policy "
                         "(TrainConfig.remat_policy; default full)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="also snapshot params+opt every N steps (0: only "
                         "the final step)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest step from --ckpt-dir and "
                         "continue; step t's draws come from seed t, so "
                         "the result matches an uninterrupted run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs there)")
    ap.add_argument("--zoo-train", action="store_true", default=None)
    ap.add_argument("--arms", type=int, default=None)
    ap.add_argument("--error-feedback", action="store_true", default=None)
    ap.add_argument("--data", default=None)
    ap.add_argument("--scan-rounds", type=int, default=None)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--serve" in argv:
        from repro_torch.serve.cli import main as serve_main
        return serve_main([a for a in argv if a != "--serve"])
    args = build_parser().parse_args(argv)
    for flag, (dest, where) in LATER_FLAGS.items():
        if getattr(args, dest) is not None:
            raise SystemExit(f"{flag} is not ported yet: it comes with "
                             f"{where}")
    if args.resume and not args.ckpt_dir:
        raise SystemExit("--resume needs --ckpt-dir")

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(aggregation=args.agg, optimizer=args.optimizer,
                       learning_rate=args.lr, cs_chunk=args.cs_chunk,
                       cs_measure=args.cs_measure, cs_topk=args.cs_topk,
                       biht_iters=10, remat_policy=args.remat_policy)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    opt_state = steps_lib.make_optimizer(tcfg).init(params)
    D = sum(p.numel() for p in tree.leaves(params))
    print(f"{cfg.name}: D={D:,} on {dev}, agg={args.agg}, "
          f"optimizer={args.optimizer}, remat={tcfg.remat_mode}",
          flush=True)
    t_start = 0
    if args.resume:
        restored = steps_lib.restore_train_state(args.ckpt_dir, model, tcfg,
                                                 dev)
        if restored is not None:
            params, opt_state, t_start = restored
            print(f"resumed from step {t_start}", flush=True)
    batch = make_batch(cfg, args.batch, args.seq, device=dev)
    step = steps_lib.make_train_step(model, tcfg)
    for t in range(t_start, args.steps):
        ctx = steps_lib.default_round_ctx(seed=t, device=dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch, ctx)
        loss = float(metrics["loss"])
        print(f"step {t:4d} loss={loss:.4f} "
              f"({time.perf_counter() - t0:.2f}s)", flush=True)
        if args.ckpt_dir and args.ckpt_every \
                and (t + 1) % args.ckpt_every == 0:
            steps_lib.save_train_state(args.ckpt_dir, t + 1, params,
                                       opt_state)
    if args.ckpt_dir:
        path = steps_lib.save_train_state(args.ckpt_dir, args.steps, params,
                                          opt_state)
        print(f"saved checkpoint: {path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
