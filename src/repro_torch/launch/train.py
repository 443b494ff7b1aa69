"""The LM trainer; port of ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch gemma2-2b --steps 2
    python -m repro_torch.launch.train --arch mamba2-2.7b --agg mean
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
        --steps 2 --agg obcsaa --arch whisper-base

Every LM architecture in ``configs/`` trains: dense, MoE, SSM, hybrid,
VLM (behind stub image embeddings) and the audio encoder-decoder (on stub
frames). Each step takes the gradient of the LM loss on fixed synthetic
token streams and, under ``--agg obcsaa`` (the default), sends it through
the 1-bit CS uplink leaf by leaf and decodes it (``launch/steps.py``). It
runs on CUDA unless ``--device`` says otherwise; without a card it raises
rather than fall back to the CPU.

One process is one FL worker. Under ``torchrun`` the processes are the
workers of one federation, the global ``--batch`` split over them and the
MAC their all-reduce; rank 0 (the PS) prints and writes the checkpoints,
every rank restores them:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch internvl2-1b --steps 2
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
        --smoke --batch 4 --steps 2

The backend is NCCL when every rank has a card of its own and gloo when
ranks share a card or run on the CPU (``launch.mesh.choose_backend``).
``--check-replicas`` ends the run by checking that every rank holds the
same parameters bit for bit (rank 0's are broadcast to every rank: a
test of the federation, off by default).

``--scan-rounds N`` schedules the whole run's rounds in one batched P2
solve (``make_scheduled_round_span``, greedy) and advances N rounds a
call (``make_scan_train_step``), with a checkpoint at every chunk
boundary when ``--ckpt-dir`` is set.

With ``--model-parallel M`` the W·M ranks are the ``(W, M)`` mesh
(``launch.mesh.world_mesh``): rank d·M + m holds 1/M of every weight
that ``param_shardings`` splits (each drawn at init as the rank's share),
worker d's M ranks gather a layer's weights over their model group for
the forward and backward, and the update runs on the shares
(``launch.steps.make_train_step`` on the mesh's model group).
Checkpoints hold the whole leaves, so a run saved at one M resumes at
another:

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
        --smoke --model-parallel 2 --agg obcsaa --steps 2 --check-replicas

``--zoo-train`` trains through the chunked zoo round instead
(``engine/zoo_train.py``, ``run_zoo_train``): the master as the
flat-shard (n_chunks, D_c) tensor, every worker of the logical mesh
``make_host_mesh()`` (one card: 1 x 1) taking a real backward pass,
with ``--optimizer``, ``--error-feedback``, checkpoints with
``--resume``, real token shards with ``--data`` and an N-arm σ² × lr
sweep with ``--arms``:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --zoo-train --smoke --steps 2 --optimizer adam --error-feedback

Under ``torchrun`` ``--zoo-train`` runs one cell of the zoo a rank: the
W·M ranks are the ``(W, M)`` mesh, M = ``--model-parallel``, worker d
training on its own token stream (``make_zoo_batch``), its M ranks
splitting the model axis. Rank 0 prints and writes the checkpoints,
every rank restores its own rows; with ``--arms`` every rank runs every
arm on its rows:

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
        --zoo-train --model-parallel 2 --smoke --steps 2 --arms 3

``--serve`` hands the remaining arguments to the scheduling service
(``repro_torch.serve.cli``).
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import TrainConfig, get_config, get_smoke_config
from repro_torch.data.synthetic import token_stream
from repro_torch.device import resolve_device
from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import infer_param_specs, spec_bytes
from repro_torch.dist.shares import ModelAxis
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import (join_world, leave_world,
                                     make_host_mesh, make_zoo_mesh,
                                     num_workers)
from repro_torch.models.layers import init_cut
from repro_torch.models.registry import build_model


def make_batch(cfg, B, S, rng_seed=0, device=None):
    """Synthetic token streams; a VLM's stub image embeddings and an
    audio model's stub frames are the reference's constant 0.01 in bf16."""
    tokens, targets = token_stream(B, S, cfg.vocab_size, seed=rng_seed)
    dev = resolve_device(device)
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "targets": torch.from_numpy(targets).to(dev)}
    stub = {"vlm": ("image_embeds", cfg.num_image_tokens),
            "audio": ("frames", cfg.encoder_seq_len)}.get(cfg.family)
    if stub is not None:
        name, n = stub
        batch[name] = 0.01 * torch.ones((B, n, cfg.d_model),
                                        dtype=torch.bfloat16, device=dev)
    return batch


def make_zoo_batch(cfg, U, B, S, rng_seed=0, device=None):
    """(U, B, ...)-stacked per-worker batches for the zoo round: each of
    the mesh's U FL workers trains on its own token stream (seed
    ``rng_seed * 1000 + u``, as the reference)."""
    per = [make_batch(cfg, B, S, rng_seed=rng_seed * 1000 + u,
                      device=device) for u in range(U)]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}


def sweep_arms(tcfg, lr: float, A: int) -> dict:
    """``--arms A``: σ² from the config's up 100x and lr down 10x, each
    log-spaced over the A arms, P^Max the config's."""
    return {"noise_var": np.float32(tcfg.noise_var)
            * np.logspace(0, 2, A, dtype=np.float32),
            "p_max": np.full((A,), tcfg.p_max, np.float32),
            "lr": np.float32(lr) * np.logspace(0, -1, A, dtype=np.float32)}


def run_zoo_train(args, cfg, tcfg, model, mesh, device) -> int:
    """--zoo-train: real backward passes through the chunked
    (n_chunks, D_c) round (``engine.zoo_train``).

    The carry is the full ZooTrainState (master, optimizer moments, EF
    residuals), so --ckpt-dir/--resume continue bit for bit. With --data
    every round samples a fresh (U, B, S) batch from the token shards,
    keyed by the absolute round index (no iterator state). Over
    processes (``mesh.world``) each rank holds its own rows of the carry
    and rank 0 prints."""
    rank = coll.axis_index(mesh.world)

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    zr = steps_lib.make_zoo_train_round(model, tcfg, mesh, device=device,
                                        use_kernels=args.kernels)
    say(f"zoo-train: D={zr.D:,} n_chunks={zr.n_chunks} "
        f"({zr.n_model} model x {zr.U} workers x {zr.n_local} local), "
        f"optimizer={zr.optimizer_name} ef={zr.error_feedback} "
        f"remat={tcfg.remat_mode} on {device}")
    if mesh.world is not None:
        say(f"world: {zr.U} x {zr.n_model} ranks over "
            f"{dist.get_backend(mesh.world)}")
    master = zr.chunk_params(model.init(0, device=device))
    key, data_key = 1, 2
    shards = None
    if args.data:
        from repro_torch.data.tokens import TokenShards
        shards = TokenShards.open(args.data)
        say(f"data: {len(shards.names)} token shards, "
            f"{shards.total_tokens:,} tokens from {args.data}")

    def zoo_batch(t):
        if shards is not None:
            return zr.shard_batch(shards.sample_zoo_batch(
                data_key, t, zr.U, args.batch, args.seq))
        return make_zoo_batch(cfg, zr.U, args.batch, args.seq,
                              device=device)

    if args.arms > 1:
        A = args.arms
        arms = sweep_arms(tcfg, args.lr, A)
        states = zr.init_sweep_state(
            master[None].expand((A,) + tuple(master.shape)).clone())
        del master
        t_start = 0
        if args.resume:
            got = zr.restore_state(args.ckpt_dir, arms=A)
            if got is not None:
                states, t_start = got
                say(f"resumed sweep at round {t_start}")
        batch = zoo_batch(t_start)   # sweeps run one fixed batch
        t0 = time.perf_counter()
        states, stats = zr.run_sweep(states, batch, arms,
                                     args.steps - t_start, key=key,
                                     t0=t_start)
        dt = time.perf_counter() - t0
        losses = stats.loss                      # (rounds, A)
        for a in range(A):
            say(f"arm {a}: noise_var={arms['noise_var'][a]:.2e} "
                f"lr={arms['lr'][a]:.3f} "
                f"loss {losses[0, a]:.4f} -> {losses[-1, a]:.4f}")
        say(f"{A} arms x {args.steps - t_start} rounds ({dt:.2f}s)")
        if args.ckpt_dir:
            path = zr.save_state(args.ckpt_dir, args.steps, states,
                                 t_next=args.steps)
            say(f"saved checkpoint: {path}")
        return 0
    state = zr.init_state(master)
    t_start = 0
    if args.resume:
        got = zr.restore_state(args.ckpt_dir)
        if got is not None:
            state, t_start = got
            say(f"resumed zoo-train at round {t_start}")
    batch = None
    for t in range(t_start, args.steps):
        if shards is not None or batch is None:
            batch = zoo_batch(t)
        t0 = time.perf_counter()
        state, st = zr.round_train(state, batch, t, key, tcfg.noise_var,
                                   tcfg.p_max, args.lr)
        say(f"round {t:4d} loss={float(st.loss):.4f} "
            f"b_t={float(st.b_t):.4f} "
            f"({time.perf_counter() - t0:.2f}s)")
        if args.ckpt_dir and args.ckpt_every \
                and (t + 1) % args.ckpt_every == 0:
            zr.save_state(args.ckpt_dir, t + 1, state, t_next=t + 1)
    if args.ckpt_dir:
        path = zr.save_state(args.ckpt_dir, args.steps, state,
                             t_next=args.steps)
        say(f"saved checkpoint: {path}")
    return 0


def train_config(args) -> TrainConfig:
    """The TrainConfig of parsed CLI arguments."""
    return TrainConfig(aggregation=args.agg, optimizer=args.optimizer,
                       learning_rate=args.lr,
                       error_feedback=args.error_feedback,
                       cs_chunk=args.cs_chunk,
                       cs_measure=args.cs_measure, cs_topk=args.cs_topk,
                       biht_iters=10, cs_packed=args.zoo_train,
                       remat_policy=args.remat_policy)


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
    ap.add_argument("--zoo-train", action="store_true",
                    help="train through the chunked zoo round with real "
                         "backward passes (engine.zoo_train): the master "
                         "as the flat-shard (n_chunks, D_c) tensor, "
                         "gradients into the packed 1-bit uplink")
    ap.add_argument("--kernels", action="store_true",
                    help="with --zoo-train: compress and decode through the "
                         "CUDA kernels K1-K4 (OBCSAAConfig.use_kernels)")
    ap.add_argument("--arms", type=int, default=1,
                    help="with --zoo-train: an N-arm noise_var x lr grid "
                         "(ZooTrainRound.run_sweep)")
    ap.add_argument("--error-feedback", action="store_true",
                    help="per-worker EF residual over the 1-bit uplink; "
                         "needs --agg obcsaa")
    ap.add_argument("--data", default=None,
                    help="token-shard directory (data.tokens.TokenShards): "
                         "with --zoo-train each round samples a fresh "
                         "per-worker batch keyed by the absolute round "
                         "index; default: fixed synthetic streams")
    ap.add_argument("--scan-rounds", type=int, default=0,
                    help="advance N rounds a call, P2 scheduled for the "
                         "whole run in one batched greedy solve; "
                         "checkpoints at every chunk boundary")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="under torchrun: the model axis M of the (W, M) "
                         "mesh the W*M ranks form "
                         "(launch.mesh.world_mesh); each rank holds 1/M "
                         "of every split weight")
    ap.add_argument("--init-method", default="env://",
                    help="under torchrun: the process group's init method "
                         "(default env://, what torchrun sets; file://PATH "
                         "for a file store)")
    ap.add_argument("--check-replicas", action="store_true",
                    help="under torchrun, end by checking that the ranks of "
                         "each worker group hold the same parameters (with "
                         "--model-parallel: shares) bit for bit (broadcasts "
                         "every leaf from the group's rank 0)")
    return ap


def _wire(stats) -> str:
    """The collectives of one step: MB and ms by kind, then the calls."""
    kinds = sorted(stats["bytes"])
    return (", ".join(f"{k} {stats['bytes'][k] / 1e6:.1f} MB "
                      f"{stats['ms'].get(k, 0.0):.1f} ms" for k in kinds)
            + " (calls: " + ", ".join(f"{k} {stats['calls'][k]}"
                                      for k in kinds) + ")")


def _bytes(leaves) -> int:
    return sum(x.numel() * x.element_size() for x in leaves)


def train(args, cfg, tcfg, model, mesh, dev) -> int:
    """The stepped or ``--scan-rounds`` loop of one rank of ``mesh`` (one
    process; rank r of the mesh's worker group; or, with a model group,
    rank d·M + m: worker d's model shard m, holding its shares)."""
    group, split = mesh.group, mesh.model_group is not None
    U, rank = num_workers(mesh), coll.axis_index(mesh.world)
    M = mesh.shape.get("model", 1)

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    def save(step: int, params, opt_state) -> None:
        if split or rank == 0:
            path = steps_lib.save_train_state(
                args.ckpt_dir, step, params, opt_state, model=model,
                tcfg=tcfg, mesh=mesh if split else None)
            say(f"saved checkpoint: {path}")

    if args.batch % U:
        raise SystemExit(f"--batch {args.batch} does not split over {U} "
                         "workers")
    axis = ModelAxis(model.init(0, device="meta"), mesh)
    params = init_cut(model, 0, axis.cut, device=dev)
    opt_state = steps_lib.make_optimizer(tcfg).init(params)
    D = sum(math.prod(s) for s in axis.shapes)
    say(f"{cfg.name}: D={D:,} on {dev}, agg={args.agg}, "
        f"optimizer={args.optimizer}, remat={tcfg.remat_mode}")
    if split:
        say(f"world: {U} x {M} ranks over {dist.get_backend(mesh.world)} "
            f"(the model split over {M} ranks), batch {args.batch} = {U} x "
            f"{args.batch // U}")
    elif group is not None:
        say(f"world: {U} workers over {dist.get_backend(group)}, "
            f"batch {args.batch} = {U} x {args.batch // U}")
    t_start = 0
    if args.resume:
        restored = steps_lib.restore_train_state(args.ckpt_dir, model, tcfg,
                                                 dev, mesh=mesh)
        if restored is not None:
            params, opt_state, t_start = restored
            say(f"resumed from step {t_start}")
    batch = make_batch(cfg, args.batch, args.seq, device=dev)
    wire = mesh.world is not None
    if args.scan_rounds > 0:
        n = args.scan_rounds
        if t_start % n:
            raise SystemExit(
                f"--resume step {t_start} does not land on a --scan-rounds "
                f"{n} chunk boundary; rerun with the cadence the "
                f"checkpoints were saved with")
        span = steps_lib.make_scheduled_round_span(mesh, tcfg, D,
                                                   args.steps, device=dev)
        scan_steps = {}   # chunk length -> step (full + tail)
        for t0_round in range(0, args.steps, n):
            m = min(n, args.steps - t0_round)
            if t0_round + m <= t_start:
                continue
            if m not in scan_steps:
                scan_steps[m] = steps_lib.make_scan_train_step(
                    model, tcfg, mesh, m)
            ctxs = {k: v[t0_round:t0_round + m] for k, v in span.items()}
            coll.reset_counters()
            t0 = time.perf_counter()
            params, opt_state, metrics = scan_steps[m](params, opt_state,
                                                       batch, ctxs)
            loss = float(metrics["loss"][-1])
            dt = time.perf_counter() - t0
            beta = ctxs["beta"].to(torch.int32).tolist()
            say(f"rounds {t0_round:4d}..{t0_round + m - 1} loss={loss:.4f} "
                f"beta={beta} ({dt:.2f}s)"
                + (f" wire: {_wire(coll.stats())}" if wire else ""))
            if args.ckpt_dir:
                save(t0_round + m, params, opt_state)
    else:
        step = steps_lib.make_train_step(model, tcfg, mesh)
        for t in range(t_start, args.steps):
            ctx = steps_lib.default_round_ctx(seed=t, device=dev, mesh=mesh)
            coll.reset_counters()
            t0 = time.perf_counter()
            params, opt_state, metrics = step(params, opt_state, batch, ctx)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            say(f"step {t:4d} loss={loss:.4f} ({dt:.2f}s)"
                + (f" wire: {_wire(coll.stats())}" if wire else ""))
            if args.ckpt_dir and args.ckpt_every \
                    and (t + 1) % args.ckpt_every == 0:
                save(t + 1, params, opt_state)
        saved = args.ckpt_every and args.steps % args.ckpt_every == 0
        if args.ckpt_dir and not (saved and args.steps > t_start):
            save(args.steps, params, opt_state)
    if mesh.world is not None:
        if args.check_replicas:
            if not coll.replicated(tree.leaves(params), group):
                raise RuntimeError("the ranks' parameters differ after the "
                                   "run")
            say(f"replicas: parameter shares bit-identical on the {U} ranks "
                f"of each worker group" if split else
                f"replicas: parameters bit-identical on all {U} ranks")
        if split:
            _report_shares(say, model, tcfg, mesh, params, opt_state, dev)
        if dev.type == "cuda":
            peak = coll.all_gather(torch.tensor(
                [torch.cuda.max_memory_allocated(dev)], device=dev),
                mesh.world, tiled=True)
            say("peak memory by rank (GiB): " + ", ".join(
                f"{v / 2**30:.2f}" for v in peak.tolist()))
    return 0


def _report_shares(say, model, tcfg, mesh, params, opt_state, dev) -> None:
    """Each rank's parameter and optimizer bytes beside the product rule
    over ``param_shardings``' specs (the optimizer state's as the
    reference lays it out); raises where a rank's bytes differ."""
    pshapes = model.init(0, device="meta")
    oshapes = steps_lib.make_optimizer(tcfg).init(pshapes)
    want = [spec_bytes(x, infer_param_specs(x, mesh), mesh)
            for x in (pshapes, oshapes)]
    mine = torch.tensor([_bytes(tree.leaves(params)),
                         _bytes(tree.leaves(opt_state))], dtype=torch.int64,
                        device=dev)
    every = coll.all_gather(mine, mesh.world).tolist()
    say("shares by rank (MB): " + ", ".join(
        f"params {p / 1e6:.3f} optimizer {o / 1e6:.3f}" for p, o in every)
        + f"; the product rule over param_shardings: params "
        f"{want[0] / 1e6:.3f} optimizer {want[1] / 1e6:.3f}")
    if any([p, o] != want for p, o in every):
        raise RuntimeError(f"a rank's shares are not the product rule's "
                           f"bytes: {every} != {want}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--serve" in argv:
        from repro_torch.serve.cli import main as serve_main
        return serve_main([a for a in argv if a != "--serve"])
    args = build_parser().parse_args(argv)
    if args.resume and not args.ckpt_dir:
        raise SystemExit("--resume needs --ckpt-dir")
    under_torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if args.model_parallel != 1 and not under_torchrun:
        raise SystemExit("--model-parallel splits the model axis over the "
                         "ranks of torchrun's world: run it under torchrun")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = train_config(args)
    model = build_model(cfg)
    if under_torchrun:
        # a rank that raises exits without the closing barrier; torchrun
        # then stops the others
        mesh, dev = join_world(args.device,
                               model_parallel=args.model_parallel,
                               init_method=args.init_method)
        run = run_zoo_train if args.zoo_train else train
        code = run(args, cfg, tcfg, model, mesh, dev)
        leave_world()
        return code
    dev = resolve_device(args.device)
    if args.zoo_train:
        return run_zoo_train(args, cfg, tcfg, model, make_host_mesh(), dev)
    return train(args, cfg, tcfg, model, make_zoo_mesh(1, 1), dev)


if __name__ == "__main__":
    raise SystemExit(main())
