"""Batched decode demo: the prompt stepped into the cache (KV rows, or
an SSM's recurrent state), then greedy or temperature decoding; port of
``repro/launch/decode_demo.py``.

    python -m repro_torch.launch.decode_demo --arch mamba2-2.7b --batch 4 \
        --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.decode_demo --device cpu \
        --smoke --arch deepseek-v2-lite-16b

The weights are random (seed 0) and f32; the model computes in its own
dtype. It runs on CUDA unless ``--device`` says otherwise; without a card
it raises rather than fall back to the CPU. ``repro_torch.launch.serve``
is the old name, kept as a deprecation shim.

Under ``torchrun`` the R ranks split the K/V cache over its length
(the (R, 1) mesh: each holds ``(P + gen) / R`` rows, the length rounded
up to a multiple of R; the attention's partial softmaxes are reduced over
the ranks), each rank runs the whole batch and the whole model, and rank
0 prints:

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.decode_demo --device cpu \
        --smoke

With ``--model-parallel M`` the R = W·M ranks form the (W, M) mesh
(``launch.mesh.world_mesh``): each model group of M ranks splits the
model (heads, hidden columns, vocabulary; ``models/tensor_parallel.py``),
each rank holding 1/M of every large weight, and every cache leaf lies
as ``launch.steps.cache_shardings`` gives it (the K/V length, or the
batch of the MLA and SSM state, over the W ranks of the data group);
the greedy pick runs over the split vocabulary:

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.decode_demo --device cpu \
        --smoke --model-parallel 2
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.dist import collectives as coll
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import join_world, leave_world
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.registry import Model, build_model


def generate(model: Model, params, prompts: torch.Tensor, gen: int, *,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None, mesh=None):
    """The reference demo's loop. prompts: (B, P) int32. The prompt is
    stepped into a fresh (P + gen)-long cache one token at a time, then
    ``gen`` tokens are drawn: the argmax, or with ``temperature > 0`` a
    draw from softmax(logits / temperature) with ``generator``. With a
    ``mesh`` the model is split over its model group (``params`` this
    rank's share) and the cache as ``cache_shardings`` lays it out (with
    M = 1 the K/V length over the data group), the length rounded up to
    a multiple of the data group's size. Returns (tokens (B, 1 + gen):
    the first prompt token and the drawn ones, seconds on the host clock,
    synchronised)."""
    B, P = prompts.shape
    total = P + gen
    R = 1 if mesh is None else mesh.shape.get("data", 1)
    dev = prompts.device
    decode = steps_lib.make_decode_step(model, mesh)
    cache = model.init_cache(B, -(-total // R) * R, dev, mesh=mesh)
    tok = prompts[:, :1]
    out = [tok]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for pos in range(total - 1):
        logits, cache = decode(params, cache, tok, pos)
        if pos + 1 < P:
            tok = prompts[:, pos + 1:pos + 2]
            continue
        last = logits[:, -1]
        if temperature > 0:
            probs = torch.softmax(
                tp.gather_logits(last, model.cfg, mesh) / temperature, -1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = tp.greedy(last, model.cfg, mesh)[:, None]
        tok = tok.to(torch.int32)
        out.append(tok)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return torch.cat(out, dim=1), time.perf_counter() - t0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch."
                                 "decode_demo")
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of --arch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="under torchrun: ranks a model group splits the "
                         "model over (the (world / M, M) mesh)")
    return ap


def _split_text(cfg, mesh, cache_len: int) -> str:
    W, M = mesh.shape["data"], mesh.shape["model"]
    if M == 1:
        return f", the K/V cache split over {W} ranks"
    from repro_torch.launch.steps import cache_shardings
    whole = build_model(cfg).init_cache(1, cache_len, "meta")
    specs = cache_shardings({k: (v.shape, v.dtype) for k, v in whole.items()},
                            mesh)
    return (f", the model split over {M} ranks x {W} data ranks ("
            + "; ".join(f"{k} {tuple(map(str, v))}" for k, v in
                        specs.items()) + ")")


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    mesh = None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        mesh, dev = join_world(args.device,
                               model_parallel=args.model_parallel)
    elif args.model_parallel != 1:
        raise SystemExit("--model-parallel needs torchrun (python -m "
                         "torch.distributed.run ...)")
    else:
        dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    B, P, G = args.batch, args.prompt_len, args.gen
    params = tp.init_params(model, 0, mesh, dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)).to(dev)
    generator = torch.Generator(device=dev).manual_seed(0)
    tokens, dt = generate(model, params, prompts, G,
                          temperature=args.temperature, generator=generator,
                          mesh=mesh)
    if mesh is None or coll.axis_index(mesh.world) == 0:
        W = 1 if mesh is None else mesh.shape["data"]
        split = ("" if mesh is None or mesh.world is None
                 else _split_text(cfg, mesh, -(-(P + G) // W) * W))
        print(f"{cfg.name} on {dev}: generated {G} tokens x batch {B} in "
              f"{dt:.2f}s ({B * G / dt:.1f} tok/s){split}")
        print("sample token ids:", tokens[0, :24].tolist())
    if mesh is not None:
        leave_world()


if __name__ == "__main__":
    main()
