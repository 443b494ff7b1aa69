"""Batched decode demo: the prompt stepped into the KV cache, then greedy
or temperature decoding; port of ``repro/launch/decode_demo.py``.

    python -m repro_torch.launch.decode_demo --arch gemma2-2b --batch 4 \
        --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.decode_demo --device cpu \
        --smoke --arch deepseek-v2-lite-16b

The weights are random (seed 0) and f32; the model computes in its own
dtype. It runs on CUDA unless ``--device`` says otherwise; without a card
it raises rather than fall back to the CPU. ``repro_torch.launch.serve``
is the old name, kept as a deprecation shim.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models.registry import Model, build_model


def generate(model: Model, params, prompts: torch.Tensor, gen: int, *,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None):
    """The reference demo's loop. prompts: (B, P) int32. The prompt is
    stepped into a fresh (P + gen)-long cache one token at a time, then
    ``gen`` tokens are drawn: the argmax, or with ``temperature > 0`` a
    draw from softmax(logits / temperature) with ``generator``. Returns
    (tokens (B, 1 + gen): the first prompt token and the drawn ones,
    seconds on the host clock, synchronised)."""
    B, P = prompts.shape
    total = P + gen
    dev = prompts.device
    decode = steps_lib.make_decode_step(model)
    cache = model.init_cache(B, total, dev)
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
            probs = torch.softmax(last / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = torch.argmax(last, dim=-1)[:, None]
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
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    B, P, G = args.batch, args.prompt_len, args.gen
    params = model.init(0, device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)).to(dev)
    generator = torch.Generator(device=dev).manual_seed(0)
    tokens, dt = generate(model, params, prompts, G,
                          temperature=args.temperature, generator=generator)
    print(f"{cfg.name} on {dev}: generated {G} tokens x batch {B} in "
          f"{dt:.2f}s ({B * G / dt:.1f} tok/s)")
    print("sample token ids:", tokens[0, :24].tolist())


if __name__ == "__main__":
    main()
