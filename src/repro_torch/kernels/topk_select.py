"""K1: per-row top-κ selection (the sparse_κ operator, eq. 6).

Port of ``repro/kernels/topk_select.py``: 32 rounds of bisection on the
per-row magnitude threshold, then select with ``hi`` and fall back to
``lo`` when ``hi`` keeps fewer than κ. Exact for rows with distinct
magnitudes; ties may admit more than κ entries; a row with fewer than κ
nonzeros selects the whole row (the ``lo`` fallback).
``topk_select_plain`` is that f32 op sequence in PyTorch, which the CPU
runs and the card checks against. The CUDA kernel,
``csrc/topk_select.cu``, reaches the same threshold bit for bit from the
(κ+1)-th and κ-th largest magnitudes (a radix select), which decide
every step of the bisection, and replays the 32 steps on scalars.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

N_BISECT = 32
MAX_D = 16384   # csrc/topk_select.cu: 32 values x 512 threads


def topk_select_plain(chunks: torch.Tensor, k: int):
    """(n, D) -> (masked values (n, D) same dtype, int8 mask (n, D))."""
    a = chunks.to(torch.float32).abs()
    amax = a.amax(dim=-1, keepdim=True)
    hi, lo = amax, torch.zeros_like(amax)
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        over = (a >= mid).sum(dim=-1, keepdim=True) > k
        lo = torch.where(over, mid, lo)
        hi = torch.where(over, hi, mid)
    mask = a >= torch.minimum(hi, amax)
    cnt_hi = mask.sum(dim=-1, keepdim=True)
    mask = torch.where(cnt_hi >= k, mask, a >= lo)
    return chunks * mask.to(chunks.dtype), mask.to(torch.int8)


def topk_select(chunks: torch.Tensor, k: int):
    """Per-row top-k by magnitude -> (values, int8 mask). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    if chunks.device.type == "cpu":
        return topk_select_plain(chunks, k)
    n, d = chunks.shape
    build.require(chunks, "chunks", (n, d))
    if d > MAX_D:
        raise ValueError(f"topk_select: the CUDA kernel holds a row in "
                         f"registers, D <= {MAX_D}; got D={d}")
    val = torch.empty_like(chunks)
    mask = chunks.new_empty((n, d), dtype=torch.int8)
    if n == 0:
        return val, mask
    rc = build.lib().topk_select_f32(
        chunks.data_ptr(), val.data_ptr(), mask.data_ptr(), n, d, int(k),
        build.stream_ptr(chunks))
    build.check(rc, "topk_select")
    build.count("topk_select")
    return val, mask
