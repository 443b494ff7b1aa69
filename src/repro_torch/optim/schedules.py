"""Learning-rate schedules on tensors; port of ``repro/optim/schedules.py``.
``step`` may be a Python number or a tensor; the result is an f32 tensor
on ``step``'s device."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.full_like(_f32(step), lr)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_f32(step) / max(1, total_steps), 0.0, 1.0)
        return lr * (final_frac + (1 - final_frac)
                     * 0.5 * (1 + torch.cos(math.pi * t)))

    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_decay(lr, total_steps - warmup, final_frac)

    def f(step):
        s = _f32(step)
        w = torch.clamp(s / max(1, warmup), 0.0, 1.0)
        return torch.where(s < warmup, lr * w, cos(s - warmup))

    return f
