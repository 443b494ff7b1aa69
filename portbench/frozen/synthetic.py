"""Synthetic MNIST, frozen here so that the yardstick does not move when
the program's own generator (``repro_torch/data/synthetic.py``) does.

The per-class stroke templates are that generator's NumPy code, copied
unchanged: the same ten 28 x 28 images. The samples are drawn on the
device from a ``torch.Generator`` instead of NumPy on the host: the same
recipe (a template, rolled by -2..2 pixels on each axis, scaled by
U(0.8, 1.2), plus N(0, 0.15) pixel noise, clipped to [0, 1]), so a run's
set-up makes 32,000 samples in a few calls on the card.
"""
from __future__ import annotations

import numpy as np
import torch


def digit_template(c: int) -> np.ndarray:
    """Procedural stroke template of class ``c`` (deterministic)."""
    img = np.zeros((28, 28), np.float32)
    rng = np.random.default_rng(1000 + c)
    yy, xx = np.mgrid[0:28, 0:28]
    n_strokes = 2 + c % 3
    for s in range(n_strokes):
        cx, cy = rng.uniform(8, 20, 2)
        r = rng.uniform(4, 9)
        a0, a1 = sorted(rng.uniform(0, 2 * np.pi, 2))
        ang = np.arctan2(yy - cy, xx - cx)
        dist = np.hypot(yy - cy, xx - cx)
        arc = (np.abs(dist - r) < 1.6) & (ang > a0) & (ang < a1)
        img[arc] = 1.0
        if c % 2 == s % 2:  # add a bar
            x0 = int(rng.uniform(6, 18))
            img[6:22, x0:x0 + 2] = np.maximum(img[6:22, x0:x0 + 2], 0.9)
    return img / max(img.max(), 1e-6)


def templates(device) -> torch.Tensor:
    """The ten templates, (10, 28, 28) f32 on ``device``."""
    return torch.from_numpy(np.stack([digit_template(c)
                                      for c in range(10)])).to(device)


def samples(n: int, generator: torch.Generator, device):
    """(x (n, 784) f32 in [0, 1], y (n,) int64) drawn on ``device``."""
    t = templates(device)
    y = torch.randint(0, 10, (n,), generator=generator, device=device)
    shift = torch.randint(-2, 3, (n, 2), generator=generator, device=device)
    noise = torch.randn((n, 28, 28), generator=generator, device=device)
    scale = torch.rand((n,), generator=generator, device=device)
    scale = 0.8 + 0.4 * scale
    ar = torch.arange(28, device=device)
    # np.roll(x, s, axis): out[i] = x[(i - s) mod 28]
    rows = (ar[None, :] - shift[:, :1]) % 28            # (n, 28)
    cols = (ar[None, :] - shift[:, 1:]) % 28
    img = t[y]                                          # (n, 28, 28)
    img = torch.gather(img, 1, rows[:, :, None].expand(n, 28, 28))
    img = torch.gather(img, 2, cols[:, None, :].expand(n, 28, 28))
    x = torch.clamp(img * scale[:, None, None] + 0.15 * noise, 0.0, 1.0)
    return x.reshape(n, 784), y
