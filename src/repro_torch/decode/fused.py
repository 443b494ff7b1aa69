"""The decode loops composed from the port's kernels; port of
``repro/decode/fused.py``.

``fused_iht``: fixed-step IHT on the real post-processed aggregate, each
iteration three launches:

  1. ``cs_project(mode="residual")`` (K3): r = ŷ − x Φᵀ
  2. ``backproject`` (K4): x' = x + τ r Φ
  3. ``topk_select`` (K1): x = η_κ(x'), the bisection threshold

``fused_biht_packed``: BIHT on packed ±1 measurements, each iteration

  1. ``cs_project(mode="pack_sign_residual")`` (K5): the fresh signs of
     x Φᵀ meet the packed y in-kernel and leave as two int32 bit-planes
  2. ``backproject_packed`` (K6): x' = x + (τ/S)·2·(plus − minus) Φ, the
     planes unpacked in-tile
  3. ``topk_select`` (K1): x = η_κ(x')

K5 accumulates as K3 does and K6 as K4 does, on the same {−2, 0, +2}
residual values, so the packed loop equals ``kernels.ops.biht`` on the
unpacked measurements bit for bit, on the card as on the CPU. On a CPU
tensor every wrapper runs its kernel's plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.cs_project import project
from repro_torch.kernels.sign import unpack_signs


def fused_iht(y: torch.Tensor, phi: torch.Tensor, k: int, iters: int = 10,
              tau: float = 1.0, x0=None) -> torch.Tensor:
    """IHT through K3 (residual epilogue), K4 and K1: y (n, S), phi (S, D)
    -> (n, D), the semantics of ``decode.iht.iht`` with the bisection hard
    threshold. ``x0`` warm-starts the iterate (zeros by default)."""
    x = (torch.zeros((y.shape[0], phi.shape[1]), dtype=y.dtype,
                     device=y.device)
         if x0 is None else x0.to(y.dtype).contiguous())
    for _ in range(iters):
        resid = project(phi, x, mode="residual", y=y)
        x = kops.backproject(x, resid, phi, tau)
        x, _ = kops.topk_select(x, k)
    return x


def fused_biht_packed(y_packed: torch.Tensor, phi: torch.Tensor, k: int,
                      iters: int = 30, tau: float = 1.0) -> torch.Tensor:
    """BIHT on packed ±1 measurements: y_packed int32 (n, S//32) words,
    phi (S, D) -> unit-norm (n, D), like ``kernels.ops.biht``. The one
    dense unpack is the x0 seed (K4 + K1), outside the loop."""
    s = phi.shape[0]
    y_f = unpack_signs(y_packed, phi.dtype)
    x0 = kops.backproject(phi.new_zeros((y_packed.shape[0], phi.shape[1])),
                          y_f, phi, 1.0 / s)
    x, _ = kops.topk_select(x0, k)
    for _ in range(iters):
        plus, minus = kops.cs_pack_sign_residual(phi, x, y_packed)
        x = kops.backproject_packed(x, plus, minus, phi, tau / s)
        x, _ = kops.topk_select(x, k)
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-12)
