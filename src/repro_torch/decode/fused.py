"""The packed 1-bit BIHT decode loop; port of ``fused_biht_packed`` from
``repro/decode/fused.py``. (The reference's ``fused_iht`` is the port's
``kernels.ops.iht``.)

Each iteration is three kernel launches:

  1. ``cs_project(mode="pack_sign_residual")`` (K5): the fresh signs of
     x Φᵀ meet the packed y in-kernel and leave as two int32 bit-planes
  2. ``backproject_packed`` (K6): x' = x + (τ/S)·2·(plus − minus) Φ, the
     planes unpacked in-tile
  3. ``topk_select`` (K1): x = η_κ(x')

K5 accumulates as K3 does and K6 as K4 does, on the same {−2, 0, +2}
residual values, so the loop equals ``kernels.ops.biht`` on the unpacked
measurements bit for bit, on the card as on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.sign import unpack_signs


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
