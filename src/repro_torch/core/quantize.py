"""1-bit quantization (paper eq. 7): C(g) = sign(Φ sparse_κ(g)).

Port of ``repro/core/quantize.py``: the sign predicate and the packed
codec live in ``repro_torch.kernels.sign`` and are re-exported here;
``pack_bits`` / ``unpack_bits`` are the uint8 codec of the digital
fallback (8 symbols a byte, bit = 1 ⇔ symbol > 0)."""
from __future__ import annotations

import torch

from repro_torch.kernels.sign import (PACK, pack_signs, sign_pm1,  # noqa: F401
                                      unpack_signs)


def quantization_error_bound(S: int, D: int, kappa: int, G: float,
                             delta: float) -> float:
    """Paper eq. (42): E||e^q||² ≤ S + (1+δ)(D−κ)/D G²."""
    return S + (1.0 + delta) * (D - kappa) / D * G ** 2


def pack_bits(signs: torch.Tensor) -> torch.Tensor:
    """Pack ±1 float symbols to uint8 bitmaps (8x wire-size reduction for
    the digital-fallback path; the analog path transmits symbols
    directly). The symbol count must be a multiple of 8."""
    bits = (signs > 0).to(torch.int64).reshape(-1, 8)
    shifts = torch.arange(8, dtype=torch.int64, device=signs.device)
    return torch.sum(bits << shifts, dim=1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``pack_bits``: uint8 bitmaps back to the first ``n``
    ±1 f32 symbols (eq. 7)."""
    shifts = torch.arange(8, dtype=torch.int64, device=packed.device)
    bits = (packed.to(torch.int64)[:, None] >> shifts) & 1
    return (bits.to(torch.float32) * 2.0 - 1.0).reshape(-1)[:n]
