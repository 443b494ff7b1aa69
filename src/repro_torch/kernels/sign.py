"""Canonical 1-bit sign convention + the 32-per-word packed codec.

Port of ``repro/kernels/sign.py``; bit-exact with it:

- ``sign_pm1`` maps 0 (and -0.0) to +1 through the ``x >= 0`` predicate
  (paper eq. 7/11: every transmitted symbol is ±1, never 0).
- 32 signs per word along the last axis, LSB-first: lane ``32j + b`` is
  bit ``b`` of word ``j``; bit = 1 ⇔ the pre-sign value was >= 0.

torch has thin uint32 coverage, so a packed word is an ``int32`` tensor
holding the uint32 bit pattern; compare words through
``numpy .view(np.uint32)``.
"""
from __future__ import annotations

import torch

PACK = 32  # signs per packed word


def sign_pm1(x: torch.Tensor) -> torch.Tensor:
    """Strict ±1 sign, sign(0) := +1 (paper eq. 7/11). Never returns 0."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x >= 0, one, -one)


def packed_width(n_lanes: int) -> int:
    """Words needed for ``n_lanes`` signs (must divide exactly)."""
    if n_lanes % PACK:
        raise ValueError(
            f"packed codec needs the sign axis to be a multiple of "
            f"{PACK}; got {n_lanes}")
    return n_lanes // PACK


def _shifts(device) -> torch.Tensor:
    return torch.arange(PACK, dtype=torch.int64, device=device)


def pack_bool(bits: torch.Tensor) -> torch.Tensor:
    """(..., S) bool -> (..., S//32) int32 words (uint32 bit patterns)."""
    w = packed_width(bits.shape[-1])
    b = bits.reshape(bits.shape[:-1] + (w, PACK)).to(torch.int64)
    words = torch.sum(b << _shifts(bits.device), dim=-1)
    # wrap [2^31, 2^32) onto the int32 range: same 32 bits
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """(..., S) real -> (..., S//32) int32 words; bit = 1 ⇔ x >= 0.

    Exact on ±1 symbol arrays and equally valid on raw projections (the
    fused sign+pack of eq. 7): both reduce to the ``x >= 0`` predicate."""
    return pack_bool(x >= 0)


def unpack_bits(packed: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """(..., W) int32 words -> (..., W*32) {0, 1} in ``dtype``."""
    words = packed.to(torch.int64) & 0xFFFFFFFF
    bits = (words[..., None] >> _shifts(packed.device)) & 1
    return bits.reshape(packed.shape[:-1] + (-1,)).to(dtype)


def unpack_signs(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(..., W) int32 words -> (..., W*32) exact ±1 in ``dtype``: the same
    values ``sign_pm1`` produces, so downstream sums match the f32 path."""
    bits = unpack_bits(packed, torch.float32)
    return (2.0 * bits - 1.0).to(dtype)
