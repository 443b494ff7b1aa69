"""1-bit quantization (paper eq. 7): C(g) = sign(Φ sparse_κ(g)).

Port of ``repro/core/quantize.py``: the sign predicate and the packed
codec live in ``repro_torch.kernels.sign`` and are re-exported here."""
from __future__ import annotations

from repro_torch.kernels.sign import (PACK, pack_signs, sign_pm1,  # noqa: F401
                                      unpack_signs)


def quantization_error_bound(S: int, D: int, kappa: int, G: float,
                             delta: float) -> float:
    """Paper eq. (42): E||e^q||² ≤ S + (1+δ)(D−κ)/D G²."""
    return S + (1.0 + delta) * (D - kappa) / D * G ** 2
