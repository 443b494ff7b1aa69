"""K4: the BIHT/IHT back-projection update x' = x + τ · r Φ.

Port of ``repro/kernels/backproject.py`` (r (n, S), Φ (S, D), x (n, D)).
The packed-residual variant (``backproject_packed``, K6) is not ported
yet. The CUDA kernel is ``csrc/backproject.cu``; ``backproject_plain`` is
the PyTorch version the CPU runs and the card checks against.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def backproject_plain(x: torch.Tensor, resid: torch.Tensor,
                      phi: torch.Tensor, tau: float) -> torch.Tensor:
    return (x.to(torch.float32)
            + tau * (resid.to(torch.float32) @ phi.to(torch.float32))
            ).to(x.dtype)


def backproject(x: torch.Tensor, resid: torch.Tensor, phi: torch.Tensor,
                tau: float) -> torch.Tensor:
    """x + tau * resid @ phi. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel."""
    n, d = x.shape
    s = phi.shape[0]
    if tuple(resid.shape) != (n, s) or tuple(phi.shape) != (s, d):
        raise ValueError(f"backproject: resid {tuple(resid.shape)} / phi "
                         f"{tuple(phi.shape)} inconsistent with x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return backproject_plain(x, resid, phi, tau)
    build.require(x, "x", (n, d))
    build.require(resid, "resid", (n, s), device=x.device)
    build.require(phi, "phi", (s, d), device=x.device)
    out = torch.empty_like(x)
    if n == 0:
        return out
    rc = build.lib().backproject_f32(
        x.data_ptr(), resid.data_ptr(), phi.data_ptr(), out.data_ptr(), n,
        s, d, float(tau), build.stream_ptr(x))
    build.check(rc, "backproject")
    build.count("backproject")
    return out
