"""K4/K6: the BIHT/IHT back-projection update x' = x + τ · r Φ.

Port of ``repro/kernels/backproject.py`` (r (n, S), Φ (S, D), x (n, D)).
``backproject_packed`` (K6) takes the residual as the two int32 bit-planes
of ``cs_project(mode="pack_sign_residual")`` and unpacks them in-tile to
r = 2·(plus − minus) ∈ {−2, 0, +2}: exactly the f32 values of the BIHT
residual, summed in K4's order, so K6 equals K4 on that residual bit for
bit. The CUDA kernel is ``csrc/backproject.cu`` (one body for both
residual forms; up to 16 rows it takes D % 4 == 0 and 16-byte aligned
rows, and raises ``ValueError`` otherwise); ``backproject_plain`` and
``backproject_packed_plain`` are the PyTorch versions the CPU runs and
the card checks against.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sign import packed_width, unpack_bits


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
    if n <= 16:
        build.require_vec4("backproject", d, x, phi)
    out = torch.empty_like(x)
    if n == 0:
        return out
    rc = build.lib().backproject_f32(
        x.data_ptr(), resid.data_ptr(), phi.data_ptr(), out.data_ptr(), n,
        s, d, float(tau), build.stream_ptr(x))
    build.check(rc, "backproject")
    build.count("backproject")
    return out


def packed_residual(plus: torch.Tensor, minus: torch.Tensor) -> torch.Tensor:
    """The f32 residual 2·(plus − minus) of two int32 bit-planes."""
    return 2.0 * (unpack_bits(plus, torch.float32)
                  - unpack_bits(minus, torch.float32))


def backproject_packed_plain(x: torch.Tensor, plus: torch.Tensor,
                             minus: torch.Tensor, phi: torch.Tensor,
                             tau: float) -> torch.Tensor:
    return backproject_plain(x, packed_residual(plus, minus), phi, tau)


def backproject_packed(x: torch.Tensor, plus: torch.Tensor,
                       minus: torch.Tensor, phi: torch.Tensor,
                       tau: float) -> torch.Tensor:
    """x + tau * (2·(plus − minus)) @ phi; plus/minus int32 (n, S//32).
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
    n, d = x.shape
    s = phi.shape[0]
    w = packed_width(s)
    if (tuple(phi.shape) != (s, d) or tuple(plus.shape) != (n, w)
            or tuple(minus.shape) != (n, w) or plus.dtype != torch.int32
            or minus.dtype != torch.int32):
        raise ValueError(
            f"backproject_packed: bit-planes must be int32 (n, S//32) = "
            f"({n}, {w}) and phi (S, D) with x {tuple(x.shape)}; got "
            f"{plus.dtype} {tuple(plus.shape)} / {minus.dtype} "
            f"{tuple(minus.shape)}, phi {tuple(phi.shape)}")
    if x.device.type == "cpu":
        return backproject_packed_plain(x, plus, minus, phi, tau)
    build.require(x, "x", (n, d))
    for name, t in (("plus", plus), ("minus", minus)):
        build.require(t, name, (n, w), dtype=torch.int32, device=x.device)
    build.require(phi, "phi", (s, d), device=x.device)
    if n <= 16:
        build.require_vec4("backproject_packed", d, x, phi)
    out = torch.empty_like(x)
    if n == 0:
        return out
    rc = build.lib().backproject_packed_f32(
        x.data_ptr(), plus.data_ptr(), minus.data_ptr(), phi.data_ptr(),
        out.data_ptr(), n, s, d, float(tau), build.stream_ptr(x))
    build.check(rc, "backproject_packed")
    build.count("backproject_packed")
    return out
