"""K2/K3/K5: fused Φ-projection with a sign, pack or residual epilogue.

Port of ``repro/kernels/cs_project.py``. ``project(phi, chunks, mode)``
computes ``chunks @ Φᵀ`` (phi (S, D), chunks (n, D)) and applies:

- ``"none"``:          x Φᵀ                     (K2, plain projection)
- ``"sign"``:          sign(x Φᵀ)               (K2, eq. 7 compression)
- ``"pack"``:          pack32(sign(x Φᵀ))       (K2, int32 (n, S//32))
- ``"sign_residual"``: y − sign(x Φᵀ)           (K3, BIHT residual)
- ``"residual"``:      y − x Φᵀ                 (K3, IHT residual)
- ``"pack_sign_residual"``: the BIHT residual on packed ±1 ``y`` (int32
  (n, S//32)) as two bit-planes ``(plus, minus)``, plus = y ∧ ¬s and
  minus = s ∧ ¬y for the fresh signs s = [x Φᵀ ≥ 0], so that
  y − sign(x Φᵀ) = 2·(plus − minus)   (K5)

The CUDA kernel is ``csrc/cs_project.cu``: one accumulation for every
mode, so K5's fresh signs are K3's bit for bit. It takes D % 4 == 0 and
16-byte aligned rows, and raises ``ValueError`` otherwise. At n <= 16 its
blocks split D and meet through a buffer on the device, so two launches
on one device must not run at the same time. ``project_plain`` is the
PyTorch version the CPU runs and the card checks against.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sign import (pack_bool, packed_width, sign_pm1,
                                      unpack_bits)

MODES = ("none", "sign", "pack", "sign_residual", "residual",
         "pack_sign_residual")
_MODE_ID = {m: i for i, m in enumerate(MODES)}
_Y_MODES = ("sign_residual", "residual", "pack_sign_residual")


def _check_mode(mode: str, y) -> None:
    if mode not in MODES:
        raise ValueError(f"cs_project: unknown mode {mode!r}; one of "
                         f"{MODES}")
    if mode in _Y_MODES and y is None:
        raise ValueError(f"cs_project: mode {mode!r} needs y")


def _check_packed_y(y: torch.Tensor, n: int, s: int) -> None:
    w = packed_width(s)
    if y.dtype != torch.int32 or tuple(y.shape) != (n, w):
        raise ValueError(f"cs_project: pack_sign_residual needs packed y "
                         f"int32 (n, S//32) = ({n}, {w}); got {y.dtype} "
                         f"{tuple(y.shape)}")


def project_plain(phi: torch.Tensor, chunks: torch.Tensor, *,
                  mode: str = "sign", y: torch.Tensor = None):
    _check_mode(mode, y)
    acc = chunks.to(torch.float32) @ phi.to(torch.float32).T
    if mode == "pack":
        packed_width(acc.shape[-1])
        return pack_bool(acc >= 0)
    if mode == "pack_sign_residual":
        _check_packed_y(y, *acc.shape)
        sb = acc >= 0
        yb = unpack_bits(y, torch.bool)
        return pack_bool(yb & ~sb), pack_bool(sb & ~yb)
    if mode == "sign":
        out = sign_pm1(acc)
    elif mode == "sign_residual":
        out = y.to(torch.float32) - sign_pm1(acc)
    elif mode == "residual":
        out = y.to(torch.float32) - acc
    else:
        out = acc
    return out.to(chunks.dtype)


def project(phi: torch.Tensor, chunks: torch.Tensor, *, mode: str = "sign",
            y: torch.Tensor = None) -> torch.Tensor:
    """phi (S, D), chunks (n, D) -> (n, S) f32, or int32 (n, S//32) words
    for ``mode="pack"``, or the two int32 (n, S//32) planes ``(plus,
    minus)`` for ``mode="pack_sign_residual"``. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (K2 for
    none/sign/pack, K3 for the residual modes, K5 for the packed one)."""
    _check_mode(mode, y)
    if chunks.device.type == "cpu":
        return project_plain(phi, chunks, mode=mode, y=y)
    n, d = chunks.shape
    s = phi.shape[0]
    build.require(chunks, "chunks", (n, d))
    build.require(phi, "phi", (s, d), device=chunks.device)
    build.require_vec4("cs_project", d, chunks, phi)
    if mode == "pack_sign_residual":
        return _pack_sign_residual(phi, chunks, y, n, s, d)
    if mode == "pack":
        out = chunks.new_empty((n, packed_width(s)), dtype=torch.int32)
    else:
        out = chunks.new_empty((n, s))
    y_ptr = None
    if mode in _Y_MODES:
        build.require(y, "y", (n, s), device=chunks.device)
        y_ptr = y.data_ptr()
    if n == 0:
        return out
    rc = build.lib().cs_project_f32(
        chunks.data_ptr(), phi.data_ptr(), y_ptr, out.data_ptr(), n, s, d,
        _MODE_ID[mode], build.stream_ptr(chunks))
    build.check(rc, f"cs_project[{mode}]")
    build.count("cs_project_resid" if mode in _Y_MODES else "cs_project")
    return out


def _pack_sign_residual(phi, chunks, y, n, s, d):
    """K5 on the card: both planes in one (2, n, S//32) allocation."""
    w = packed_width(s)
    build.require(y, "y", (n, w), dtype=torch.int32, device=chunks.device)
    planes = chunks.new_empty((2, n, w), dtype=torch.int32)
    if n:
        rc = build.lib().cs_project_pack_resid_f32(
            chunks.data_ptr(), phi.data_ptr(), y.data_ptr(),
            planes.data_ptr(), n, s, d, build.stream_ptr(chunks))
        build.check(rc, "cs_project[pack_sign_residual]")
        build.count("cs_project_pack_resid")
    return planes[0], planes[1]
