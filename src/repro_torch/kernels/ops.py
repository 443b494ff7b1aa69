"""Public wrappers for the port's kernels, and the BIHT loop composed from
them (the IHT and packed loops are ``decode/fused.py``).

Port of ``repro/kernels/ops.py``. Every wrapper dispatches on the device of
its input: a CPU tensor runs the kernel's plain PyTorch version, a CUDA
tensor launches the hand-written kernel or raises. The kernels mask ragged
shapes themselves, so unlike the JAX wrappers nothing here pads rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.backproject import backproject, backproject_packed
from repro_torch.kernels.cs_project import project
from repro_torch.kernels.prefix_eval import prefix_eval
from repro_torch.kernels.topk_select import topk_select

__all__ = ["backproject", "backproject_packed", "biht",
           "cs_pack_sign_residual", "cs_project", "cs_project_pack",
           "cs_project_sign", "prefix_eval", "ref", "topk_select"]


def cs_project_sign(phi: torch.Tensor, chunks: torch.Tensor) -> torch.Tensor:
    """sign(chunks @ phiᵀ): phi (S, D), chunks (n, D) -> (n, S)."""
    return project(phi, chunks, mode="sign")


def cs_project_pack(phi: torch.Tensor, chunks: torch.Tensor) -> torch.Tensor:
    """Fused sign+pack compression: -> int32 (n, S//32) words; unpacking
    reproduces ``cs_project_sign`` bit for bit (one sign predicate)."""
    return project(phi, chunks, mode="pack")


def cs_pack_sign_residual(phi: torch.Tensor, x: torch.Tensor,
                          y_packed: torch.Tensor):
    """Packed BIHT residual planes: the fresh sign(x Φᵀ) is consumed
    in-kernel; returns (plus, minus) int32 (n, S//32) with
    resid = 2·(plus − minus)."""
    return project(phi, x, mode="pack_sign_residual", y=y_packed)


def cs_project(phi: torch.Tensor, chunks: torch.Tensor) -> torch.Tensor:
    """Plain projection chunks @ phiᵀ -> (n, S)."""
    return project(phi, chunks, mode="none")


def biht(y: torch.Tensor, phi: torch.Tensor, k: int, iters: int,
         tau: float) -> torch.Tensor:
    """Full BIHT decode composed from K1, K3 and K4, exactly as
    ``repro.kernels.ops.biht``: y (n, S), phi (S, D) -> unit-norm (n, D).

    One round at ``iters`` costs 1 + iters launches of topk_select and
    backproject and ``iters`` of the sign_residual projection."""
    s = phi.shape[0]
    x0 = backproject(torch.zeros((y.shape[0], phi.shape[1]), dtype=y.dtype,
                                 device=y.device), y, phi, 1.0 / s)
    x, _ = topk_select(x0, k)
    for _ in range(iters):
        resid = project(phi, x, mode="sign_residual", y=y)
        x = backproject(x, resid, phi, tau / s)
        x, _ = topk_select(x, k)
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-12)

