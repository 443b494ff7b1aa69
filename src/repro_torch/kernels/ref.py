"""Plain PyTorch versions of every ported kernel, under the names of
``repro/kernels/ref.py``. These are what the CPU runs and what
``chip_smoke.py`` holds each kernel against on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels.backproject import (backproject_packed_plain,
                                             backproject_plain)
from repro_torch.kernels.cs_project import project_plain
from repro_torch.kernels.prefix_eval import prefix_eval_plain
from repro_torch.kernels.sign import sign_pm1  # noqa: F401
from repro_torch.kernels.topk_select import topk_select_plain

__all__ = ["backproject_packed_ref", "backproject_ref", "biht_ref",
           "cs_pack_sign_residual_ref", "cs_project_pack_ref",
           "cs_project_ref", "cs_project_sign_ref", "prefix_eval_ref",
           "sign_pm1", "sign_residual_planes_ref", "topk_select_ref"]

topk_select_ref = topk_select_plain
backproject_ref = backproject_plain
backproject_packed_ref = backproject_packed_plain
prefix_eval_ref = prefix_eval_plain


def cs_project_sign_ref(phi: torch.Tensor, chunks: torch.Tensor):
    return project_plain(phi, chunks, mode="sign")


def cs_project_pack_ref(phi: torch.Tensor, chunks: torch.Tensor):
    return project_plain(phi, chunks, mode="pack")


def cs_project_ref(phi: torch.Tensor, chunks: torch.Tensor, *, mode="none",
                   y=None):
    return project_plain(phi, chunks, mode=mode, y=y)


def cs_pack_sign_residual_ref(phi: torch.Tensor, x: torch.Tensor,
                              y_packed: torch.Tensor):
    return project_plain(phi, x, mode="pack_sign_residual", y=y_packed)


def sign_residual_planes_ref(phi: torch.Tensor, x: torch.Tensor,
                             y_packed: torch.Tensor):
    """Packed BIHT residual oracle -> (plus, minus) int32 words (n, S//32):
    the +2 lanes (y = +1, sign(Φx) = −1) and the −2 lanes of y − sign(Φx),
    so that the residual is 2·(plus − minus)."""
    return project_plain(phi, x, mode="pack_sign_residual", y=y_packed)


def biht_ref(y: torch.Tensor, phi: torch.Tensor, k: int, iters: int,
             tau: float) -> torch.Tensor:
    """The whole BIHT loop (sign consistency) of the plain versions, as
    the reference's oracle runs it: x0 = top-k(yΦ / S), then ``iters``
    steps x ← top-k(x + τ/S · (y − sign(xΦᵀ)) Φ); each row unit-normed."""
    s = phi.shape[0]
    x, _ = topk_select_ref((y.to(torch.float32) @ phi.to(torch.float32))
                           / s, k)
    for _ in range(iters):
        resid = project_plain(phi, x, mode="sign_residual", y=y)
        x, _ = topk_select_ref(backproject_ref(x, resid, phi, tau / s), k)
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-12)
