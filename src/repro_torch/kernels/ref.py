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

__all__ = ["backproject_packed_ref", "backproject_ref",
           "cs_pack_sign_residual_ref", "cs_project_pack_ref",
           "cs_project_ref", "cs_project_sign_ref", "prefix_eval_ref",
           "sign_pm1", "topk_select_ref"]

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
