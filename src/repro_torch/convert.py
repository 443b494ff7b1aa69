"""Carry arrays between the JAX package and the port, as NumPy.

``params_from_reference`` turns a JAX parameter dict (``np.asarray`` of each
leaf) into tensors in the same layout (``w1`` stays (784, 64));
``params_to_numpy`` goes back. ``arrays_from_reference`` turns the reference's
draws — Φ, fades (complex64) and AWGN — into tensors, so a test can feed
both packages the same numbers. ``lm_params_from_reference`` and
``lm_params_to_numpy`` do the same for an LM's nested parameter dict (the
stacked (L, ...) layer leaves included), leaf for leaf, and for a decode
cache. NumPy has no bfloat16 of its own: a bf16 leaf of the reference
(``ml_dtypes.bfloat16``) comes across by its bit pattern, and a bf16
tensor goes back as f32, which holds it exactly.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import resolve_device


def params_from_reference(np_params: Mapping, device=None
                    ) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in np_params.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def arrays_from_reference(*arrays, device=None) -> Tuple[torch.Tensor, ...]:
    dev = resolve_device(device)
    return tuple(torch.from_numpy(np.array(a, copy=True)).to(dev)
                 for a in arrays)


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_reference(np_params, device=None):
    """A nested dict of NumPy arrays (``np.asarray`` of each JAX leaf, a
    parameter dict or a decode cache) -> the same nested dict of tensors
    on ``device``."""
    dev = resolve_device(device)
    return tree.tree_map(lambda a: _tensor(a).to(dev), np_params)


def lm_params_to_numpy(params):
    """A nested dict of tensors -> the same nested dict of NumPy arrays
    (bf16 leaves as f32)."""
    def to_numpy(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree.tree_map(to_numpy, params)
