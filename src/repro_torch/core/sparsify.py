"""Top-κ sparsification (paper eq. 6) and the flat-vector helpers.

Port of ``repro/core/sparsify.py``. ``topk_sparsify`` keeps exactly κ
entries per row with ``lax.top_k``'s tie rule (equal magnitudes go to the
lowest index), which ``torch.topk`` does not promise: a stable descending
sort gives it. ``topk_sparsify_bisect`` is the threshold bisection of the
``topk_select`` kernel, run for ``iters`` rounds.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def topk_sparsify(g: torch.Tensor, k: int):
    """Dense top-k over the last axis. Returns (sparse_g, bool mask)."""
    idx = torch.sort(g.abs(), dim=-1, descending=True, stable=True)[1]
    mask = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
    mask.scatter_(-1, idx[..., :k], True)
    return g * mask.to(g.dtype), mask


def topk_sparsify_bisect(g: torch.Tensor, k: int, iters: int = 40):
    """Top-k by bisection on the magnitude threshold: exact for rows with
    distinct magnitudes (ties may admit more than k)."""
    a = g.to(torch.float32).abs()
    hi = a.amax(dim=-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        over = (a >= mid).sum(dim=-1, keepdim=True) > k
        lo = torch.where(over, mid, lo)
        hi = torch.where(over, hi, mid)
    mask = a >= hi
    cnt_hi = mask.sum(dim=-1, keepdim=True)
    mask = torch.where(cnt_hi >= k, mask, a >= lo)
    return g * mask.to(g.dtype), mask


def topk_sparsify_chunked(g: torch.Tensor, k_per_chunk: int, chunk: int):
    """Per-chunk top-k: g (n_chunks·chunk,) or (n_chunks, chunk) ->
    (sparse, mask) of g's shape."""
    shp = g.shape
    if g.ndim == 1:
        if g.numel() % chunk:
            raise ValueError(f"topk_sparsify_chunked: {g.numel()} entries "
                             f"are not a whole number of chunks of {chunk}")
        g = g.reshape(-1, chunk)
    sg, mask = topk_sparsify(g, k_per_chunk)
    return sg.reshape(shp), mask.reshape(shp)


def sparsification_error_bound(D: int, kappa: int, G: float,
                               delta: float) -> float:
    """Paper eq. (40): E‖e^s‖² ≤ (1+δ)(D−κ)/D·G²."""
    return (1.0 + delta) * (D - kappa) / D * G ** 2


def pad_to_chunks(flat: torch.Tensor, chunk: int):
    """Zero-pad a flat vector to a multiple of ``chunk``; (padded, D)."""
    d = flat.shape[-1]
    rem = (-d) % chunk
    if rem:
        flat = torch.nn.functional.pad(flat, (0, rem))
    return flat, d


def flatten_pytree(tree: Dict[str, torch.Tensor], batch_dims: int = 0
                   ) -> Tuple[torch.Tensor, Callable]:
    """Flatten a dict of tensors to one f32 vector, in JAX's pytree order
    (sorted keys: ``b1, b2, w1, w2`` for the MLP), + an unflatten closure.

    ``batch_dims`` leading axes are kept, so a stack of per-worker
    gradients (U, ...) flattens to (U, D)."""
    keys = sorted(tree)
    lead = tuple(tree[keys[0]].shape[:batch_dims]) if keys else ()
    shapes = [tuple(tree[k].shape[batch_dims:]) for k in keys]
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    dtypes = [tree[k].dtype for k in keys]
    flat = torch.cat([tree[k].reshape(lead + (-1,)).to(torch.float32)
                      for k in keys], dim=-1)

    def unflatten(vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for key, shp, sz, dt in zip(keys, shapes, sizes, dtypes):
            out[key] = vec[..., off:off + sz].reshape(
                vec.shape[:-1] + shp).to(dt)
            off += sz
        return out

    return flat, unflatten
