"""Mixture-of-Experts: top-k router and capacity-based dispatch; port of
``repro/models/moe.py``.

Each token's top-k experts come from a stable descending sort of the
router's softmax, so that tied probabilities go to the lower expert index,
as ``jax.lax.top_k`` orders them (``torch.topk`` promises no tie order; the
router's logits are in the model's dtype and bf16 ties are common). A
route's slot in its expert's buffer is the number of earlier routes to the
same expert (a cumsum of the one-hot routes, token-major); a route past the
capacity is dropped: it goes to slot ``capacity − 1`` with weight 0.
Shared (always-on) experts are a plain dense MLP (DeepSeek-V2 style).

This is the reference's one-device branch. Its ``shard_map`` branch, one
dispatch per data shard, belongs with ``dist/collectives`` (ROADMAP.md
Queue 1, item 5): ``moe_forward``'s ``group`` is where it will take the
process group, and today it must be ``None``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import he_init, init_mlp, mlp


def init_moe(generator, d_model: int, d_ff: int, m: MoEConfig, gated=True,
             lead=(), device=None, dtype=torch.float32):
    """The reference's MoE leaves; ``lead`` prepends the layer axis L.
    Fan-ins are those of one layer."""
    lead = tuple(lead)
    E = m.num_experts

    def w(shape, fan_in):
        return he_init(generator, lead + shape, fan_in=fan_in,
                       device=device, dtype=dtype)

    p = {"router": w((d_model, E), d_model),
         "ew1": w((E, d_model, d_ff), d_model),
         "ew2": w((E, d_ff, d_model), d_ff)}
    if gated:
        p["ew3"] = w((E, d_model, d_ff), d_model)
    if m.num_shared_experts:
        p["shared"] = init_mlp(generator, d_model,
                               d_ff * m.num_shared_experts, gated, lead=lead,
                               device=device, dtype=dtype)
    return p


def _route(logits: torch.Tensor, top_k: int):
    """Returns (weights (T, k), idx (T, k), aux_loss scalar)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :top_k], idx[:, :top_k]
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss
    E = logits.shape[-1]
    me = torch.mean(probs, dim=0)                                # (E,)
    ce = torch.mean(F.one_hot(idx[:, 0], E).to(torch.float32), dim=0)
    aux = E * torch.sum(me * ce)
    return w, idx, aux


def capacity_of(T: int, m: MoEConfig) -> int:
    """Slots per expert for T tokens: ⌈T·k/E·factor⌉, at least 8 and a
    multiple of 8."""
    c = int(math.ceil(T * m.top_k / m.num_experts * m.capacity_factor))
    return max(8, -(-c // 8) * 8)


def _dispatch(idx: torch.Tensor, E: int, capacity: int):
    """(flat expert, slot, keep) of every route, token-major: a route's
    slot is the count of earlier routes to its expert; a route at or past
    ``capacity`` is dropped and parked at slot ``capacity − 1``."""
    flat_idx = idx.reshape(-1)                                   # (T*k,)
    onehot = F.one_hot(flat_idx, E).to(torch.int32)              # (T*k, E)
    before = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = torch.gather(before, 1, flat_idx[:, None])[:, 0].long()
    keep = pos < capacity
    slot = torch.where(keep, pos, torch.full_like(pos, capacity - 1))
    return flat_idx, slot, keep


def _moe_tokens(p, xf: torch.Tensor, m: MoEConfig, gated: bool,
                capacity: int):
    """The MoE over flat tokens xf (T, d); the dispatch is computed from
    these tokens only."""
    T, d = xf.shape
    k, E = m.top_k, m.num_experts
    logits = xf @ p["router"].to(xf.dtype)                       # (T, E)
    w, idx, aux = _route(logits, k)                              # (T, k)
    if capacity <= 0:
        capacity = capacity_of(T, m)
    flat_idx, slot, keep = _dispatch(idx, E, capacity)
    w_flat = w.reshape(-1) * keep
    src = torch.repeat_interleave(xf, k, dim=0)                  # (T*k, d)
    buf = torch.zeros((E, capacity, d), dtype=xf.dtype, device=xf.device)
    # kept routes own distinct slots; a dropped one adds exact zeros
    buf = buf.index_put((flat_idx, slot), src * keep[:, None].to(xf.dtype),
                        accumulate=True)
    h = torch.einsum("ecd,edf->ecf", buf, p["ew1"].to(xf.dtype))
    if gated:
        h = F.silu(h) * torch.einsum("ecd,edf->ecf", buf,
                                     p["ew3"].to(xf.dtype))
    else:
        h = F.gelu(h, approximate="tanh")        # jax.nn.gelu's default
    out_buf = torch.einsum("ecf,efd->ecd", h, p["ew2"].to(xf.dtype))
    gathered = out_buf[flat_idx, slot]                           # (T*k, d)
    combined = (gathered * w_flat[:, None].to(xf.dtype)).reshape(T, k, d)
    out = torch.sum(combined, dim=1)
    if m.num_shared_experts:
        out = out + mlp(p["shared"], xf[None], gated)[0]
    return out, aux.to(torch.float32)


def moe_forward(p, x: torch.Tensor, m: MoEConfig, *, gated=True,
                capacity: int = 0, group=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (out, aux_loss)."""
    if group is not None:
        raise NotImplementedError(
            "a per-shard MoE dispatch needs dist/collectives (ROADMAP.md "
            "Queue 1, item 5); one card takes group=None")
    B, S, d = x.shape
    out, aux = _moe_tokens(p, x.reshape(B * S, d), m, gated, capacity)
    return out.reshape(B, S, d), aux
