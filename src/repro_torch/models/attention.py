"""Attention, GQA/MHA half (RoPE, sliding window, logit softcap); port of
``repro/models/attention.py``.

Full-sequence attention (train/prefill) loops over query blocks, each
block against all keys, so no S×S score tensor is live at once; with more
than one block each is checkpointed (its scores recomputed in the
backward pass). Scores are f32, softcapped before the mask, masked with
−1e30 (not −inf), and the softmax weights are cast to v's dtype before the
value product, as in the reference. MLA, cross-attention and the
decode-time functions belong to later slices.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import AttentionConfig
from repro_torch.models.layers import apply_rope, he_init, softcap


def init_gqa(generator, d_model: int, a: AttentionConfig, lead=(),
             device=None, dtype=torch.float32):
    """``lead`` prepends stacked axes (the layer axis L)."""
    hd = a.head_dim if a.head_dim else d_model // a.num_heads
    lead = tuple(lead)
    return {
        "wq": he_init(generator, lead + (d_model, a.num_heads, hd),
                      fan_in=d_model, device=device, dtype=dtype),
        "wk": he_init(generator, lead + (d_model, a.num_kv_heads, hd),
                      fan_in=d_model, device=device, dtype=dtype),
        "wv": he_init(generator, lead + (d_model, a.num_kv_heads, hd),
                      fan_in=d_model, device=device, dtype=dtype),
        "wo": he_init(generator, lead + (a.num_heads, hd, d_model),
                      fan_in=a.num_heads * hd, device=device, dtype=dtype),
    }


def _block_attend(q, k, v, q_pos, k_pos, *, scale, causal, window,
                  is_global, cap: float):
    """One query block against all keys.

    q: (B, Tq, H, hd); k/v: (B, S, KV, hd). Returns (B, Tq, H, vd).
    ``is_global`` is a Python bool (or None): the window applies only
    where it is false."""
    B, Tq, H, _ = q.shape
    KV = k.shape[2]
    rep = H // KV
    qg = q.reshape(B, Tq, KV, rep, q.shape[-1])
    scores = torch.einsum("btkrh,bskh->btkrs", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = softcap(scores, cap)
    delta = q_pos[:, None] - k_pos[None, :]              # (Tq, S)
    mask = torch.ones((Tq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= delta >= 0
    if window is not None and not is_global:
        mask &= delta < window
    scores = torch.where(mask[None, :, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("btkrs,bskh->btkrh", w, v)
    return out.reshape(B, Tq, H, v.shape[-1])


def blockwise_attention(q, k, v, q_positions, k_positions, *, scale,
                        causal=True, window=None, is_global=None, cap=0.0,
                        block_size=512):
    """Loop over query blocks; each block sees all keys (masked)."""
    B, S, H, hd = q.shape
    bs = min(block_size, S)
    while S % bs:
        bs //= 2
    nb = S // bs
    kw = dict(scale=scale, causal=causal, window=window,
              is_global=is_global, cap=cap)
    if nb <= 1:
        return _block_attend(q, k, v, q_positions, k_positions, **kw)

    def block(qblk, pblk):
        return _block_attend(qblk, k, v, pblk, k_positions, **kw)

    # flash-style: recompute a block's scores in the backward pass, so
    # only the (B, bs, H, hd) block outputs stay live across blocks
    outs = [checkpoint(block, q[:, j * bs:(j + 1) * bs],
                       q_positions[j * bs:(j + 1) * bs], use_reentrant=False)
            for j in range(nb)]
    return torch.cat(outs, dim=1)


def gqa_forward(p, x, a: AttentionConfig, *, positions,
                is_global: Optional[bool] = None):
    """Causal self-attention with RoPE. x: (B, S, d). Returns (out,
    (k, v)); k/v seed a decode cache."""
    hd = p["wq"].shape[-1]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    q = apply_rope(q, positions, a.rope_theta)
    k = apply_rope(k, positions, a.rope_theta)
    window = a.window if a.window else None
    out = blockwise_attention(
        q, k, v, positions, positions, scale=1.0 / math.sqrt(hd),
        window=window, is_global=is_global, cap=a.logit_softcap)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, (k, v)
