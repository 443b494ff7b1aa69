"""Attention: GQA/MHA (RoPE, sliding window, logit softcap) and MLA; port
of ``repro/models/attention.py``.

Full-sequence attention (train/prefill) loops over query blocks, each
block against all keys, so no S×S score tensor is live at once; with more
than one block each is checkpointed (its scores recomputed in the
backward pass). Scores are f32, softcapped before the mask, masked with
−1e30 (not −inf), and the softmax weights are cast to v's dtype before the
value product, as in the reference.

Decode attends one query over the KV cache. The new K/V (or MLA latent)
row is written into the cache **in place** at ``pos``, as the reference's
donated cache buffer is, and the cache tensors are returned. MLA decodes
with the absorbed-latent scores against the cached ``ckv``/``kr``.
Cross-attention (``cross=True``, whisper) belongs to a later slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import AttentionConfig
from repro_torch.models.layers import apply_rope, he_init, rmsnorm, softcap


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


def init_mla(generator, d_model: int, a: AttentionConfig, lead=(),
             device=None, dtype=torch.float32):
    """The reference's MLA leaves; ``lead`` prepends the layer axis L.
    Fan-ins are those of one layer."""
    lead = tuple(lead)
    qd = a.qk_nope_dim + a.qk_rope_dim

    def w(shape, fan_in):
        return he_init(generator, lead + shape, fan_in=fan_in,
                       device=device, dtype=dtype)

    p = {}
    if a.q_lora_rank:
        p["w_dq"] = w((d_model, a.q_lora_rank), d_model)
        p["w_uq"] = w((a.q_lora_rank, a.num_heads, qd), a.q_lora_rank)
        p["q_norm"] = torch.zeros(lead + (a.q_lora_rank,), dtype=dtype,
                                  device=device)
    else:
        p["wq"] = w((d_model, a.num_heads, qd), d_model)
    p["w_dkv"] = w((d_model, a.kv_lora_rank), d_model)
    p["w_kr"] = w((d_model, a.qk_rope_dim), d_model)
    p["kv_norm"] = torch.zeros(lead + (a.kv_lora_rank,), dtype=dtype,
                               device=device)
    p["w_uk"] = w((a.kv_lora_rank, a.num_heads, a.qk_nope_dim),
                  a.kv_lora_rank)
    p["w_uv"] = w((a.kv_lora_rank, a.num_heads, a.v_head_dim),
                  a.kv_lora_rank)
    p["wo"] = w((a.num_heads, a.v_head_dim, d_model),
                a.num_heads * a.v_head_dim)
    return p


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


def decode_attention_sharded(q, k, v, pos: int, *, scale, window=None,
                             is_global=None, cap=0.0, n_chunks=16):
    """Flash-decoding arithmetic for one query: the cache length split
    into ``n_chunks`` partial softmaxes (each chunk's max, then the
    global max, exp-sums and weighted V summed over the chunks). The
    reference shards the chunks over devices; on one card it is the
    same arithmetic, which ``cfg.decode_sharded_chunks > 0`` selects.

    q: (B, 1, H, hd); k/v: (B, S, KV, hd). Returns (B, 1, H, hd)."""
    B, S, KV, hd = k.shape
    H = q.shape[2]
    rep = H // KV
    while S % n_chunks:
        n_chunks //= 2
    cl = S // n_chunks
    kc = k.reshape(B, n_chunks, cl, KV, hd)
    vc = v.reshape(B, n_chunks, cl, KV, hd)
    qg = q.reshape(B, KV, rep, hd)
    scores = torch.einsum("bkrh,bnskh->bnkrs", qg.to(torch.float32),
                          kc.to(torch.float32)) * scale
    scores = softcap(scores, cap)
    k_pos = torch.arange(S, dtype=torch.int32,
                         device=q.device).reshape(n_chunks, cl)
    mask = k_pos <= pos                                    # causal
    if window is not None and not is_global:
        mask &= (pos - k_pos) < window
    scores = torch.where(mask[None, :, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    m_part = torch.amax(scores, dim=-1)                    # (B,nc,KV,rep)
    m_glob = torch.amax(m_part, dim=1, keepdim=True)       # across chunks
    e = torch.exp(scores - m_glob[..., None])
    denom = torch.sum(e, dim=(1, 4))                       # (B,KV,rep)
    num = torch.einsum("bnkrs,bnskh->bkrh", e, vc.to(torch.float32))
    out = num / denom[..., None]
    return out.reshape(B, 1, H, hd).to(v.dtype)


def gqa_decode(p, x, a: AttentionConfig, *, cache_k, cache_v, pos: int,
               is_global: Optional[bool] = None, cross: bool = False,
               sharded_cache_chunks: int = 0):
    """x: (B, 1, d); cache_k/v: (B, S, KV, hd), written in place at
    ``pos``. Returns (out, cache_k, cache_v)."""
    if cross:
        raise NotImplementedError(
            "cross-attention (whisper) is not ported yet — VLM and enc-dec: "
            "ROADMAP.md Queue 1, item 2")
    hd = p["wq"].shape[-1]
    S = cache_k.shape[1]
    q_pos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    knew = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    vnew = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    q = apply_rope(q, q_pos, a.rope_theta)
    knew = apply_rope(knew, q_pos, a.rope_theta)
    cache_k[:, pos:pos + 1] = knew.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = vnew.to(cache_v.dtype)
    window = a.window if a.window else None
    kw = dict(scale=1.0 / math.sqrt(hd), window=window, is_global=is_global,
              cap=a.logit_softcap)
    if sharded_cache_chunks:
        out = decode_attention_sharded(q, cache_k, cache_v, pos,
                                       n_chunks=sharded_cache_chunks, **kw)
    else:
        k_pos = torch.arange(S, dtype=torch.int32, device=x.device)
        out = _block_attend(q, cache_k, cache_v, q_pos, k_pos, causal=True,
                            **kw)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, cache_k, cache_v


# --- MLA ---------------------------------------------------------------------

def _mla_q(p, x, a: AttentionConfig, positions, eps):
    if a.q_lora_rank:
        cq = rmsnorm(x @ p["w_dq"].to(x.dtype), p["q_norm"], eps)
        q = torch.einsum("bsr,rhk->bshk", cq, p["w_uq"].to(x.dtype))
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    q_nope = q[..., :a.qk_nope_dim]
    q_rope = apply_rope(q[..., a.qk_nope_dim:], positions, a.rope_theta)
    return q_nope, q_rope


def mla_forward(p, x, a: AttentionConfig, *, positions, eps=1e-6):
    """Materialised-K MLA for train/prefill; the values are
    ``v_head_dim`` wide, the queries and keys ``qk_nope + qk_rope``.
    Returns (out, (c_kv, k_rope)); the pair seeds a decode cache."""
    q_nope, q_rope = _mla_q(p, x, a, positions, eps)
    c_kv = rmsnorm(x @ p["w_dkv"].to(x.dtype), p["kv_norm"], eps)
    k_rope = apply_rope((x @ p["w_kr"].to(x.dtype))[:, :, None, :],
                        positions, a.rope_theta)           # (B,S,1,rd)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"].to(x.dtype))
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uv"].to(x.dtype))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1],
                                         a.qk_rope_dim)], dim=-1)
    scale = 1.0 / math.sqrt(a.qk_nope_dim + a.qk_rope_dim)
    out = blockwise_attention(q, k, v, positions, positions, scale=scale,
                              cap=a.logit_softcap)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, (c_kv, k_rope[:, :, 0, :])


def mla_decode(p, x, a: AttentionConfig, *, cache_ckv, cache_kr, pos: int,
               eps=1e-6):
    """Absorbed-latent decode: the query is taken into the latent space
    through W_uk and scored against the cached latents; the output comes
    back through W_uv. cache_ckv: (B, S, r); cache_kr: (B, S, rd), both
    written in place at ``pos``. Returns (out, cache_ckv, cache_kr)."""
    S = cache_ckv.shape[1]
    q_pos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, x, a, q_pos, eps)           # (B,1,H,*)
    c_new = rmsnorm(x @ p["w_dkv"].to(x.dtype), p["kv_norm"], eps)
    kr_new = apply_rope((x @ p["w_kr"].to(x.dtype))[:, :, None, :], q_pos,
                        a.rope_theta)[:, :, 0, :]
    cache_ckv[:, pos:pos + 1] = c_new.to(cache_ckv.dtype)
    cache_kr[:, pos:pos + 1] = kr_new.to(cache_kr.dtype)
    # absorb: q_latent[h] = q_nope[h] @ W_uk[h]^T -> (B, 1, H, r)
    q_lat = torch.einsum("bthk,rhk->bthr", q_nope, p["w_uk"].to(x.dtype))
    ckv = cache_ckv.to(torch.float32)
    scores = (torch.einsum("bthr,bsr->bhts", q_lat.to(torch.float32), ckv)
              + torch.einsum("bthk,bsk->bhts", q_rope.to(torch.float32),
                             cache_kr.to(torch.float32)))
    scores = scores * (1.0 / math.sqrt(a.qk_nope_dim + a.qk_rope_dim))
    k_pos = torch.arange(S, dtype=torch.int32, device=x.device)
    scores = torch.where((k_pos <= pos)[None, None, None], scores,
                         torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhts,bsr->bthr", w, ckv)
    out = torch.einsum("bthr,rhv->bthv", out_lat.to(x.dtype),
                       p["w_uv"].to(x.dtype))
    out = torch.einsum("bthv,hvd->btd", out, p["wo"].to(x.dtype))
    return out, cache_ckv, cache_kr
