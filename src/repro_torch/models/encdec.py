"""Whisper-style encoder-decoder transformer; port of
``repro/models/encdec.py``.

The mel + conv frontend is a stub, as in the reference: the model takes
precomputed frame embeddings (B, S_enc, d_model). The encoder adds
sinusoidal positions and attends without a mask; the decoder adds learned
positions (a 4,096-row table, read at ``position % 4096``) and attends
causally to itself and to the encoder's output. No RoPE anywhere.

Per-layer parameters are stacked along a leading axis (``enc_layers``:
L_enc, ``layers``: L), as ``jax.vmap`` of the reference's init stacks
them. The decode cache holds the decoder's self-attention ``k``/``v``
(L, B, S, KV, hd) and the encoder's ``cross_k``/``cross_v`` (L, B,
S_enc, KV, hd), computed once by ``seed_cross_cache``;
``encdec_decode_step`` writes each layer's new self-attention row into the
cache in place and reads the cross K/V.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, dtype_of
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed, init_embedding, init_mlp, mlp,
                                       rmsnorm, sinusoidal_positions,
                                       unembed)
from repro_torch.models.transformer import _layer_slices, remat_wrap

POS_TABLE = 4096        # rows of the decoder's learned position table


def _init_layers(generator, cfg: ModelConfig, L: int, cross: bool, device,
                 dtype):
    d = cfg.d_model

    def norm():
        return torch.zeros((L, d), dtype=dtype, device=device)

    def gqa():
        return attn.init_gqa(generator, d, cfg.attention, lead=(L,),
                             device=device, dtype=dtype)

    p = {"attn_norm": norm(), "attn": gqa()}
    if cross:
        p["cross_norm"], p["cross"] = norm(), gqa()
    p["ffn_norm"] = norm()
    p["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.gated_mlp, lead=(L,),
                        device=device, dtype=dtype)
    return p


def init_encdec(seed: int, cfg: ModelConfig, device=None):
    """Random f32 parameters from ``seed`` (``device="meta"``: the shapes
    only); the reference's weights come in through
    ``repro_torch.convert``."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    dtype = torch.float32
    return {
        "embedding": init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                    device=dev, dtype=dtype),
        "pos_embedding": torch.randn((POS_TABLE, cfg.d_model), generator=gen,
                                     device=dev).mul_(0.01).to(dtype),
        "enc_layers": _init_layers(gen, cfg, cfg.num_encoder_layers, False,
                                   dev, dtype),
        "enc_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "layers": _init_layers(gen, cfg, cfg.num_layers, True, dev, dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }


def encode(params, cfg: ModelConfig, frames, *, layer_resolver=None):
    """frames: (B, S_enc, d) stub embeddings -> the encoder states (B,
    S_enc, d) in the model's dtype."""
    dtype = dtype_of(cfg)
    x = frames.to(dtype)
    S = x.shape[1]
    x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(dtype)[None]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    layer = _layer_slices(params["enc_layers"])
    for i in range(cfg.num_encoder_layers):
        lp = layer(i)
        if layer_resolver is not None:
            lp = layer_resolver(lp)
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        o, _ = attn.gqa_forward(lp["attn"], h, cfg.attention,
                                positions=positions, causal=False,
                                use_rope=False)
        x = x + o
        h = rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + mlp(lp["mlp"], h, cfg.gated_mlp)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _dec_positions(params, positions, dtype):
    table = params["pos_embedding"]
    return table[positions % table.shape[0]].to(dtype)


def decode_full(params, cfg: ModelConfig, tokens, enc_out, *, remat=True,
                return_hidden=False, layer_resolver=None):
    """The teacher-forced decoder over tokens (B, S_dec) against
    ``enc_out``. Returns the logits, or with ``return_hidden`` the final
    hidden states."""
    dtype = dtype_of(cfg)
    x = embed(params["embedding"], tokens, dtype) * math.sqrt(cfg.d_model)
    S = tokens.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    x = x + _dec_positions(params, positions, dtype)[None]
    enc_pos = torch.arange(enc_out.shape[1], dtype=torch.int32,
                           device=x.device)
    a, eps = cfg.attention, cfg.norm_eps

    def body(x, lp):
        if layer_resolver is not None:
            lp = layer_resolver(lp)
        h = rmsnorm(x, lp["attn_norm"], eps)
        o, _ = attn.gqa_forward(lp["attn"], h, a, positions=positions,
                                causal=True, use_rope=False)
        x = x + o
        h = rmsnorm(x, lp["cross_norm"], eps)
        o, _ = attn.gqa_forward(lp["cross"], h, a, positions=positions,
                                causal=False, use_rope=False, kv=enc_out,
                                kv_positions=enc_pos)
        x = x + o
        h = rmsnorm(x, lp["ffn_norm"], eps)
        return x + mlp(lp["mlp"], h, cfg.gated_mlp)

    body_fn = remat_wrap(body, remat)
    layer = _layer_slices(params["layers"])
    for i in range(cfg.num_layers):
        x = body_fn(x, layer(i))
    x = rmsnorm(x, params["final_norm"], eps)
    if return_hidden:
        return x
    return unembed(x, embedding=params["embedding"])


def init_encdec_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      device=None, kv_group=None):
    """Zero cache in the model's dtype: self ``k``/``v`` of ``seq_len``
    (with ``kv_group`` this rank's ``transformer.kv_length`` rows of it)
    and ``cross_k``/``cross_v`` of ``encoder_seq_len``, whole."""
    from repro_torch.models.transformer import kv_length
    dev = resolve_device(device)
    L, a, dtype = cfg.num_layers, cfg.attention, dtype_of(cfg)
    own = (L, batch, kv_length(seq_len, kv_group), a.num_kv_heads,
           cfg.head_dim)
    enc = (L, batch, cfg.encoder_seq_len, a.num_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, shape in (("k", own), ("v", own), ("cross_k", enc),
                                ("cross_v", enc))}


@torch.no_grad()
def seed_cross_cache(params, cfg: ModelConfig, cache, enc_out):
    """Set every layer's cross-attention K/V from the encoder's output
    (once, before decoding); the cache is returned with its ``cross_k``
    and ``cross_v`` replaced, in the cache's dtype."""
    cross = params["layers"]["cross"]
    dt = cache["cross_k"].dtype
    cache["cross_k"] = torch.einsum("bsd,ldhk->lbshk", enc_out,
                                    cross["wk"].to(enc_out.dtype)).to(dt)
    cache["cross_v"] = torch.einsum("bsd,ldhk->lbshk", enc_out,
                                    cross["wv"].to(enc_out.dtype)).to(dt)
    return cache


@torch.no_grad()
def encdec_decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                       kv_group=None):
    """One decoder token against the self cache and the cross K/V.
    tokens: (B, 1); pos: int. Returns (logits (B, 1, V) f32, cache), each
    layer's new k/v row written into the cache at ``pos`` in place. With
    ``kv_group`` the self cache's length is split over the group."""
    pos = int(pos)
    dtype = dtype_of(cfg)
    a, eps = cfg.attention, cfg.norm_eps
    x = embed(params["embedding"], tokens, dtype) * math.sqrt(cfg.d_model)
    x = x + _dec_positions(
        params, torch.full((1,), pos, dtype=torch.int64, device=x.device),
        dtype)[None]
    layer = _layer_slices(params["layers"])
    cache_l = _layer_slices(cache)
    for i in range(cfg.num_layers):
        lp, c = layer(i), cache_l(i)
        h = rmsnorm(x, lp["attn_norm"], eps)
        o, _, _ = attn.gqa_decode(lp["attn"], h, a, cache_k=c["k"],
                                  cache_v=c["v"], pos=pos, use_rope=False,
                                  kv_group=kv_group)
        x = x + o
        h = rmsnorm(x, lp["cross_norm"], eps)
        o, _, _ = attn.gqa_decode(lp["cross"], h, a, cache_k=c["cross_k"],
                                  cache_v=c["cross_v"], pos=pos,
                                  use_rope=False, cross=True)
        x = x + o
        h = rmsnorm(x, lp["ffn_norm"], eps)
        x = x + mlp(lp["mlp"], h, cfg.gated_mlp)
    x = rmsnorm(x, params["final_norm"], eps)
    return unembed(x, embedding=params["embedding"]), cache
