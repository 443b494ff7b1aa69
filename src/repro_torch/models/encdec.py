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

With a ``mesh`` of M > 1 (``models/tensor_parallel.py``) the weights are
this rank's share: heads and hidden columns over the model group, the
vocabulary rows of the tied embedding and the rows of the position
table (a masked lookup, then a sum), and the logits this rank's
vocabulary columns. The cache's ``cross_k``/``cross_v`` take
``k``/``v``'s layout (``launch.steps.cache_shardings``): the encoder's
length over the data group where it divides, the KV heads over the
model group; the cross attention then reduces its partial softmaxes
over the data group as the self attention does.
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
from repro_torch.dist import collectives as coll
from repro_torch.models.tensor_parallel import split_of
from repro_torch.models.transformer import (_groups, _layer_slices,
                                            data_group, kv_length,
                                            local_cache_shapes, own_rows,
                                            remat_wrap)

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


def encode(params, cfg: ModelConfig, frames, *, layer_resolver=None,
           mesh=None):
    """frames: (B, S_enc, d) stub embeddings -> the encoder states (B,
    S_enc, d) in the model's dtype. ``mesh``: this rank's share of the
    weights (module docstring); the states come out whole."""
    dtype = dtype_of(cfg)
    sp = split_of(cfg, mesh)
    g = _groups(sp)
    if sp is not None:
        params = sp.whole(params, small_only=True)
    x = frames.to(dtype)
    S = x.shape[1]
    x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(dtype)[None]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    layer = _layer_slices(params["enc_layers"])
    for i in range(cfg.num_encoder_layers):
        lp = layer(i)
        if layer_resolver is not None:
            lp = layer_resolver(lp)
        if sp is not None:
            lp = sp.whole(lp, ("enc_layers",))
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        o, _ = attn.gqa_forward(lp["attn"], h, cfg.attention,
                                positions=positions, causal=False,
                                use_rope=False, group=g("attn"))
        x = x + o
        h = rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + coll.psum_(mlp(lp["mlp"], h, cfg.gated_mlp), g("mlp"))
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _dec_positions(params, positions, dtype, sp=None):
    """The learned positions' rows; where the table's rows are split over
    the model group, a masked lookup in this rank's block, summed."""
    table = params["pos_embedding"]
    if table.shape[0] == POS_TABLE:
        return table[positions % table.shape[0]].to(dtype)
    return embed(table, positions % POS_TABLE, dtype, sp.model)


def decode_full(params, cfg: ModelConfig, tokens, enc_out, *, remat=True,
                return_hidden=False, layer_resolver=None, mesh=None):
    """The teacher-forced decoder over tokens (B, S_dec) against
    ``enc_out``. Returns the logits, or with ``return_hidden`` the final
    hidden states. ``mesh``: this rank's share of the weights, and the
    logits its vocabulary columns (module docstring)."""
    dtype = dtype_of(cfg)
    sp = split_of(cfg, mesh)
    g = _groups(sp)
    if sp is not None:
        params = sp.whole(params, small_only=True)
    x = embed(params["embedding"], tokens, dtype, g("vocab")) * \
        math.sqrt(cfg.d_model)
    S = tokens.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    x = x + _dec_positions(params, positions, dtype, sp)[None]
    enc_pos = torch.arange(enc_out.shape[1], dtype=torch.int32,
                           device=x.device)
    a, eps = cfg.attention, cfg.norm_eps

    def body(x, lp):
        if layer_resolver is not None:
            lp = layer_resolver(lp)
        if sp is not None:
            lp = sp.whole(lp, ("layers",))
        h = rmsnorm(x, lp["attn_norm"], eps)
        o, _ = attn.gqa_forward(lp["attn"], h, a, positions=positions,
                                causal=True, use_rope=False,
                                group=g("attn"))
        x = x + o
        h = rmsnorm(x, lp["cross_norm"], eps)
        o, _ = attn.gqa_forward(lp["cross"], h, a, positions=positions,
                                causal=False, use_rope=False, kv=enc_out,
                                kv_positions=enc_pos, group=g("attn"))
        x = x + o
        h = rmsnorm(x, lp["ffn_norm"], eps)
        return x + coll.psum_(mlp(lp["mlp"], h, cfg.gated_mlp), g("mlp"))

    body_fn = remat_wrap(body, remat)
    layer = _layer_slices(params["layers"])
    for i in range(cfg.num_layers):
        x = body_fn(x, layer(i))
    x = rmsnorm(x, params["final_norm"], eps)
    if return_hidden:
        return x
    return unembed(x, embedding=params["embedding"])


def init_encdec_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      device=None, mesh=None):
    """Zero cache in the model's dtype: self ``k``/``v`` of ``seq_len``
    (with a ``mesh`` of M = 1 this rank's ``transformer.kv_length`` rows
    of it over the data group) and ``cross_k``/``cross_v`` of
    ``encoder_seq_len``, whole. With M > 1 each leaf is this rank's
    block as ``transformer.cache_specs`` lays it out."""
    dev = resolve_device(device)
    sp = split_of(cfg, mesh)
    L, a, dtype = cfg.num_layers, cfg.attention, dtype_of(cfg)
    rows = (seq_len if sp is not None
            else kv_length(seq_len, data_group(mesh)))
    shapes = {"k": (L, batch, rows, a.num_kv_heads, cfg.head_dim)}
    shapes["v"] = shapes["k"]
    shapes["cross_k"] = shapes["cross_v"] = (
        L, batch, cfg.encoder_seq_len, a.num_kv_heads, cfg.head_dim)
    if sp is not None:
        shapes = local_cache_shapes(shapes, mesh)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, shape in shapes.items()}


@torch.no_grad()
def seed_cross_cache(params, cfg: ModelConfig, cache, enc_out, mesh=None):
    """Set every layer's cross-attention K/V from the encoder's output
    (once, before decoding); the cache is returned with its ``cross_k``
    and ``cross_v`` replaced, in the cache's dtype. With a ``mesh`` of
    M > 1: this rank's KV heads, and its rows of the encoder's length
    where the cache splits it over the data group."""
    sp = split_of(cfg, mesh)
    cross = params["layers"]["cross"]
    dt = cache["cross_k"].dtype
    for name, w in (("cross_k", cross["wk"]), ("cross_v", cross["wv"])):
        if sp is not None:
            w = sp.whole(w, ("layers", "cross", "w" + name[-1]))
        kv = torch.einsum("bsd,ldhk->lbshk", enc_out, w.to(enc_out.dtype))
        if sp is not None:
            kv = own_rows(kv, cache[name].shape[2], sp.data, dim=2)
        cache[name] = kv.to(dt)
    return cache


@torch.no_grad()
def encdec_decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                       mesh=None):
    """One decoder token against the self cache and the cross K/V.
    tokens: (B, 1); pos: int. Returns (logits (B, 1, V) f32, cache), each
    layer's new k/v row written into the cache at ``pos`` in place. With
    a ``mesh`` of M = 1 the self cache's length is split over its data
    group; with M > 1 the weights and the cache are this rank's (module
    docstring) and the logits its vocabulary columns."""
    pos = int(pos)
    dtype = dtype_of(cfg)
    a, eps = cfg.attention, cfg.norm_eps
    sp = split_of(cfg, mesh)
    g = _groups(sp)
    cross_group = None
    kv_group = data_group(mesh)
    if sp is not None:
        params = sp.whole(params, small_only=True)
        if cache["cross_k"].shape[2] != cfg.encoder_seq_len:
            cross_group = sp.data
    x = embed(params["embedding"], tokens, dtype, g("vocab")) * \
        math.sqrt(cfg.d_model)
    x = x + _dec_positions(
        params, torch.full((1,), pos, dtype=torch.int64, device=x.device),
        dtype, sp)[None]
    layer = _layer_slices(params["layers"])
    cache_l = _layer_slices(cache)
    for i in range(cfg.num_layers):
        lp, c = layer(i), cache_l(i)
        if sp is not None:
            lp = sp.whole(lp, ("layers",))
        h = rmsnorm(x, lp["attn_norm"], eps)
        o, _, _ = attn.gqa_decode(lp["attn"], h, a, cache_k=c["k"],
                                  cache_v=c["v"], pos=pos, use_rope=False,
                                  kv_group=kv_group, group=g("attn"))
        x = x + o
        h = rmsnorm(x, lp["cross_norm"], eps)
        o, _, _ = attn.gqa_decode(lp["cross"], h, a, cache_k=c["cross_k"],
                                  cache_v=c["cross_v"], pos=pos,
                                  use_rope=False, cross=True,
                                  kv_group=cross_group, group=g("attn"))
        x = x + o
        h = rmsnorm(x, lp["ffn_norm"], eps)
        x = x + coll.psum_(mlp(lp["mlp"], h, cfg.gated_mlp), g("mlp"))
    x = rmsnorm(x, params["final_norm"], eps)
    return unembed(x, embedding=params["embedding"]), cache
