"""Decoder-only LM of every decoder family (dense, MoE, SSM, hybrid, VLM);
port of ``repro/models/transformer.py``.

Parameters are a nested dict of tensors, the per-layer ones **stacked**
along a leading layer axis L, exactly as the reference's ``init_lm``
builds them: the leaf names, shapes and the ``repro_torch.tree`` flatten
order equal the reference's, which the per-leaf OBCSAA aggregation and its
per-leaf noise depend on. The reference's ``lax.scan`` over layers is a
loop over layer slices (``unbind``: one gradient ``stack`` per leaf in the
backward pass, not a full-size scatter per layer); ``remat_wrap`` maps the
reference's ``jax.checkpoint`` policies onto ``torch.utils.checkpoint``.

The attention families' layer is attention (GQA or MLA) plus an MLP or an
MoE. An SSM layer is a Mamba2 block (``models/ssm.py``); the hybrid
(zamba2) adds one weight-tied attention + MLP block, ``params
["shared_block"]``, after every ``hybrid_attn_every``-th Mamba2 layer (the
``apply_attn`` flag; a Python branch where the reference has ``lax.cond``).
Its gradient sums over every application. A VLM prepends the image
embeddings plus ``params["img_pos"]`` to the text.

Decode keeps a cache stacked over layers: (L, B, S, KV, hd) ``k``/``v``
for GQA, (L, B, S, r) ``ckv`` / (L, B, S, rd) ``kr`` for MLA, (L, B, W − 1,
conv_dim) ``conv`` in the model's dtype and (L, B, h, p, n) f32 ``ssm``
for the SSM families, the hybrid with ``k``/``v`` over all L layers (only
the attention layers write theirs). ``lm_decode_step`` writes each
layer's new state into it in place (the reference donates the buffer) and
returns it.
"""
from __future__ import annotations

import functools
import math
from typing import Dict

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, dtype_of
from repro_torch.device import resolve_device
from repro_torch.dist import collectives as coll
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (embed, he_init, init_embedding,
                                       init_mlp, mlp, rmsnorm, unembed)

ATTN_FAMILIES = ("dense", "vlm", "moe")


# --- init --------------------------------------------------------------------

def _init_layers(generator, cfg: ModelConfig, device, dtype):
    """The stacked (L, ...) per-layer parameters, in the reference's leaf
    names: attention (GQA or MLA), then the MLP or the MoE; or a Mamba2
    block."""
    L, d, a = cfg.num_layers, cfg.d_model, cfg.attention
    if cfg.family in ("ssm", "hybrid"):
        return {"ssm_norm": torch.zeros((L, d), dtype=dtype, device=device),
                "ssm": ssm_lib.init_mamba2(generator, d, cfg.ssm, lead=(L,),
                                           device=device, dtype=dtype)}
    if cfg.family not in ATTN_FAMILIES:
        raise ValueError(cfg.family)
    init_attn = attn.init_mla if a.use_mla else attn.init_gqa
    p = {"attn_norm": torch.zeros((L, d), dtype=dtype, device=device),
         "attn": init_attn(generator, d, a, lead=(L,), device=device,
                           dtype=dtype),
         "ffn_norm": torch.zeros((L, d), dtype=dtype, device=device)}
    if cfg.family == "moe":
        p["moe"] = moe_lib.init_moe(generator, d, cfg.d_ff, cfg.moe,
                                    gated=cfg.gated_mlp, lead=(L,),
                                    device=device, dtype=dtype)
    else:
        p["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.gated_mlp,
                            lead=(L,), device=device, dtype=dtype)
    return p


def _init_shared_attn_block(generator, cfg: ModelConfig, device, dtype):
    """zamba2's weight-tied attention + MLP block (one copy, no L axis)."""
    d = cfg.d_model
    return {"attn_norm": torch.zeros((d,), dtype=dtype, device=device),
            "attn": attn.init_gqa(generator, d, cfg.attention, device=device,
                                  dtype=dtype),
            "ffn_norm": torch.zeros((d,), dtype=dtype, device=device),
            "mlp": init_mlp(generator, d, cfg.d_ff, cfg.gated_mlp,
                            device=device, dtype=dtype)}


def layer_flags(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Per-layer flags (CPU bool tensors of length L): layer i is global
    iff i % period == period − 1; with no period every layer is global
    unless the attention has a window. The hybrid's shared block follows
    layer i iff i % hybrid_attn_every == hybrid_attn_every − 1."""
    L = cfg.num_layers
    idx = torch.arange(L)
    if cfg.local_global_period:
        pp = cfg.local_global_period
        is_global = (idx % pp) == (pp - 1)
    else:
        is_global = torch.full((L,), cfg.attention is None
                               or not cfg.attention.window)
    if cfg.hybrid_attn_every:
        apply_attn = (idx % cfg.hybrid_attn_every) == \
            (cfg.hybrid_attn_every - 1)
    else:
        apply_attn = torch.zeros((L,), dtype=torch.bool)
    return {"is_global": is_global, "apply_attn": apply_attn}


def init_lm(seed: int, cfg: ModelConfig, device=None):
    """Random f32 parameters from ``seed`` (the port's generator, not
    JAX's bits: parity tests load the reference's weights through
    ``repro_torch.convert``). ``device="meta"`` gives the shapes only."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    dtype = torch.float32
    params = {
        "embedding": init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                    device=dev, dtype=dtype),
        "layers": _init_layers(gen, cfg, dev, dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = he_init(gen, (cfg.d_model, cfg.vocab_size),
                                    fan_in=cfg.d_model, device=dev,
                                    dtype=dtype)
    if cfg.family == "hybrid":
        params["shared_block"] = _init_shared_attn_block(gen, cfg, dev,
                                                         dtype)
    if cfg.family == "vlm":
        # the stub projector's position marker (the frontend is external)
        params["img_pos"] = torch.randn(
            (cfg.num_image_tokens, cfg.d_model), generator=gen, device=dev
        ).mul_(0.02).to(dtype)
    return params


def _layer_slices(stacked):
    """A function i -> the i-th slice (views) of a tree of stacked
    leaves."""
    leaves, treedef = tree.flatten(stacked)
    slices = [leaf.unbind(0) for leaf in leaves]
    return lambda i: tree.unflatten(treedef, [s[i] for s in slices])


# --- layer application -------------------------------------------------------

def _shared_block(sb, x, cfg: ModelConfig, positions):
    """The hybrid's weight-tied attention + MLP block over x. Returns
    (x, (k, v))."""
    eps = cfg.norm_eps
    h = rmsnorm(x, sb["attn_norm"], eps)
    o, kv = attn.gqa_forward(sb["attn"], h, cfg.attention,
                             positions=positions)
    x = x + o
    h = rmsnorm(x, sb["ffn_norm"], eps)
    return x + mlp(sb["mlp"], h, cfg.gated_mlp), kv


def _apply_layer_full(lp, x, cfg: ModelConfig, is_global: bool,
                      apply_attn: bool, positions, shared_block, dp=None):
    """Full-sequence (train/prefill) layer. Returns (x, cache_seed, aux):
    the seed is (k, v) for GQA, (c_kv, k_rope) for MLA, (conv, ssm) for
    an SSM layer and (conv, ssm, k, v) for a hybrid one (zero k/v where
    the shared block does not follow); aux is the MoE load-balance loss
    (0 for every other layer); ``dp`` is ``moe_forward``'s."""
    eps = cfg.norm_eps
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("ssm", "hybrid"):
        h = rmsnorm(x, lp["ssm_norm"], eps)
        o, seed = ssm_lib.mamba2_forward(lp["ssm"], h, cfg.ssm, eps=eps)
        x = x + o
        if cfg.family == "hybrid":
            if apply_attn:
                x, kv = _shared_block(shared_block, x, cfg, positions)
            else:
                B, S = x.shape[0], x.shape[1]
                z = torch.zeros((B, S, cfg.attention.num_kv_heads,
                                 cfg.head_dim), dtype=x.dtype,
                                device=x.device)
                kv = (z, z)
            seed = seed + kv
        return x, seed, aux
    h = rmsnorm(x, lp["attn_norm"], eps)
    if cfg.attention.use_mla:
        o, seed = attn.mla_forward(lp["attn"], h, cfg.attention,
                                   positions=positions, eps=eps)
    else:
        o, seed = attn.gqa_forward(lp["attn"], h, cfg.attention,
                                   positions=positions, is_global=is_global)
    x = x + o
    h = rmsnorm(x, lp["ffn_norm"], eps)
    if cfg.family == "moe":
        o, aux = moe_lib.moe_forward(lp["moe"], h, cfg.moe,
                                     gated=cfg.gated_mlp, dp=dp)
    else:
        o = mlp(lp["mlp"], h, cfg.gated_mlp)
    return x + o, seed, aux


_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
_BATCHED_MATMULS = {torch.ops.aten.bmm.default,
                    torch.ops.aten.baddbmm.default}


def _save_dots(batched: bool):
    """Selective-checkpoint policy: save matmul outputs (with
    ``batched``, also those with batch dims), recompute the rest."""
    keep = _MATMULS | (_BATCHED_MATMULS if batched else set())

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


REMAT_POLICIES = ("off", "full", "dots", "dots_no_batch")


def remat_wrap(body, remat):
    """Wrap a layer body per the remat knob.

    ``remat`` is a bool (True == "full") or a policy name: "off" keeps
    every activation, "full" keeps only the body's inputs and recomputes
    the rest in the backward pass, "dots" / "dots_no_batch" keep the
    matmul outputs (the latter only those without batch dims). Remat
    changes no number, only what is held."""
    if remat in (False, None, "off"):
        return body
    if remat in (True, "full"):
        return functools.partial(checkpoint, body, use_reentrant=False)
    if remat not in ("dots", "dots_no_batch"):
        raise ValueError(f"remat policy {remat!r} not in {REMAT_POLICIES}")
    return functools.partial(checkpoint, body, use_reentrant=False,
                             context_fn=_save_dots(remat == "dots"))


def lm_forward(params, cfg: ModelConfig, tokens, *, image_embeds=None,
               remat=True, collect_cache=False, return_hidden=False,
               layer_resolver=None, dp=None):
    """tokens: (B, S_text). Returns (logits_or_hidden, aux, caches): aux
    is the MoE load-balance loss summed over the layers (0 for the other
    families); with ``collect_cache`` caches is the tuple of each layer's
    cache seed stacked over layers (``_apply_layer_full``), else None.

    For a VLM, ``image_embeds`` (B, N, d) plus ``img_pos`` are prepended
    (N + S_text positions in all). ``return_hidden=True`` skips the
    unembed (the chunked-CE training path). ``layer_resolver`` maps a
    layer's parameter slice to the form the block consumes, inside the
    remat boundary. ``dp = (group, W)``: the MoE layers dispatch over W
    data-parallel workers (``moe.moe_forward``)."""
    dtype = dtype_of(cfg)
    x = embed(params["embedding"], tokens, dtype) * math.sqrt(cfg.d_model)
    if cfg.family == "vlm":
        img = image_embeds.to(dtype) + params["img_pos"].to(dtype)[None]
        x = torch.cat([img, x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    flags = layer_flags(cfg)
    is_global = flags["is_global"].tolist()
    apply_attn = flags["apply_attn"].tolist()
    shared_block = params.get("shared_block")
    layer = _layer_slices(params["layers"])

    def body(x, lp, glob, with_attn):
        if layer_resolver is not None:
            lp = layer_resolver(lp)
        x, seed, aux = _apply_layer_full(lp, x, cfg, glob, with_attn,
                                         positions, shared_block, dp)
        return x, (seed if collect_cache else None), aux

    body_fn = remat_wrap(body, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    seeds = []
    for i in range(cfg.num_layers):
        x, seed, aux_i = body_fn(x, layer(i), is_global[i], apply_attn[i])
        aux = aux + aux_i
        seeds.append(seed)
    caches = (tuple(torch.stack(leaf) for leaf in zip(*seeds))
              if collect_cache else None)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, aux, caches
    logits = unembed(x, embedding=params.get("embedding")
                     if cfg.tie_embeddings else None,
                     lm_head=params.get("lm_head"),
                     final_softcap=cfg.final_logit_softcap)
    return logits, aux, caches


# --- decode ------------------------------------------------------------------

def cache_shardings_hints():
    """Dim hints for cache leaves: length over data, heads over model."""
    return {
        "k": (None, None, "data", "model", None),
        "v": (None, None, "data", "model", None),
        "ckv": (None, "data", None, "model"),
        "kr": (None, "data", None, None),
        "conv": (None, "data", None, "model"),
        "ssm": (None, "data", "model", None, None),
    }


def kv_length(seq_len: int, kv_group) -> int:
    """This rank's rows of a ``seq_len``-long K/V cache split over
    ``kv_group`` (all of them without one). The split is what
    ``launch.steps.cache_shardings`` gives k/v on a (ranks, 1) mesh: the
    length over "data", which must divide it."""
    R = coll.axis_size(kv_group)
    if seq_len % R:
        raise ValueError(f"a K/V cache of length {seq_len} does not split "
                         f"over {R} ranks; make the length a multiple of "
                         f"{R}")
    return seq_len // R


def init_lm_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None,
                  kv_group=None):
    """Zero cache, stacked over layers (leading L axis), in the model's
    dtype; the SSM state in f32. With ``kv_group`` the k/v leaves hold
    this rank's ``kv_length`` rows of the length; the MLA latents and
    the SSM state stay whole on every rank."""
    dev = resolve_device(device)
    L, a, dtype = cfg.num_layers, cfg.attention, dtype_of(cfg)
    shapes = {}
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        _, n_heads, conv_dim = ssm_lib.ssm_dims(cfg.d_model, s)
        shapes["conv"] = (L, batch, s.conv_width - 1, conv_dim)
        shapes["ssm"] = (L, batch, n_heads, s.head_dim, s.d_state)
    if a is not None and a.use_mla:
        shapes["ckv"] = (L, batch, seq_len, a.kv_lora_rank)
        shapes["kr"] = (L, batch, seq_len, a.qk_rope_dim)
    elif cfg.family != "ssm":
        kv = (L, batch, kv_length(seq_len, kv_group), a.num_kv_heads,
              cfg.head_dim)
        shapes["k"] = shapes["v"] = kv
    return {name: torch.zeros(shape, dtype=torch.float32 if name == "ssm"
                              else dtype, device=dev)
            for name, shape in shapes.items()}


def seed_cache_from_prefill(cfg: ModelConfig, cache, seeds, *,
                            start: int = 0, kv_group=None):
    """Write prefill cache seeds into a decode cache at ``start`` (in
    place; the cache is returned).

    ``seeds`` is the stacked tuple ``lm_forward(collect_cache=True)``
    returns. The forward already applies RoPE to K at the absolute
    positions 0..T−1, the values ``gqa_decode`` would have written token
    by token, so seeding the first T slots and decoding from
    ``pos = start + T`` reproduces the full forward. With ``kv_group``
    each rank writes the seeds' rows that fall in its part of the k/v
    length. The SSM families carry a recurrent state with no positional
    slot, and raise."""
    if cfg.family not in ATTN_FAMILIES:
        raise NotImplementedError(
            f"prefill cache seeding is attention-only; family "
            f"{cfg.family!r} carries recurrent state that has no positional "
            "slot to seed")
    names = ("ckv", "kr") if cfg.attention.use_mla else ("k", "v")
    for name, seed in zip(names, seeds):
        T, S = seed.shape[2], cache[name].shape[2]
        lo = coll.axis_index(kv_group) * S if name in ("k", "v") else 0
        a, b = max(start, lo), min(start + T, lo + S)
        if a < b:
            cache[name][:, :, a - lo:b - lo] = \
                seed[:, :, a - start:b - start].to(cache[name].dtype)
    return cache


@torch.no_grad()
def lm_decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                   kv_group=None):
    """tokens: (B, 1); pos: int (or a 0-d tensor). Returns (logits,
    cache): logits (B, 1, V) f32; every layer's new K/V (or latent) row is
    written into the cache at ``pos``, and an SSM layer's conv and ssm
    state over its old one, in place. With ``kv_group`` the k/v length is
    split over the group (``init_lm_cache``; ``attention.gqa_decode``)."""
    pos = int(pos)
    eps = cfg.norm_eps
    a = cfg.attention
    x = embed(params["embedding"], tokens, dtype_of(cfg)) * \
        math.sqrt(cfg.d_model)
    flags = layer_flags(cfg)
    is_global = flags["is_global"].tolist()
    apply_attn = flags["apply_attn"].tolist()
    sb = params.get("shared_block")
    layer = _layer_slices(params["layers"])
    cache_l = _layer_slices(cache)
    for i in range(cfg.num_layers):
        lp, c = layer(i), cache_l(i)
        if cfg.family in ("ssm", "hybrid"):
            h = rmsnorm(x, lp["ssm_norm"], eps)
            o, (conv, ssm) = ssm_lib.mamba2_decode(
                lp["ssm"], h, cfg.ssm, conv_state=c["conv"],
                ssm_state=c["ssm"], eps=eps)
            x = x + o
            c["conv"].copy_(conv)
            c["ssm"].copy_(ssm)
            if apply_attn[i]:
                h = rmsnorm(x, sb["attn_norm"], eps)
                o, _, _ = attn.gqa_decode(sb["attn"], h, a, cache_k=c["k"],
                                          cache_v=c["v"], pos=pos,
                                          kv_group=kv_group)
                x = x + o
                h = rmsnorm(x, sb["ffn_norm"], eps)
                x = x + mlp(sb["mlp"], h, cfg.gated_mlp)
            continue
        h = rmsnorm(x, lp["attn_norm"], eps)
        if a.use_mla:
            o, _, _ = attn.mla_decode(lp["attn"], h, a, cache_ckv=c["ckv"],
                                      cache_kr=c["kr"], pos=pos, eps=eps)
        else:
            o, _, _ = attn.gqa_decode(
                lp["attn"], h, a, cache_k=c["k"], cache_v=c["v"], pos=pos,
                is_global=is_global[i],
                sharded_cache_chunks=cfg.decode_sharded_chunks,
                kv_group=kv_group)
        x = x + o
        h = rmsnorm(x, lp["ffn_norm"], eps)
        if cfg.family == "moe":
            o, _ = moe_lib.moe_forward(lp["moe"], h, cfg.moe,
                                       gated=cfg.gated_mlp)
        else:
            o = mlp(lp["mlp"], h, cfg.gated_mlp)
        x = x + o
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(x, embedding=params.get("embedding")
                     if cfg.tie_embeddings else None,
                     lm_head=params.get("lm_head"),
                     final_softcap=cfg.final_logit_softcap)
    return logits, cache
