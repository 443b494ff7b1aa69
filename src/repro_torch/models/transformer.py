"""Decoder-only LM, the attention families (dense and MoE, GQA or MLA);
port of ``repro/models/transformer.py``.

Parameters are a nested dict of tensors, the per-layer ones **stacked**
along a leading layer axis L, exactly as the reference's ``init_lm``
builds them: the leaf names, shapes and the ``repro_torch.tree`` flatten
order equal the reference's, which the per-leaf OBCSAA aggregation and its
per-leaf noise depend on. The reference's ``lax.scan`` over layers is a
loop over layer slices (``unbind``: one gradient ``stack`` per leaf in the
backward pass, not a full-size scatter per layer); ``remat_wrap`` maps the
reference's ``jax.checkpoint`` policies onto ``torch.utils.checkpoint``.

Decode keeps a KV cache stacked over layers, (L, B, S, KV, hd) ``k``/``v``
for GQA and (L, B, S, r) ``ckv`` / (L, B, S, rd) ``kr`` for MLA.
``lm_decode_step`` writes each layer's new row into it in place (the
reference donates the buffer) and returns it. SSM, hybrid, VLM and audio
models belong to later slices (``ROADMAP.md`` Queue 1) and raise
``NotImplementedError``.
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
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (embed, he_init, init_embedding,
                                       init_mlp, mlp, rmsnorm, unembed)

LATER = {
    "ssm": "SSM and hybrid (mamba2, zamba2): ROADMAP.md Queue 1, item 1",
    "hybrid": "SSM and hybrid (mamba2, zamba2): ROADMAP.md Queue 1, item 1",
    "vlm": "VLM and enc-dec (internvl2, whisper): ROADMAP.md Queue 1, item 2",
    "audio": "VLM and enc-dec (internvl2, whisper): ROADMAP.md Queue 1, "
             "item 2",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for a model
    this port cannot build yet: anything but a dense or MoE decoder."""
    if cfg.family not in ("dense", "moe") or cfg.attention is None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet — "
            f"{LATER.get(cfg.family, 'ROADMAP.md Queue 1')}")


# --- init --------------------------------------------------------------------

def _init_layers(generator, cfg: ModelConfig, device, dtype):
    """The stacked (L, ...) per-layer parameters, in the reference's leaf
    names: attention (GQA or MLA), then the MLP or the MoE."""
    check_supported(cfg)
    L, d, a = cfg.num_layers, cfg.d_model, cfg.attention
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


def layer_flags(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Per-layer flags (CPU bool tensors of length L): layer i is global
    iff i % period == period − 1; with no period every layer is global
    unless the attention has a window."""
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
    return params


def _layer_slices(stacked):
    """A function i -> the i-th slice (views) of a tree of stacked
    leaves."""
    leaves, treedef = tree.flatten(stacked)
    slices = [leaf.unbind(0) for leaf in leaves]
    return lambda i: tree.unflatten(treedef, [s[i] for s in slices])


# --- layer application -------------------------------------------------------

def _apply_layer_full(lp, x, cfg: ModelConfig, is_global: bool, positions):
    """Full-sequence (train/prefill) layer. Returns (x, cache_seed, aux):
    the seed is (k, v) for GQA or (c_kv, k_rope) for MLA, aux the MoE
    load-balance loss (0 for a dense layer)."""
    eps = cfg.norm_eps
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
                                     gated=cfg.gated_mlp)
    else:
        o = mlp(lp["mlp"], h, cfg.gated_mlp)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
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


def lm_forward(params, cfg: ModelConfig, tokens, *, remat=True,
               collect_cache=False, return_hidden=False,
               layer_resolver=None):
    """tokens: (B, S). Returns (logits_or_hidden, aux, caches): aux is
    the MoE load-balance loss summed over the layers (0 for a dense
    model); with ``collect_cache`` caches is the tuple of each cache
    seed stacked over layers, ((L, B, S, KV, hd) k and v, or (L, B, S, r)
    c_kv and (L, B, S, rd) k_rope), else None.

    ``return_hidden=True`` skips the unembed (the chunked-CE training
    path). ``layer_resolver`` maps a layer's parameter slice to the form
    the block consumes, inside the remat boundary."""
    check_supported(cfg)
    dtype = dtype_of(cfg)
    x = embed(params["embedding"], tokens, dtype) * math.sqrt(cfg.d_model)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    is_global = layer_flags(cfg)["is_global"].tolist()
    layer = _layer_slices(params["layers"])

    def body(x, lp, glob):
        if layer_resolver is not None:
            lp = layer_resolver(lp)
        x, seed, aux = _apply_layer_full(lp, x, cfg, glob, positions)
        return x, (seed if collect_cache else None), aux

    body_fn = remat_wrap(body, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    seeds = []
    for i in range(cfg.num_layers):
        x, seed, aux_i = body_fn(x, layer(i), is_global[i])
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

def init_lm_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Zero cache, stacked over layers (leading L axis), in the model's
    dtype."""
    check_supported(cfg)
    dev = resolve_device(device)
    L, a, dtype = cfg.num_layers, cfg.attention, dtype_of(cfg)
    if a.use_mla:
        shapes = {"ckv": (L, batch, seq_len, a.kv_lora_rank),
                  "kr": (L, batch, seq_len, a.qk_rope_dim)}
    else:
        kv = (L, batch, seq_len, a.num_kv_heads, cfg.head_dim)
        shapes = {"k": kv, "v": kv}
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, shape in shapes.items()}


def seed_cache_from_prefill(cfg: ModelConfig, cache, seeds, *,
                            start: int = 0):
    """Write prefill cache seeds into a decode cache at ``start`` (in
    place; the cache is returned).

    ``seeds`` is the stacked tuple ``lm_forward(collect_cache=True)``
    returns. The forward already applies RoPE to K at the absolute
    positions 0..T−1, the values ``gqa_decode`` would have written token
    by token, so seeding the first T slots and decoding from
    ``pos = start + T`` reproduces the full forward."""
    check_supported(cfg)
    names = ("ckv", "kr") if cfg.attention.use_mla else ("k", "v")
    for name, seed in zip(names, seeds):
        T = seed.shape[2]
        cache[name][:, :, start:start + T] = seed.to(cache[name].dtype)
    return cache


@torch.no_grad()
def lm_decode_step(params, cfg: ModelConfig, cache, tokens, pos):
    """tokens: (B, 1); pos: int (or a 0-d tensor). Returns (logits,
    cache): logits (B, 1, V) f32; every layer's new K/V (or latent) row
    is written into the cache at ``pos``, in place."""
    check_supported(cfg)
    pos = int(pos)
    eps = cfg.norm_eps
    a = cfg.attention
    x = embed(params["embedding"], tokens, dtype_of(cfg)) * \
        math.sqrt(cfg.d_model)
    is_global = layer_flags(cfg)["is_global"].tolist()
    layer = _layer_slices(params["layers"])
    cache_l = _layer_slices(cache)
    for i in range(cfg.num_layers):
        lp, c = layer(i), cache_l(i)
        h = rmsnorm(x, lp["attn_norm"], eps)
        if a.use_mla:
            o, _, _ = attn.mla_decode(lp["attn"], h, a, cache_ckv=c["ckv"],
                                      cache_kr=c["kr"], pos=pos, eps=eps)
        else:
            o, _, _ = attn.gqa_decode(
                lp["attn"], h, a, cache_k=c["k"], cache_v=c["v"], pos=pos,
                is_global=is_global[i],
                sharded_cache_chunks=cfg.decode_sharded_chunks)
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
