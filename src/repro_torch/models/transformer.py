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

Serving over processes takes a ``mesh`` (``launch.mesh.world_mesh(M)``).
With M = 1 its data group splits only the k/v length over its ranks,
every weight and every other leaf whole on each. With M > 1 it splits
the model over
its model group (``models/tensor_parallel.py``: ``lm_forward``'s and
``lm_decode_step``'s weights are the rank's share) and lays every cache
leaf out as ``cache_specs`` (``launch.steps.cache_shardings``) gives it:
``k``/``v`` the length over the data group and the KV heads over the
model group, ``ckv`` the batch over data and the latent over model,
``kr`` the batch over data, ``conv`` the batch over data and the
channels over model (this rank's own channels, as many as the spec's
block), ``ssm`` the batch over data and the heads over model. Where the
batch is split, a decode step runs its own rows; the hybrid's shared
attention block, whose k/v split the length, gathers the rows over the
data group and hands back its own after it, and the rows are gathered
again before the final norm.
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
from repro_torch.dist.sharding import best_spec, local_shape
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (embed, he_init, init_embedding,
                                       init_mlp, mlp, rmsnorm, unembed)
from repro_torch.models.tensor_parallel import gather_blocks, split_of

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

def _groups(sp):
    """what -> the model group where ``what`` is split (None: whole)."""
    return (lambda what: None) if sp is None else sp.group


def _shared_block(sb, x, cfg: ModelConfig, positions, g=_groups(None)):
    """The hybrid's weight-tied attention + MLP block over x. Returns
    (x, (k, v)). ``g``: ``_groups``."""
    eps = cfg.norm_eps
    h = rmsnorm(x, sb["attn_norm"], eps)
    o, kv = attn.gqa_forward(sb["attn"], h, cfg.attention,
                             positions=positions, group=g("attn"))
    x = x + o
    h = rmsnorm(x, sb["ffn_norm"], eps)
    return x + coll.psum_(mlp(sb["mlp"], h, cfg.gated_mlp), g("mlp")), kv


def _apply_layer_full(lp, x, cfg: ModelConfig, is_global: bool,
                      apply_attn: bool, positions, shared_block, dp=None,
                      g=_groups(None)):
    """Full-sequence (train/prefill) layer. Returns (x, cache_seed, aux):
    the seed is (k, v) for GQA, (c_kv, k_rope) for MLA, (conv, ssm) for
    an SSM layer and (conv, ssm, k, v) for a hybrid one (zero k/v where
    the shared block does not follow); aux is the MoE load-balance loss
    (0 for every other layer); ``dp`` is ``moe_forward``'s; ``g`` maps a
    module to its tensor-parallel group (``_groups``)."""
    eps = cfg.norm_eps
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("ssm", "hybrid"):
        h = rmsnorm(x, lp["ssm_norm"], eps)
        o, seed = ssm_lib.mamba2_forward(lp["ssm"], h, cfg.ssm, eps=eps,
                                         group=g("ssm"))
        x = x + o
        if cfg.family == "hybrid":
            if apply_attn:
                x, kv = _shared_block(shared_block, x, cfg, positions, g)
            else:
                B, S = x.shape[0], x.shape[1]
                kv_heads = shared_block["attn"]["wk"].shape[-2]
                z = torch.zeros((B, S, kv_heads, cfg.head_dim),
                                dtype=x.dtype, device=x.device)
                kv = (z, z)
            seed = seed + kv
        return x, seed, aux
    h = rmsnorm(x, lp["attn_norm"], eps)
    if cfg.attention.use_mla:
        o, seed = attn.mla_forward(lp["attn"], h, cfg.attention,
                                   positions=positions, eps=eps,
                                   group=g("attn"))
    else:
        o, seed = attn.gqa_forward(lp["attn"], h, cfg.attention,
                                   positions=positions, is_global=is_global,
                                   group=g("attn"))
    x = x + o
    h = rmsnorm(x, lp["ffn_norm"], eps)
    if cfg.family == "moe":
        o, aux = moe_lib.moe_forward(lp["moe"], h, cfg.moe,
                                     gated=cfg.gated_mlp, dp=dp,
                                     tp=g("mlp"))
    else:
        o = coll.psum_(mlp(lp["mlp"], h, cfg.gated_mlp), g("mlp"))
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
               layer_resolver=None, dp=None, mesh=None):
    """tokens: (B, S_text). Returns (logits_or_hidden, aux, caches): aux
    is the MoE load-balance loss summed over the layers (0 for the other
    families); with ``collect_cache`` caches is the tuple of each layer's
    cache seed stacked over layers (``_apply_layer_full``), else None.

    For a VLM, ``image_embeds`` (B, N, d) plus ``img_pos`` are prepended
    (N + S_text positions in all). ``return_hidden=True`` skips the
    unembed (the chunked-CE training path). ``layer_resolver`` maps a
    layer's parameter slice to the form the block consumes, inside the
    remat boundary. ``dp = (group, W)``: the MoE layers dispatch over W
    data-parallel workers (``moe.moe_forward``). ``mesh`` (with M > 1):
    ``params`` are this rank's share of the model (the module docstring)
    and the logits its columns of the vocabulary; the seeds are its
    heads (and latent columns, and SSM channels)."""
    dtype = dtype_of(cfg)
    sp = split_of(cfg, mesh)
    g = _groups(sp)
    if sp is not None:
        params = sp.whole(params, small_only=True)
    x = embed(params["embedding"], tokens, dtype, g("vocab")) * \
        math.sqrt(cfg.d_model)
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
        if sp is not None:
            lp = sp.whole(lp, ("layers",))
        x, seed, aux = _apply_layer_full(lp, x, cfg, glob, with_attn,
                                         positions, shared_block, dp, g)
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


def cache_specs(cache_shapes, mesh) -> Dict[str, tuple]:
    """Partition specs of a cache's leaves on ``mesh`` from
    ``cache_shardings_hints`` (``cross_k``/``cross_v`` take ``k``/``v``'s),
    through ``dist.sharding.best_spec``: {name: spec tuple}.
    ``cache_shapes`` maps a leaf's name to a tensor or a ``(shape,
    dtype)`` pair. ``launch.steps.cache_shardings`` is this."""
    hints = cache_shardings_hints()
    hints.update({"cross_k": hints["k"], "cross_v": hints["v"]})
    out = {}
    for name, leaf in cache_shapes.items():
        shape = tuple(leaf.shape if hasattr(leaf, "shape") else leaf[0])
        out[name] = best_spec(shape, hints.get(name, (None,) * len(shape)),
                              mesh)
    return out


def local_cache_shapes(shapes: Dict[str, tuple], mesh) -> Dict[str, tuple]:
    """Each whole cache leaf's block on one rank of ``mesh``, as
    ``cache_specs`` lays it out; the K/V length must split over the data
    group (as ``kv_length`` requires)."""
    specs = cache_specs({n: (shape, None) for n, shape in shapes.items()},
                        mesh)
    W = mesh.shape.get("data", 1)
    for name in ("k", "v"):
        if name in specs and W > 1 and specs[name][2] != "data":
            raise ValueError(
                f"a K/V cache of length {shapes[name][2]} does not split "
                f"over {W} ranks; make the length a multiple of {W}")
    return {name: local_shape(shape, specs[name], mesh)
            for name, shape in shapes.items()}


def data_group(mesh):
    """The group ``mesh``'s data axis splits the cache over (None
    without a mesh: one process)."""
    return None if mesh is None else mesh.group


def kv_length(seq_len: int, group) -> int:
    """This rank's rows of a ``seq_len``-long K/V cache split over
    ``group`` (all of them without one). The split is what
    ``launch.steps.cache_shardings`` gives k/v on a (ranks, 1) mesh: the
    length over "data", which must divide it."""
    R = coll.axis_size(group)
    if seq_len % R:
        raise ValueError(f"a K/V cache of length {seq_len} does not split "
                         f"over {R} ranks; make the length a multiple of "
                         f"{R}")
    return seq_len // R


def init_lm_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None,
                  mesh=None):
    """Zero cache, stacked over layers (leading L axis), in the model's
    dtype; the SSM state in f32. With a ``mesh`` of M = 1 the k/v leaves
    hold this rank's ``kv_length`` rows of the length over its data
    group; the MLA latents and the SSM state stay whole on every rank.
    With M > 1 every leaf is this rank's block as ``cache_specs`` lays
    it out (``local_cache_shapes``)."""
    dev = resolve_device(device)
    sp = split_of(cfg, mesh)
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
        rows = (seq_len if sp is not None
                else kv_length(seq_len, data_group(mesh)))
        shapes["k"] = shapes["v"] = (L, batch, rows, a.num_kv_heads,
                                     cfg.head_dim)
    if sp is not None:
        shapes = local_cache_shapes(shapes, mesh)
    return {name: torch.zeros(shape, dtype=torch.float32 if name == "ssm"
                              else dtype, device=dev)
            for name, shape in shapes.items()}


def own_rows(x: torch.Tensor, n: int, group, dim: int = 1) -> torch.Tensor:
    """This rank's block of n rows of x along ``dim`` when x has more
    (the group's ranks hold equal blocks in rank order); x itself when
    it has n."""
    if x.shape[dim] == n:
        return x
    return x.narrow(dim, coll.axis_index(group) * n, n)


def seed_cache_from_prefill(cfg: ModelConfig, cache, seeds, *,
                            start: int = 0, mesh=None):
    """Write prefill cache seeds into a decode cache at ``start`` (in
    place; the cache is returned).

    ``seeds`` is the stacked tuple ``lm_forward(collect_cache=True)``
    returns. The forward already applies RoPE to K at the absolute
    positions 0..T−1, the values ``gqa_decode`` would have written token
    by token, so seeding the first T slots and decoding from
    ``pos = start + T`` reproduces the full forward. With a ``mesh``
    each rank writes the seeds' rows that fall in its data group's part
    of the k/v length; with M > 1 (the seeds of the split prefill:
    this rank's heads and latent columns) its data group's part of the
    length, and of the batch for ``ckv``/``kr`` where their batch is
    split. The SSM families carry a recurrent state with no positional
    slot, and raise."""
    if cfg.family not in ATTN_FAMILIES:
        raise NotImplementedError(
            f"prefill cache seeding is attention-only; family "
            f"{cfg.family!r} carries recurrent state that has no positional "
            "slot to seed")
    sp = split_of(cfg, mesh)
    data = data_group(mesh)
    names = ("ckv", "kr") if cfg.attention.use_mla else ("k", "v")
    for name, seed in zip(names, seeds):
        if sp is not None and name in ("ckv", "kr"):
            seed = own_rows(seed, cache[name].shape[1], data)
        T, S = seed.shape[2], cache[name].shape[2]
        lo = coll.axis_index(data) * S if name in ("k", "v") else 0
        a, b = max(start, lo), min(start + T, lo + S)
        if a < b:
            cache[name][:, :, a - lo:b - lo] = \
                seed[:, :, a - start:b - start].to(cache[name].dtype)
    return cache


def _ssm_state(c, sp, conv_dim: int, n_heads: int):
    """A layer's (conv, ssm) state whole over the model group where the
    cache splits it and the SSM runs whole (its heads or groups do not
    divide by M), else as held."""
    conv, ssm = c["conv"], c["ssm"]
    if sp is None or sp.flags.ssm:
        return conv, ssm
    if conv.shape[-1] != conv_dim:
        conv = gather_blocks([conv], [-1], sp.model)[0]
    if ssm.shape[1] != n_heads:
        ssm = gather_blocks([ssm], [1], sp.model)[0]
    return conv, ssm


@torch.no_grad()
def lm_decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                   mesh=None):
    """tokens: (B, 1); pos: int (or a 0-d tensor). Returns (logits,
    cache): logits (B, 1, V) f32; every layer's new K/V (or latent) row is
    written into the cache at ``pos``, and an SSM layer's conv and ssm
    state over its old one, in place. With a ``mesh`` of M = 1 the k/v
    length is split over its data group (``init_lm_cache``;
    ``attention.gqa_decode``). With M > 1, ``params`` are this rank's
    share, the cache its blocks (``init_lm_cache(mesh=)``), ``tokens``
    the whole batch's, and the logits the whole batch's, this rank's
    vocabulary columns."""
    pos = int(pos)
    eps = cfg.norm_eps
    a = cfg.attention
    sp = split_of(cfg, mesh)
    g = _groups(sp)
    kv_group = data_group(mesh)
    if sp is not None:
        if a is not None and a.use_mla and not sp.flags.attn:
            raise NotImplementedError(
                f"{cfg.name}: MLA over {sp.M} model ranks needs its heads, "
                "latent and d_model to divide by them")
        params = sp.whole(params, small_only=True)
    x = embed(params["embedding"], tokens, dtype_of(cfg),
              g("vocab")) * math.sqrt(cfg.d_model)
    # the batch rows of this rank where the cache splits them over data
    B = x.shape[0]
    bl = next((cache[n].shape[1] for n in ("ckv", "conv") if n in cache), B)
    r0 = 0 if bl == B else sp.d * bl
    x = x[r0:r0 + bl]
    flags = layer_flags(cfg)
    is_global = flags["is_global"].tolist()
    apply_attn = flags["apply_attn"].tolist()
    sb = params.get("shared_block")
    layer = _layer_slices(params["layers"])
    cache_l = _layer_slices(cache)
    if cfg.family in ("ssm", "hybrid"):
        _, n_heads, conv_dim = ssm_lib.ssm_dims(cfg.d_model, cfg.ssm)
    model = sp.model if sp is not None else None
    for i in range(cfg.num_layers):
        lp, c = layer(i), cache_l(i)
        if sp is not None:
            lp = sp.whole(lp, ("layers",))
        if cfg.family in ("ssm", "hybrid"):
            h = rmsnorm(x, lp["ssm_norm"], eps)
            conv, ssm = _ssm_state(c, sp, conv_dim, n_heads)
            o, (conv, ssm) = ssm_lib.mamba2_decode(
                lp["ssm"], h, cfg.ssm, conv_state=conv, ssm_state=ssm,
                eps=eps, group=g("ssm"))
            x = x + o
            c["conv"].copy_(own_rows(conv, c["conv"].shape[-1], model, -1))
            c["ssm"].copy_(own_rows(ssm, c["ssm"].shape[1], model))
            if apply_attn[i]:
                # the shared block's k/v split the length: every row
                if bl != B:
                    x = coll.all_gather(x, sp.data, tiled=True)
                h = rmsnorm(x, sb["attn_norm"], eps)
                o, _, _ = attn.gqa_decode(sb["attn"], h, a, cache_k=c["k"],
                                          cache_v=c["v"], pos=pos,
                                          kv_group=kv_group,
                                          group=g("attn"))
                x = x + o
                h = rmsnorm(x, sb["ffn_norm"], eps)
                x = x + coll.psum_(mlp(sb["mlp"], h, cfg.gated_mlp),
                                   g("mlp"))
                x = x[r0:r0 + bl]
            continue
        h = rmsnorm(x, lp["attn_norm"], eps)
        if a.use_mla:
            o, _, _ = attn.mla_decode(lp["attn"], h, a, cache_ckv=c["ckv"],
                                      cache_kr=c["kr"], pos=pos, eps=eps,
                                      group=g("attn"))
        else:
            o, _, _ = attn.gqa_decode(
                lp["attn"], h, a, cache_k=c["k"], cache_v=c["v"], pos=pos,
                is_global=is_global[i],
                sharded_cache_chunks=cfg.decode_sharded_chunks,
                kv_group=kv_group, group=g("attn"))
        x = x + o
        h = rmsnorm(x, lp["ffn_norm"], eps)
        if cfg.family == "moe":
            o, _ = moe_lib.moe_forward(lp["moe"], h, cfg.moe,
                                       gated=cfg.gated_mlp, tp=g("mlp"))
        else:
            o = coll.psum_(mlp(lp["mlp"], h, cfg.gated_mlp), g("mlp"))
        x = x + o
    if bl != B:
        x = coll.all_gather(x, sp.data, tiled=True)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(x, embedding=params.get("embedding")
                     if cfg.tie_embeddings else None,
                     lm_head=params.get("lm_head"),
                     final_softcap=cfg.final_logit_softcap)
    return logits, cache
