"""Decoder-only LM, dense GQA family; port of ``repro/models/transformer.py``.

Parameters are a nested dict of tensors, the per-layer ones **stacked**
along a leading layer axis L, exactly as the reference's ``init_lm``
builds them: the leaf names, shapes and the ``repro_torch.tree`` flatten
order equal the reference's, which the per-leaf OBCSAA aggregation and its
per-leaf noise depend on. The reference's ``lax.scan`` over layers is a
loop over layer slices (``unbind``: one gradient ``stack`` per leaf in the
backward pass, not a full-size scatter per layer); ``remat_wrap`` maps the
reference's ``jax.checkpoint`` policies onto ``torch.utils.checkpoint``.

MoE, SSM, hybrid, VLM and MLA layers and the decode-time cache belong to
later slices (``ROADMAP.md`` Queue 1) and raise ``NotImplementedError``.
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
from repro_torch.models.layers import (embed, he_init, init_embedding,
                                       init_mlp, mlp, rmsnorm, unembed)

LATER = {
    "moe": "MoE (mixtral, deepseek): ROADMAP.md Queue 1, item 2",
    "mla": "MLA attention (minicpm3, deepseek): ROADMAP.md Queue 1, item 2",
    "ssm": "SSM and hybrid (mamba2, zamba2): ROADMAP.md Queue 1, item 3",
    "hybrid": "SSM and hybrid (mamba2, zamba2): ROADMAP.md Queue 1, item 3",
    "vlm": "VLM and enc-dec (internvl2, whisper): ROADMAP.md Queue 1, item 4",
    "audio": "VLM and enc-dec (internvl2, whisper): ROADMAP.md Queue 1, "
             "item 4",
    "decode": "the LM decode path (prefill, init_cache, decode_step): "
              "ROADMAP.md Queue 1, item 1",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for a model
    this slice cannot build: anything but a dense GQA decoder."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet — "
            f"{LATER.get(cfg.family, 'ROADMAP.md Queue 1')}")
    if cfg.attention is None or cfg.attention.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet — {LATER['mla']}")


# --- init --------------------------------------------------------------------

def _init_layers(generator, cfg: ModelConfig, device, dtype):
    """The stacked (L, ...) per-layer parameters of a dense GQA model."""
    check_supported(cfg)
    L, d = cfg.num_layers, cfg.d_model
    return {
        "attn_norm": torch.zeros((L, d), dtype=dtype, device=device),
        "attn": attn.init_gqa(generator, d, cfg.attention, lead=(L,),
                              device=device, dtype=dtype),
        "ffn_norm": torch.zeros((L, d), dtype=dtype, device=device),
        "mlp": init_mlp(generator, d, cfg.d_ff, cfg.gated_mlp, lead=(L,),
                        device=device, dtype=dtype),
    }


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


# --- layer application -------------------------------------------------------

def _apply_layer_full(lp, x, cfg: ModelConfig, is_global: bool, positions):
    """Full-sequence (train/prefill) dense layer."""
    eps = cfg.norm_eps
    h = rmsnorm(x, lp["attn_norm"], eps)
    o, _ = attn.gqa_forward(lp["attn"], h, cfg.attention,
                            positions=positions, is_global=is_global)
    x = x + o
    h = rmsnorm(x, lp["ffn_norm"], eps)
    return x + mlp(lp["mlp"], h, cfg.gated_mlp)


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
               return_hidden=False, layer_resolver=None):
    """tokens: (B, S). Returns (logits_or_hidden, aux); aux is the MoE
    load-balance sum, 0 for a dense model.

    ``return_hidden=True`` skips the unembed (the chunked-CE training
    path). ``layer_resolver`` maps a layer's parameter slice to the form
    the block consumes, inside the remat boundary."""
    check_supported(cfg)
    dtype = dtype_of(cfg)
    x = embed(params["embedding"], tokens, dtype) * math.sqrt(cfg.d_model)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    is_global = layer_flags(cfg)["is_global"].tolist()
    leaves, treedef = tree.flatten(params["layers"])
    slices = [leaf.unbind(0) for leaf in leaves]

    def body(x, lp, glob):
        if layer_resolver is not None:
            lp = layer_resolver(lp)
        return _apply_layer_full(lp, x, cfg, glob, positions)

    body_fn = remat_wrap(body, remat)
    for i in range(cfg.num_layers):
        lp = tree.unflatten(treedef, [s[i] for s in slices])
        x = body_fn(x, lp, is_global[i])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, aux
    logits = unembed(x, embedding=params.get("embedding")
                     if cfg.tie_embeddings else None,
                     lm_head=params.get("lm_head"),
                     final_softcap=cfg.final_logit_softcap)
    return logits, aux
