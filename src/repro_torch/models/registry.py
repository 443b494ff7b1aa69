"""Model registry: one interface over the architecture families; port of
``repro/models/registry.py``.

``build_model(cfg)`` returns a ``Model`` with
  init(seed, device=None) -> params
  loss_fn(params, batch, remat=...) -> (scalar loss, aux)
  forward(params, batch, remat=...) -> logits
  prefill(params, batch) -> (logits, cache seeds)
  init_cache(batch_size, seq_len, device=None) -> cache
  decode_step(params, cache, tokens, pos) -> (logits, cache)
  input_specs(shape) -> {name: (shape, dtype)}
for the dense and MoE decoders (GQA or MLA) and the paper's MLP, which has
no decode path. SSM, hybrid, VLM and audio models raise
``NotImplementedError`` naming their ROADMAP item. ``prefill`` and
``decode_step`` run without autograd; ``decode_step`` writes the cache in
place.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer
from repro_torch.models.layers import chunked_cross_entropy
from repro_torch.models.mlp_mnist import (init_mlp_mnist, mlp_mnist_logits,
                                          mlp_mnist_loss)


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable
    loss_fn: Callable
    forward: Callable
    prefill: Callable
    init_cache: Callable
    decode_step: Callable
    input_specs: Callable


def cross_entropy(logits, targets, mask=None):
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _lm_model(cfg: ModelConfig) -> Model:
    transformer.check_supported(cfg)

    def init(seed, device=None):
        return transformer.init_lm(seed, cfg, device)

    def forward(params, batch, remat=True, layer_resolver=None):
        logits, _, _ = transformer.lm_forward(
            params, cfg, batch["tokens"], remat=remat,
            layer_resolver=layer_resolver)
        return logits

    def loss_fn(params, batch, remat=True, layer_resolver=None):
        hidden, aux, _ = transformer.lm_forward(
            params, cfg, batch["tokens"], remat=remat, return_hidden=True,
            layer_resolver=layer_resolver)
        loss = chunked_cross_entropy(
            hidden, batch["targets"],
            embedding=params["embedding"] if cfg.tie_embeddings else None,
            lm_head=params.get("lm_head"),
            final_softcap=cfg.final_logit_softcap)
        if cfg.moe is not None:
            loss = loss + cfg.moe.router_aux_loss * aux / cfg.num_layers
        return loss, {"aux": aux}

    @torch.no_grad()
    def prefill(params, batch):
        logits, _, caches = transformer.lm_forward(
            params, cfg, batch["tokens"], remat=False, collect_cache=True)
        return logits, caches

    def init_cache(batch_size, seq_len, device=None):
        return transformer.init_lm_cache(cfg, batch_size, seq_len, device)

    def decode_step(params, cache, tokens, pos):
        return transformer.lm_decode_step(params, cfg, cache, tokens, pos)

    def input_specs(shape: InputShape):
        return lm_input_specs(cfg, shape)

    return Model(cfg, init, loss_fn, forward, prefill, init_cache,
                 decode_step, input_specs)


def _mlp_model(cfg: ModelConfig) -> Model:
    def init(seed, device=None):
        return init_mlp_mnist(seed, cfg.d_ff, cfg.d_model, cfg.vocab_size,
                              device=device)

    def loss_fn(params, batch, remat=False, layer_resolver=None):
        return mlp_mnist_loss(params, batch["x"], batch["y"]), {}

    def forward(params, batch, remat=False, layer_resolver=None):
        return mlp_mnist_logits(params, batch["x"])

    def unsupported(*a, **k):
        raise NotImplementedError("mnist-mlp has no decode path")

    def input_specs(shape: InputShape):
        B = shape.global_batch
        return {"x": ((B, cfg.d_ff), torch.float32),
                "y": ((B,), torch.int32)}

    return Model(cfg, init, loss_fn, forward, unsupported, unsupported,
                 unsupported, input_specs)


def lm_input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """(shape, dtype) of every model input, allocating nothing."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        return {"tokens": ((B, S), torch.int32),
                "targets": ((B, S), torch.int32)}
    # decode: one new token against a seq_len cache
    return {"tokens": ((B, 1), torch.int32)}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "mlp":
        return _mlp_model(cfg)
    return _lm_model(cfg)
