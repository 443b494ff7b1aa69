"""Model registry: one interface over the architecture families; port of
``repro/models/registry.py``.

``build_model(cfg)`` returns a ``Model`` with
  init(seed, device=None) -> params
  loss_fn(params, batch, remat=...) -> (scalar loss, aux)
  forward(params, batch, remat=...) -> logits
  input_specs(shape) -> {name: (shape, dtype)}
and ``prefill``, ``init_cache``, ``decode_step``, which raise
``NotImplementedError`` until the LM decode path is ported. This slice
builds the dense GQA decoders and the paper's MLP; the other families
raise ``NotImplementedError`` naming their ROADMAP item.
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


def _no_decode(*args, **kwargs):
    raise NotImplementedError(
        f"not ported yet — {transformer.LATER['decode']}")


def _lm_model(cfg: ModelConfig) -> Model:
    transformer.check_supported(cfg)

    def init(seed, device=None):
        return transformer.init_lm(seed, cfg, device)

    def forward(params, batch, remat=True, layer_resolver=None):
        logits, _ = transformer.lm_forward(
            params, cfg, batch["tokens"], remat=remat,
            layer_resolver=layer_resolver)
        return logits

    def loss_fn(params, batch, remat=True, layer_resolver=None):
        hidden, aux = transformer.lm_forward(
            params, cfg, batch["tokens"], remat=remat, return_hidden=True,
            layer_resolver=layer_resolver)
        loss = chunked_cross_entropy(
            hidden, batch["targets"],
            embedding=params["embedding"] if cfg.tie_embeddings else None,
            lm_head=params.get("lm_head"),
            final_softcap=cfg.final_logit_softcap)
        return loss, {"aux": aux}

    def input_specs(shape: InputShape):
        return lm_input_specs(cfg, shape)

    return Model(cfg, init, loss_fn, forward, _no_decode, _no_decode,
                 _no_decode, input_specs)


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
