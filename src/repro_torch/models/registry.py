"""Model registry: one interface over the architecture families; port of
``repro/models/registry.py``.

``build_model(cfg)`` returns a ``Model`` with
  init(seed, device=None) -> params
  loss_fn(params, batch, remat=..., dp=None) -> (scalar loss, aux)
  forward(params, batch, remat=...) -> logits
  prefill(params, batch, mesh=None) -> (logits, cache seeds)
  init_cache(batch_size, seq_len, device=None, mesh=None) -> cache
  decode_step(params, cache, tokens, pos, mesh=None) -> (logits, cache)
  input_specs(shape) -> {name: (shape, dtype)}
for every decoder family (dense, MoE, SSM, hybrid, VLM; ``transformer``),
the encoder-decoder (audio; ``encdec``) and the paper's MLP, which has no
decode path. A VLM batch carries ``image_embeds`` (B, N, d) before its
text, an audio batch ``frames`` (B, S_enc, d). ``prefill`` and
``decode_step`` run without autograd; ``decode_step`` writes the cache in
place. A ``mesh`` (``launch.mesh.world_mesh(M)``) with M = 1 splits the
self-attention K/V cache's length over its data group
(``transformer.kv_length``). With M > 1 it splits the model over its
model group and every cache leaf as ``launch.steps.cache_shardings`` lays
it out: ``params`` are then this rank's share
(``tensor_parallel.init_params`` or ``shard_params``), the logits its
vocabulary columns (``tensor_parallel.greedy`` picks over all of them).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig, dtype_of
from repro_torch.models import encdec, transformer
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
    is_vlm = cfg.family == "vlm"

    def init(seed, device=None):
        return transformer.init_lm(seed, cfg, device)

    def forward(params, batch, remat=True, layer_resolver=None):
        logits, _, _ = transformer.lm_forward(
            params, cfg, batch["tokens"],
            image_embeds=batch.get("image_embeds"), remat=remat,
            layer_resolver=layer_resolver)
        return logits

    def loss_fn(params, batch, remat=True, layer_resolver=None, dp=None):
        hidden, aux, _ = transformer.lm_forward(
            params, cfg, batch["tokens"],
            image_embeds=batch.get("image_embeds"), remat=remat,
            return_hidden=True, layer_resolver=layer_resolver, dp=dp)
        tgt, mask = batch["targets"], None
        if is_vlm:      # the image positions carry no LM loss
            n_img = cfg.num_image_tokens
            tgt = torch.nn.functional.pad(tgt, (n_img, 0))
            mask = torch.ones(tgt.shape, dtype=torch.float32,
                              device=tgt.device)
            mask[:, :n_img] = 0.0
        loss = chunked_cross_entropy(
            hidden, tgt,
            embedding=params["embedding"] if cfg.tie_embeddings else None,
            lm_head=params.get("lm_head"),
            final_softcap=cfg.final_logit_softcap, mask=mask)
        if cfg.moe is not None:
            loss = loss + cfg.moe.router_aux_loss * aux / cfg.num_layers
        return loss, {"aux": aux}

    @torch.no_grad()
    def prefill(params, batch, mesh=None):
        logits, _, caches = transformer.lm_forward(
            params, cfg, batch["tokens"],
            image_embeds=batch.get("image_embeds"), remat=False,
            collect_cache=True, mesh=mesh)
        return logits, caches

    def init_cache(batch_size, seq_len, device=None, mesh=None):
        return transformer.init_lm_cache(cfg, batch_size, seq_len, device,
                                         mesh)

    def decode_step(params, cache, tokens, pos, mesh=None):
        return transformer.lm_decode_step(params, cfg, cache, tokens, pos,
                                          mesh)

    def input_specs(shape: InputShape):
        return lm_input_specs(cfg, shape)

    return Model(cfg, init, loss_fn, forward, prefill, init_cache,
                 decode_step, input_specs)


def _encdec_model(cfg: ModelConfig) -> Model:
    def init(seed, device=None):
        return encdec.init_encdec(seed, cfg, device)

    def forward(params, batch, remat=True, layer_resolver=None):
        enc = encdec.encode(params, cfg, batch["frames"],
                            layer_resolver=layer_resolver)
        return encdec.decode_full(params, cfg, batch["tokens"], enc,
                                  remat=remat, layer_resolver=layer_resolver)

    def loss_fn(params, batch, remat=True, layer_resolver=None, dp=None):
        enc = encdec.encode(params, cfg, batch["frames"],
                            layer_resolver=layer_resolver)
        hidden = encdec.decode_full(params, cfg, batch["tokens"], enc,
                                    remat=remat, return_hidden=True,
                                    layer_resolver=layer_resolver)
        return chunked_cross_entropy(hidden, batch["targets"],
                                     embedding=params["embedding"]), {}

    @torch.no_grad()
    def prefill(params, batch, mesh=None):
        """(logits, a decode cache as long as the tokens, its cross K/V
        seeded from the encoder)."""
        frames = batch["frames"]
        enc = encdec.encode(params, cfg, frames, mesh=mesh)
        cache = encdec.init_encdec_cache(cfg, frames.shape[0],
                                         batch["tokens"].shape[1],
                                         frames.device, mesh=mesh)
        cache = encdec.seed_cross_cache(params, cfg, cache, enc, mesh)
        logits = encdec.decode_full(params, cfg, batch["tokens"], enc,
                                    remat=False, mesh=mesh)
        return logits, cache

    def init_cache(batch_size, seq_len, device=None, mesh=None):
        return encdec.init_encdec_cache(cfg, batch_size, seq_len, device,
                                        mesh)

    def decode_step(params, cache, tokens, pos, mesh=None):
        return encdec.encdec_decode_step(params, cfg, cache, tokens, pos,
                                         mesh)

    def input_specs(shape: InputShape):
        return lm_input_specs(cfg, shape)

    return Model(cfg, init, loss_fn, forward, prefill, init_cache,
                 decode_step, input_specs)


def _mlp_model(cfg: ModelConfig) -> Model:
    def init(seed, device=None):
        return init_mlp_mnist(seed, cfg.d_ff, cfg.d_model, cfg.vocab_size,
                              device=device)

    def loss_fn(params, batch, remat=False, layer_resolver=None, dp=None):
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
    dtype = dtype_of(cfg)
    tok = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            return {"frames": ((B, cfg.encoder_seq_len, cfg.d_model), dtype),
                    "tokens": ((B, S), tok), "targets": ((B, S), tok)}
        if cfg.family == "vlm":
            s_text = S - cfg.num_image_tokens
            return {"image_embeds": ((B, cfg.num_image_tokens, cfg.d_model),
                                     dtype),
                    "tokens": ((B, s_text), tok),
                    "targets": ((B, s_text), tok)}
        return {"tokens": ((B, S), tok), "targets": ((B, S), tok)}
    # decode: one new token against a seq_len cache
    return {"tokens": ((B, 1), tok)}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "mlp":
        return _mlp_model(cfg)
    if cfg.family == "audio":
        return _encdec_model(cfg)
    return _lm_model(cfg)
