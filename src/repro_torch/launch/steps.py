"""The train steps of the LM trainer (``mean`` | ``obcsaa``) and the
serve steps (prefill, decode, seeded prefill); port of
``repro/launch/steps.py``.

One card is one FL worker: the reference's worker mesh axes shrink to a
one-worker world, so the MAC sum is the worker's own power-scaled symbols
and the PS adds AWGN and decodes (``core.obcsaa.shardmap_*``). Each
gradient leaf goes through the 1-bit CS uplink on its own, in
``repro_torch.tree`` order (the reference's ``tree_flatten`` order): it is
flattened row-major, zero-padded to a whole number of chunks, compressed
(bisection top-κ, Φ-projection, sign), decoded (BIHT with the bisection
hard threshold) and cast back to the leaf's dtype. Φ is drawn once per
step and shared by every leaf; leaf i's AWGN is the i-th draw from the
step's generator (the reference folds i into the step's key). Only one
leaf's temporaries are alive at a time.

Like the reference's trainer and decode, these paths launch none of the
port's CUDA kernels: ``obcsaa_config`` sets ``spmd_topk`` and leaves
``use_kernels`` off, and the decode path calls no kernel.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import checkpoint, tree
from repro_torch.configs.base import TrainConfig
from repro_torch.core.obcsaa import (OBCSAAConfig, shardmap_compress,
                                     shardmap_reconstruct)
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.registry import Model
from repro_torch.optim import Optimizer, make as make_opt


def make_optimizer(tcfg: TrainConfig) -> Optimizer:
    return make_opt(tcfg.optimizer)


def obcsaa_config(tcfg: TrainConfig) -> OBCSAAConfig:
    return OBCSAAConfig(chunk=tcfg.cs_chunk, measure=tcfg.cs_measure,
                        topk=tcfg.cs_topk, biht_iters=tcfg.biht_iters,
                        decoder=tcfg.cs_decoder, recon_tau=tcfg.cs_tau,
                        noise_var=tcfg.noise_var, p_max=tcfg.p_max,
                        spmd_topk=True, packed=tcfg.cs_packed)


# --- OBCSAA per-leaf gradient aggregation ------------------------------------

def _shard_aligned_perm(leaf_shape, spec, model_axis="model"):
    """Permutation putting the model-sharded dim first, so the
    flatten->chunk reshape is local to a shard. ``spec`` is a partition
    spec as a tuple of axis names (or tuples of them, or None) per dim."""
    if spec is None:
        return None
    parts = list(spec) + [None] * (len(leaf_shape) - len(spec))
    for i, p in enumerate(parts):
        names = (p,) if isinstance(p, str) else (p or ())
        if model_axis in names:
            return (i,) + tuple(j for j in range(len(leaf_shape)) if j != i)
    return None


def _aggregate_leaf(ob: OBCSAAConfig, leaf: torch.Tensor, phi, *, k_weight,
                    beta_i, b_t, generator=None, noise=None,
                    wire_dtype=torch.float32, perm=None, hook=None,
                    index: int = 0) -> torch.Tensor:
    """Compress one gradient leaf on this worker, superpose, decode.
    ``hook(stage, index, grad, decoded)``, when given, is called after
    the compression ("compress") and after the decode ("decode", with the
    leaf and its decoded chunks, flat and padded, before the cut back to
    the leaf's size)."""
    leaf_t = leaf.permute(perm) if perm is not None else leaf
    flat = leaf_t.reshape(-1).to(torch.float32)
    D = flat.shape[0]
    rem = (-D) % ob.chunk
    if rem:
        flat = torch.nn.functional.pad(flat, (0, rem))
    chunks = flat.reshape(-1, ob.chunk)
    y, ksum, mag_sum = shardmap_compress(ob, chunks, k_weight=k_weight,
                                         beta_i=beta_i, b_t=b_t, phi=phi,
                                         wire_dtype=wire_dtype)
    del flat, chunks
    if hook is not None:
        hook("compress", index, None, None)
    ghat = shardmap_reconstruct(ob, y, ksum, mag_sum, b_t=b_t, phi=phi,
                                generator=generator, noise=noise)
    out = ghat[:D].reshape(leaf_t.shape).to(leaf.dtype)
    if perm is not None:
        out = out.permute(tuple(int(i) for i in np.argsort(perm)))
    if hook is not None:
        hook("decode", index, leaf, ghat)
    return out


def obcsaa_aggregate_tree(ob: OBCSAAConfig, grads, *, k_weight, beta_i, b_t,
                          generator: Optional[torch.Generator] = None,
                          noises: Optional[List[torch.Tensor]] = None,
                          phi: Optional[torch.Tensor] = None,
                          wire_dtype=torch.float32,
                          specs: Optional[list] = None, hook=None):
    """The decoded gradient tree, leaf by leaf. ``noises[i]`` (leaf i's
    AWGN, (n_chunks_i, S_c)) and ``phi`` replace the draws; ``specs``
    gives each leaf's partition spec, in leaf order, for the shard-aligned
    chunking."""
    leaves, treedef = tree.flatten(grads)
    if phi is None:
        phi = ob.phi(leaves[0].device)
    out = []
    for i, leaf in enumerate(leaves):
        perm = (_shard_aligned_perm(leaf.shape, specs[i])
                if specs is not None else None)
        out.append(_aggregate_leaf(
            ob, leaf, phi, k_weight=k_weight, beta_i=beta_i, b_t=b_t,
            generator=generator,
            noise=noises[i] if noises is not None else None,
            wire_dtype=wire_dtype, perm=perm, hook=hook, index=i))
    return tree.unflatten(treedef, out)


# --- train steps -------------------------------------------------------------

def loss_and_grads(model: Model, tcfg: TrainConfig, params, batch):
    """(loss, grads): the gradient of the mean loss with respect to every
    parameter leaf, a tree of the parameters' structure."""
    leaves, treedef = tree.flatten(params)
    req = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, _ = model.loss_fn(tree.unflatten(treedef, req), batch,
                                remat=tcfg.remat_mode)
        grads = torch.autograd.grad(loss, req)
    return loss.detach(), tree.unflatten(treedef, list(grads))


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns ``step(params, opt_state, batch, round_ctx) -> (params,
    opt_state, metrics)``. ``round_ctx`` is ``default_round_ctx``'s dict;
    it may also hold ``phi``, ``noise`` (one AWGN tensor per leaf) and
    ``hook`` (``_aggregate_leaf``'s, also called with "backward" after the
    gradient and "update" after the optimizer step)."""
    opt = make_optimizer(tcfg)
    if tcfg.cs_shard_aligned:
        raise NotImplementedError(
            "TrainConfig.cs_shard_aligned needs the parameter shardings of "
            "dist/sharding (ROADMAP.md Queue 1, item 4)")

    if tcfg.aggregation == "mean":
        def step(params, opt_state, batch, round_ctx=None):
            loss, grads = loss_and_grads(model, tcfg, params, batch)
            with torch.no_grad():
                params, opt_state = opt.update(grads, opt_state, params,
                                               tcfg.learning_rate)
            return params, opt_state, {"loss": loss}

        return step
    if tcfg.aggregation != "obcsaa":
        raise ValueError(f"unknown aggregation {tcfg.aggregation!r} "
                         "(mean | obcsaa)")

    ob = obcsaa_config(tcfg)
    wire_dtype = (torch.bfloat16 if tcfg.wire_dtype == "bfloat16"
                  else torch.float32)

    def step(params, opt_state, batch, round_ctx):
        hook = round_ctx.get("hook")
        loss, grads = loss_and_grads(model, tcfg, params, batch)
        if hook is not None:
            hook("backward", -1, None, None)
        with torch.no_grad():
            # the one worker's β; K_i = 1 (equal shards, as the reference)
            ghat = obcsaa_aggregate_tree(
                ob, grads, k_weight=1.0, beta_i=round_ctx["beta"][0],
                b_t=round_ctx["b_t"], generator=round_ctx.get("generator"),
                noises=round_ctx.get("noise"), phi=round_ctx.get("phi"),
                wire_dtype=wire_dtype, hook=hook)
            del grads
            params, opt_state = opt.update(ghat, opt_state, params,
                                           tcfg.learning_rate)
        if hook is not None:
            hook("update", -1, None, None)
        return params, opt_state, {"loss": loss}

    return step


def default_round_ctx(seed: int = 0, device=None) -> Dict:
    """Everyone scheduled at unit power: h = β = 1 for the one worker,
    b_t = 1, and the step's generator (the reference's PRNG key)."""
    dev = resolve_device(device)
    return {"h": torch.ones((1,), dtype=torch.float32, device=dev),
            "beta": torch.ones((1,), dtype=torch.float32, device=dev),
            "b_t": torch.ones((), dtype=torch.float32, device=dev),
            "generator": torch.Generator(device=dev).manual_seed(seed)}


# --- serve steps -------------------------------------------------------------

def make_prefill_step(model: Model) -> Callable:
    def step(params, batch):
        return model.prefill(params, batch)

    return step


def make_decode_step(model: Model) -> Callable:
    def step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return step


def make_seeded_prefill(model: Model, total_len: int) -> Callable:
    """Prefill a prompt and seed a ``total_len`` decode cache.

    Returns ``step(params, batch) -> (logits, cache, offset)``: the
    prompt runs through the full forward once, its per-layer cache seeds
    land in slots [0, offset) of a fresh cache on the tokens' device,
    and decoding continues at ``pos = offset + i``."""
    cfg = model.cfg

    def step(params, batch):
        if batch.get("image_embeds") is not None:
            raise NotImplementedError(
                "an image prefix needs the VLM family (ROADMAP.md Queue 1, "
                "item 2)")
        tokens = batch["tokens"]
        logits, seeds = model.prefill(params, batch)
        cache = model.init_cache(tokens.shape[0], total_len, tokens.device)
        cache = transformer.seed_cache_from_prefill(cfg, cache, seeds,
                                                    start=0)
        return logits, cache, tokens.shape[1]

    return step


# --- trainer checkpointing ---------------------------------------------------

def save_train_state(ckpt_dir: str, step: int, params, opt_state) -> str:
    """Snapshot params + optimizer state at ``step`` (one atomic step
    directory, the reference's format: either package restores it)."""
    return checkpoint.save(ckpt_dir, step,
                           {"params": params, "opt_state": opt_state})


def restore_train_state(ckpt_dir: str, model: Model, tcfg: TrainConfig,
                        device=None):
    """(params, opt_state, step) from the latest checkpoint, on
    ``device``; None when ``ckpt_dir`` holds no steps yet."""
    step = checkpoint.latest_step(ckpt_dir)
    if step is None:
        return None
    dev = resolve_device(device)
    pshapes = model.init(0, device="meta")
    oshapes = make_optimizer(tcfg).init(pshapes)
    got = checkpoint.restore(ckpt_dir, step,
                             {"params": pshapes, "opt_state": oshapes})
    got = tree.tree_map(lambda t: t.to(dev), got)
    return got["params"], got["opt_state"], step
