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
leaf's temporaries are alive at a time, and a large leaf's only for a
block of its chunks (``BLOCK_ROWS``).

With ``TrainConfig.cs_shard_aligned`` a leaf is chunked along its
model-sharded dim first: the specs are ``dist.sharding``'s on the step's
logical mesh (``launch.mesh``), and on a 1 x 1 mesh no dim is sharded.
``make_zoo_train_round`` builds the zoo's real-backward round
(``engine/zoo_train.py``) from the same TrainConfig.

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
from repro_torch.core import channel as chan
from repro_torch.core.obcsaa import (OBCSAAConfig, shardmap_compress,
                                     shardmap_reconstruct)
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import infer_param_specs
from repro_torch.launch.mesh import ZooMesh, make_host_mesh
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


#: Chunk rows compressed or decoded at a time. A leaf's temporaries (the
#: bisection's per-pass counts, the BIHT iterate and its update) grow with
#: the rows in flight, several times the rows' own size, so a multi-GB leaf
#: (mamba2-2.7b's stacked in_proj is 8.1 GB in f32) goes through in blocks.
#: Rows are independent and the leaf's AWGN is drawn whole, so the blocks
#: change no draw.
BLOCK_ROWS = 1 << 17


def _aggregate_leaf(ob: OBCSAAConfig, leaf: torch.Tensor, phi, *, k_weight,
                    beta_i, b_t, generator=None, noise=None,
                    wire_dtype=torch.float32, perm=None, hook=None,
                    index: int = 0) -> torch.Tensor:
    """Compress one gradient leaf on this worker, superpose, decode, in
    blocks of ``BLOCK_ROWS`` chunks. ``hook(stage, index, grad,
    decoded)``, when given, is called after the compression ("compress")
    and after the decode ("decode", with the leaf and its decoded chunks,
    flat and padded, before the cut back to the leaf's size)."""
    leaf_t = leaf.permute(perm) if perm is not None else leaf
    flat = leaf_t.reshape(-1).to(torch.float32)
    D = flat.shape[0]
    rem = (-D) % ob.chunk
    if rem:
        flat = torch.nn.functional.pad(flat, (0, rem))
    chunks = flat.reshape(-1, ob.chunk)
    n = chunks.shape[0]
    starts = range(0, n, BLOCK_ROWS)
    sent = [shardmap_compress(ob, chunks[r:r + BLOCK_ROWS], k_weight=k_weight,
                              beta_i=beta_i, b_t=b_t, phi=phi,
                              wire_dtype=wire_dtype) for r in starts]
    del flat, chunks
    if hook is not None:
        hook("compress", index, None, None)
    if noise is None:
        noise = chan.draw_noise(generator, (n, ob.measure), ob.noise_var,
                                device=leaf.device)
    ghat = torch.empty((n, ob.chunk), dtype=torch.float32,
                       device=leaf.device)
    for r in starts:
        y, ksum, mag_sum = sent.pop(0)
        ghat[r:r + BLOCK_ROWS] = shardmap_reconstruct(
            ob, y, ksum, mag_sum, b_t=b_t, phi=phi,
            noise=noise[r:r + BLOCK_ROWS]).reshape(-1, ob.chunk)
    ghat = ghat.reshape(-1)
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


def make_train_step(model: Model, tcfg: TrainConfig,
                    mesh: Optional[ZooMesh] = None) -> Callable:
    """Returns ``step(params, opt_state, batch, round_ctx) -> (params,
    opt_state, metrics)``. ``round_ctx`` is ``default_round_ctx``'s dict;
    it may also hold ``phi``, ``noise`` (one AWGN tensor per leaf) and
    ``hook`` (``_aggregate_leaf``'s, also called with "backward" after the
    gradient and "update" after the optimizer step).

    With ``tcfg.cs_shard_aligned`` each leaf is chunked along its
    model-sharded dim first: the specs are ``infer_param_sharding``'s on
    ``mesh`` (default ``make_host_mesh()``; on a 1 x 1 mesh no leaf is
    sharded and every permutation is None)."""
    opt = make_optimizer(tcfg)
    grad_specs = None
    if tcfg.cs_shard_aligned:
        grad_specs = infer_param_specs(model.init(0, device="meta"),
                                       mesh or make_host_mesh())

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
                wire_dtype=wire_dtype, specs=grad_specs, hook=hook)
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


# --- zoo-scale real-gradient rounds ------------------------------------------

def make_zoo_train_round(model: Model, tcfg: TrainConfig, mesh, **kw):
    """The real-backward zoo round (``engine.zoo_train.ZooTrainRound``)
    for (model, tcfg, mesh), built from the same TrainConfig knobs the
    per-leaf train step reads: ``obcsaa_config(tcfg)`` for the wire
    geometry, ``tcfg.remat_mode``, the optimizer and error feedback.
    Extra kwargs (``scheduler``, ``compute_dtype``, ``device``, ...) pass
    through."""
    from repro_torch.engine.zoo_train import ZooTrainRound
    kw.setdefault("remat", tcfg.remat_mode)
    kw.setdefault("optimizer", tcfg.optimizer)
    kw.setdefault("error_feedback", tcfg.error_feedback)
    return ZooTrainRound(model, mesh, obcsaa_config(tcfg), **kw)


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
    """Prefill a prompt prefix and seed a ``total_len`` decode cache.

    Returns ``step(params, batch) -> (logits, cache, offset)``: the
    prefix (a VLM's ``image_embeds``, then any prompt tokens; the tokens
    may be zero-length) runs through the full forward once, its per-layer
    cache seeds land in slots [0, offset) of a fresh cache on the tokens'
    device, and decoding continues at ``pos = offset + i``. Decode steps
    are text-only, so an image enters through the cache. The SSM, hybrid
    and audio families have no positional seeds and raise
    (``transformer.seed_cache_from_prefill``), as in the reference."""
    cfg = model.cfg

    def step(params, batch):
        tokens = batch["tokens"]
        logits, seeds = model.prefill(params, batch)
        img = batch.get("image_embeds")
        offset = tokens.shape[1] + (img.shape[1] if img is not None else 0)
        cache = model.init_cache(tokens.shape[0], total_len, tokens.device)
        cache = transformer.seed_cache_from_prefill(cfg, cache, seeds,
                                                    start=0)
        return logits, cache, offset

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
