"""The train steps of the LM trainer (``mean`` | ``obcsaa``), the
P2-scheduled round contexts and the multi-round step, and the serve
steps (prefill, decode, seeded prefill); port of
``repro/launch/steps.py``.

FL workers. The step's mesh (``launch.mesh.ZooMesh``) has U =
``num_workers(mesh)`` workers, and the global batch's leading dim is
split over them: worker r takes rows ``[r·B/U, (r+1)·B/U)``. With the
mesh's ``group`` (``launch.mesh.join_world``) each worker is a process and
the MAC is the group's all-reduce (``dist/collectives``); without one the
U workers run in turn in one process, the oracle the process path is
held against. One worker (no mesh) is the one-card federation.

``obcsaa``: each worker takes the gradient of its own shard's loss. Each
gradient leaf goes through the 1-bit CS uplink on its own, in
``repro_torch.tree`` order (the reference's ``tree_flatten`` order): it is
flattened row-major, zero-padded to a whole number of chunks, compressed
(bisection top-κ, Φ-projection, sign) with the worker's β_i and K_i = 1,
superposed over the workers, and decoded (BIHT with the bisection hard
threshold) by the PS, rank 0 of the group, which broadcasts the decoded
leaf: every rank applies the same ĝ bit for bit, and a shared card runs
one decode, not U. Φ is drawn once per step and shared by every leaf;
leaf i's AWGN is the i-th draw from the step's generator (the reference
folds i into the step's key). Only one leaf's temporaries are alive at a
time, and a large leaf's only for a block of its chunks
(``BLOCK_ROWS``). The loss is the workers' mean.

``mean``: the gradient of the global batch's mean loss, as the
reference's GSPMD step takes it; over processes the all-reduced sum of
the shards' gradients over U. The two agree when every row has the same
count of valid targets, as in the trainer's batches (a VLM's image
positions are masked alike in every row). An MoE layer dispatches per
worker under the reference's rule (``models.moe.moe_forward``'s ``dp``).

With ``TrainConfig.cs_shard_aligned`` a leaf is chunked along its
model-sharded dim first: the specs are ``dist.sharding``'s on the step's
mesh, and with a model axis of 1 no dim is sharded.
``make_zoo_train_round`` builds the zoo's real-backward round
(``engine/zoo_train.py``) from the same TrainConfig.

Like the reference's trainer and decode, these paths launch none of the
port's CUDA kernels: ``obcsaa_config`` sets ``spmd_topk`` and leaves
``use_kernels`` off, the scheduled contexts use ``SchedConfig()`` (no
kernel), and the decode path calls no kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import checkpoint, tree
from repro_torch.configs.base import TrainConfig
from repro_torch.core import channel as chan
from repro_torch.core.obcsaa import (OBCSAAConfig, shardmap_compress,
                                     shardmap_reconstruct)
from repro_torch.device import resolve_device
from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import (infer_param_sharding,
                                       infer_param_specs)
from repro_torch.launch.mesh import ZooMesh, make_zoo_mesh, num_workers
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


def _send_leaf(ob: OBCSAAConfig, leaf: torch.Tensor, phi, group=None, *,
               k_weight, beta_i, b_t, wire_dtype=torch.float32, perm=None):
    """This worker's compression of one leaf, superposed over ``group``,
    in blocks of ``BLOCK_ROWS`` chunks: a list of ``shardmap_compress``'s
    (y, ksum, mag_sum), one a block."""
    leaf_t = leaf.permute(perm) if perm is not None else leaf
    flat = leaf_t.reshape(-1).to(torch.float32)
    rem = (-flat.shape[0]) % ob.chunk
    if rem:
        flat = torch.nn.functional.pad(flat, (0, rem))
    chunks = flat.reshape(-1, ob.chunk)
    return [shardmap_compress(ob, chunks[r:r + BLOCK_ROWS], group,
                              k_weight=k_weight, beta_i=beta_i, b_t=b_t,
                              phi=phi, wire_dtype=wire_dtype)
            for r in range(0, chunks.shape[0], BLOCK_ROWS)]


def _add_sent(acc, sent):
    """Blockwise sum of two workers' ``_send_leaf`` lists."""
    if acc is None:
        return sent
    return [tuple(a + b if a is not None else None for a, b in zip(x, y))
            for x, y in zip(acc, sent)]


def _receive_leaf(ob: OBCSAAConfig, leaf: torch.Tensor, sent, phi,
                  group=None, *, b_t, generator=None, noise=None, perm=None,
                  hook=None, index: int = 0) -> torch.Tensor:
    """The PS's half for one leaf: AWGN, post-processing and decode of
    the superposed blocks ``sent`` on rank 0 of ``group``, broadcast to
    every rank; the decoded leaf in ``leaf``'s shape and dtype (``leaf``
    may be a meta tensor of them). ``hook`` is called with "decode", the
    leaf (None for a meta one) and its decoded chunks (flat and padded,
    before the cut back to the leaf's size)."""
    leaf_t = leaf.permute(perm) if perm is not None else leaf
    D = leaf_t.numel()
    n = -(-D // ob.chunk)
    dev = sent[0][0].device
    ghat = torch.empty((n, ob.chunk), dtype=torch.float32, device=dev)
    if coll.axis_index(group) == 0:
        if noise is None:
            noise = chan.draw_noise(generator, (n, ob.measure),
                                    ob.noise_var, device=dev)
        for r in range(0, n, BLOCK_ROWS):
            y, ksum, mag_sum = sent.pop(0)
            ghat[r:r + BLOCK_ROWS] = shardmap_reconstruct(
                ob, y, ksum, mag_sum, b_t=b_t, phi=phi,
                noise=noise[r:r + BLOCK_ROWS]).reshape(-1, ob.chunk)
    sent.clear()
    ghat = coll.broadcast(ghat, group).reshape(-1)
    out = ghat[:D].reshape(leaf_t.shape).to(leaf.dtype)
    if perm is not None:
        out = out.permute(tuple(int(i) for i in np.argsort(perm)))
    if hook is not None:
        hook("decode", index, None if leaf.is_meta else leaf, ghat)
    return out


def _aggregate_leaf(ob: OBCSAAConfig, leaf: torch.Tensor, phi, group=None,
                    *, k_weight, beta_i, b_t, generator=None, noise=None,
                    wire_dtype=torch.float32, perm=None, hook=None,
                    index: int = 0) -> torch.Tensor:
    """Compress one gradient leaf on this worker, superpose over
    ``group``, decode at the PS. ``hook(stage, index, grad, decoded)``,
    when given, is called after the compression ("compress") and after
    the decode ("decode")."""
    sent = _send_leaf(ob, leaf, phi, group, k_weight=k_weight,
                      beta_i=beta_i, b_t=b_t, wire_dtype=wire_dtype,
                      perm=perm)
    if hook is not None:
        hook("compress", index, None, None)
    return _receive_leaf(ob, leaf, sent, phi, group, b_t=b_t,
                         generator=generator, noise=noise, perm=perm,
                         hook=hook, index=index)


def _perms(leaves, specs):
    return [(_shard_aligned_perm(leaf.shape, specs[i])
             if specs is not None else None) for i, leaf in enumerate(leaves)]


def obcsaa_aggregate_tree(ob: OBCSAAConfig, grads, group=None, *, k_weight,
                          beta_i, b_t,
                          generator: Optional[torch.Generator] = None,
                          noises: Optional[List[torch.Tensor]] = None,
                          phi: Optional[torch.Tensor] = None,
                          wire_dtype=torch.float32,
                          specs: Optional[list] = None, hook=None):
    """The decoded gradient tree, leaf by leaf, superposed over ``group``
    (None: one worker). ``noises[i]`` (leaf i's AWGN, (n_chunks_i, S_c))
    and ``phi`` replace the draws; ``specs`` gives each leaf's partition
    spec, in leaf order, for the shard-aligned chunking."""
    leaves, treedef = tree.flatten(grads)
    if phi is None:
        phi = ob.phi(leaves[0].device)
    out = []
    for i, (leaf, perm) in enumerate(zip(leaves, _perms(leaves, specs))):
        out.append(_aggregate_leaf(
            ob, leaf, phi, group, k_weight=k_weight, beta_i=beta_i, b_t=b_t,
            generator=generator,
            noise=noises[i] if noises is not None else None,
            wire_dtype=wire_dtype, perm=perm, hook=hook, index=i))
    return tree.unflatten(treedef, out)


# --- train steps -------------------------------------------------------------

def loss_and_grads(model: Model, tcfg: TrainConfig, params, batch,
                   dp=None):
    """(loss, grads): the gradient of the mean loss with respect to every
    parameter leaf, a tree of the parameters' structure. ``dp = (group,
    W)``: the MoE layers dispatch over W data-parallel workers."""
    leaves, treedef = tree.flatten(params)
    req = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, _ = model.loss_fn(tree.unflatten(treedef, req), batch,
                                remat=tcfg.remat_mode, dp=dp)
        grads = torch.autograd.grad(loss, req)
    return loss.detach(), tree.unflatten(treedef, list(grads))


def shard_batch(batch, worker: int, workers: int):
    """Worker ``worker``'s rows ``[w·B/U, (w+1)·B/U)`` of the global
    batch's leading dim; a batch whose B the U workers do not split
    raises, as the reference's sharding would."""
    if workers == 1:
        return batch
    B = tree.leaves(batch)[0].shape[0]
    if B % workers:
        raise ValueError(f"the global batch of {B} rows does not split "
                         f"over {workers} workers")
    n = B // workers
    return tree.tree_map(lambda x: x[worker * n:(worker + 1) * n], batch)


def _round_generator(round_ctx, device) -> Optional[torch.Generator]:
    """The step's generator: the context's own, or one seeded with its
    ``seed`` (a scheduled span's contexts carry seeds)."""
    if "generator" in round_ctx or "seed" not in round_ctx:
        return round_ctx.get("generator")
    return torch.Generator(device=device).manual_seed(
        int(round_ctx["seed"]))


def make_train_step(model: Model, tcfg: TrainConfig,
                    mesh: Optional[ZooMesh] = None) -> Callable:
    """Returns ``step(params, opt_state, batch, round_ctx) -> (params,
    opt_state, metrics)`` for the U workers of ``mesh`` (default: one).
    ``batch`` is the global batch; ``round_ctx`` is
    ``default_round_ctx``'s dict (or a scheduled one: ``beta`` (U,),
    ``b_t``, and a ``generator`` or a ``seed``); it may also hold ``phi``,
    ``noise`` (one AWGN tensor per leaf) and ``hook``
    (``_aggregate_leaf``'s, also called with "backward" after a worker's
    gradient and "update" after the optimizer step).

    With the mesh's ``group`` this process is worker ``rank`` of U; the
    group must have U ranks. Without one, U > 1 workers run in turn."""
    mesh = mesh or make_zoo_mesh(1, 1)
    U, group = num_workers(mesh), mesh.group
    if group is not None and coll.axis_size(group) != U:
        raise ValueError(f"the mesh has {U} workers but its group "
                         f"{coll.axis_size(group)} ranks")
    rank = coll.axis_index(group)
    opt = make_optimizer(tcfg)
    grad_specs = None
    if tcfg.cs_shard_aligned:
        grad_specs = infer_param_specs(model.init(0, device="meta"), mesh)

    if tcfg.aggregation == "mean":
        def step(params, opt_state, batch, round_ctx=None):
            loss, grads = loss_and_grads(
                model, tcfg, params,
                batch if group is None else shard_batch(batch, rank, U),
                dp=(group, U))
            with torch.no_grad():
                if group is not None:
                    leaves, treedef = tree.flatten(grads)
                    for i, g in enumerate(leaves):
                        leaves[i] = coll.psum(g, group).div_(U)
                    grads = tree.unflatten(treedef, leaves)
                    loss = coll.pmean(loss, group)
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

    def aggregate_in_turn(params, batch, round_ctx, phi, gen, hook):
        """The U workers one after another: each one's compressed leaves
        are added into the MAC's sums (its gradient freed leaf by leaf),
        then the PS decodes every leaf."""
        losses, sums = [], None
        for u in range(U):
            loss, grads = loss_and_grads(model, tcfg, params,
                                         shard_batch(batch, u, U))
            if hook is not None:
                hook("backward", -1, None, None)
            losses.append(loss)
            with torch.no_grad():
                leaves = tree.leaves(grads)
                del grads
                if sums is None:
                    sums, perms = [None] * len(leaves), _perms(leaves,
                                                               grad_specs)
                    likes = [torch.empty_like(x, device="meta")
                             for x in leaves]
                for i in range(len(leaves)):
                    sums[i] = _add_sent(sums[i], _send_leaf(
                        ob, leaves[i], phi, k_weight=1.0,
                        beta_i=round_ctx["beta"][u], b_t=round_ctx["b_t"],
                        wire_dtype=wire_dtype, perm=perms[i]))
                    leaves[i] = None
                    if hook is not None:
                        hook("compress", i, None, None)
        noises = round_ctx.get("noise")
        with torch.no_grad():
            out = [_receive_leaf(ob, likes[i], sums[i], phi,
                                 b_t=round_ctx["b_t"], generator=gen,
                                 noise=noises[i] if noises else None,
                                 perm=perms[i], hook=hook, index=i)
                   for i in range(len(likes))]
        return torch.mean(torch.stack(losses)), out

    def step(params, opt_state, batch, round_ctx):
        hook = round_ctx.get("hook")
        dev = tree.leaves(params)[0].device
        phi = round_ctx.get("phi")
        phi = ob.phi(dev) if phi is None else phi
        gen = _round_generator(round_ctx, dev)
        if group is None and U > 1:
            loss, out = aggregate_in_turn(params, batch, round_ctx, phi,
                                          gen, hook)
            ghat = tree.unflatten(tree.flatten(params)[1], out)
        else:
            loss, grads = loss_and_grads(model, tcfg, params,
                                         shard_batch(batch, rank, U))
            if hook is not None:
                hook("backward", -1, None, None)
            with torch.no_grad():
                # this worker's β; K_i = 1 (equal shards, as the reference)
                ghat = obcsaa_aggregate_tree(
                    ob, grads, group, k_weight=1.0,
                    beta_i=round_ctx["beta"][rank], b_t=round_ctx["b_t"],
                    generator=gen, noises=round_ctx.get("noise"), phi=phi,
                    wire_dtype=wire_dtype, specs=grad_specs, hook=hook)
                del grads
                loss = coll.pmean(loss, group)
        with torch.no_grad():
            params, opt_state = opt.update(ghat, opt_state, params,
                                           tcfg.learning_rate)
        if hook is not None:
            hook("update", -1, None, None)
        return params, opt_state, {"loss": loss}

    return step


def default_round_ctx(seed: int = 0, device=None,
                      mesh: Optional[ZooMesh] = None) -> Dict:
    """Everyone scheduled at unit power: h = β = 1 for each of the
    mesh's U workers (one without a mesh), b_t = 1, and the step's
    generator (the reference's PRNG key) seeded with ``seed``."""
    dev = resolve_device(device)
    U = num_workers(mesh) if mesh is not None else 1
    return {"h": torch.ones((U,), dtype=torch.float32, device=dev),
            "beta": torch.ones((U,), dtype=torch.float32, device=dev),
            "b_t": torch.ones((), dtype=torch.float32, device=dev),
            "generator": torch.Generator(device=dev).manual_seed(seed)}


#: a round's generator seed is ``seed · ROUND_SEED_STRIDE + t`` (the
#: reference's keys PRNGKey(seed·100003 + t) and fold_in(PRNGKey(seed·
#: 100003), t))
ROUND_SEED_STRIDE = 100003


def _trajectory(scn, seed: int, trajectory, device) -> torch.Tensor:
    """The (rounds, 1, U) fading trajectory: ``trajectory`` when given,
    else ``sched.scenario.generate`` from a generator seeded ``seed``."""
    from repro_torch.sched.scenario import generate
    dev = resolve_device(device)
    if trajectory is not None:
        return torch.as_tensor(trajectory, dtype=torch.float32, device=dev)
    return generate(scn, torch.Generator(device=dev).manual_seed(seed),
                    device=dev)


def _from_ps(ctx: Dict, group) -> Dict:
    """Every rank takes the PS's (rank 0's) h, β and b_t."""
    for k in ("h", "beta", "b_t"):
        ctx[k] = coll.broadcast(ctx[k].contiguous(), group)
    return ctx


def make_scheduled_round_ctx(mesh, tcfg: TrainConfig, D: int, *,
                             scenario=None, method: str = "greedy_batched",
                             seed: int = 0, trajectory=None, device=None):
    """P2-scheduled round contexts for the train step.

    Generates a time-correlated fading trajectory for the mesh's U
    workers (``sched.scenario``; ``trajectory`` injects one, (rounds, 1,
    U)) and returns ``round_ctx(t)``: each call takes round t's channels
    (t modulo the scenario's rounds), solves P2 through the scheduler
    registry (``method``, ``SchedConfig()``) and yields the {h, beta, b_t,
    generator} dict the train step consumes, the generator seeded
    ``seed·ROUND_SEED_STRIDE + t``. ``D`` is the model's flat parameter
    count (the R_t dimension term). Over a process group every rank takes
    rank 0's h, β and b_t."""
    from repro_torch.sched import SchedConfig, ScenarioConfig, schedule
    from repro_torch.sched.scenario import round_problems
    from repro_torch.theory.bounds import AnalysisConstants

    U = num_workers(mesh)
    scn = scenario or ScenarioConfig(rounds=256, cells=1, workers=U)
    if scn.workers != U:
        raise ValueError(f"scenario has {scn.workers} workers, the mesh {U}")
    traj = _trajectory(scn, seed, trajectory, device)
    const, cfg = AnalysisConstants(), SchedConfig()

    def round_ctx(t: int) -> Dict:
        prob = round_problems(traj, t % scn.rounds, k_weights=1.0,
                              p_max=tcfg.p_max, noise_var=tcfg.noise_var,
                              D=D, S=tcfg.cs_measure, kappa=tcfg.cs_topk,
                              const=const)
        beta, b_t, _ = schedule(prob, method, cfg)
        ctx = {"h": traj[t % scn.rounds, 0],
               "beta": beta[0].to(torch.float32),
               "b_t": b_t[0].to(torch.float32),
               "generator": torch.Generator(device=traj.device).manual_seed(
                   seed * ROUND_SEED_STRIDE + t)}
        return _from_ps(ctx, mesh.group)

    return round_ctx


def make_scheduled_round_span(mesh, tcfg: TrainConfig, D: int, rounds: int,
                              *, scenario=None,
                              method: str = "greedy_batched", seed: int = 0,
                              trajectory=None, device=None) -> Dict:
    """Stacked round contexts for ``make_scan_train_step``: the whole
    span's P2 in one batched registry call (a B = rounds
    ``BatchedProblem`` of the (rounds, U) channels). Returns (rounds,
    ...)-leading ``h``, ``beta``, ``b_t`` and ``seed`` (round t's
    generator seed, ``seed·ROUND_SEED_STRIDE + t``, int64 on the CPU).
    ``trajectory`` injects the fading, (≥ rounds, 1, U). Over a process
    group every rank takes rank 0's h, β and b_t."""
    from repro_torch.sched import (BatchedProblem, SchedConfig,
                                   ScenarioConfig, schedule)
    from repro_torch.theory.bounds import AnalysisConstants

    U = num_workers(mesh)
    scn = scenario or ScenarioConfig(rounds=rounds, cells=1, workers=U)
    if scn.workers != U or scn.rounds < rounds:
        raise ValueError(f"scenario {scn} does not cover {rounds} rounds "
                         f"of {U} workers")
    h = _trajectory(scn, seed, trajectory, device)[:rounds, 0]
    prob = BatchedProblem.from_arrays(
        h, 1.0, tcfg.p_max, tcfg.noise_var, D=D, S=tcfg.cs_measure,
        kappa=tcfg.cs_topk, const=AnalysisConstants())
    beta, b_t, _ = schedule(prob, method, SchedConfig())
    span = {"h": h, "beta": beta.to(torch.float32),
            "b_t": b_t.to(torch.float32),
            "seed": seed * ROUND_SEED_STRIDE + torch.arange(rounds)}
    return _from_ps(span, mesh.group)


#: round-context entries shared by every round of a span, not stacked
SHARED_CTX = ("phi", "hook")


def make_scan_train_step(model: Model, tcfg: TrainConfig, mesh,
                         n_rounds: int) -> Callable:
    """Multi-round train step: ``n_rounds`` rounds of ``make_train_step``
    over stacked round contexts, a host loop (the reference's
    ``lax.scan``), as ``engine.zoo_train``'s ``run_sweep``.

    Returns ``scan_step(params, opt_state, batch, round_ctxs) -> (params,
    opt_state, metrics)``: ``round_ctxs`` comes from
    ``make_scheduled_round_span`` (or any dict of (n_rounds, ...)-leading
    entries shaped like ``default_round_ctx``'s, a per-round ``noise``
    list included; ``phi`` and ``hook`` are shared); each metric comes out
    stacked, (n_rounds,)."""
    step = make_train_step(model, tcfg, mesh)

    def scan_step(params, opt_state, batch, round_ctxs):
        metrics = []
        for t in range(n_rounds):
            ctx = {k: v if k in SHARED_CTX else v[t]
                   for k, v in round_ctxs.items()}
            params, opt_state, m = step(params, opt_state, batch, ctx)
            metrics.append(m)
        return params, opt_state, {k: torch.stack([m[k] for m in metrics])
                                   for k in metrics[0]}

    return scan_step


# --- zoo-scale real-gradient rounds ------------------------------------------

def make_zoo_train_round(model: Model, tcfg: TrainConfig, mesh, **kw):
    """The real-backward zoo round (``engine.zoo_train.ZooTrainRound``)
    for (model, tcfg, mesh), built from the same TrainConfig knobs the
    per-leaf train step reads: ``obcsaa_config(tcfg)`` for the wire
    geometry, ``tcfg.remat_mode``, the optimizer and error feedback.
    ``use_kernels=True`` runs its compression and decode through the CUDA
    kernels. Extra kwargs (``scheduler``, ``compute_dtype``, ``device``,
    ...) pass through."""
    from repro_torch.engine.zoo_train import ZooTrainRound
    kw.setdefault("remat", tcfg.remat_mode)
    kw.setdefault("optimizer", tcfg.optimizer)
    kw.setdefault("error_feedback", tcfg.error_feedback)
    ob = dataclasses.replace(obcsaa_config(tcfg),
                             use_kernels=kw.pop("use_kernels", False))
    return ZooTrainRound(model, mesh, ob, **kw)


# --- serve steps -------------------------------------------------------------

def make_prefill_step(model: Model, mesh=None) -> Callable:
    """``step(params, batch) -> (logits, cache seeds)``; with a ``mesh``
    of M > 1 the split prefill (``model.prefill(mesh=)``)."""
    def step(params, batch):
        return model.prefill(params, batch, mesh=mesh)

    return step


def make_decode_step(model: Model, mesh=None) -> Callable:
    """``step(params, cache, tokens, pos)``; with a ``mesh`` the model
    over its model group and the cache as ``cache_shardings`` lays it out
    (``model.init_cache(..., mesh=)``; with M = 1 the K/V length over the
    data group)."""
    def step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, mesh=mesh)

    return step


def make_seeded_prefill(model: Model, total_len: int,
                        mesh=None) -> Callable:
    """Prefill a prompt prefix and seed a ``total_len`` decode cache.

    Returns ``step(params, batch) -> (logits, cache, offset)``: the
    prefix (a VLM's ``image_embeds``, then any prompt tokens; the tokens
    may be zero-length) runs through the full forward once, its per-layer
    cache seeds land in slots [0, offset) of a fresh cache on the tokens'
    device, and decoding continues at ``pos = offset + i``. Decode steps
    are text-only, so an image enters through the cache. With a ``mesh``
    of M = 1 the cache's K/V length is split over its data group and each
    rank keeps its own rows of the seeds; with M > 1 the prefill is split
    over its model group and each rank keeps its block of the seeds
    (``transformer.seed_cache_from_prefill``). The SSM,
    hybrid and audio families have no positional seeds and raise, as in
    the reference."""
    cfg = model.cfg

    def step(params, batch):
        tokens = batch["tokens"]
        logits, seeds = model.prefill(params, batch, mesh=mesh)
        img = batch.get("image_embeds")
        offset = tokens.shape[1] + (img.shape[1] if img is not None else 0)
        cache = model.init_cache(tokens.shape[0], total_len, tokens.device,
                                 mesh=mesh)
        cache = transformer.seed_cache_from_prefill(cfg, cache, seeds,
                                                    start=0, mesh=mesh)
        return logits, cache, offset

    return step


# --- sharding specs ----------------------------------------------------------

def cache_shardings(cache_shapes, mesh) -> Dict[str, tuple]:
    """Partition specs of a cache's leaves on ``mesh`` from
    ``transformer.cache_shardings_hints`` (``cross_k``/``cross_v`` take
    ``k``/``v``'s), through ``dist.sharding.best_spec``: {name: spec
    tuple}. ``cache_shapes`` maps a leaf's name to a tensor (a meta one
    allocates nothing) or a ``(shape, dtype)`` pair. It is the layout
    ``model.init_cache(mesh=)`` allocates (``transformer.cache_specs``)."""
    return transformer.cache_specs(cache_shapes, mesh)


def param_shardings(model: Model, mesh, sample_batch_specs=None):
    """(spec pytree, meta-tensor params) of ``model`` on ``mesh``: each
    leaf's largest model-divisible dim over "model"
    (``dist.sharding.infer_param_sharding``); nothing is allocated."""
    shapes = model.init(0, device="meta")
    return infer_param_sharding(shapes, mesh), shapes


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
