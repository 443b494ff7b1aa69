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

The model axis. On a ``launch.mesh.world_mesh(M)`` of M > 1 rank
d·M + m holds model shard m of every weight and moment
(``dist.shares``: ``param_shardings``' layout), its model group gathers
the weights for worker d's forward and backward, and the update runs on
the shares; the checkpoints stay whole
(``save_train_state`` streams each leaf to rank 0, ``restore_train_state``
reads a rank's share), so a run saved at one M resumes at any.

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
from repro_torch.dist.shares import ModelAxis
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


def _chunk_rows(ob: OBCSAAConfig, leaf: torch.Tensor, perm=None
                ) -> torch.Tensor:
    """A leaf (its dims permuted by ``perm`` first) flattened row-major
    in f32, zero-padded to whole chunks: (n_chunks, D_c)."""
    leaf_t = leaf.permute(perm) if perm is not None else leaf
    flat = leaf_t.reshape(-1).to(torch.float32)
    rem = (-flat.shape[0]) % ob.chunk
    if rem:
        flat = torch.nn.functional.pad(flat, (0, rem))
    return flat.reshape(-1, ob.chunk)


def _from_chunks(ghat: torch.Tensor, leaf: torch.Tensor, perm=None
                 ) -> torch.Tensor:
    """``_chunk_rows``' inverse: the flat padded chunks ``ghat`` cut back
    to ``leaf``'s shape and dtype (``leaf`` may be a meta tensor)."""
    shape = (tuple(leaf.shape[i] for i in perm) if perm is not None
             else tuple(leaf.shape))
    out = ghat[:leaf.numel()].reshape(shape).to(leaf.dtype)
    if perm is not None:
        out = out.permute(tuple(int(i) for i in np.argsort(perm)))
    return out


def _compress_rows(ob: OBCSAAConfig, rows: torch.Tensor, phi, group=None,
                   *, k_weight, beta_i, b_t, wire_dtype=torch.float32):
    """This worker's compression of chunk rows, superposed over
    ``group``, in blocks of ``BLOCK_ROWS``: a list of
    ``shardmap_compress``'s (y, ksum, mag_sum), one a block."""
    return [shardmap_compress(ob, rows[r:r + BLOCK_ROWS], group,
                              k_weight=k_weight, beta_i=beta_i, b_t=b_t,
                              phi=phi, wire_dtype=wire_dtype)
            for r in range(0, rows.shape[0], BLOCK_ROWS)]


def _decode_into(ob: OBCSAAConfig, out: torch.Tensor, sent, noise, *, phi,
                 b_t) -> None:
    """The PS's AWGN, post-processing and decode of the superposed
    blocks ``sent`` (``_compress_rows``', taken as they go) into the rows
    of ``out``, whose AWGN rows are ``noise``'s."""
    for r in range(0, out.shape[0], BLOCK_ROWS):
        y, ksum, mag_sum = sent.pop(0)
        out[r:r + BLOCK_ROWS] = shardmap_reconstruct(
            ob, y, ksum, mag_sum, b_t=b_t, phi=phi,
            noise=noise[r:r + BLOCK_ROWS]).reshape(-1, ob.chunk)


def _send_leaf(ob: OBCSAAConfig, leaf: torch.Tensor, phi, *, k_weight,
               beta_i, b_t, wire_dtype=torch.float32, perm=None):
    """One worker's compression of one leaf (``_compress_rows`` of all
    its chunks), for the workers in turn."""
    return _compress_rows(ob, _chunk_rows(ob, leaf, perm), phi,
                          k_weight=k_weight, beta_i=beta_i, b_t=b_t,
                          wire_dtype=wire_dtype)


def _add_sent(acc, sent):
    """Blockwise sum of two workers' ``_send_leaf`` lists."""
    if acc is None:
        return sent
    return [tuple(a + b if a is not None else None for a, b in zip(x, y))
            for x, y in zip(acc, sent)]


def _receive_leaf(ob: OBCSAAConfig, leaf: torch.Tensor, sent, phi, *, b_t,
                  generator=None, noise=None, perm=None, hook=None,
                  index: int = 0) -> torch.Tensor:
    """The PS's half for one leaf, for the workers in turn: AWGN,
    post-processing and decode of the summed blocks ``sent``; the decoded
    leaf in ``leaf``'s shape and dtype (``leaf`` may be a meta tensor of
    them). ``hook`` is called with "decode", the leaf (None for a meta
    one) and its decoded chunks (flat and padded, before the cut back to
    the leaf's size)."""
    n = -(-leaf.numel() // ob.chunk)
    dev = sent[0][0].device
    ghat = torch.empty((n, ob.chunk), dtype=torch.float32, device=dev)
    if noise is None:
        noise = chan.draw_noise(generator, (n, ob.measure), ob.noise_var,
                                device=dev)
    _decode_into(ob, ghat, sent, noise, phi=phi, b_t=b_t)
    ghat = ghat.reshape(-1)
    out = _from_chunks(ghat, leaf, perm)
    if hook is not None:
        hook("decode", index, None if leaf.is_meta else leaf, ghat)
    return out


def _row_block(n: int, M: int, m: int) -> tuple:
    """Model shard m's chunk rows [a, b) of a leaf's n: blocks of ⌈n/M⌉,
    the last ones short or empty, as GSPMD pads a split dim."""
    c = -(-n // M)
    return min(m * c, n), min((m + 1) * c, n)


def _split_leaf(ob: OBCSAAConfig, full: torch.Tensor, phi, group=None,
                mgroup=None, *, k_weight, beta_i, b_t, generator=None,
                noise=None, wire_dtype=torch.float32, perm=None, hook=None,
                index: int = 0) -> torch.Tensor:
    """One gradient leaf through the uplink, this worker's whole gradient
    ``full`` in, the decoded leaf whole out (``full``'s shape and dtype).
    The leaf's chunk rows split over the model group ``mgroup`` (None:
    one model shard): this rank compresses its row block
    (``_row_block``), the MAC is the all-reduce of those rows over the
    worker group ``group`` (None: one worker), the PS of the column (its
    rank 0) decodes them and broadcasts them over the column, and the
    model group gathers the rows back. The PS draws the leaf's whole
    (n_chunks, S_c) AWGN and takes its rows, so the columns' generators
    stay in step. ``hook("compress", index)`` follows the compression,
    ``hook("decode", index, full, ĝ)`` sees the whole decoded chunks
    (flat and padded)."""
    M, m = coll.axis_size(mgroup), coll.axis_index(mgroup)
    chunks = _chunk_rows(ob, full, perm)
    n = chunks.shape[0]
    a, b = _row_block(n, M, m)
    sent = _compress_rows(ob, chunks[a:b], phi, group, k_weight=k_weight,
                          beta_i=beta_i, b_t=b_t, wire_dtype=wire_dtype)
    del chunks
    if hook is not None:
        hook("compress", index, None, None)
    mine = torch.zeros((-(-n // M), ob.chunk), dtype=torch.float32,
                       device=full.device)
    if coll.axis_index(group) == 0:
        if noise is None:
            noise = chan.draw_noise(generator, (n, ob.measure),
                                    ob.noise_var, device=full.device)
        _decode_into(ob, mine[:b - a], sent, noise[a:b], phi=phi, b_t=b_t)
    sent.clear()
    if b > a:
        mine = coll.broadcast(mine, group)
    ghat = coll.gather_tiled(mine, mgroup, kind="all_gather_ghat")[
        :n].reshape(-1)
    out = _from_chunks(ghat, full, perm)
    if hook is not None:
        hook("decode", index, full, ghat)
    return out


def _perms(shapes, specs):
    return [(_shard_aligned_perm(tuple(shape), specs[i])
             if specs is not None else None)
            for i, shape in enumerate(shapes)]


def obcsaa_aggregate_tree(ob: OBCSAAConfig, grads, group=None, *, k_weight,
                          beta_i, b_t,
                          generator: Optional[torch.Generator] = None,
                          noises: Optional[List[torch.Tensor]] = None,
                          phi: Optional[torch.Tensor] = None,
                          wire_dtype=torch.float32,
                          specs: Optional[list] = None, hook=None):
    """The decoded gradient tree, leaf by leaf (``_split_leaf``),
    superposed over ``group`` (None: one worker). ``noises[i]`` (leaf
    i's AWGN, (n_chunks_i, S_c)) and ``phi`` replace the draws; ``specs``
    gives each leaf's partition spec, in leaf order, for the
    shard-aligned chunking."""
    leaves, treedef = tree.flatten(grads)
    if phi is None:
        phi = ob.phi(leaves[0].device)
    perms = _perms([x.shape for x in leaves], specs)
    out = [_split_leaf(ob, leaf, phi, group, k_weight=k_weight,
                       beta_i=beta_i, b_t=b_t, generator=generator,
                       noise=noises[i] if noises is not None else None,
                       wire_dtype=wire_dtype, perm=perms[i], hook=hook,
                       index=i)
           for i, leaf in enumerate(leaves)]
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
    ``noise`` (one AWGN tensor per leaf) and ``hook`` (``_split_leaf``'s,
    also called with "backward" after a worker's gradient and "update"
    after the optimizer step).

    Without the mesh's ``group``, U > 1 workers run in turn in one
    process, the weights whole. With it this process is worker d of U,
    the group's rank d (it must have U ranks), and with a ``model_group``
    too (``launch.mesh.world_mesh(M)``, M > 1) the model axis is split:
    the reference's step, manual over the worker axes, ``model`` left to
    GSPMD (``repro/launch/steps.py:122-170``). Rank d·M + m is worker
    d's model shard m; ``params`` and ``opt_state`` are its shares
    (``dist.shares.ModelAxis``: ``param_shardings``' GSPMD layout; an
    optimizer's moments split with their leaves, Adam's counter
    replicated). Every rank of worker d's model group runs the forward
    and backward on worker d's rows of the batch, the weights gathered
    over the group: a non-stacked leaf once, a stacked collection a layer
    at a time inside the remat boundary. At M = 1 the shares are the
    whole leaves and nothing is gathered.

    ``mean``: each gradient share summed over the worker group, over U,
    then the optimizer step on the shares; a leaf's gradient is its block
    of the whole gradient bit for bit, so M changes no bit.

    ``obcsaa``: leaf by leaf (``_split_leaf``): the rank takes its
    worker's whole gradient of the leaf (a stacked leaf's gathered over
    the model group; the backward takes a non-stacked one whole),
    compresses its 1/M of the chunk rows, the MAC sums them over the
    worker group, the PS of the column decodes them and broadcasts them
    over it, the model group gathers ĝ's rows, and the rank keeps its
    share. Peak above the shares: one leaf's whole gradient and whole
    ĝ, and the non-stacked leaves' whole gradients. Φ and each leaf's
    AWGN do not depend on M; with ``cs_shard_aligned`` the perms come
    from this mesh, as the reference's do, so the chunking at M > 1 is
    not M = 1's. (Where the shares are whole chunks of the permuted
    leaf, a rank's row block is its own share; the route gathers all
    the same.)"""
    mesh = mesh or make_zoo_mesh(1, 1)
    U, group, mgroup = num_workers(mesh), mesh.group, mesh.model_group
    if group is not None and coll.axis_size(group) != U:
        raise ValueError(f"the mesh has {U} workers but its worker group "
                         f"{coll.axis_size(group)} ranks")
    in_turn = group is None and U > 1
    rank = coll.axis_index(group)
    shapes = model.init(0, device="meta")
    # a logical mesh's model axis is a layout only: the weights stay whole
    axis = ModelAxis(shapes, mesh if mgroup is not None
                     else make_zoo_mesh(1, 1))
    opt = make_optimizer(tcfg)

    if tcfg.aggregation == "mean":
        def step(params, opt_state, batch, round_ctx=None):
            loss, grads = axis.loss_and_grads(
                model, params,
                batch if group is None else shard_batch(batch, rank, U),
                remat=tcfg.remat_mode, dp=(group, U))
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
    perms = _perms(axis.shapes, infer_param_specs(shapes, mesh)
                   if tcfg.cs_shard_aligned else None)

    def aggregate_in_turn(params, batch, round_ctx, phi, gen, hook):
        """The U workers one after another: each one's compressed leaves
        are added into the MAC's sums (its gradient freed leaf by leaf),
        then the PS decodes every leaf."""
        losses, sums, likes = [], [None] * len(axis.shapes), None
        for u in range(U):
            loss, grads = loss_and_grads(model, tcfg, params,
                                         shard_batch(batch, u, U))
            if hook is not None:
                hook("backward", -1, None, None)
            losses.append(loss)
            with torch.no_grad():
                leaves = tree.leaves(grads)
                del grads
                if likes is None:
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
            out = [_receive_leaf(ob, like, sums[i], phi,
                                 b_t=round_ctx["b_t"], generator=gen,
                                 noise=noises[i] if noises else None,
                                 perm=perms[i], hook=hook, index=i)
                   for i, like in enumerate(likes)]
        return torch.mean(torch.stack(losses)), out

    def aggregate(params, batch, round_ctx, phi, gen, hook):
        """This rank's worker (and model shard): its gradient, then each
        leaf through ``_split_leaf``, the rank's share of ĝ kept."""
        loss, grads = axis.loss_and_grads(
            model, params, shard_batch(batch, rank, U),
            remat=tcfg.remat_mode, whole_unstacked=True)
        if hook is not None:
            hook("backward", -1, None, None)
        noises = round_ctx.get("noise")
        with torch.no_grad():
            leaves = tree.leaves(grads)
            del grads
            for i in range(len(leaves)):
                full = (axis.whole_leaf(leaves[i], i, "all_gather_grad")
                        if axis.stacked[i] else leaves[i])
                leaves[i] = None        # only ``full`` holds it now
                leaves[i] = axis.share_leaf(_split_leaf(
                    ob, full, phi, group, mgroup, k_weight=1.0,
                    beta_i=round_ctx["beta"][rank], b_t=round_ctx["b_t"],
                    generator=gen, noise=noises[i] if noises else None,
                    wire_dtype=wire_dtype, perm=perms[i], hook=hook,
                    index=i), i)
                del full
            loss = coll.pmean(loss, group)
        return loss, leaves

    def step(params, opt_state, batch, round_ctx):
        hook = round_ctx.get("hook")
        dev = tree.leaves(params)[0].device
        phi = round_ctx.get("phi")
        phi = ob.phi(dev) if phi is None else phi
        gen = _round_generator(round_ctx, dev)
        loss, out = (aggregate_in_turn if in_turn else aggregate)(
            params, batch, round_ctx, phi, gen, hook)
        with torch.no_grad():
            params, opt_state = opt.update(
                tree.unflatten(tree.flatten(params)[1], out), opt_state,
                params, tcfg.learning_rate)
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

def state_axis(model: Model, tcfg: TrainConfig, mesh) -> ModelAxis:
    """The ``ModelAxis`` of the trainer's carry {"params", "opt_state"}
    on ``mesh``: each moment split as its parameter, as the reference's
    ``infer_param_sharding`` of the optimizer state lays it out."""
    pshapes = model.init(0, device="meta")
    return ModelAxis({"params": pshapes,
                      "opt_state": make_optimizer(tcfg).init(pshapes)},
                     mesh)


def save_train_state(ckpt_dir: str, step: int, params, opt_state, *,
                     model: Optional[Model] = None,
                     tcfg: Optional[TrainConfig] = None,
                     mesh: Optional[ZooMesh] = None) -> str:
    """Snapshot params + optimizer state at ``step`` (one atomic step
    directory, the reference's format: either package restores it).

    Over a split mesh (a ``model_group``; ``model`` and ``tcfg`` give the
    whole shapes) the carry is this rank's shares: the checkpoint still
    holds the whole leaves, streamed to rank 0 one leaf at a time, each
    gathered over worker 0's model group; every rank calls it (the other
    workers' ranks hold replicas and only wait for rank 0's word that the
    step is on disk)."""
    obj = {"params": params, "opt_state": opt_state}
    if mesh is None or mesh.model_group is None:
        return checkpoint.save(ckpt_dir, step, obj)
    d, m = mesh.cell()
    leaves, treedef = tree.flatten(obj)
    if d == 0:
        axis = state_axis(model, tcfg, mesh)
        streamed = [checkpoint.RowBlocks(
            axis.shapes[i], x.dtype, lambda i=i, x=x: iter([
                axis.whole_leaf(x, i)])) if axis.split(i) else x
            for i, x in enumerate(leaves)]
        if m == 0:
            checkpoint.save(ckpt_dir, step, tree.unflatten(treedef,
                                                           streamed))
        for leaf in streamed if m else ():
            if isinstance(leaf, checkpoint.RowBlocks):
                for _ in leaf.blocks():
                    pass
    # rank 0's word that the step is on disk
    coll.broadcast(torch.zeros(1, device=leaves[0].device), mesh.world)
    return checkpoint.step_dir(ckpt_dir, step)


def restore_train_state(ckpt_dir: str, model: Model, tcfg: TrainConfig,
                        device=None, mesh: Optional[ZooMesh] = None):
    """(params, opt_state, step) from the latest checkpoint, on
    ``device``; None when ``ckpt_dir`` holds no steps yet. Over a split
    mesh each rank reads only its shares, memory-mapped. The checkpoint
    holds whole leaves, so any checkpoint resumes on any mesh, as the
    reference places any checkpoint on any mesh."""
    step = checkpoint.latest_step(ckpt_dir)
    if step is None:
        return None
    dev = resolve_device(device)
    pshapes = model.init(0, device="meta")
    like = {"params": pshapes,
            "opt_state": make_optimizer(tcfg).init(pshapes)}
    rows = None
    if mesh is not None and mesh.model_group is not None:
        axis = state_axis(model, tcfg, mesh)
        rows = [axis.share_index(i) for i in range(len(axis.shapes))]
    got = checkpoint.restore(ckpt_dir, step, like, rows=rows)
    got = tree.tree_map(lambda t: t.to(dev), got)
    return got["params"], got["opt_state"], step
