"""Real backward passes at zoo scale, with stateful carries; port of
``repro/engine/zoo_train.py``.

``engine/zoo.py`` runs the ≥1B-parameter compress → MAC → decode →
update round on surrogate gradients; this module feeds it the genuine
eq. 3 gradients of a model from ``models/registry``:

* The master lives as the zoo round's chunked (n_chunks, D_c) f32
  tensor, in the model-major flat order of ``dist.flat_layout
  .FlatShardLayout``: section m holds the m-th model-axis slice of every
  leaf. That order decides which parameters share a chunk, so it fixes
  the numbers; it is the reference's bit for bit.
* In one process each round casts the master to ``compute_dtype`` as
  the full parameter tree (``master_to_tree``) once, then takes every
  worker's loss and gradient on its own batch in turn, as the
  reference's single-device oracle does. A worker's gradient is laid
  into the master's order (``tree_to_master``) and compressed a block of
  chunk rows at a time; only one worker's gradient is alive at a time.
* Over processes (a mesh of ``launch.mesh.world_mesh``) rank (d, m)
  holds its own n_local master rows and runs the reference's
  ``shard_map`` body (``zoo_train.py:183-230``): it gathers its section
  over the worker group in ``compute_dtype`` and views it as per-leaf
  shards (``section_to_tree``). The forward is redundant over the model
  axis: ``dist.shares.ModelAxis`` gathers each non-stacked leaf once and
  one layer's weights at a time, both through
  ``collectives.replicated_gather`` over the model group, whose adjoint
  is the local slice, so the backward's cotangents are this rank's
  section block (``tree_to_section``), laid straight into compression.
  The resolver hands each layer the same weights as the in-turn path's
  full tree, so the ranks' round equals the in-turn round bit for bit
  with two workers (``engine/zoo.py``).
* The MAC, the decode and the update are the zoo round's, in place on
  the master: decode and update go a block of rows at a time.

The carry is a :class:`ZooTrainState`: next to the master, momentum and
Adam moments in the master's own chunk rows (``optim``'s update is
elementwise, so a block's update is the global update on those rows;
Adam's step counter is stepped once a round), and with
``error_feedback=True`` the per-worker residual (U, n_chunks, D_c) in the
gradients' layout: ``optim.ef_step`` corrects each block of a worker's
gradient with its residual rows, and the top-κ sparse block goes into
``compress_chunks``' presparsified path (no second selection).

Over processes the carry is the rank's own rows: master and moments
(n_local, D_c), the residual its worker's (n_half, D_c) rows of its
half (``local_state`` cuts them from a whole carry).

``round_train`` updates the carry's tensors in place and returns the
carry; ``reference_round_train`` is the same round on a copy, the
single-device oracle on one card. ``run_sweep`` is a host loop over
rounds × arms, in one process or on every rank of a cell, each rank
running every arm on its rows of the arm-stacked carry (a CUDA graph of
it is later work).
``save_state`` / ``restore_state`` write the reference's checkpoint
format, the whole carry, so either package resumes the other's: over
processes rank 0 writes it a block of rows at a time, gathered from
their owners, and every rank reads its own rows memory-mapped. The flat
order depends on the model axis, so a carry resumes onto the same
logical (W, M) mesh only, in one process or over W·M ranks.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import checkpoint, tree
from repro_torch.core.obcsaa import OBCSAAConfig, compress_chunks
from repro_torch.core.sparsify import topk_sparsify, topk_sparsify_bisect
from repro_torch.dist import collectives as coll
from repro_torch.dist.flat_layout import FlatShardLayout
from repro_torch.dist.shares import ModelAxis
from repro_torch.engine.zoo import ZooDraws, ZooRound, ZooStats, host_stats
from repro_torch.launch.mesh import num_workers
from repro_torch.optim import optimizers as optim


class ZooTrainStats(NamedTuple):
    """ZooStats plus the mean local training loss."""
    loss: torch.Tensor
    n_scheduled: torch.Tensor
    b_t: torch.Tensor
    ghat_norm: torch.Tensor
    budget: object


class ZooTrainState(NamedTuple):
    """The zoo-train round carry.

    ``master``: (n_chunks, D_c) f32 in the flat-shard layout.
    ``opt``: optimizer moments over the same chunk rows: ``()`` for sgd,
    a (n_chunks, D_c) f32 tensor for momentum, ``{"m", "v", "t"}`` for
    adam. ``residual``: the per-worker EF residual (U, n_chunks, D_c) f32,
    or None without error feedback. Its leaves are the reference's, in
    its order (the checkpoint format depends on it)."""
    master: torch.Tensor
    opt: Any
    residual: Optional[torch.Tensor]


def _with_loss(st: ZooStats, loss) -> ZooTrainStats:
    return ZooTrainStats(loss=loss, n_scheduled=st.n_scheduled, b_t=st.b_t,
                         ghat_norm=st.ghat_norm, budget=st.budget)


def _rowwise(leaf) -> bool:
    return getattr(leaf, "ndim", 0) >= 2


class ZooTrainRound(ZooRound):
    """Zoo round whose gradients come from real backward passes.

    ``model``: a ``models.registry.Model`` whose params are a dict.
    ``optimizer``: sgd | momentum | adam (``optim.make``); its moments
    become carry leaves beside the master. ``error_feedback`` adds the
    per-worker residual carry. ``compute_dtype`` is the dtype of the
    forward and backward (the master stays f32). Its D may pass 2**32
    (zamba2-7b's 6.7e9): only the inherited surrogate round hashes uint32
    indices, and it refuses such a D when called."""

    SURROGATE = False

    def __init__(self, model, mesh, ob: OBCSAAConfig, *,
                 scheduler: str = "all", const=None, sched_cfg=None,
                 block_chunks: int = 64, compute_dtype=torch.bfloat16,
                 remat="full", optimizer: str = "sgd", opt_kwargs=None,
                 error_feedback: bool = False, device=None, phi=None):
        self.model = model
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.optimizer_name = optimizer
        self.optimizer = optim.make(optimizer, **(opt_kwargs or {}))
        self.error_feedback = bool(error_feedback)
        shapes = model.init(0, device="meta")
        if not isinstance(shapes, dict):
            raise TypeError("zoo-train expects a dict params pytree, got "
                            f"{type(shapes)}")
        # n_half aligned to workers x block_chunks, as the reference, so
        # the flat layout (and with it every number) is the reference's
        self.layout = FlatShardLayout.build(
            shapes, mesh, chunk=ob.chunk,
            gran=num_workers(mesh) * block_chunks)
        super().__init__(ob, self.layout.D, mesh, scheduler=scheduler,
                         const=const, sched_cfg=sched_cfg,
                         block_chunks=block_chunks,
                         n_chunks=self.layout.n_chunks, device=device,
                         phi=phi)
        self._opt_shapes = self.optimizer.init(torch.empty(
            (self.n_chunks, ob.chunk), dtype=torch.float32, device="meta"))
        # the model axis's gathers over processes (dist.shares)
        self.axis = ModelAxis(shapes, mesh)

    def _local_loss_and_grads(self, pl, batch_u):
        """Over processes: (loss, this rank's (n_half, D_c) gradient
        block in compute dtype) from its master rows ``pl``: the section
        gathered over the worker group and viewed as the leaves' shares,
        the forward and backward on them (``dist.shares.ModelAxis``: the
        model-axis gathers, the gradient of a non-stacked leaf taken
        whole and sliced, so the shares' gradients are the in-turn
        path's blocks bit for bit), laid out as the section."""
        with torch.no_grad():
            sect = coll.all_gather(pl.to(self.compute_dtype), self.wgroup,
                                   tiled=True)
            shares = self.layout.section_to_tree(sect)
        loss, grads = self.axis.loss_and_grads(self.model, shares, batch_u,
                                               remat=self.remat)
        del sect, shares
        return loss, self.layout.tree_to_section(grads)

    # -- gradients -----------------------------------------------------------

    def _loss_and_grads(self, p_full, batch_u):
        """(loss, gradient tree in compute dtype) of one worker's batch."""
        leaves, treedef = tree.flatten(p_full)
        req = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            loss, _ = self.model.loss_fn(tree.unflatten(treedef, req),
                                         batch_u, remat=self.remat)
            grads = torch.autograd.grad(loss, req)
        return loss.detach(), tree.unflatten(treedef, list(grads))

    def _worker_grads(self, p_full, batch, u):
        """(loss, gradient (n_chunks, D_c) in compute dtype) of worker u,
        in the master's flat order."""
        batch_u = {k: v[u] for k, v in batch.items()}
        loss, g = self._loss_and_grads(p_full, batch_u)
        gm = self.layout.tree_to_master(g, dtype=self.compute_dtype)
        return loss, gm

    def _sparse_approx(self, corrected):
        """approx_fn for ``optim.ef_step``: per-chunk top-κ of the
        corrected gradient, the selection following ``ob.spmd_topk`` as
        the compressor's does; the sparse vector is both what the residual
        accumulates against and what the compressor transmits."""
        ob = self.ob
        if ob.spmd_topk:
            sp, _ = topk_sparsify_bisect(corrected, ob.topk,
                                         iters=ob.bisect_iters)
        else:
            sp, _ = topk_sparsify(corrected, ob.topk)
        return sp, sp

    def _compress_blocks(self, g_rows):
        """compress_chunks of a block of f32 gradient rows."""
        return compress_chunks(self.ob, g_rows, self.phi)

    def _compress_blocks_ef(self, g_rows, res_rows):
        """EF-corrected compression of a block: ``optim.ef_step`` corrects
        the f32 gradient rows with the worker's residual rows, whose new
        value is written in place; the top-κ sparse rows go into the
        presparsified compressor. Returns (signs, mags)."""
        sp, r2, _ = optim.ef_step(g_rows, res_rows, self._sparse_approx)
        res_rows.copy_(r2)
        return compress_chunks(self.ob, sp, self.phi, presparsified=True)

    def _opt_update_blocks(self, ghat, opt, master, a, b, lr):
        """``Optimizer.update`` on rows [a, b) of the master and of every
        row-wise moment, written in place. Returns the new scalar leaves
        (Adam's step counter), the same from every block."""
        leaves, td = tree.flatten(opt)
        blk = [l[a:b] if _rowwise(l) else l for l in leaves]
        p2, st2 = self.optimizer.update(ghat, tree.unflatten(td, blk),
                                        master[a:b], lr)
        master[a:b] = p2
        scalars = []
        for old, new in zip(blk, tree.leaves(st2)):
            if _rowwise(old):
                old.copy_(new)
            else:
                scalars.append(new)
        return scalars

    # -- state construction --------------------------------------------------

    def init_state(self, master) -> ZooTrainState:
        """Fresh carry for a (n_chunks, D_c) master: zero moments in the
        master's chunk rows, a zero EF residual when error feedback is
        on. Over processes the carry of this rank's rows (the master may
        be the whole one or the rank's rows)."""
        master = torch.as_tensor(master)
        if self.cell is not None and master.shape[0] == self.n_chunks:
            master = self.shard_params(master)
        master = master.to(self.device, torch.float32)
        res_shape = ((self.U, self.n_chunks, self.ob.chunk)
                     if self.cell is None else (self.n_half, self.ob.chunk))
        res = (torch.zeros(res_shape, dtype=torch.float32,
                           device=self.device)
               if self.error_feedback else None)
        return ZooTrainState(master=master, opt=self.optimizer.init(master),
                             residual=res)

    def init_sweep_state(self, masters) -> ZooTrainState:
        """Arm-stacked carry for (A, n_chunks, D_c) masters: per-arm
        moments and residuals; Adam's step counter becomes (A,). Over
        processes the carry of this rank's rows of every arm (the masters
        may be the whole ones or the rank's (A, n_local, D_c) rows)."""
        masters = torch.as_tensor(masters)
        if self.cell is not None and masters.shape[1] == self.n_chunks:
            masters = masters[:, self.row0:self.row0 + self.n_local]
        masters = masters.to(self.device, torch.float32,
                             copy=self.cell is not None)
        A = int(masters.shape[0])
        opt = tree.tree_map(
            lambda l: l if _rowwise(l) else torch.zeros(
                (A,) + tuple(l.shape), dtype=l.dtype, device=l.device),
            self.optimizer.init(masters))
        res_shape = ((A, self.U, self.n_chunks, self.ob.chunk)
                     if self.cell is None else (A, self.n_half, self.ob.chunk))
        res = (torch.zeros(res_shape, dtype=torch.float32, device=self.device)
               if self.error_feedback else None)
        return ZooTrainState(master=masters, opt=opt, residual=res)

    def state_template(self, arms: Optional[int] = None) -> ZooTrainState:
        """Meta-tensor pytree of the carry: the template-strict checkpoint
        restore target. ``arms``: the arm-stacked sweep carry."""
        lead = () if arms is None else (int(arms),)

        def meta(shape, dtype):
            return torch.empty(lead + tuple(shape), dtype=dtype,
                               device="meta")

        master = meta((self.n_chunks, self.ob.chunk), torch.float32)
        opt = tree.tree_map(lambda l: meta(l.shape, l.dtype),
                            self._opt_shapes)
        res = (meta((self.U, self.n_chunks, self.ob.chunk), torch.float32)
               if self.error_feedback else None)
        return ZooTrainState(master=master, opt=opt, residual=res)

    def as_state(self, state) -> ZooTrainState:
        """Accept a ZooTrainState or, for the stateless sgd round without
        EF only, a bare (n_chunks, D_c) master (or (A, n_chunks, D_c) arm
        stack), wrapped into the trivial carry."""
        if isinstance(state, ZooTrainState):
            return state
        if getattr(state, "ndim", None) in (2, 3):
            if self.optimizer_name == "sgd" and not self.error_feedback:
                return ZooTrainState(master=state, opt=(), residual=None)
            raise TypeError(
                f"zoo-train round built with "
                f"optimizer={self.optimizer_name!r}, "
                f"error_feedback={self.error_feedback} carries stateful "
                f"moments/residuals; pass the ZooTrainState from "
                f"init_state(master) instead of a bare master array "
                f"(DESIGN.md §17)")
        raise TypeError(
            f"zoo-train round expects a ZooTrainState or a bare "
            f"(n_chunks, D_c) master array, got {type(state).__name__}")

    def local_state(self, state: ZooTrainState) -> ZooTrainState:
        """This rank's rows of a whole carry, as copies on the round's
        device: master and moments rows ``row0`` onward, the residual its
        worker's rows of its half."""
        d, _ = self.cell
        r0, h0 = self.row0, self.half0

        def rows(x):
            x = torch.as_tensor(x)
            if _rowwise(x):
                x = x[r0:r0 + self.n_local]
            return x.to(self.device, copy=True)

        res = state.residual
        if res is not None:
            res = torch.as_tensor(res)[d, h0:h0 + self.n_half].to(
                self.device, copy=True)
        return ZooTrainState(master=rows(state.master),
                             opt=tree.tree_map(rows, state.opt),
                             residual=res)

    def _check_state(self, state: ZooTrainState):
        """EF residual geometry, checked at the entry points, naming the
        expected geometry."""
        res = state.residual
        if self.cell is not None:
            # this rank's rows: the master (lead, n_local, D_c), each
            # moment the master's shape, the residual (lead, n_half, D_c);
            # lead is () or an arm-stacked carry's (A,)
            master = tuple(state.master.shape)
            lead = master[:-2]
            if master[-2:] != (self.n_local, self.ob.chunk):
                raise ValueError(
                    f"ZooTrainRound over processes: the carry's master is "
                    f"{master}, expected (..., n_local, D_c) = (..., "
                    f"{self.n_local}, {self.ob.chunk}) (this rank's rows; "
                    f"local_state cuts them from a whole carry)")
            for x in tree.leaves(state.opt):
                if _rowwise(x) and tuple(x.shape) != master:
                    raise ValueError(
                        f"ZooTrainRound over processes: an optimizer "
                        f"moment is {tuple(x.shape)}, expected the "
                        f"master's {master}")
            want = (lead + (self.n_half, self.ob.chunk)
                    if self.error_feedback else None)
            got = None if res is None else tuple(res.shape)
            if got != want:
                raise ValueError(
                    f"ZooTrainRound(error_feedback={self.error_feedback}) "
                    f"over processes: the carry's EF residual is {got}, "
                    f"expected {want} (this rank's worker's rows of its "
                    f"half; local_state cuts them from a whole carry)")
            return
        want = (self.U, self.n_chunks, self.ob.chunk)
        if self.error_feedback:
            if res is None:
                raise ValueError(
                    f"ZooTrainRound(error_feedback=True): the round carry "
                    f"has no EF residual; error feedback needs the "
                    f"per-worker (U, n_chunks, D_c) = {want} residual "
                    f"carry in the grads layout — build the carry with "
                    f"init_state(master), or restore a checkpoint written "
                    f"with error feedback on (DESIGN.md §17)")
            shape = tuple(res.shape)[-3:]
            if shape != want:
                raise ValueError(
                    f"ZooTrainRound(error_feedback=True): EF residual has "
                    f"shape {tuple(res.shape)}, expected (U, n_chunks, "
                    f"D_c) = {want} — the residual lives in the same "
                    f"chunk rows as the master, one row block per worker "
                    f"(DESIGN.md §17)")
        elif res is not None:
            raise ValueError(
                "ZooTrainRound(error_feedback=False) got a carry WITH an "
                "EF residual; rebuild the round with error_feedback=True "
                "or drop the residual — silently ignoring it would break "
                "the EF convergence contract (DESIGN.md §17)")

    # -- batches -------------------------------------------------------------

    def shard_batch(self, batch):
        """A (U, ...)-stacked batch dict (arrays or tensors) as tensors on
        the round's device."""
        return {k: torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v).to(self.device)
            for k, v in batch.items()}

    # -- the round -------------------------------------------------------------

    def round_train(self, state, batch, t, key, noise_var, p_max, lr, *,
                    draws: Optional[ZooDraws] = None, hook=None):
        """One real-gradient round. ``state``: a ZooTrainState from
        ``init_state`` (a bare master for the stateless sgd round);
        ``batch``: dict of (U, ...)-stacked tensors. Updates the carry in
        place; returns (state, ZooTrainStats)."""
        state = self.as_state(state)
        self._check_state(state)
        beta, b_t, z = self._prologue(t, key, noise_var, p_max, draws)
        if self.cell is not None:
            return self._round_train_procs(state, batch, beta, b_t, z,
                                           noise_var, lr, hook)
        p_full = self.layout.master_to_tree(state.master,
                                            dtype=self.compute_dtype)
        losses, cur = [], {}

        def worker_rows(u):
            cur.clear()
            loss, cur["g"] = self._worker_grads(p_full, batch, u)
            losses.append(loss)
            if hook is not None:
                hook("backward")
            return lambda a, b: cur["g"][a:b].to(torch.float32)

        if state.residual is None:
            def compress(u, rows, a):
                return self._compress_blocks(rows)
        else:
            res = state.residual

            def compress(u, rows, a):
                return self._compress_blocks_ef(
                    rows, res[u, a:a + rows.shape[0]])

        y_sum, mag_sum = self._upload(worker_rows, beta, b_t, hook,
                                      compress=compress)
        cur.clear()
        del p_full
        lr_t = float(np.float32(lr))
        scalars = []

        def apply(a, b, ghat):
            scalars[:] = self._opt_update_blocks(ghat, state.opt,
                                                 state.master, a, b, lr_t)

        gn2 = self._mac_decode(y_sum, mag_sum, beta, b_t, z, noise_var,
                               apply, hook)
        olds = [l for l in tree.leaves(state.opt) if not _rowwise(l)]
        for old, new in zip(olds, scalars):
            old.copy_(new)
        loss = torch.mean(torch.stack(losses).to(torch.float32))
        return state, _with_loss(self._stats(beta, b_t, gn2, noise_var),
                                 loss)

    def _round_train_procs(self, state, batch, beta, b_t, z, noise_var, lr,
                           hook):
        """``round_train``'s body on rank (d, m): the worker's backward on
        its own batch, the EF-corrected compression of its half, the MAC
        over the worker group, the decode and update of its own rows."""
        d, m = self.cell
        loss, g_sect = self._local_loss_and_grads(
            state.master, {k: v[d] for k, v in batch.items()})
        if hook is not None:
            hook("backward")
        res = state.residual

        def blocks():
            for a, b in self._half_blocks(m):
                yield a, g_sect[a - self.half0:b - self.half0].to(
                    torch.float32)

        def compress(u, rows, a):
            if res is None:
                return self._compress_blocks(rows)
            lo = a - self.half0
            return self._compress_blocks_ef(rows,
                                            res[lo:lo + rows.shape[0]])

        y_sum, mag_sum = self._upload_procs(blocks, beta, b_t, hook,
                                            compress=compress)
        del g_sect
        lr_t = float(np.float32(lr))
        scalars = []

        def apply(a, b, ghat):
            scalars[:] = self._opt_update_blocks(ghat, state.opt,
                                                 state.master, a, b, lr_t)

        gn2 = self._mac_decode(y_sum, mag_sum, beta, b_t, z, noise_var,
                               apply, hook)
        olds = [l for l in tree.leaves(state.opt) if not _rowwise(l)]
        for old, new in zip(olds, scalars):
            old.copy_(new)
        loss = coll.pmean(loss.to(torch.float32).reshape(1), self.wgroup)[0]
        return state, _with_loss(self._stats(beta, b_t, gn2, noise_var),
                                 loss)

    def grads_in_layout(self, master, batch):
        """The per-worker gradients as a (U, n_chunks, D_c) f32 tensor in
        the master's flat order, what ``round_from_grads`` consumes.
        Returns (grads, per-worker losses (U,)); over processes (this
        rank's (n_half, D_c) block from its master rows, its loss)."""
        if isinstance(master, ZooTrainState):
            master = master.master
        if self.cell is not None:
            loss, g = self._local_loss_and_grads(
                master, {k: v[self.cell[0]] for k, v in batch.items()})
            return g.to(torch.float32), loss
        p_full = self.layout.master_to_tree(master, dtype=self.compute_dtype)
        gs, losses = [], []
        for u in range(self.U):
            loss, gm = self._worker_grads(p_full, batch, u)
            gs.append(gm.to(torch.float32))
            losses.append(loss)
        return torch.stack(gs), torch.stack(losses)

    def reference_round_train(self, state, batch, t, key, noise_var, p_max,
                              lr, *, draws: Optional[ZooDraws] = None):
        """The single-device oracle of ``round_train``: on one card, the
        same round on a copy of the carry."""
        state = self.as_state(state)
        return self.round_train(clone_state(state), batch, t, key,
                                noise_var, p_max, lr, draws=draws)

    def reference_grads(self, chunked, batch):
        """The single-device oracle of ``grads_in_layout``."""
        return self.grads_in_layout(chunked, batch)

    # -- params layout ---------------------------------------------------------

    def chunk_params(self, params) -> torch.Tensor:
        """Params pytree -> (n_chunks, D_c) f32 in the flat-shard layout,
        on the round's device."""
        out = torch.zeros((self.n_chunks, self.ob.chunk),
                          dtype=torch.float32, device=self.device)
        return self.layout.tree_to_master(params, out=out)

    def params_from_master(self, chunked):
        """(n_chunks, D_c) -> full params pytree (views of the master when
        the model axis is 1)."""
        if isinstance(chunked, ZooTrainState):
            chunked = chunked.master
        return self.layout.master_to_tree(torch.as_tensor(chunked))

    def unchunk(self, chunked) -> torch.Tensor:
        leaves = tree.leaves(self.params_from_master(chunked))
        return torch.cat([x.reshape(-1) for x in leaves])

    # -- multi-arm sweep ---------------------------------------------------------

    def run_sweep(self, states, batch, arms, rounds: int, *, key, t0=0,
                  draws=None):
        """Arms × rounds as a host loop: for each round, each arm's round
        on its slice of the arm-stacked carry (in place). ``states``: from
        ``init_sweep_state`` (bare (A, n_chunks, D_c) masters for the
        stateless round); ``arms``: dict of (A,) ``noise_var`` / ``p_max``
        / ``lr``; ``draws``: optional callable t -> ZooDraws (every arm of
        round t shares its draws, as the reference's arms share the
        round's key). Over processes each rank runs every arm on its
        rows of the carry (``init_sweep_state``'s), and the stats come
        back on every rank. Returns (states, ZooTrainStats of NumPy
        arrays stacked (rounds, A))."""
        states = self.as_state(states)
        self._check_state(states)
        nv, pm, lr = (np.asarray(torch.as_tensor(arms[k]).cpu(), np.float32)
                      for k in ("noise_var", "p_max", "lr"))
        A = int(nv.shape[0])
        if tuple(states.master.shape[:-2]) != (A,):
            raise ValueError(
                f"run_sweep: {A} arms, but the carry's master is "
                f"{tuple(states.master.shape)}, expected (A, rows, D_c)")
        rows = []
        for t in range(int(t0), int(t0) + int(rounds)):
            dr = draws(t) if draws is not None else None
            per_arm = []
            for a in range(A):
                sa = tree.tree_map(lambda x: x[a], states)
                _, st = self.round_train(sa, batch, t, key, float(nv[a]),
                                         float(pm[a]), float(lr[a]),
                                         draws=dr)
                per_arm.append(host_stats(st))
            rows.append(tree.tree_map(lambda *x: np.stack(x), *per_arm))
        return states, tree.tree_map(lambda *x: np.stack(x), *rows)

    def reference_sweep(self, states, batch, arms, rounds: int, *, key,
                        t0=0, draws=None):
        """The single-device oracle of ``run_sweep``: the same loop on a
        copy of the carry."""
        states = self.as_state(states)
        return self.run_sweep(clone_state(states), batch, arms, rounds,
                              key=key, t0=t0, draws=draws)

    def shard_masters(self, masters):
        """(A, n_chunks, D_c) arm-stacked masters on the round's device."""
        return torch.as_tensor(masters).to(self.device, torch.float32)

    # -- checkpointing ---------------------------------------------------------

    def save_state(self, ckpt_dir: str, step: int, state: ZooTrainState,
                   t_next: int) -> str:
        """Snapshot the full carry (master, moments, EF residuals) and the
        absolute next round, one atomic step dir in the reference's
        format. Every draw is keyed by the absolute round index, so no
        generator state is saved."""
        state = self.as_state(state)
        if self.cell is None:
            return checkpoint.save(ckpt_dir, step,
                                   {"state": state,
                                    "t_next": np.int32(t_next)})
        obj = {"state": self._streamed(state), "t_next": np.int32(t_next)}
        if coll.axis_index(self.world) == 0:
            path = checkpoint.save(ckpt_dir, step, obj)
        else:
            for leaf in tree.leaves(obj):
                if isinstance(leaf, checkpoint.RowBlocks):
                    for _ in leaf.blocks():
                        pass
            path = checkpoint.step_dir(ckpt_dir, step)
        # rank 0's word that the step is on disk
        coll.broadcast(torch.zeros(1, device=self.device), self.world)
        return path

    def _streamed(self, state: ZooTrainState) -> ZooTrainState:
        """The whole carry as ``RowBlocks`` leaves: each leaf's rows in
        order (an arm-stacked carry's arm by arm), every owner's block
        broadcast from it over the world (rank 0 writes them). Rank
        d·M + m owns master rows m·n_half + d·n_local and worker d's
        residual rows of half m."""
        W, M = self.U, self.n_model
        me = coll.axis_index(self.world)

        def rows_of(local, owners):
            def blocks():
                for lead in np.ndindex(*local.shape[:-2]):
                    x = local[lead]
                    for src in owners:
                        for a, b in self._blocks(0, x.shape[0]):
                            buf = (x[a:b].contiguous() if me == src
                                   else torch.empty_like(x[a:b]))
                            yield coll.broadcast(buf, self.world, src=src)
            return blocks

        by_rows = [d * M + m for m in range(M) for d in range(W)]
        by_res = [u * M + m for u in range(W) for m in range(M)]

        def leaf(x):
            if not _rowwise(x):
                return x
            return checkpoint.RowBlocks(
                tuple(x.shape[:-2]) + (self.n_chunks, self.ob.chunk),
                x.dtype, rows_of(x, by_rows))

        res = state.residual
        if res is not None:
            res = checkpoint.RowBlocks(
                tuple(res.shape[:-2]) + (self.U, self.n_chunks,
                                         self.ob.chunk),
                res.dtype, rows_of(res, by_res))
        return ZooTrainState(master=leaf(state.master),
                             opt=tree.tree_map(leaf, state.opt),
                             residual=res)

    def restore_state(self, ckpt_dir: str, step: Optional[int] = None,
                      arms: Optional[int] = None):
        """(state, t_next) from ``step`` (default: the latest), strict
        against :meth:`state_template` (leaf count, shapes, dtypes), on
        the round's device; over processes this rank's rows of it. None
        when the directory holds no steps."""
        if step is None:
            step = checkpoint.latest_step(ckpt_dir)
            if step is None:
                return None
        like = {"state": self.state_template(arms),
                "t_next": torch.empty((), dtype=torch.int32, device="meta")}
        rows = None
        if self.cell is not None:
            # this rank's rows of each leaf (of every arm), memory-mapped
            d, _ = self.cell
            lead = () if arms is None else (slice(None),)
            own = lead + (slice(self.row0, self.row0 + self.n_local),)
            half = lead + (d, slice(self.half0, self.half0 + self.n_half))
            rows = [{2: own, 3: half}.get(x.ndim - len(lead))
                    for x in tree.leaves(like)]
        got = checkpoint.restore(ckpt_dir, step, like, rows=rows)
        state = tree.tree_map(lambda x: x.to(self.device), got["state"])
        return state, int(got["t_next"])

    # -- host loop -----------------------------------------------------------------

    def run_rounds_train(self, state, batch, rounds: int, *, key,
                         noise_var, p_max, lr, t0: int = 0,
                         ckpt_dir: Optional[str] = None,
                         ckpt_every: int = 0, draws=None):
        """Host loop over real-gradient rounds from absolute round ``t0``,
        snapshotting the carry every ``ckpt_every`` rounds. Returns
        (state, list of host ZooTrainStats)."""
        state = self.as_state(state)
        out = []
        for t in range(t0, t0 + rounds):
            dr = draws(t) if draws is not None else None
            state, st = self.round_train(state, batch, t, key, noise_var,
                                         p_max, lr, draws=dr)
            out.append(host_stats(st))
            if ckpt_dir and ckpt_every and (t + 1) % ckpt_every == 0:
                self.save_state(ckpt_dir, t + 1, state, t_next=t + 1)
        return state, out


def clone_state(state: ZooTrainState) -> ZooTrainState:
    """A copy of every carry leaf."""
    return tree.tree_map(torch.clone, state)


def build_zoo_train_round(model, mesh, ob: OBCSAAConfig,
                          **kw) -> ZooTrainRound:
    """Build the real-backward zoo round for (model, mesh, ob)."""
    return ZooTrainRound(model, mesh, ob, **kw)
