"""One rank's share of a parameter tree over a mesh's model group, and
the forward and backward on it: the layout GSPMD gives the reference's
``infer_param_sharding`` (``dist.sharding``), with its gathers written
out. The zoo-train round (``engine/zoo_train.py``) and the split train
step (``launch/steps.py``) both run through it.

A leaf's share on rank (d, m) of a ``launch.mesh.world_mesh(M)`` is its
m-th of M equal blocks along ``param_shard_dims``' dim (the largest
divisible one, ties to the trailing dim; a stacked leaf's layer axis
kept whole); a leaf with no such dim is held whole. The worker axis
holds replicas.

- ``ModelAxis(shapes, mesh)``: the dims and the model group.
  ``materialize`` gathers each non-stacked leaf once; ``layer_resolver``
  gathers one layer's weights of a stacked collection, inside the remat
  boundary, so the backward gathers them again rather than keep them.
  Both go through ``collectives.replicated_gather``, whose backward is
  the local slice: every rank of a model group runs the same batch, so
  its cotangents are replicas and the slice is the exact adjoint.
  ``loss_and_grads`` takes the gradient of a non-stacked leaf whole and
  slices it, so a leaf used in several places (a tied embedding, the
  hybrid's shared block) sums its cotangents in the whole tree's order:
  the shares' gradients are the whole gradient's blocks bit for bit.
- ``shard_tree``/``whole_tree``: a whole tree to this rank's shares and
  back (the inverse gathers over the model group).
- ``cut``: a leaf's share by its key path, for
  ``models.layers.init_cut``, which cuts each weight as the init draws
  it, so that no rank holds the whole model: the slice of
  ``model.init(seed)`` bit for bit.

The product rule over ``launch.steps.param_shardings`` gives the bytes a
rank holds (``dist.sharding.spec_bytes``).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch import tree
from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import (STACKED_KEYS, _path_is_stacked,
                                       param_shard_dims)


def _narrow(x: torch.Tensor, dim: int, M: int, m: int) -> torch.Tensor:
    k = x.shape[dim] // M
    return x.narrow(dim, m * k, k)


class ModelAxis:
    """The model-axis layout of a parameter tree of ``shapes`` (tensors,
    meta ones allocate nothing) on ``mesh``, for model shard ``m``
    (default: this process's, ``mesh.cell()``)."""

    def __init__(self, shapes, mesh, m: Optional[int] = None):
        self.M = int(mesh.shape.get("model", 1))
        self.m = mesh.cell()[1] if m is None else int(m)
        self.group = getattr(mesh, "model_group", None)
        dims_tree = param_shard_dims(shapes, mesh)
        self.dims: List[int] = tree.leaves(dims_tree)
        self.keys = [tuple(k) for k, _ in tree.flatten_with_keys(shapes)]
        self.shapes = [tuple(x.shape) for x in tree.leaves(shapes)]
        # the rule param_shard_dims keeps a stacked leaf's layer axis by
        self.stacked = [_path_is_stacked(k, STACKED_KEYS) for k in self.keys]
        self._index = {k: i for i, k in enumerate(self.keys)}
        # a stacked collection's per-layer dims (dim 0, the layer axis,
        # sliced off), keyed by the key paths of its per-layer tree
        self._resolver_dims = {}
        for key in STACKED_KEYS:
            if key in shapes:
                paths = tuple(p for p, _ in
                              tree.flatten_with_paths(shapes[key])[0])
                self._resolver_dims[paths] = [
                    max(d - 1, -1) for d in tree.leaves(dims_tree[key])]
        self._dims_tree = dims_tree

    # -- shares ---------------------------------------------------------------

    def split(self, i: int) -> bool:
        """Whether leaf i is split over the model group."""
        return self.M > 1 and self.dims[i] >= 0

    def share_leaf(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's block of the whole leaf i (a copy; the leaf itself
        when it is held whole)."""
        if not self.split(i):
            return x
        return _narrow(x, self.dims[i], self.M, self.m).clone()

    def share_index(self, i: int) -> Optional[tuple]:
        """The index of this rank's block in the whole leaf i (None: the
        whole leaf)."""
        if not self.split(i):
            return None
        d = self.dims[i]
        k = self.shapes[i][d] // self.M
        return (slice(None),) * d + (slice(self.m * k, (self.m + 1) * k),)

    def gather_leaf(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole leaf from the group's blocks along ``dim`` (autograd:
        the backward is this rank's slice)."""
        if self.M == 1 or dim < 0:
            return x
        return coll.replicated_gather(self.group, self.M, dim=dim)(x)

    def whole_leaf(self, x: torch.Tensor, i: int,
                   kind: str = "all_gather") -> torch.Tensor:
        """Leaf i whole, from this rank's share (no autograd; the gather
        counted as ``kind``)."""
        if not self.split(i):
            return x
        return coll.gather_tiled(x, self.group, axis=self.dims[i],
                                 kind=kind)

    # -- the forward and backward on shares -------------------------------

    def layer_resolver(self, lp):
        """Shares -> whole weights of one layer of a stacked collection."""
        flat, td = tree.flatten_with_paths(lp)
        dims = self._resolver_dims.get(tuple(p for p, _ in flat))
        if dims is None:
            raise KeyError(
                f"model-axis layer resolver saw an unknown per-layer "
                f"structure {[p for p, _ in flat][:4]}...; stacked "
                f"collections must be registered under "
                f"dist.sharding.STACKED_KEYS {STACKED_KEYS}")
        return tree.unflatten(td, [self.gather_leaf(x, d) for (_, x), d
                                   in zip(flat, dims)])

    def materialize(self, shares):
        """Non-stacked leaves gathered whole once; stacked collections
        stay shares for ``layer_resolver``."""
        if self.M == 1:
            return shares
        return {key: sub if key in STACKED_KEYS else tree.tree_map(
                    self.gather_leaf, sub, self._dims_tree[key])
                for key, sub in shares.items()}

    def loss_and_grads(self, model, shares, batch, *, remat, dp=None,
                       whole_unstacked: bool = False):
        """(loss, gradient tree) of ``model.loss_fn`` on ``batch`` from
        this rank's ``shares``: every gradient leaf this rank's block of
        the whole gradient, or, with ``whole_unstacked``, the whole
        gradient of every non-stacked leaf (stacked leaves' are blocks
        either way)."""
        with torch.no_grad():
            p = self.materialize(shares)
        leaves, td = tree.flatten(p)
        req = [x.detach().requires_grad_() for x in leaves]
        resolver = (self.layer_resolver
                    if self.M > 1 and self._resolver_dims else None)
        with torch.enable_grad():
            loss, _ = model.loss_fn(tree.unflatten(td, req), batch,
                                    remat=remat, layer_resolver=resolver,
                                    dp=dp)
            grads = list(torch.autograd.grad(loss, req))
        del req, leaves, p
        if not whole_unstacked:
            for i, g in enumerate(grads):
                if not self.stacked[i] and self.split(i):
                    grads[i] = _narrow(g, self.dims[i], self.M, self.m)
        return loss.detach(), tree.unflatten(td, grads)

    # -- whole trees ----------------------------------------------------------

    def shard_tree(self, params):
        """This rank's shares of a whole tree."""
        leaves, td = tree.flatten(params)
        return tree.unflatten(td, [self.share_leaf(x, i)
                                   for i, x in enumerate(leaves)])

    def whole_tree(self, shares):
        """The whole tree from every rank's shares (each rank of the model
        group calls it)."""
        leaves, td = tree.flatten(shares)
        return tree.unflatten(td, [self.whole_leaf(x, i)
                                   for i, x in enumerate(leaves)])

    def cut(self, key: tuple, w: torch.Tensor) -> torch.Tensor:
        """This rank's share of the whole leaf at key path ``key`` (the
        cut ``models.layers.init_cut`` takes)."""
        i = self._index.get(tuple(key))
        return w if i is None else self.share_leaf(w, i)


def shard_tree(params, mesh, m: Optional[int] = None):
    """Rank (·, m)'s shares of the whole tree ``params`` on ``mesh``
    (default m: this process's)."""
    return ModelAxis(params, mesh, m).shard_tree(params)


def whole_tree(shares, model, mesh):
    """The whole tree of ``model``'s parameters from every rank's
    ``shares``, over ``mesh``'s model group (every rank of it calls)."""
    return ModelAxis(model.init(0, device="meta"), mesh).whole_tree(shares)
