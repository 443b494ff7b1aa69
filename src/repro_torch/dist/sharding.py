"""Which dims of a parameter leaf the mesh splits; port of
``repro/dist/sharding.py``, the parts the zoo needs.

Pure index math over a ``launch.mesh.ZooMesh`` (or anything with
``axis_names`` and a ``shape`` mapping), exact against the reference. A
partition spec is a tuple with one entry per dim: an axis name, a tuple
of names, or None; ``()`` replicates (the reference's ``P()``).

- ``best_spec(shape, hints, mesh)``: per-dim axis choice from priority
  hint lists like ``["data", None]``, the first candidate that exists,
  is unused and divides the dim; ``data`` widens to ``("pod", "data")``
  on a 3-axis mesh when that still divides.
- ``param_shard_dims`` / ``infer_param_sharding``: each leaf's largest
  ``model``-divisible dim (ties to the trailing one) is split over the
  model axis; worker axes are never used, every FL worker holds the
  whole model. Leaves under a ``STACKED_KEYS`` collection keep their
  leading dim (the layer axis) whole.
- ``infer_batch_sharding(tree, mesh)``: a sweep's (A, ...)-stacked
  leaves split along the arm axis over the worker axes where A divides
  their product W, replicated where it does not; ``batch_indices(A,
  mesh)`` the arms one rank holds under it (worker d the block
  ``[d·A/W, (d+1)·A/W)``, every arm when replicated or in one process).
- ``local_shape(shape, spec, mesh)``: the block of a leaf one rank holds
  under a spec (each dim over the product of the sizes of its axes);
  ``spec_bytes`` the bytes a rank holds of a tree of leaves (the product
  rule).
- ``constrain(x, axes)`` is the identity: one card holds every shard.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import tree

# Keys whose subtrees hold layer-stacked leaves: dim 0 is the layer axis,
# not a shardable weight dim.
STACKED_KEYS = ("layers", "enc_layers")


def _axis_sizes(mesh) -> dict:
    return dict(mesh.shape)


def constrain(x, axes):
    """The reference's soft sharding constraint; on one card every shard
    is on the card, so nothing is constrained."""
    del axes
    return x


def best_spec(shape: Sequence[int], hints, mesh) -> tuple:
    """Pick a partition spec for ``shape`` from per-dim hint candidates.

    ``hints[i]`` is an axis name, None, or a priority list of candidates.
    For each dim the first candidate that exists in the mesh, is unused,
    and divides the dim wins; the ``data`` hint is widened to the full
    worker-axis product ``("pod", "data")`` on 3-axis meshes when that
    larger factor still divides. No candidate fits -> the dim is
    replicated (None)."""
    sizes = _axis_sizes(mesh)
    used = set()
    parts = []
    for i, dim in enumerate(shape):
        hint = hints[i] if i < len(hints) else None
        cands = list(hint) if isinstance(hint, (list, tuple)) else [hint]
        chosen = None
        for cand in cands:
            if cand is None:
                break
            options = [(cand,)]
            if cand == "data" and "pod" in sizes:
                options.insert(0, ("pod", "data"))
            for opt in options:
                if any(a not in sizes or a in used for a in opt):
                    continue
                total = 1
                for a in opt:
                    total *= sizes[a]
                if dim % total == 0:
                    chosen = opt
                    break
            if chosen:
                break
        if chosen:
            used.update(chosen)
            parts.append(chosen if len(chosen) > 1 else chosen[0])
        else:
            parts.append(None)
    return tuple(parts)


def infer_batch_sharding(t, mesh, *, dim: int = 0):
    """Spec pytree for an (A, ...)-stacked sweep carry or ``Arms``: dim
    ``dim`` of every leaf over the worker axes (``best_spec``'s ``data``
    hint, ``("pod", "data")`` on a 3-axis mesh) when the arm count
    divides, replicated (``()``) otherwise; leaves without that dim
    replicate. Arms share nothing, so either layout is correct."""
    def spec_of(keys, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) <= dim:
            return ()
        hints = [None] * len(shape)
        hints[dim] = "data"
        return best_spec(shape, hints, mesh)

    return _rebuild(t, _map_with_keys(spec_of, t))


def batch_indices(n: int, mesh) -> range:
    """The arms of an ``n``-arm sweep this process holds on ``mesh`` under
    ``infer_batch_sharding``: worker d of W the block ``[d·n/W,
    (d+1)·n/W)`` (the ranks of one model group hold the same block), every
    arm where W does not divide n, and every arm without a mesh or in one
    process (a mesh without a ``world``, whose cells run in turn)."""
    if mesh is None or getattr(mesh, "world", None) is None:
        return range(n)
    spec = infer_batch_sharding(torch.empty((n,), device="meta"), mesh)
    if spec[0] is None:
        return range(n)
    per = local_shape((n,), spec, mesh)[0]
    d = mesh.cell()[0]
    return range(d * per, (d + 1) * per)


def local_shape(shape: Sequence[int], spec, mesh) -> tuple:
    """The shape of one rank's block of a ``shape`` leaf laid out by
    ``spec`` on ``mesh``: each dim over the product of the sizes of the
    axes its entry names (which must divide it, as ``best_spec``'s
    do)."""
    sizes = _axis_sizes(mesh)
    out = []
    for i, dim in enumerate(shape):
        part = spec[i] if i < len(spec) else None
        div = 1
        for ax in ((part,) if isinstance(part, str) else part or ()):
            div *= sizes[ax]
        if dim % div:
            raise ValueError(f"local_shape: dim {i} of {tuple(shape)} does "
                             f"not split {div} ways ({spec})")
        out.append(dim // div)
    return tuple(out)


def spec_bytes(shapes, specs, mesh) -> int:
    """Bytes a card holds of the leaves ``shapes`` (tensors) under the
    partition ``specs`` (one spec tuple per leaf, in leaf order): each
    leaf's bytes over the product of the sizes of the axes its spec
    names."""
    sizes = _axis_sizes(mesh)
    total = 0
    for x, spec in zip(tree.leaves(shapes), specs):
        div = 1
        for part in spec:
            for ax in ((part,) if isinstance(part, str) else part or ()):
                div *= sizes[ax]
        total += x.numel() * x.element_size() // div
    return total


def _map_with_keys(fn, t):
    """``fn(keys, leaf)`` over the leaves of ``t``, as a list in walk
    order (a spec is a tuple, which ``repro_torch.tree`` would walk into,
    so the results are placed with ``unflatten`` and never re-flattened)."""
    return [fn(keys, leaf) for keys, leaf in tree.flatten_with_keys(t)]


def _rebuild(t, values):
    return tree.unflatten(tree.flatten(t)[1], values)


def _path_is_stacked(path, stacked_keys) -> bool:
    """Does the key path (dict keys, field names, indices) pass through a
    stacked collection?"""
    return any(isinstance(k, str) and k in stacked_keys for k in path)


def _best_model_dim(shape, msize, *, skip_leading: bool):
    """Index of the largest ``msize``-divisible dim, or None.

    ``skip_leading`` excludes dim 0 (a stacked leaf's layer axis). Ties go
    to the trailing dim: the contraction/output dim of weight matrices."""
    if msize <= 1 or not shape:
        return None
    best = None
    for i, d in enumerate(shape):
        if skip_leading and i == 0:
            continue
        if d > 1 and d % msize == 0 and (best is None or d >= shape[best]):
            best = i
    return best


def _dims(t, mesh, model_axis, stacked_keys) -> list:
    msize = _axis_sizes(mesh).get(model_axis, 1)

    def dim_of(path, leaf):
        best = _best_model_dim(
            tuple(getattr(leaf, "shape", ())), msize,
            skip_leading=_path_is_stacked(path, stacked_keys))
        return -1 if best is None else best

    return _map_with_keys(dim_of, t)


def param_shard_dims(t, mesh, *, model_axis: str = "model",
                     stacked_keys: Sequence[str] = STACKED_KEYS):
    """Per-leaf pytree of the dim split over ``model_axis``, -1 where the
    leaf replicates (so the result stays congruent with ``t``)."""
    return _rebuild(t, _dims(t, mesh, model_axis, stacked_keys))


def infer_param_specs(t, mesh, *, model_axis: str = "model",
                      stacked_keys: Sequence[str] = STACKED_KEYS) -> list:
    """``infer_param_sharding``'s specs as a list in leaf order."""
    out = []
    for (_, leaf), d in zip(tree.flatten_with_keys(t),
                            _dims(t, mesh, model_axis, stacked_keys)):
        if d < 0:
            out.append(())
            continue
        parts = [None] * len(tuple(leaf.shape))
        parts[d] = model_axis
        out.append(tuple(parts))
    return out


def infer_param_sharding(t, mesh, *, model_axis: str = "model",
                         stacked_keys: Sequence[str] = STACKED_KEYS):
    """Spec pytree for params / optimizer state: each leaf's largest
    ``model``-divisible dim over the model axis (ties -> the trailing
    dim); scalars, odd-shaped leaves and meshes without model parallelism
    replicate (``()``). Stacked leaves keep dim 0 whole."""
    return _rebuild(t, infer_param_specs(t, mesh, model_axis=model_axis,
                                         stacked_keys=stacked_keys))
