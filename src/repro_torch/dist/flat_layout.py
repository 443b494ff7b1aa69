"""The zoo-train master's model-major flat order; port of
``repro/dist/flat_layout.py``, bit for bit.

The zoo round (``engine/zoo.py``) keeps parameters as a chunked
``(n_chunks, D_c)`` f32 array. With ``mp`` model shards the flat vector
is the concatenation of ``mp`` *sections*: the m-th section is, leaf by
leaf in ``repro_torch.tree`` order (the reference's flatten order), the
raveled m-th slice of each leaf along its model-sharded dim
(``dist.sharding.param_shard_dims``), zero-padded at the section end to
``n_half`` chunks (rounded up so ``gran``, the worker count times the
block size, divides it). This order alone decides which parameters share
a chunk, and so which entries compete in a chunk's top-κ: it fixes the
numbers of every round.

Every leaf must split evenly over ``mp`` along some dim; ``build`` raises
naming the offending leaf otherwise. On one card the sections are rows
of one tensor, and ``section_to_tree`` returns views into them.
"""
from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Tuple

import torch

from repro_torch import tree
from repro_torch.dist.sharding import STACKED_KEYS, param_shard_dims


class _LeafSlot(NamedTuple):
    name: str            # key path, for error messages
    shape: Tuple[int, ...]
    dtype: Any
    dim: int             # model-sharded dim (-1: replicated, mp == 1 only)
    offset: int          # element offset of the m-slice within its section
    m_size: int          # elements of one m-slice (= prod(shape) // mp)


class FlatShardLayout:
    """See module docstring. Build via :meth:`build`."""

    def __init__(self, treedef, slots: List[_LeafSlot], *, mp: int,
                 chunk: int, n_half: int):
        self.treedef = treedef
        self.slots = slots
        self.mp = mp
        self.chunk = chunk
        self.n_half = n_half                       # chunks per section
        self.n_chunks = mp * n_half
        self.sec_elems = sum(s.m_size for s in slots)
        self.D = self.sec_elems * mp               # true parameter count
        self.D_pad = self.n_chunks * chunk

    @classmethod
    def build(cls, shapes_tree, mesh, *, chunk: int, gran: int = 1,
              model_axis: str = "model", stacked_keys=STACKED_KEYS):
        """Layout for a params pytree of tensors (``device="meta"`` ones
        allocate nothing) or anything with ``shape`` and ``dtype``.

        ``gran``: round ``n_half`` up to a multiple of this (the worker
        count, so every cell owns a whole number of chunk rows)."""
        mp = int(dict(mesh.shape).get(model_axis, 1))
        dims = tree.leaves(param_shard_dims(shapes_tree, mesh,
                                            model_axis=model_axis,
                                            stacked_keys=stacked_keys))
        leaves, treedef = tree.flatten_with_paths(shapes_tree)
        slots, off = [], 0
        for (name, leaf), dim in zip(leaves, dims):
            shape = tuple(leaf.shape)
            size = math.prod(shape) if shape else 1
            if mp > 1:
                if dim < 0 or shape[dim] % mp != 0:
                    raise ValueError(
                        f"zoo-train layout: leaf {name} with shape {shape} "
                        f"has no dim divisible by the model-axis size "
                        f"{mp}; every parameter leaf must split evenly "
                        f"over '{model_axis}' (DESIGN.md §16). Resize the "
                        f"offending dimension or shrink the model axis.")
                if size % mp != 0:
                    raise ValueError(
                        f"zoo-train layout: leaf {name} size {size} not "
                        f"divisible by model-axis size {mp}")
            m_size = size // mp
            slots.append(_LeafSlot(name, shape, leaf.dtype, dim, off, m_size))
            off += m_size
        n_half = -(-off // chunk)
        n_half = -(-n_half // max(gran, 1)) * max(gran, 1)
        return cls(treedef, slots, mp=mp, chunk=chunk, n_half=n_half)

    # -- shapes ------------------------------------------------------------

    def shard_shape(self, slot: _LeafSlot) -> Tuple[int, ...]:
        """Shape of one m-slice of ``slot`` (the leaf's shape with the
        sharded dim divided by mp)."""
        if self.mp == 1 or slot.dim < 0:
            return slot.shape
        s = list(slot.shape)
        s[slot.dim] //= self.mp
        return tuple(s)

    # -- one section (identical for every m) --------------------------------

    def section_to_tree(self, sect: torch.Tensor):
        """(n_half, D_c) or flat m-section -> pytree of per-leaf m-slices
        (views of ``sect`` where it is contiguous)."""
        flat = sect.reshape(-1)
        leaves = [flat[s.offset:s.offset + s.m_size].view(self.shard_shape(s))
                  for s in self.slots]
        return tree.unflatten(self.treedef, leaves)

    def tree_to_section(self, slices_tree) -> torch.Tensor:
        """pytree of per-leaf m-slices -> (n_half, D_c) flat m-section,
        zero-padded; the dtype follows the leaves."""
        leaves = tree.leaves(slices_tree)
        out = leaves[0].new_zeros((self.n_half * self.chunk,))
        for s, x in zip(self.slots, leaves):
            out[s.offset:s.offset + s.m_size] = x.reshape(-1)
        return out.view(self.n_half, self.chunk)

    # -- full-tree conversions (init, oracle, checkpoint interop) ----------

    def _slice_m(self, leaf, slot: _LeafSlot, m: int):
        if self.mp == 1 or slot.dim < 0:
            return leaf
        k = slot.shape[slot.dim] // self.mp
        return leaf.narrow(slot.dim, m * k, k)

    def tree_to_master(self, params, dtype=torch.float32,
                       out: torch.Tensor = None) -> torch.Tensor:
        """Full params pytree -> the canonical (n_chunks, D_c) array, on
        the leaves' device; written into ``out`` when given. One leaf
        slice is copied at a time, so the peak is the master plus one
        slice."""
        leaves = tree.leaves(params)
        if out is None:
            out = torch.zeros((self.n_chunks, self.chunk), dtype=dtype,
                              device=leaves[0].device)
        flat = out.view(self.mp, self.n_half * self.chunk)
        for m in range(self.mp):
            for leaf, s in zip(leaves, self.slots):
                flat[m, s.offset:s.offset + s.m_size] = \
                    self._slice_m(leaf, s, m).reshape(-1)
            flat[m, self.sec_elems:] = 0
        return out

    def master_to_tree(self, master: torch.Tensor, dtype=None):
        """(n_chunks, D_c) -> full params pytree (inverse of
        ``tree_to_master``; pad elements are dropped). ``dtype`` casts the
        leaves (None keeps the master's dtype; with mp = 1 the leaves are
        then views of the master)."""
        flat = master.reshape(self.mp, self.n_half * self.chunk)
        per_m = [tree.leaves(self.section_to_tree(flat[m]))
                 for m in range(self.mp)]
        leaves = []
        for i, s in enumerate(self.slots):
            if self.mp == 1 or s.dim < 0:
                x = per_m[0][i]
            else:
                x = torch.cat([per_m[m][i] for m in range(self.mp)],
                              dim=s.dim)
            leaves.append(x if dtype is None else x.to(dtype))
        return tree.unflatten(self.treedef, leaves)
