"""Checkpoints of trees of tensors; port of ``repro/checkpoint/io.py``,
in the same on-disk format, so either package restores the other's:

    <dir>/step_<N:08d>/{tree.msgpack, arrays.npz}

``arrays.npz`` holds leaf i as ``a<i>``, the leaves in
``jax.tree_util.tree_flatten``'s order (``repro_torch.tree``); bfloat16
leaves are stored as float32. ``tree.msgpack`` is the meta map
``{"keys", "dtypes", "shapes", "step"}`` — leaf key paths as
``jax.tree_util.keystr`` writes them, storage dtypes, shapes, the step —
encoded by ``msgpack_meta`` (a MessagePack subset written by hand: the
card's machine has no ``msgpack``).

- ``save`` writes ``step_<N>.tmp`` and renames it at the end, so a crash
  mid-write leaves no directory ``latest_step`` would pick up.
- ``restore`` checks the leaf count, every shape and every dtype against
  the template ``like`` and raises a ``ValueError`` naming the leaf; a
  corrupt or truncated file raises ``ValueError("corrupt or truncated
  checkpoint ...")``. Template leaves are tensors (``device="meta"`` ones
  allocate nothing) or anything with ``shape`` and ``dtype``; a restored
  leaf lands on its template's device (the CPU for a meta template).
- A leaf given to ``save`` as ``RowBlocks`` is written a block of rows
  at a time as its generator yields them, never whole; ``restore`` with
  ``rows`` reads only the selected part of each leaf, memory-mapped
  (``arrays.npz`` is stored uncompressed, as ``np.savez`` writes it).
"""
from __future__ import annotations

import os
import re
import shutil
import struct
import zipfile
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint import msgpack_meta


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def _storage_dtype(dtype) -> str:
    """What a template leaf of ``dtype`` is stored as: bfloat16 as
    float32, everything else as itself."""
    name = _dtype_name(dtype)
    return "float32" if name == "bfloat16" else name


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    return np.asarray(leaf)


class RowBlocks:
    """A leaf of ``shape`` and ``dtype`` whose rows ``blocks()`` yields in
    order, a block (tensor or array) at a time, for ``save`` to write as
    they come."""

    def __init__(self, shape, dtype, blocks: Callable):
        self.shape, self.dtype, self.blocks = tuple(shape), dtype, blocks


def _write_npz(path: str, leaves) -> None:
    """The file ``np.savez`` writes (members ``a<i>.npy``, stored
    uncompressed), a ``RowBlocks`` leaf streamed a block at a time."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, leaf in enumerate(leaves):
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                if not isinstance(leaf, RowBlocks):
                    np.lib.format.write_array(f, leaf, allow_pickle=False)
                    continue
                np.lib.format.write_array_header_1_0(f, {
                    "descr": np.lib.format.dtype_to_descr(
                        np.dtype(_storage_dtype(leaf.dtype))),
                    "fortran_order": False, "shape": leaf.shape})
                for block in leaf.blocks():
                    f.write(np.ascontiguousarray(_to_numpy(block)).tobytes())


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, step: int, obj: Any) -> str:
    """Write one checkpoint step atomically; returns the step directory."""
    path = step_dir(ckpt_dir, step)
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat, _ = tree.flatten_with_paths(obj)
    leaves = [(k, v if isinstance(v, RowBlocks) else _to_numpy(v))
              for k, v in flat]
    meta = {"keys": [k for k, _ in leaves],
            "dtypes": [_storage_dtype(a.dtype) if isinstance(a, RowBlocks)
                       else str(a.dtype) for _, a in leaves],
            "shapes": [list(a.shape) for _, a in leaves],
            "step": step}
    _write_npz(os.path.join(tmp, "arrays.npz"), [a for _, a in leaves])
    with open(os.path.join(tmp, "tree.msgpack"), "wb") as f:
        f.write(msgpack_meta.packb(meta))
    if os.path.isdir(path):        # overwrite an existing step in place
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def _memmap_members(npz_p: str, n: int) -> list:
    """Read-only memmaps of members ``a0.npy`` .. of an uncompressed
    npz: each member's data starts after its zip local header (30 bytes,
    the name, the extra field) and its npy header."""
    out = []
    with zipfile.ZipFile(npz_p) as zf, open(npz_p, "rb") as f:
        for i in range(n):
            info = zf.getinfo(f"a{i}.npy")
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"member a{i}.npy is compressed")
            f.seek(info.header_offset)
            head = f.read(30)
            name_len, extra_len = struct.unpack("<HH", head[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            if fortran:
                raise ValueError(f"member a{i}.npy is Fortran-ordered")
            if shape and 0 not in shape:
                out.append(np.memmap(npz_p, dtype=dtype, mode="r",
                                     offset=f.tell(), shape=shape))
            else:
                size = int(np.prod(shape)) * dtype.itemsize
                out.append(np.frombuffer(f.read(size), dtype).reshape(shape))
    return out


def _load_step(path: str, mmap: bool = False):
    """(meta, arrays) of one step dir (with ``mmap`` the arrays are
    read-only memmaps), or a ValueError that names the corrupt or
    truncated file and says how to recover."""
    meta_p = os.path.join(path, "tree.msgpack")
    npz_p = os.path.join(path, "arrays.npz")
    try:
        with open(meta_p, "rb") as f:
            meta = msgpack_meta.unpackb(f.read())
        if not isinstance(meta, dict) or "keys" not in meta:
            raise ValueError("meta is not a checkpoint dict")
    except Exception as e:
        raise ValueError(
            f"corrupt or truncated checkpoint meta {meta_p!r}: "
            f"{type(e).__name__}: {e}. Delete this step directory and "
            f"resume from an earlier step.") from e
    try:
        if mmap:
            arrays = _memmap_members(npz_p, len(meta["keys"]))
        else:
            with np.load(npz_p) as data:
                arrays = [data[f"a{i}"] for i in range(len(meta["keys"]))]
    except Exception as e:
        raise ValueError(
            f"corrupt or truncated checkpoint arrays {npz_p!r}: "
            f"{type(e).__name__}: {e}. Delete this step directory and "
            f"resume from an earlier step.") from e
    return meta, arrays


def _target_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, _dtype_name(dtype))


def restore(ckpt_dir: str, step: int, like: Any, rows=None) -> Any:
    """Restore into the structure of ``like`` (the shape and dtype
    template); every leaf comes back as a tensor. ``rows``, when given,
    is a list with an index per leaf (None: the whole leaf): each leaf
    is checked against the template whole, then only ``leaf[index]`` is
    read, from a memmap of the file."""
    path = step_dir(ckpt_dir, step)
    if not os.path.isdir(path):
        have = _steps(ckpt_dir)
        raise FileNotFoundError(
            f"no checkpoint step {step} under {ckpt_dir!r} "
            f"(available steps: {have or 'none'})")
    meta, arrays = _load_step(path, mmap=rows is not None)
    flat, treedef = tree.flatten(like)
    if len(flat) != len(arrays):
        raise ValueError(
            f"checkpoint {path!r} has {len(arrays)} leaves, template has "
            f"{len(flat)}; saved paths: {meta['keys'][:8]}... — was it "
            f"written by a differently-configured run?")
    restored: List[torch.Tensor] = []
    for i, (key, arr, leaf) in enumerate(zip(meta["keys"], arrays, flat)):
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {tuple(arr.shape)}, "
                f"template expects {tuple(leaf.shape)} — the run geometry "
                f"(D, U, arms, chunking) must match the saved sweep")
        want = _storage_dtype(leaf.dtype)
        if str(arr.dtype) != want:
            raise ValueError(
                f"checkpoint leaf {key!r} has dtype {arr.dtype}, template "
                f"expects {_dtype_name(leaf.dtype)} (stored as {want}) — "
                f"optimizer moments and round carries restore "
                f"dtype-strict; a silent cast would break bitwise resume. "
                f"Re-save the checkpoint with the template's dtypes or fix "
                f"the restore template.")
        if rows is not None and rows[i] is not None:
            arr = arr[rows[i]]
        dev = getattr(leaf, "device", None)
        dev = "cpu" if dev is None or dev.type == "meta" else dev
        restored.append(torch.from_numpy(np.array(arr, copy=True)).to(
            device=dev, dtype=_target_dtype(leaf.dtype)))
    return tree.unflatten(treedef, restored)


def _steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                  if (m := re.match(r"step_(\d+)$", d)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None
