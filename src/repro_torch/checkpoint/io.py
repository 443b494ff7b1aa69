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
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, List, Optional

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


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, step: int, obj: Any) -> str:
    """Write one checkpoint step atomically; returns the step directory."""
    path = step_dir(ckpt_dir, step)
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat, _ = tree.flatten_with_paths(obj)
    leaves = [(k, _to_numpy(v)) for k, v in flat]
    arrays = {f"a{i}": arr for i, (_, arr) in enumerate(leaves)}
    meta = {"keys": [k for k, _ in leaves],
            "dtypes": [str(a.dtype) for _, a in leaves],
            "shapes": [list(a.shape) for _, a in leaves],
            "step": step}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "tree.msgpack"), "wb") as f:
        f.write(msgpack_meta.packb(meta))
    if os.path.isdir(path):        # overwrite an existing step in place
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def _load_step(path: str):
    """(meta, arrays) of one step dir, or a ValueError that names the
    corrupt or truncated file and says how to recover."""
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


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like`` (the shape and dtype
    template); every leaf comes back as a tensor."""
    path = step_dir(ckpt_dir, step)
    if not os.path.isdir(path):
        have = _steps(ckpt_dir)
        raise FileNotFoundError(
            f"no checkpoint step {step} under {ckpt_dir!r} "
            f"(available steps: {have or 'none'})")
    meta, arrays = _load_step(path)
    flat, treedef = tree.flatten(like)
    if len(flat) != len(arrays):
        raise ValueError(
            f"checkpoint {path!r} has {len(arrays)} leaves, template has "
            f"{len(flat)}; saved paths: {meta['keys'][:8]}... — was it "
            f"written by a differently-configured run?")
    restored: List[torch.Tensor] = []
    for key, arr, leaf in zip(meta["keys"], arrays, flat):
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
