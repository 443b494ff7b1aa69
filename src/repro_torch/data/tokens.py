"""Memory-mapped token shards for the zoo-train data path; port of
``repro/data/tokens.py``, in the same files, so either package reads the
other's.

Layout: ``<dir>/tokens_meta.json`` (dtype + shard file names) beside
``shard_*.tokens`` flat little-endian token streams with no framing.
Alignment is checked on open: a file whose byte size is not a whole
number of tokens is truncated or was written with another dtype, and
fails loudly instead of shifting every later token.

Sampling is keyed like the round's draws: worker u's (B, S) batch of
round t depends only on (key, t, u), so a resume needs no iterator
state. The reference draws the shard indices and the offsets from
``fold_in(fold_in(key, t), u)``; the port does not replicate threefry,
so ``sample_worker`` takes those draws injected (``shard_idx``, ``u01``)
and otherwise draws them from a ``torch.Generator`` seeded by
(key, t, u). The offset is then the reference's: numpy's
``float32 × int64 → float64`` product, truncated, clipped to the span.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

META_NAME = "tokens_meta.json"


def _window_seed(key: int, t: int, u: int) -> int:
    """The generator seed of worker u's windows in round t."""
    from repro_torch.engine.zoo import round_seed
    return round_seed(round_seed(key, t), u)


class TokenShards:
    """Open memory-mapped token shards + deterministic batch sampling."""

    def __init__(self, directory: str, memmaps, dtype: np.dtype,
                 names: Sequence[str]):
        self.directory = directory
        self.memmaps = list(memmaps)
        self.dtype = dtype
        self.names = list(names)
        self.lengths = np.array([m.shape[0] for m in self.memmaps],
                                dtype=np.int64)

    # -- on-disk format ----------------------------------------------------

    @staticmethod
    def write(directory: str, shards, dtype=np.int32) -> str:
        """Write 1-D token arrays as flat binary shards + meta; returns
        the directory."""
        os.makedirs(directory, exist_ok=True)
        dtype = np.dtype(dtype)
        names = []
        for i, arr in enumerate(shards):
            a = np.ascontiguousarray(np.asarray(arr, dtype=dtype).ravel())
            name = f"shard_{i:05d}.tokens"
            a.tofile(os.path.join(directory, name))
            names.append(name)
        meta = {"dtype": dtype.name, "shards": names}
        with open(os.path.join(directory, META_NAME), "w") as f:
            json.dump(meta, f)
        return directory

    @classmethod
    def open(cls, directory: str) -> "TokenShards":
        """Memory-map every shard listed in the meta, checking token
        alignment."""
        meta_p = os.path.join(directory, META_NAME)
        if not os.path.isfile(meta_p):
            raise FileNotFoundError(
                f"{directory!r} has no {META_NAME}; --data expects a "
                f"token-shard directory written by TokenShards.write")
        with open(meta_p) as f:
            meta = json.load(f)
        dtype = np.dtype(meta["dtype"])
        mms = []
        for name in meta["shards"]:
            p = os.path.join(directory, name)
            if not os.path.isfile(p):
                raise FileNotFoundError(
                    f"token shard {name!r} listed in {META_NAME} is "
                    f"missing from {directory!r}")
            size = os.path.getsize(p)
            if size == 0 or size % dtype.itemsize:
                raise ValueError(
                    f"token shard {name!r} is misaligned: {size} bytes "
                    f"is not a whole positive number of {dtype.name} "
                    f"tokens (itemsize {dtype.itemsize}) — the file is "
                    f"truncated or was written with a different dtype; "
                    f"re-export the shard or fix 'dtype' in {META_NAME}")
            mms.append(np.memmap(p, dtype=dtype, mode="r"))
        return cls(directory, mms, dtype, meta["shards"])

    @property
    def total_tokens(self) -> int:
        return int(self.lengths.sum())

    # -- sampling ----------------------------------------------------------

    def _check_window(self, S: int):
        need = S + 1
        short = np.flatnonzero(self.lengths < need)
        if short.size:
            i = int(short[0])
            raise ValueError(
                f"token shard {self.names[i]!r} holds "
                f"{int(self.lengths[i])} tokens but seq_len={S} sampling "
                f"needs windows of {need}; drop the shard from "
                f"{META_NAME} or lower --seq")

    def sample_worker(self, key: int, t: int, u: int, B: int, S: int, *,
                      shard_idx: Optional[np.ndarray] = None,
                      u01: Optional[np.ndarray] = None):
        """Worker ``u``'s (B, S) next-token batch of round ``t`` as int32
        NumPy (tokens, targets). ``shard_idx`` (B,) ints in [0, n_shards)
        and ``u01`` (B,) f32 in [0, 1) replace the draws; each missing
        one comes from the generator of (key, t, u)."""
        self._check_window(S)
        n = len(self.memmaps)
        if shard_idx is None or u01 is None:
            gen = torch.Generator().manual_seed(_window_seed(key, t, u))
            draw_idx = torch.randint(0, n, (B,), generator=gen).numpy()
            draw_u01 = torch.rand((B,), generator=gen).numpy()
            shard_idx = draw_idx if shard_idx is None else shard_idx
            u01 = draw_u01 if u01 is None else u01
        sidx = np.asarray(shard_idx, np.int64)
        span = self.lengths[sidx] - (S + 1)
        u01 = np.asarray(u01, np.float32)
        offs = np.minimum((u01 * (span + 1)).astype(np.int64), span)
        rows = np.stack([
            np.asarray(self.memmaps[int(si)][int(off):int(off) + S + 1])
            for si, off in zip(sidx, offs)])
        rows = rows.astype(np.int32)
        return rows[:, :-1], rows[:, 1:]

    def sample_zoo_batch(self, key: int, t: int, U: int, B: int, S: int,
                         draws=None):
        """(U, B, S) stacked per-worker batch dict of round ``t`` (feed it
        through ``ZooTrainRound.shard_batch``). ``draws``: optional list of
        U (shard_idx, u01) pairs."""
        toks, tgts = zip(*(
            self.sample_worker(key, t, u, B, S,
                               **({} if draws is None else
                                  dict(shard_idx=draws[u][0],
                                       u01=draws[u][1])))
            for u in range(U)))
        return {"tokens": np.stack(toks), "targets": np.stack(tgts)}


def write_token_shards(directory: str, shards, dtype=np.int32) -> str:
    """Module-level alias of :meth:`TokenShards.write`."""
    return TokenShards.write(directory, shards, dtype=dtype)
