"""MNIST loader: real IDX files if present under $MNIST_DIR, else the
deterministic synthetic substitute. A copy of the NumPy code of
``repro/data/mnist.py``: the same files or seed give the same arrays."""
from __future__ import annotations

import gzip
import os
import struct
from typing import Tuple

import numpy as np

from repro_torch.data.synthetic import synthetic_mnist


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">HBB", f.read(4))
        _, dtype_code, ndim = magic
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def load_mnist(mnist_dir: str = None) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray, np.ndarray]:
    """Returns (x_train (60000,784) float [0,1], y_train, x_test, y_test)."""
    mnist_dir = mnist_dir or os.environ.get("MNIST_DIR", "")
    names = [("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
             ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")]
    if mnist_dir and os.path.isdir(mnist_dir):
        found = []
        for img_n, lbl_n in names:
            for suffix in ("", ".gz"):
                ip = os.path.join(mnist_dir, img_n + suffix)
                lp = os.path.join(mnist_dir, lbl_n + suffix)
                if os.path.exists(ip) and os.path.exists(lp):
                    found.append((ip, lp))
                    break
        if len(found) == 2:
            (ti, tl), (vi, vl) = found
            xtr = _read_idx(ti).reshape(-1, 784).astype(np.float32) / 255.0
            ytr = _read_idx(tl).astype(np.int32)
            xte = _read_idx(vi).reshape(-1, 784).astype(np.float32) / 255.0
            yte = _read_idx(vl).astype(np.int32)
            return xtr, ytr, xte, yte
    return synthetic_mnist()


def partition_workers(x: np.ndarray, y: np.ndarray, n_workers: int,
                      samples_per_worker: int, *, iid: bool = True,
                      seed: int = 0):
    """Paper §V: randomly select K̄ distinct samples per worker.

    iid=False gives a label-skewed (2-class-dominant) non-iid split."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    if iid:
        for _ in range(n_workers):
            idx = rng.choice(len(x), samples_per_worker, replace=False)
            xs.append(x[idx])
            ys.append(y[idx])
    else:
        for w in range(n_workers):
            major = (2 * w) % 10, (2 * w + 1) % 10
            p = np.where(np.isin(y, major), 8.0, 1.0)
            p = p / p.sum()
            idx = rng.choice(len(x), samples_per_worker, replace=False, p=p)
            xs.append(x[idx])
            ys.append(y[idx])
    return np.stack(xs), np.stack(ys)   # (U, K̄, 784), (U, K̄)
