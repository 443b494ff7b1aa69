"""The zoo's logical mesh; port of ``repro/launch/mesh.py``.

A ``ZooMesh`` is axis names and sizes and no devices: the counterpart of
the ``jax.sharding.AbstractMesh`` the reference's single-device oracles
run on. The zoo (``engine/zoo.py``, ``engine/zoo_train.py``) reads two
things from it: how many FL workers there are (the product of the worker
axes ``pod`` and ``data``) and how many model shards the parameters are
laid out over (the ``model`` axis), which fixes the chunk padding and, in
``dist/flat_layout.py``, the flat order. On one card every (worker,
model-shard) cell of the mesh runs in turn on that card, as the
reference's oracle runs them in one program. Mapping the cells onto
processes is ``dist/collectives`` (ROADMAP.md Queue 1, item 5), and the
TPU pod spec ``make_production_mesh`` waits for ``launch/dryrun.py``
(item 6).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class ZooMesh:
    """Named axes and their sizes; ``shape`` maps name -> size in axis
    order, as a JAX mesh's does."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"ZooMesh: {len(self.axis_names)} axis names "
                             f"for {len(self.axis_sizes)} sizes")
        if any(int(n) < 1 for n in self.axis_sizes):
            raise ValueError(f"ZooMesh: axis sizes must be positive; got "
                             f"{self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, (int(n) for n in self.axis_sizes)))


def local_device_count() -> int:
    """The cards this process sees (1 without one: the CPU)."""
    return max(torch.cuda.device_count(), 1) if torch.cuda.is_available() \
        else 1


def make_host_mesh(model_parallel: int = 1) -> ZooMesh:
    """(devices // model_parallel, model_parallel) over ("data", "model")
    for the devices present (the reference's CPU and example mesh)."""
    n = local_device_count()
    if n % model_parallel:
        raise ValueError(f"make_host_mesh: {n} devices do not split into "
                         f"{model_parallel} model shards")
    return ZooMesh(("data", "model"), (n // model_parallel, model_parallel))


def make_zoo_mesh(n_workers: int = 0, model_parallel: int = 0) -> ZooMesh:
    """(n_workers, model_parallel) over ("data", "model"). Zeros pick the
    reference's defaults for the devices present (model parallelism 2
    when the count is even and above 1, every device used): one card
    gives 1 x 1. Explicit sizes build a logical mesh of that shape whose
    cells run in turn; ``make_zoo_mesh(4, 2)`` is the geometry of
    ``benchmarks/zoo_bench.py``."""
    n = local_device_count()
    if not model_parallel:
        model_parallel = 2 if n % 2 == 0 and n > 1 else 1
    if not n_workers:
        n_workers = max(n // model_parallel, 1)
    return ZooMesh(("data", "model"), (int(n_workers), int(model_parallel)))


def worker_axes(mesh) -> tuple:
    """Mesh axes that enumerate FL workers."""
    return tuple(ax for ax in ("pod", "data") if ax in mesh.axis_names)


def num_workers(mesh) -> int:
    n = 1
    for ax in worker_axes(mesh):
        n *= mesh.shape[ax]
    return n
