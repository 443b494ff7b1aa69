"""The trainer's and the zoo's mesh; port of ``repro/launch/mesh.py``.

A ``ZooMesh`` is axis names and sizes: the counterpart of the
``jax.sharding.AbstractMesh`` the reference's single-device oracles run
on. Its users read two things from it: how many FL workers there are (the
product of the worker axes ``pod`` and ``data``) and how many model
shards the parameters are laid out over (the ``model`` axis), which fixes
the zoo's chunk padding and, in ``dist/flat_layout.py``, its flat order.

Without a ``group`` every (worker, model-shard) cell of the mesh runs in
turn in one process, as the reference's oracle runs them in one program.
With one, the worker axes are the processes of that ``torch.distributed``
group, one FL worker each: ``join_world`` builds the ``(world, 1)`` mesh
of the world ``torchrun`` describes, and the LM train step
(``launch/steps.py``) runs its MAC as the group's all-reduce. The model
axis stays 1 across processes; the zoo's cells mapped onto processes are
ROADMAP.md Queue 1, item 5, and the TPU pod spec ``make_production_mesh``
waits for ``launch/dryrun.py`` (item 6).

Backend rule (``choose_backend``), decided before the world starts: NCCL
when every rank of the host has a card of its own, gloo when ranks share
a card or run on the CPU (NCCL refuses two ranks on one device). A
backend that fails to start raises; nothing switches backend.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class ZooMesh:
    """Named axes and their sizes; ``shape`` maps name -> size in axis
    order, as a JAX mesh's does. ``group``, when set, is the process
    group whose ranks are the mesh's workers."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    group: Optional[object] = field(default=None, compare=False, repr=False)

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


def world_group():
    """The default process group when a world is initialised, else None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def make_host_mesh(model_parallel: int = 1) -> ZooMesh:
    """(devices // model_parallel, model_parallel) over ("data", "model")
    for the devices present (the reference's CPU and example mesh). Under
    an initialised world the workers are the world's processes, one
    each, as the reference counts every device of its job: (world, 1)
    with the world's group."""
    group = world_group()
    if group is not None:
        if model_parallel != 1:
            raise ValueError("make_host_mesh: the model axis stays 1 across "
                             "processes (ROADMAP.md Queue 1, item 5)")
        return ZooMesh(("data", "model"), (dist.get_world_size(), 1),
                       group=group)
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


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when each of the host's ``local_world`` ranks has a card of
    its own; gloo when they share cards or run on the CPU."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def join_world(device=None, *, init_method: str = "env://"):
    """Join the world ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``; with ``env://`` also
    ``MASTER_ADDR`` and ``MASTER_PORT``). Rank r runs on
    ``cuda:(LOCAL_RANK % device_count)``, or on the CPU when ``device``
    is ``"cpu"``; without a card and without ``device="cpu"`` it raises.
    The backend is ``choose_backend``'s. Returns ``(mesh, device)``: the
    ``(world, 1)`` mesh over ("data", "model") with the world's group."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "join_world: no CUDA device is available; pass "
                "device='cpu' (the CLI's --device cpu) to run the ranks "
                "on the CPU")
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, local_world)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return ZooMesh(("data", "model"), (world, 1),
                   group=dist.group.WORLD), dev


def leave_world() -> None:
    """Wait for every rank, then tear the world down."""
    if world_group() is not None:
        dist.barrier()
        dist.destroy_process_group()
