"""The trainer's and the zoo's mesh; port of ``repro/launch/mesh.py``.

A ``ZooMesh`` is axis names and sizes: the counterpart of the
``jax.sharding.AbstractMesh`` the reference's single-device oracles run
on. Its users read two things from it: how many FL workers there are (the
product of the worker axes ``pod`` and ``data``) and how many model
shards the parameters are laid out over (the ``model`` axis), which fixes
the zoo's chunk padding and, in ``dist/flat_layout.py``, its flat order.

Without a ``world`` every (worker, model-shard) cell of the mesh runs in
turn in one process, as the reference's oracle runs them in one program.
With one, every cell is a process: ``join_world(model_parallel=M)``
lays the W·M ranks ``torchrun`` starts out as the ``(W, M)`` mesh over
("data", "model"), rank r = d·M + m the cell (worker d, model shard m),
row-major as ``jax.make_mesh`` lays devices out. The mesh then carries
one group per axis: ``group``, the ranks of r's model column (the same
m: the FL workers, whose all-reduce is the MAC), ``model_group``, the
ranks of r's worker row (the same d: the model shards of one worker),
and ``world``. A group of one rank is None, which the collectives take
as the identity. The LM train step (``launch/steps.py``), the zoo
rounds (``engine/zoo.py``, ``engine/zoo_train.py``) and the split
serving path run over both.

``make_production_mesh`` is the H100 cluster spec ``launch/dryrun.py``
estimates one card of: its shape, no groups.

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

from repro_torch.dist import collectives as coll


@dataclass(frozen=True)
class ZooMesh:
    """Named axes and their sizes; ``shape`` maps name -> size in axis
    order, as a JAX mesh's does. Over processes: ``group`` is this
    rank's worker group (the ranks with its model shard), ``model_group``
    its model group (the ranks with its worker), ``world`` every rank;
    all None in one process."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    group: Optional[object] = field(default=None, compare=False, repr=False)
    model_group: Optional[object] = field(default=None, compare=False,
                                          repr=False)
    world: Optional[object] = field(default=None, compare=False,
                                    repr=False)

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

    def cell(self) -> Tuple[int, int]:
        """(worker d, model shard m) of this process: rank d·M + m of the
        world; (0, 0) in one process."""
        if self.world is None:
            return 0, 0
        M = self.shape.get("model", 1)
        r = dist.get_rank(self.world)
        return r // M, r % M


def local_device_count() -> int:
    """The cards this process sees (1 without one: the CPU)."""
    return max(torch.cuda.device_count(), 1) if torch.cuda.is_available() \
        else 1


def world_group():
    """The default process group when a world is initialised, else None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


_WORLD_MESHES: Dict[int, ZooMesh] = {}


def world_mesh(model_parallel: int = 1) -> ZooMesh:
    """The ``(W, M)`` mesh of the initialised world, M =
    ``model_parallel``, with its groups. Every rank must call it (with
    the same M): each creates every sub-group, in the same order, as
    ``dist.new_group`` requires; the mesh is kept per M."""
    world = dist.get_world_size()
    M = int(model_parallel)
    if M < 1 or world % M:
        raise ValueError(f"world_mesh: {world} ranks do not split into "
                         f"{M} model shards")
    if M in _WORLD_MESHES:
        return _WORLD_MESHES[M]
    W = world // M
    rank = dist.get_rank()
    d, m = rank // M, rank % M
    if M == 1:
        workers, model = dist.group.WORLD, None
    else:
        # every rank creates every group, the columns first, then the rows
        cols = [dist.new_group([w * M + j for w in range(W)])
                if W > 1 else None for j in range(M)]
        rows = [dist.new_group([w * M + j for j in range(M)])
                for w in range(W)]
        workers, model = cols[m], rows[d]
    mesh = ZooMesh(("data", "model"), (W, M), group=workers,
                   model_group=model, world=dist.group.WORLD)
    coll.name_group(workers, "data")
    coll.name_group(model, "model")
    _WORLD_MESHES[M] = mesh
    return mesh


def make_host_mesh(model_parallel: int = 1) -> ZooMesh:
    """(devices // model_parallel, model_parallel) over ("data", "model")
    for the devices present (the reference's CPU and example mesh). Under
    an initialised world every process is a device, as the reference
    counts every device of its job: the ``(world // M, M)`` mesh of
    ``world_mesh``."""
    if world_group() is not None:
        return world_mesh(model_parallel)
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


def make_production_mesh(*, multi_pod: bool = False) -> ZooMesh:
    """The H100 cluster the dry run (``launch/dryrun.py``) estimates one
    card of: 32 nodes of 8 cards, ``(32, 8)`` over ("data", "model"),
    256 cards; ``multi_pod`` two such clusters, ``(2, 32, 8)`` over
    ("pod", "data", "model"). The model axis is the 8 cards of one node,
    joined all to all by NVLink; the reference's TPU pod has a model axis
    of 16, which on H100s would span two nodes and put the layer
    resolver's gathers on the network. No process joins it here, so the
    mesh has no groups."""
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ZooMesh(axes, shape)


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


def join_world(device=None, *, model_parallel: int = 1,
               init_method: str = "env://"):
    """Join the world ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``; with ``env://`` also
    ``MASTER_ADDR`` and ``MASTER_PORT``). Rank r runs on
    ``cuda:(LOCAL_RANK % device_count)``, or on the CPU when ``device``
    is ``"cpu"``; without a card and without ``device="cpu"`` it raises.
    The backend is ``choose_backend``'s. Returns ``(mesh, device)``: the
    ``(world // model_parallel, model_parallel)`` mesh of ``world_mesh``
    over ("data", "model"), with its groups."""
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
    return world_mesh(model_parallel), dev


def leave_world() -> None:
    """Wait for every rank, then tear the world down."""
    if world_group() is not None:
        dist.barrier()
        dist.destroy_process_group()
    _WORLD_MESHES.clear()
