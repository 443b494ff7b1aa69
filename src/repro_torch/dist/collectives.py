"""Worker-group collectives, the over-the-air MAC primitives; port of
``repro/dist/collectives.py``.

The paper's analog superposition (eq. 8-12) is not modelled by a sum over
the workers, it is that sum: every worker transmits its power-scaled ±1
measurement symbols and the multiple-access channel adds them. In the
port the FL workers are the processes of a ``torch.distributed`` group,
and the MAC is the group's all-reduce. ``core.obcsaa.shardmap_*`` and the
train step (``launch/steps.py``) call through these wrappers.

The reference's axis argument becomes a worker group: a process group,
or None. None is the reference's "no worker axes", a one-worker
federation: ``psum`` is the identity, ``axis_index`` 0 and ``axis_size``
1, so the one-worker call sites run the same code.

Backends. NCCL takes CUDA tensors only; gloo takes CPU tensors, and on
CUDA tensors every collective here: PyTorch's table lists only
all-reduce and broadcast for gloo on the GPU, but its all-gather of CUDA
tensors ran and held on an H100 with ranks sharing the card
(``chip_smoke.py`` phase 13a checks it). Where a caller chooses the
device of what it hands to a collective (a sweep's records,
``engine/runner.py``), ``wire_device`` gives it: the CPU under gloo, the
run's card under NCCL. Nothing here retries a collective or switches
backend: a tensor the backend refuses raises.

``BYTES`` and ``CALLS`` count, by kind, what this process hands to the
collectives: a tensor's bytes for an all-reduce or a broadcast, the input
shard's bytes for an all-gather (``gather_tiled`` names its own kind:
the split train step's uplink counts its gathers apart). ``stats()``
adds each kind's time (CUDA events around the call for a CUDA tensor,
the host clock otherwise);
``by_group()`` the same bytes and calls split by the name a group was
given (``name_group``; ``launch.mesh.world_mesh`` names its "data" and
"model" groups); ``reset_counters()`` sets everything to 0.

A sweep's arms over the worker group (``engine/runner.py``) add
``gather_rows``, every rank's rows of a list of leaves of any dtypes in
one all-gather of their bytes, ``barrier`` and ``wire_device``.

The serving path's tensor parallelism (``models/tensor_parallel.py``)
adds two: ``psum_``, a forward-only sum in place (no copy, no autograd),
and ``argmax_split``, the greedy pick over a vocabulary whose columns
are split in equal blocks over the model group.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch
import torch.distributed as dist

from repro_torch.kernels.sign import unpack_bits

BYTES: Dict[str, int] = {}
CALLS: Dict[str, int] = {}
_HOST_MS: Dict[str, float] = {}
_EVENTS: List[tuple] = []
_BY_GROUP: Dict[tuple, List[int]] = {}
_GROUP_NAMES: Dict[object, str] = {}


def reset_counters() -> None:
    BYTES.clear()
    CALLS.clear()
    _HOST_MS.clear()
    _EVENTS.clear()
    _BY_GROUP.clear()


def name_group(group, name: str) -> None:
    """Count the collectives over ``group`` under ``name`` in
    ``by_group()``."""
    if group is not None:
        _GROUP_NAMES[group] = name


def by_group() -> Dict[str, Dict[str, dict]]:
    """{group name: {kind: {"bytes": .., "calls": ..}}} since the last
    ``reset_counters()``; a group without a name counts as "other"."""
    out: Dict[str, Dict[str, dict]] = {}
    for (name, kind), (nbytes, calls) in _BY_GROUP.items():
        out.setdefault(name, {})[kind] = {"bytes": nbytes, "calls": calls}
    return out


def stats() -> Dict[str, dict]:
    """{"bytes": .., "calls": .., "ms": ..} by kind since the last
    ``reset_counters()``; reading the CUDA events synchronises."""
    ms = dict(_HOST_MS)
    if _EVENTS:
        torch.cuda.synchronize()
    for kind, start, end in _EVENTS:
        ms[kind] = ms.get(kind, 0.0) + start.elapsed_time(end)
    return {"bytes": dict(BYTES), "calls": dict(CALLS), "ms": ms}


class _Count:
    """Counts one collective call of ``kind`` on ``x`` and times it."""

    def __init__(self, kind: str, x: torch.Tensor, group=None):
        self.kind, self.cuda = kind, x.is_cuda
        n = x.numel() * x.element_size()
        BYTES[kind] = BYTES.get(kind, 0) + n
        CALLS[kind] = CALLS.get(kind, 0) + 1
        tally = _BY_GROUP.setdefault((_GROUP_NAMES.get(group, "other"),
                                      kind), [0, 0])
        tally[0] += n
        tally[1] += 1

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _EVENTS.append((self.kind, self.start, end))
        else:
            _HOST_MS[self.kind] = (_HOST_MS.get(self.kind, 0.0)
                                   + 1e3 * (time.perf_counter() - self.t0))
        return False


def axis_index(group) -> int:
    """This worker's rank in the group (0 without one)."""
    return 0 if group is None else dist.get_rank(group)


def axis_size(group) -> int:
    """The group's worker count (1 without one)."""
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over the group in place; ``x`` must be contiguous."""
    with _Count("all_reduce", x, group):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def psum_(x: torch.Tensor, group) -> torch.Tensor:
    """Forward-only sum over the group, in place when ``x`` is
    contiguous (a copy is summed otherwise): the reduction after a
    row-split product, whose partial sum nothing else reads. No autograd;
    no group: ``x``."""
    if group is None:
        return x
    return _all_reduce_(x if x.is_contiguous() else x.contiguous(), group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the workers: the MAC superposition (eq. 12). Returns a
    new tensor; ``x`` is left as it was."""
    if group is None:
        return x
    return _all_reduce_(x.clone(memory_format=torch.contiguous_format),
                        group)


def psum_bits_mac(packed: torch.Tensor, group, *, beta_i=None
                  ) -> torch.Tensor:
    """MAC superposition of PACKED 1-bit symbols (eq. 12).

    ``packed``: int32 words (..., S//32) holding uint32 bit patterns, 32
    signs each (``kernels/sign.py``). Each worker's lane contributes
    β·(2·bit − 1) ∈ {−1, 0, +1}, summed EXACTLY as int32 over the group:
    integer superposition has no f32 rounding. Returns the int32 lane sums
    (..., S); the caller applies the worker-uniform K·b_t scale after the
    sum (per-worker weights need the f32 wire)."""
    contrib = 2 * unpack_bits(packed, torch.int32) - 1
    if beta_i is not None:
        contrib = contrib * torch.as_tensor(beta_i, device=contrib.device
                                            ).to(torch.int32)
    if group is None:
        return contrib
    return _all_reduce_(contrib.contiguous(), group)


def shard_slice(x: torch.Tensor, group, *, axis: int = 0) -> torch.Tensor:
    """This worker's equal block of a replicated tensor, the dual of
    ``all_gather(tiled=True)``: rows ``[idx·n, (idx+1)·n)`` along
    ``axis``, ``n = shape[axis] // axis_size(group)``. No group: the
    whole tensor. No communication."""
    if group is None:
        return x
    n = x.shape[axis] // axis_size(group)
    return x.narrow(axis, axis_index(group) * n, n)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the workers (``lax.pmax``): the length-split
    decode's global softmax max. Returns a new tensor."""
    if group is None:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    with _Count("all_reduce_max", y, group):
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    return psum(x, group) / axis_size(group)


def broadcast(x: torch.Tensor, group, *, src: int = 0) -> torch.Tensor:
    """``x`` from the worker of rank ``src`` in the group to every
    worker, in place (the PS's downlink of the decoded gradient)."""
    if group is None:
        return x
    with _Count("broadcast", x, group):
        dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    return x


def replicated(tensors, group) -> bool:
    """Whether every rank of the group holds the same ``tensors``, bit
    for bit: rank 0's are broadcast and compared byte for byte on each
    rank, and the ranks' verdicts are summed."""
    if group is None:
        return True
    differ = 0
    for x in tensors:
        x = x.detach().contiguous().reshape(-1)
        ref = broadcast(x.clone(), group)
        differ += int(not torch.equal(ref.view(torch.uint8),
                                      x.view(torch.uint8)))
    flag = torch.tensor([differ], dtype=torch.int32,
                        device=tensors[0].device)
    return int(_all_reduce_(flag, group)) == 0


def wire_device(group, device) -> torch.device:
    """The device on which the group's backend takes the tensors that a
    caller stages for it: the CPU under gloo; ``device``, the run's
    device (its card), under NCCL and any other backend; ``device``
    without a group. The backend is ``dist.get_backend(group)``'s."""
    if group is not None and dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return torch.device(device)


def _gather(x: torch.Tensor, group, kind: str = "all_gather"
            ) -> List[torch.Tensor]:
    """Every worker's ``x``, in rank order, counted as ``kind``. bfloat16
    travels as its bytes (a gather copies, so the bits are the value;
    gloo takes no bfloat16)."""
    x = x.contiguous()
    wire = x.view(torch.uint8) if x.dtype == torch.bfloat16 else x
    out = [torch.empty_like(wire) for _ in range(axis_size(group))]
    with _Count(kind, x, group):
        dist.all_gather(out, wire, group=group)
    return [o.view(x.dtype) for o in out]


def barrier(group) -> None:
    """Wait for every rank of the group (no group: return)."""
    if group is not None:
        dist.barrier(group=group)


def gather_rows(leaves, group, *, kind: str = "all_gather_rows") -> list:
    """Each leaf (n, ...), n ≥ 1, of every rank of the group concatenated along
    dim 0 in rank order, (n·R, ...): the leaves' bytes travel in one
    all-gather, so their dtypes may differ (complex, uint8, bool) and
    the bits come back as they were. Every rank must pass leaves of the
    same shapes and dtypes, on one device that the group's backend takes
    (``wire_device``: the card under NCCL, which refuses CPU tensors; the
    CPU or the card under gloo); the rows come back on that device. No
    group: the leaves."""
    leaves = [x.contiguous() for x in leaves]
    if group is None or not leaves:
        return leaves
    parts = [x.reshape(-1).view(torch.uint8) for x in leaves]
    every = _gather(torch.cat(parts), group, kind)
    out, off = [], 0
    for x, p in zip(leaves, parts):
        n = p.numel()
        # a copy: a slice at an odd byte offset cannot be viewed as x's type
        out.append(torch.cat([b[off:off + n].clone().view(x.dtype)
                              .reshape(x.shape) for b in every]))
        off += n
    return out


def argmax_split(x: torch.Tensor, group) -> torch.Tensor:
    """``torch.argmax`` over the last dim of rows whose columns are split
    in equal blocks over the group (rank r holds columns [r·n, (r+1)·n)):
    the index in the whole row, ties to the lowest, on every rank. Each
    rank's (max, global index) pair travels as two float64s, which hold
    both exactly: one all-gather. No group: ``torch.argmax``."""
    if group is None:
        return torch.argmax(x, dim=-1)
    n = x.shape[-1]
    idx = torch.argmax(x, dim=-1, keepdim=True)
    pair = torch.cat([torch.gather(x, -1, idx).to(torch.float64),
                      (idx + axis_index(group) * n).to(torch.float64)], -1)
    every = torch.stack(_gather(pair, group))          # (R, ..., 2)
    # the first rank holding the max holds its lowest index
    best = torch.argmax(every[..., 0], dim=0, keepdim=True)
    return torch.gather(every[..., 1], 0, best)[0].to(torch.int64)


def _join(parts, axis: int, tiled: bool) -> torch.Tensor:
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


class _AllGather(torch.autograd.Function):
    """All-gather whose backward is the sum over the workers of the
    cotangent, sliced to this worker's block (the transpose of a
    gather: every worker's loss may depend on every worker's input)."""

    @staticmethod
    def forward(ctx, x, group, axis, tiled):
        ctx.group, ctx.axis, ctx.tiled = group, axis, tiled
        ctx.n = x.shape[axis]
        return _join(_gather(x, group), axis, tiled)

    @staticmethod
    def backward(ctx, g):
        g = psum(g.contiguous(), ctx.group)
        idx = axis_index(ctx.group)
        if ctx.tiled:
            return g.narrow(ctx.axis, idx * ctx.n, ctx.n), None, None, None
        return g.select(ctx.axis, idx), None, None, None


def all_gather(x: torch.Tensor, group, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Gather per-worker values along ``axis`` (stacked, or concatenated
    with ``tiled``); differentiable, its backward as the reference's
    transpose: the summed cotangent's block of this worker."""
    if group is None:
        return x if tiled else x.unsqueeze(axis)
    return _AllGather.apply(x, group, axis, tiled)


def gather_tiled(x: torch.Tensor, group, *, axis: int = 0,
                 kind: str = "all_gather") -> torch.Tensor:
    """The group's blocks of a tensor concatenated along ``axis``,
    counted as ``kind`` (no autograd); no group: ``x``."""
    if group is None:
        return x
    return torch.cat(_gather(x, group, kind), axis)


class _ReplicatedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, group_size, dim):
        ctx.group, ctx.dim, ctx.group_size = group, dim, group_size
        return torch.cat(_gather(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.group_size
        return (g.narrow(ctx.dim, axis_index(ctx.group) * n, n).contiguous(),
                None, None, None)


def replicated_gather(group, group_size: int, *, dim: int = 0
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """All-gather whose backward is this worker's LOCAL slice of the
    cotangent: every worker of the group runs the same forward on the
    same batch, so their cotangents are identical replicas and the exact
    adjoint is a slice; a summing backward would scale the gradient by
    the group size. Returns ``gather(x)``, a tiled all-gather along
    ``dim``; no group: the identity."""
    if group is None:
        return lambda x: x

    def gather(x):
        return _ReplicatedGather.apply(x, group, group_size, dim)

    return gather
