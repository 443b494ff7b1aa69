"""The dry run: one card's share of each (architecture × input shape ×
mesh) on an H100 cluster, estimated without a card; port of
``repro/launch/dryrun.py``.

    python -m repro_torch.launch.dryrun --arch zamba2-7b --shape train_4k \\
        --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both [--agg mean]
    python -m repro_torch.launch.dryrun --arch whisper-base --variant opt

The reference compiles each combination for a forced 512-device host
and reads XLA's per-device analysis. The port runs **one rank's step of
its own program** on the meta device (shapes, no data, nothing
allocated) inside a ``torch.distributed`` "fake" process group the size
of ``launch.mesh.make_production_mesh`` (256 cards, 512 with
``multi``), so its collectives run and count as they would on rank 0
of that world. The program of each kind:

- **train**, ``--agg obcsaa``: the zoo-train round (``engine/zoo_train``),
  the port's path with the model axis across ranks: rank (0, 0) of the
  (W, 8) mesh, its worker's batch of ``global_batch / W`` sequences;
  ``"model_axis": "split"``.
- **train**, ``--agg mean``: ``launch.steps.make_train_step`` of rank
  (0, 0) of the (W, M) world, its worker's ``global_batch / W``
  sequences: with M > 1 the split step, on the rank's shares of the
  weights and the optimizer state, the layers'
  weights gathered over the model group, the gradient shares summed over
  the worker group (``"model_axis": "split"``, the parameter bytes the
  product rule over ``param_shardings``); with M = 1 every card a worker
  and the weights whole (``"replicated"``).
- **prefill**: the split prefill (``model.prefill(mesh=)``) of rank
  (0, 0) on the batch shard of the data axis (``global_batch / W``
  sequences), its share of the weights (``models/tensor_parallel.py``:
  heads, hidden columns, vocabulary rows over the model group, 1/M of
  every leaf ``param_shardings`` splits); ``"model_axis": "split"``.
- **decode**: the split ``model.decode_step(mesh=)`` of rank (0, 0)
  with the whole batch, its share of the weights and its block of every
  cache leaf as ``cache_shardings`` lays it out (``init_cache(mesh=)``:
  the K/V length or the MLA/SSM batch over the data group, KV heads,
  latent, channels and SSM heads over the model group);
  ``"model_axis": "split"``. ``long_500k`` is skipped for the
  full-attention archs, with the reference's reason.

Each result records:

- ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count
  of the step, which counts matmuls, convolutions and attention only
  (``"counts"``); XLA's ``flops`` counts every op.
- ``memory``: bytes per card of the parameters (the product rule over
  ``launch.steps.param_shardings``' specs where the program splits the
  model axis, which the serving share's bytes equal, the whole leaves
  where it does not), the zoo's master
  rows, the optimizer state, the batch and the cache (by
  ``cache_shardings``' split); ``step_peak``, the most bytes of tensors
  the step itself made that were alive at once (activations, saved
  tensors, gathered weights, gradients, temporaries: every storage an op
  returns, freed when its last reference goes, ``PeakBytes``); and
  ``total``, their sum. The allocator's rounding and workspaces are not
  counted.
- ``collectives``: bytes and calls by kind, from ``collectives.stats()``.
- ``param_count``: the parameters of the init.
- ``fits``: whether ``memory.total`` is under the card's memory: the
  first card's ``total_memory`` where there is one, else
  ``H100_80GB_BYTES``.

``--variant opt`` is the reference's: the decode rows of ``decode_32k``
and ``long_500k`` run the flash-decoding arithmetic in
``decode_sharded_chunks=16`` chunks, and the train rows use
``TrainConfig(cs_shard_aligned=True)``. Only the ``obcsaa`` train step
reads that, and on the production mesh (a model axis of 8) the
``obcsaa`` row is the zoo-train round and the ``mean`` row takes no
compression, so their opt rows are the baseline's. Its rows carry
``"variant"`` and what it changed in the row's program (``"changed"``)
and go to files suffixed ``__opt``; the baseline's rows and files are
as without the option.

Results are JSON under ``experiments/dryrun_torch/`` (``--force``
recomputes). No number in them is measured on a card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, TrainConfig,
                                 get_config)
from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import infer_param_specs, spec_bytes
from repro_torch.dist.shares import ModelAxis
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import (leave_world, make_production_mesh,
                                     num_workers, world_mesh)
from repro_torch.models.registry import build_model

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"

#: ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA
#: H100 80GB HBM3 (``chip_smoke.py`` prints it on the card)
H100_80GB_BYTES = 85_017_493_504

LONG_SKIP = ("full-attention arch: long_500k requires sub-quadratic "
             "attention (DESIGN.md §5)")


def card_bytes() -> int:
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return H100_80GB_BYTES


@contextlib.contextmanager
def fake_world(size: int):
    """Rank 0 of a "fake" process group of ``size`` ranks: collectives
    return at once and move nothing, but run through the port's own
    wrappers and their counters."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        leave_world()


class PeakBytes(TorchDispatchMode):
    """The most bytes of storages made under the mode that were alive at
    once. A storage counts from the op that returns it until its last
    reference (a view, autograd's saved tensors) goes; the storages of
    ``known`` tensors, made before, never count."""

    def __init__(self, known=()):
        super().__init__()
        self.live = self.peak = 0
        self.seen = weakref.WeakValueDictionary()
        for t in known:
            st = t.untyped_storage()
            self.seen[id(st)] = st

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree.leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if self.seen.get(id(st)) is st:
                continue
            self.seen[id(st)] = st
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)
        return out


def _bytes(x) -> int:
    return x.numel() * x.element_size()


def _meta_batch(model, shape, rows: int):
    """The model's inputs for ``rows`` sequences of ``shape``, as meta
    tensors."""
    from repro_torch.configs import InputShape
    specs = model.input_specs(InputShape(shape.name, shape.seq_len, rows,
                                         shape.kind))
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in specs.items()}


def _train_zoo(model, tcfg, mesh, shape):
    """One zoo-train round on rank (0, 0): its memory and the call."""
    from repro_torch.engine.zoo import ZooDraws
    W = num_workers(mesh)
    zr = steps_lib.make_zoo_train_round(
        model, tcfg, mesh, device="meta",
        compute_dtype=getattr(torch, tcfg.compute_dtype),
        phi=torch.empty((tcfg.cs_measure, tcfg.cs_chunk), device="meta"))
    state = zr.init_state(torch.empty((zr.n_local, zr.ob.chunk),
                                      device="meta"))
    rows = shape.global_batch // W
    batch = {k: v[None].expand((W,) + tuple(v.shape))
             for k, v in _meta_batch(model, shape, rows).items()}
    draws = ZooDraws(h=torch.ones((zr.U,), device="meta"),
                     z=torch.empty((zr.n_chunks, zr.ob.measure),
                                   device="meta"))
    specs = steps_lib.param_shardings(model, mesh)
    shapes = specs[1]
    pspecs = [_leaf(specs[0], keys) for keys, _ in
              tree.flatten_with_keys(shapes)]
    mem = {"params": spec_bytes(shapes, pspecs, mesh),
           "master": _bytes(state.master),
           "optimizer": sum(_bytes(x) for x in tree.leaves(state.opt))
           + (_bytes(state.residual) if state.residual is not None else 0),
           "batch": sum(_bytes(v) for v in batch.values()) // W,
           "cache": 0}

    def run():
        zr.round_train(state, batch, 0, 0, tcfg.noise_var, tcfg.p_max,
                       tcfg.learning_rate, draws=draws)

    info = {"model_axis": "split", "rows_per_card": rows,
            "zoo": {"n_chunks": zr.n_chunks, "n_half": zr.n_half,
                    "n_local": zr.n_local, "chunk": zr.ob.chunk}}
    known = tree.leaves(state) + list(batch.values()) + [*draws, zr.phi]
    return mem, run, info, known


def _leaf(t, keys):
    for k in keys:
        t = t[k]
    return t


def _train_mean(model, tcfg, mesh, shape):
    """``make_train_step`` on rank (0, 0): its memory and the call. With a
    model axis the split step on the rank's shares (``dist.shares``),
    their bytes the product rule over ``param_shardings``."""
    W = num_workers(mesh)
    shapes = model.init(0, device="meta")
    params = ModelAxis(shapes, mesh).shard_tree(shapes)
    opt_state = steps_lib.make_optimizer(tcfg).init(params)
    batch = _meta_batch(model, shape, shape.global_batch)
    step = steps_lib.make_train_step(model, tcfg, mesh)
    split = mesh.model_group is not None
    mem = {"params": (spec_bytes(shapes, infer_param_specs(shapes, mesh),
                                 mesh) if split else
                      sum(_bytes(x) for x in tree.leaves(params))),
           "master": 0,
           "optimizer": sum(_bytes(x) for x in tree.leaves(opt_state)),
           "batch": sum(_bytes(v) for v in batch.values()) // W,
           "cache": 0}

    def run():
        step(params, opt_state, batch, None)

    return mem, run, {"model_axis": "split" if split else "replicated",
                      "rows_per_card": shape.global_batch // W}, \
        tree.leaves(params) + tree.leaves(opt_state) + list(batch.values())


def _share(model, mesh):
    """Rank (0, 0)'s share of the weights for the split serving path, and
    its bytes: the product rule over ``param_shardings``."""
    from repro_torch.models.tensor_parallel import shard_params
    params = shard_params(model.init(0, device="meta"), model.cfg,
                          mesh.shape["model"], 0)
    return params, sum(_bytes(x) for x in tree.leaves(params))


def _prefill(model, mesh, shape):
    W = num_workers(mesh)
    rows = max(shape.global_batch // W, 1)
    params, nbytes = _share(model, mesh)
    batch = _meta_batch(model, shape, rows)
    mem = {"params": nbytes, "master": 0, "optimizer": 0,
           "batch": sum(_bytes(v) for v in batch.values()), "cache": 0}

    def run():
        model.prefill(params, batch, mesh=mesh)

    return mem, run, {"model_axis": "split", "rows_per_card": rows}, \
        tree.leaves(params) + list(batch.values())


def _decode(model, mesh, shape):
    params, nbytes = _share(model, mesh)
    B = shape.global_batch
    cache = model.init_cache(B, shape.seq_len, "meta", mesh=mesh)
    whole = model.init_cache(B, shape.seq_len, "meta")
    split = steps_lib.cache_shardings(whole, mesh)
    tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
    mem = {"params": nbytes, "master": 0, "optimizer": 0,
           "batch": _bytes(tokens),
           "cache": sum(_bytes(x) for x in cache.values())}

    def run():
        model.decode_step(params, cache, tokens, shape.seq_len - 1,
                          mesh=mesh)

    return mem, run, {"model_axis": "split", "rows_per_card": B,
                      "cache_split": {k: list(map(str, v)) for k, v in
                                      split.items()},
                      "cache_shapes": {k: list(v.shape) for k, v in
                                       cache.items()}}, \
        tree.leaves(params) + list(cache.values()) + [tokens]


def measure(cfg, shape, mesh_shape, axis_names, *, agg: str = "obcsaa",
            tcfg: TrainConfig = None) -> dict:
    """One rank's step of ``cfg`` at ``shape`` on a (W, M) world of the
    given mesh shape (worker axes flattened into W): memory, FLOPs,
    collectives. See the module docstring for each kind's program."""
    model = build_model(cfg)
    sizes = dict(zip(axis_names, mesh_shape))
    M = sizes.get("model", 1)
    world = math.prod(mesh_shape)
    tcfg = tcfg or TrainConfig(aggregation=agg)
    with fake_world(world):
        if shape.kind == "train" and agg == "obcsaa" and M > 1:
            built = _train_zoo(model, tcfg, world_mesh(M), shape)
        elif shape.kind == "train":
            built = _train_mean(model, tcfg, world_mesh(
                M if agg == "mean" else 1), shape)
        elif shape.kind == "prefill":
            built = _prefill(model, world_mesh(M), shape)
        else:
            built = _decode(model, world_mesh(M), shape)
        mem, run, info, known = built
        coll.reset_counters()
        counter = FlopCounterMode(display=False)
        peak = PeakBytes(known)
        t0 = time.perf_counter()
        with counter, peak:
            run()
        seconds = time.perf_counter() - t0
        stats = coll.stats()
    mem["step_peak"] = peak.peak
    mem["total"] = sum(mem.values())
    return {
        **info,
        "memory": mem,
        "cost": {"flops": counter.get_total_flops(),
                 "counts": "matmul, conv, sdpa"},
        "collectives": {"bytes": stats["bytes"], "calls": stats["calls"],
                        "total_bytes": sum(stats["bytes"].values())},
        "param_count": sum(x.numel() for x in
                           tree.leaves(model.init(0, device="meta"))),
        "card_bytes": card_bytes(),
        "fits": mem["total"] <= card_bytes(),
        "run_s": seconds,
    }


#: the shapes whose decode ``--variant opt`` runs as flash-decoding chunks
OPT_DECODE_SHAPES = ("decode_32k", "long_500k")


def variant_config(cfg, shape_name: str, agg: str, variant: str, M: int):
    """(cfg, tcfg, what the variant changed) of a combination on a mesh
    with a model axis of M: the reference's rule (``repro/launch/
    dryrun.py``'s ``lower_combo``). ``opt`` decodes ``decode_32k`` and
    ``long_500k`` in ``decode_sharded_chunks=16`` chunks and trains with
    ``cs_shard_aligned``; ``baseline`` changes nothing. What it changed
    lists only what the row's program reads: ``cs_shard_aligned`` is
    read by the ``obcsaa`` train step, which ``measure`` runs without a
    model axis, and neither by the zoo-train round (``obcsaa`` with one)
    nor by the ``mean`` step."""
    tcfg = TrainConfig(aggregation=agg)
    if variant == "baseline":
        return cfg, tcfg, {}
    if variant != "opt":
        raise ValueError(f"unknown variant {variant!r} (baseline | opt)")
    changed = {}
    if shape_name in OPT_DECODE_SHAPES:
        cfg = dataclasses.replace(cfg, decode_sharded_chunks=16)
        changed["decode_sharded_chunks"] = 16
    if INPUT_SHAPES[shape_name].kind == "train":
        tcfg = dataclasses.replace(tcfg, cs_shard_aligned=True)
        if agg == "obcsaa" and M <= 1:
            changed["cs_shard_aligned"] = True
    return cfg, tcfg, changed


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool,
                agg: str = "obcsaa", variant: str = "baseline") -> dict:
    """One combination's result. A ``variant`` other than ``baseline``
    records ``"variant"`` and what it changed (``"changed"``)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg, tcfg, changed = variant_config(
        get_config(arch), shape_name, agg, variant,
        mesh.shape.get("model", 1))
    shape = INPUT_SHAPES[shape_name]
    tag = {} if variant == "baseline" else {"variant": variant,
                                            "changed": changed}
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return {"status": "skipped", "reason": LONG_SKIP, **tag}
    res = measure(cfg, shape, mesh.axis_sizes, mesh.axis_names, agg=agg,
                  tcfg=tcfg)
    return {"status": "ok", **tag, "arch": arch, "shape": shape_name,
            "mesh": "x".join(map(str, mesh.axis_sizes)),
            "agg": agg if shape.kind == "train" else None,
            "n_devices": math.prod(mesh.axis_sizes), **res}


def combo_path(arch, shape_name, mesh_tag, agg,
               variant: str = "baseline") -> Path:
    suffix = "" if variant == "baseline" else f"__{variant}"
    return RESULTS_DIR / (f"{arch}__{shape_name}__{mesh_tag}__{agg}{suffix}"
                          ".json")


def run_combo(arch, shape_name, multi_pod, agg="obcsaa", force=False,
              variant: str = "baseline"):
    mesh_tag = "multi" if multi_pod else "single"
    path = combo_path(arch, shape_name, mesh_tag, agg, variant)
    if path.exists() and not force:
        return json.loads(path.read_text())
    try:
        res = lower_combo(arch, shape_name, multi_pod=multi_pod, agg=agg,
                          variant=variant)
    except Exception as e:
        res = {"status": "error", "arch": arch, "shape": shape_name,
               "mesh": mesh_tag, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-3000:]}
        if variant != "baseline":
            res["variant"] = variant
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(res, indent=1, default=str))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--agg", default="obcsaa", choices=["obcsaa", "mean"])
    ap.add_argument("--all", action="store_true",
                    help="every assigned arch (as without --arch)")
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "opt"],
                    help="opt: decode_32k and long_500k in 16 flash-"
                    "decoding chunks, train with cs_shard_aligned; results "
                    "in files suffixed __opt")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    bad = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = "multi" if mp else "single"
                res = run_combo(arch, shape, mp, args.agg, force=args.force,
                                variant=args.variant)
                status = res["status"]
                if status == "ok":
                    mem = res["memory"]
                    extra = (f"{res['run_s']:.1f}s flops="
                             f"{res['cost']['flops']:.3e} coll="
                             f"{res['collectives']['total_bytes']:.3e}B "
                             f"mem={mem['total'] / 2**30:.2f}GiB "
                             f"fits={res['fits']}")
                elif status == "error":
                    bad += 1
                    extra = res["error"][:160]
                else:
                    extra = res.get("reason", "")[:80]
                opt = "" if args.variant == "baseline" else \
                    f"{args.variant} "
                print(f"[{status:7s}] {arch:22s} {shape:12s} {tag:6s} "
                      f"{opt}{extra}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
