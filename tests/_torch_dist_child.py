"""One rank of the port's multi-process CPU tests
(``tests/test_torch_collectives.py``, ``tests/test_torch_workers.py``,
``tests/test_torch_zoo_procs.py``, ``tests/test_torch_shardings.py``,
``tests/test_torch_dryrun.py``, ``tests/test_torch_serve_model_axis.py``,
``tests/test_torch_train_model_axis.py``, ``tests/test_torch_sweep_procs.py``).
It imports torch and ``repro_torch``
only, never JAX: the tests compute the reference's oracles in their own
process.

    python tests/_torch_dist_child.py CASE DIR RANK WORLD [DEVICE [M]]

joins a world of WORLD ranks on DEVICE ("cpu", the default, or "cuda":
the ranks share the card over gloo, a world of one runs over NCCL)
through a file store in DIR, as the (WORLD / M, M) mesh (M = 1 by
default), runs CASE on ``DIR/inputs.pt`` (written by ``run_world``) and
writes ``DIR/out_RANK.pt``, on the CPU.
The case ``zoo_cli`` joins no world itself: it runs the trainer's CLI,
which joins and leaves its own.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def run_world(case: str, world: int, inputs: dict, tmp_dir,
              timeout: float = 240.0, device: str = "cpu",
              model_parallel: int = 1) -> list:
    """Start WORLD ranks of CASE on ``inputs`` and return their outputs
    in rank order; a rank that exits non-zero fails the caller."""
    tmp_dir = str(tmp_dir)
    torch.save(inputs, os.path.join(tmp_dir, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, tmp_dir, str(r),
         str(world), device, str(model_parallel)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode]
    if bad:
        raise AssertionError(f"ranks failed: {bad}")
    return [torch.load(os.path.join(tmp_dir, f"out_{r}.pt"))
            for r in range(world)]


# --- cases ---------------------------------------------------------------

def collectives(inp, mesh, dev):
    from repro_torch.dist import collectives as coll
    g = mesh.group
    r, n = coll.axis_index(g), coll.axis_size(g)
    out = {"index": r, "size": n}
    coll.reset_counters()
    out["bits"] = coll.psum_bits_mac(inp["words"][r], g,
                                     beta_i=inp["beta"][r])
    x = inp["x"][r]
    out["psum"], out["pmean"] = coll.psum(x, g), coll.pmean(x, g)
    out["x_after"] = x
    out["stacked"] = coll.all_gather(x, g)
    out["tiled"] = coll.all_gather(x, g, axis=1, tiled=True)
    out["slice"] = coll.shard_slice(inp["rows"], g)
    # backward of the gather: d/dx of Σ w_r ⊙ gather(x) on every rank
    xg = x.clone().requires_grad_()
    torch.sum(inp["w"][r] * coll.all_gather(xg, g, axis=1, tiled=True)
              ).backward()
    out["gather_grad"] = xg.grad
    # the replicated gather's backward is this rank's slice, unscaled
    shard = inp["shard"][r].clone().requires_grad_()
    full = coll.replicated_gather(g, n, dim=0)(shard)
    torch.sum(inp["cot"] * full).backward()
    out["rep_full"], out["rep_grad"] = full.detach(), shard.grad
    out["stats"] = coll.stats()
    out["replicated_same"] = coll.replicated([inp["x"][0]], g)
    out["replicated_differ"] = coll.replicated([x], g)
    out["bcast"] = coll.broadcast(x.clone(), g, src=n - 1)
    return out


def aggregate(inp, mesh, dev):
    from repro_torch.core import obcsaa as tob
    from repro_torch.dist import collectives as coll
    g = mesh.group
    r = coll.axis_index(g)
    return {name: tob.shardmap_aggregate(
        tob.OBCSAAConfig(**kw), inp["grads"][r], g, k_weight=1.0,
        beta_i=inp["beta"][r], b_t=inp["b_t"], phi=inp["phi"],
        noise=inp["noise"]) for name, kw in inp["cfgs"].items()}


def _to(x, dev):
    from repro_torch import tree
    return tree.tree_map(lambda a: a.to(dev), x)


def train(inp, mesh, dev):
    from repro_torch import configs, tree
    from repro_torch.dist import collectives as coll
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    out = {}
    for name, case in inp["cases"].items():
        cfg = configs.scaled(configs.get_smoke_config(case["arch"]),
                             dtype="float32")
        model = build_model(cfg)
        tcfg = configs.TrainConfig(aggregation=case["agg"], **inp["cs"])
        step = steps.make_train_step(model, tcfg, mesh)
        params = _to(case["params"], dev)
        batch = _to(case["batch"], dev)
        opt_state = steps.make_optimizer(tcfg).init(params)
        decoded, losses = [], []
        coll.reset_counters()
        for ctx in case["ctxs"]:
            got = {}
            ctx = dict(_to(ctx, dev),
                       hook=lambda stage, i, grad, dec, got=got:
                       got.__setitem__(i, dec.to("cpu", copy=True))
                       if stage == "decode" else None)
            params, opt_state, m = step(params, opt_state, batch, ctx)
            decoded.append([got[i] for i in sorted(got)])
            losses.append(float(m["loss"]))
        out[name] = {"params": [p.cpu() for p in tree.leaves(params)],
                     "decoded": decoded,
                     "losses": losses, "bytes": coll.stats()["bytes"]}
    return out


def train_split(inp, mesh, dev):
    """The train step with the model axis split over the (W, M) world
    (``make_train_step`` on its model group) for each case, from this rank's shares
    of the whole ``params``: the shares after each step, each step's
    decoded leaves (the whole ĝ, from the hook), loss and collectives'
    bytes by kind. With ``m1``, the same steps at M = 1 over
    this rank's worker group (W workers, whole weights), run by every
    model column at once. The whole parameters after the steps, gathered
    from the shares (``whole_tree``). With ``ckpt``: the split carry saved after the
    steps (rank 0 writing the whole leaves), each rank's restore of it
    against its shares, and the M = 1 carry saved by world rank 0 and
    restored by every rank as its shares."""
    from repro_torch import configs, tree
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.shares import shard_tree, whole_tree
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import ZooMesh
    from repro_torch.models.registry import build_model
    import torch.distributed as dist
    W = mesh.shape["data"]
    column = ZooMesh(("data", "model"), (W, 1), group=mesh.group,
                     world=mesh.group)

    def run(model, tcfg, m, params, case):
        step = steps.make_train_step(model, tcfg, m)
        opt_state = steps.make_optimizer(tcfg).init(params)
        res = {"params": [], "decoded": [], "losses": [], "bytes": []}
        for ctx in case["ctxs"]:
            coll.reset_counters()
            got = {}
            ctx = dict(_to(ctx, dev),
                       hook=lambda stage, i, grad, dec, got=got:
                       got.__setitem__(i, dec.to("cpu", copy=True))
                       if stage == "decode" else None)
            params, opt_state, met = step(params, opt_state,
                                          _to(case["batch"], dev), ctx)
            res["params"].append([p.cpu().clone()
                                  for p in tree.leaves(params)])
            res["decoded"].append([got[i] for i in sorted(got)])
            res["losses"].append(float(met["loss"]))
            res["bytes"].append(coll.stats()["bytes"])
        res["opt"] = [x.cpu().clone() for x in tree.leaves(opt_state)]
        return res, params, opt_state

    out = {}
    for name, case in inp["cases"].items():
        cfg = configs.scaled(configs.get_smoke_config(case["arch"]),
                             dtype="float32")
        model = build_model(cfg)
        tcfg = configs.TrainConfig(aggregation=case["agg"],
                                   optimizer=case.get("opt", "sgd"),
                                   cs_shard_aligned=case.get("aligned",
                                                             False),
                                   **inp["cs"])
        whole = _to(case["params"], dev)
        res, params, opt_state = run(model, tcfg, mesh,
                                     shard_tree(whole, mesh), case)
        res["whole"] = [x.cpu() for x in
                        tree.leaves(whole_tree(params, model, mesh))]
        if case.get("m1"):
            res["m1"], wp, wo = run(model, tcfg, column, whole, case)
        if case.get("ckpt"):
            ck = os.path.join(inp["dir"], name)
            steps.save_train_state(os.path.join(ck, "m2"), 2, params,
                                   opt_state, model=model, tcfg=tcfg,
                                   mesh=mesh)
            if dist.get_rank() == 0:
                steps.save_train_state(os.path.join(ck, "m1"), 2, wp, wo)
            dist.barrier()
            got = steps.restore_train_state(os.path.join(ck, "m2"), model,
                                            tcfg, dev, mesh=mesh)
            res["restored_m2"] = got[2] == 2 and all(torch.equal(a, b) for
                                                     a, b in zip(
                tree.leaves((got[0], got[1])),
                tree.leaves((params, opt_state))))
            got = steps.restore_train_state(os.path.join(ck, "m1"), model,
                                            tcfg, dev, mesh=mesh)
            want = shard_tree({"params": wp, "opt_state": wo}, mesh)
            res["restored_m1"] = all(torch.equal(a, b) for a, b in zip(
                tree.leaves((got[0], got[1])),
                tree.leaves((want["params"], want["opt_state"]))))
        out[name] = res
    return out


def _stats(st) -> dict:
    """A round's stats as plain numbers (the parent loads weights only)."""
    out = {k: float(getattr(st, k)) for k in ("b_t", "ghat_norm")}
    out["n_scheduled"] = int(st.n_scheduled)
    out["budget"] = [float(x) for x in st.budget]
    if hasattr(st, "loss"):
        out["loss"] = float(st.loss)
    return out


def zoo(inp, mesh, dev):
    """Surrogate rounds of ``ZooRound`` from the whole chunked
    parameters, each round's draws injected: this rank's rows, the MAC
    sums of its half, the stats and the collectives' bytes; then a round
    on the given (U, n_chunks, D_c) gradients."""
    from repro_torch.core.obcsaa import OBCSAAConfig
    from repro_torch.dist import collectives as coll
    from repro_torch.engine import zoo as tzoo
    zr = tzoo.build_zoo_round(OBCSAAConfig(**inp["ob"]), inp["D"], mesh,
                              device=dev, phi=inp["phi"],
                              scheduler=inp["scheduler"])
    p = zr.shard_params(inp["params"])
    out = {"cell": zr.cell, "rows": [], "mac": [], "stats": []}
    coll.reset_counters()
    for t, dr in enumerate(inp["draws"]):
        seen = {}
        _, st = zr.round_gen(p, t, 0, *inp["args"], draws=tzoo.ZooDraws(
            *dr), hook=lambda stage, **i: seen.update(i)
            if stage == "mac" else None)
        out["rows"].append(p.clone())
        out["mac"].append((seen["y_sum"].clone(), seen["mag_sum"].clone()))
        out["stats"].append(_stats(st))
    out["bytes"] = coll.stats()["bytes"]
    zr.round_from_grads(p, inp["grads"], 2, 0, *inp["args"],
                        draws=tzoo.ZooDraws(*inp["draws"][0]))
    out["from_grads"] = p.clone()
    return out


def _zoo_train_round(case, mesh, dev):
    from repro_torch import configs
    from repro_torch.core.obcsaa import OBCSAAConfig
    from repro_torch.engine import zoo_train as tzt
    from repro_torch.models.registry import build_model
    cfg = configs.scaled(configs.get_smoke_config(case["arch"]),
                         dtype="float32")
    return tzt.build_zoo_train_round(
        build_model(cfg), mesh, OBCSAAConfig(**case["ob"]),
        compute_dtype=torch.float32, device=dev, phi=case["phi"],
        optimizer=case["opt"], error_feedback=case["ef"])


def zoo_train(inp, mesh, dev):
    """Rounds of ``ZooTrainRound`` for each case from a whole carry,
    draws injected: this rank's gradient block and loss before them, its
    carry after each round, the stats, the collectives' bytes of a
    round; then the carry saved by the ranks and restored by them."""
    from repro_torch import tree
    from repro_torch.dist import collectives as coll
    from repro_torch.engine import zoo as tzoo
    from repro_torch.engine import zoo_train as tzt
    out = {}
    for name, case in inp["cases"].items():
        zr = _zoo_train_round(case, mesh, dev)
        state = zr.local_state(tzt.ZooTrainState(*case["state"]))
        res = {"states": [], "stats": [], "bytes": [],
               "grads": zr.grads_in_layout(state, case["batch"])}
        for t, dr in enumerate(case["draws"]):
            coll.reset_counters()
            state, st = zr.round_train(state, case["batch"], t, 0,
                                       *inp["args"],
                                       draws=tzoo.ZooDraws(*dr))
            res["bytes"].append(coll.stats()["bytes"])
            res["states"].append(tuple(tree.tree_map(torch.clone, state)))
            res["stats"].append(_stats(st))
        ck = os.path.join(inp["dir"], name)
        res["path"] = zr.save_state(ck, 2, state, t_next=2)
        got, t_next = zr.restore_state(ck)
        res["restored_equal"] = t_next == 2 and all(
            torch.equal(a, b) for a, b in zip(tree.leaves(got),
                                              tree.leaves(state)))
        out[name] = res
    return out


def zoo_sweep(inp, mesh, dev):
    """``ZooTrainRound.run_sweep`` on this rank's rows of the arm-stacked
    carry of ``inp["masters"]`` (A, n_chunks, D_c), each round's draws
    injected: the carry after the sweep, the stats of every round and
    arm; then the carry saved by the ranks (rank 0 writing it) and
    restored by each (``arms=A``) against its own; then the messages with
    which ``run_sweep`` refuses a carry a row short in its master and in
    its residual."""
    from repro_torch import tree
    from repro_torch.engine import zoo as tzoo
    case = inp["case"]
    zr = _zoo_train_round(case, mesh, dev)
    states = zr.init_sweep_state(inp["masters"])
    states, st = zr.run_sweep(
        states, case["batch"], inp["arms"], len(case["draws"]), key=0,
        draws=lambda t: tzoo.ZooDraws(*case["draws"][t]))
    out = {"state": tuple(tree.tree_map(torch.clone, states)),
           "stats": {k: np.asarray(getattr(st, k)).tolist() for k in
                     ("loss", "b_t", "ghat_norm", "n_scheduled")}}
    A = int(states.master.shape[0])
    path = zr.save_state(inp["dir"], len(case["draws"]), states,
                         t_next=len(case["draws"]))
    got, t_next = zr.restore_state(inp["dir"], arms=A)
    out["path"] = path
    out["restored_equal"] = t_next == len(case["draws"]) and all(
        torch.equal(a, b) for a, b in zip(tree.leaves(got),
                                          tree.leaves(states)))
    # a carry with a row short (master, then residual) is refused before
    # any collective runs
    out["refused"] = []
    for bad in (states._replace(master=states.master[:, 1:]),
                states._replace(residual=states.residual[:, 1:])):
        try:
            zr.run_sweep(bad, case["batch"], inp["arms"], 1, key=0)
            out["refused"].append("")
        except ValueError as e:
            out["refused"].append(str(e))
    return out


def sweep_engine(spec, dev="cpu"):
    """(EngineRun, Arms) of a sweep case. ``spec["task"]`` "small" is
    tests/test_torch_checkpoint.py's resume sweep (a quadratic of D =
    1,200 over U = 4 workers; EF and warm-start IHT under
    ``greedy_batched``; Adam; 8 rounds in chunks cut at 0, 3, 6, 7; the
    CUDA kernels with ``spec["kernels"]``), "mlp"
    the §V MLP on ``spec``'s weights, data, config (``ob``, ``const``,
    ``fl``) and Φ. The arms: ``spec``'s seeds and σ²."""
    from repro_torch.core.obcsaa import OBCSAAConfig
    from repro_torch.engine import EngineRun, FLConfig, make_arms
    from repro_torch.optim import make
    if spec["task"] == "small":
        U, D = 4, 1200
        cfg = FLConfig(aggregator="obcsaa", scheduler="greedy_batched",
                       rounds=8, eval_every=3, error_feedback=True,
                       obcsaa=OBCSAAConfig(chunk=256, measure=64, topk=16,
                                           biht_iters=3, warm_start=True,
                                           recon_alg="iht", recon_tau=0.25,
                                           use_kernels=spec.get("kernels",
                                                                False)))
        data = {"c": torch.randn((U, D), generator=torch.Generator()
                                 .manual_seed(3))}

        def loss(p, d):
            return 0.5 * torch.sum((p["w"] - d["c"]) ** 2, dim=-1)

        def ev(p):
            return torch.sum(p["w"] ** 2), torch.tensor(0.0)

        run = EngineRun(cfg, loss, {"w": torch.linspace(-1.0, 1.0, D)},
                        data, np.ones(U), eval_fn=ev,
                        optimizer=make("adam"), device=dev)
    else:
        from repro_torch.models import mlp_mnist as tm
        from repro_torch.theory import AnalysisConstants
        cfg = FLConfig(obcsaa=OBCSAAConfig(**spec["ob"]),
                       const=AnalysisConstants(**spec["const"]),
                       **spec["fl"])
        xe, ye = spec["xte"], spec["yte"]
        run = EngineRun(
            cfg, lambda p, d: tm.mlp_mnist_loss(p, d["x"], d["y"]),
            spec["params"], {"x": spec["wx"], "y": spec["wy"]},
            spec["k_weights"], eval_fn=lambda p: (
                tm.mlp_mnist_loss(p, xe, ye),
                tm.mlp_mnist_accuracy(p, xe, ye)),
            phi=spec["phi"], device=dev)
    return run, make_arms(cfg, seeds=spec["seeds"],
                          noise_var=spec["noise_var"])


def sweep_summary(res) -> dict:
    """A ``run_sweep`` result in tensors (what a rank hands back): the
    streams, the budget's fields, ``t_start``, every arm's carry leaves
    (its generator's state in the generator's place) and the stacked
    parameters."""
    from repro_torch import tree
    from repro_torch.engine.state import with_generator_state
    out = {k: torch.from_numpy(np.array(res[k])) for k in (
        "n_scheduled", "b_t", "rt_bound", "eval_rounds", "loss",
        "accuracy") if k in res}
    out["budget"] = [torch.from_numpy(np.array(b)) for b in res["budget"]]
    out["t_start"] = res["t_start"]
    out["state"] = [[x.cpu() for x in tree.leaves(with_generator_state(s))]
                    for s in res["state"]]
    out["params"] = {k: v.cpu() for k, v in res["params"].items()}
    return out


def _spied(fn, name, dev, calls):
    """``fn(leaves, group, ...)`` that first appends (``name``, the
    devices of ``leaves``, ``wire_device(group, dev)``, whether the group
    is None) to ``calls``."""
    from repro_torch.dist import collectives as coll

    def spy(leaves, group, *args, **kw):
        calls.append((name, sorted({str(x.device) for x in leaves}),
                      str(coll.wire_device(group, dev)), group is None))
        return fn(leaves, group, *args, **kw)
    return spy


def sweep(inp, mesh, dev):
    """``EngineRun.run_sweep(mesh=world_mesh(M))`` for each run of
    ``inp["runs"]``, in order: its ``sweep_summary``, the arms this rank
    ran, the collectives' bytes by kind, the kernels' launches, every
    call of ``gather_rows`` and ``replicated`` as (name, the devices of
    its leaves, ``wire_device`` of its group, whether the group is None),
    the world's backend, or the message of the ``ValueError`` it was
    refused with."""
    import torch.distributed as dist

    from repro_torch.dist import collectives as coll
    from repro_torch.kernels import build
    from repro_torch.dist.sharding import batch_indices
    from repro_torch.engine import Draws
    from repro_torch.launch.mesh import world_mesh
    out = {}
    calls = []
    real = coll.gather_rows, coll.replicated
    coll.gather_rows = _spied(real[0], "gather_rows", dev, calls)
    coll.replicated = _spied(real[1], "replicated", dev, calls)
    for name, spec in inp["runs"].items():
        m = world_mesh(spec.get("M", 1))
        run, arms = sweep_engine(spec, dev)
        draws = Draws(*spec["draws"]) if "draws" in spec else None
        coll.reset_counters()
        build.reset_launch_counts()
        calls.clear()
        try:
            res = run.run_sweep(arms, eval_every=spec.get("every"),
                                ckpt_dir=spec.get("ckpt"),
                                resume=spec.get("resume"), mesh=m,
                                draws=draws)
        except ValueError as e:
            out[name] = {"refused": str(e)}
            continue
        out[name] = dict(sweep_summary(res),
                         own=list(batch_indices(len(spec["seeds"]), m)),
                         bytes=coll.stats()["bytes"],
                         launches=build.launch_counts(),
                         wire=list(calls), backend=dist.get_backend())
    coll.gather_rows, coll.replicated = real
    return out


def zoo_cli(inp, rank, tmp_dir):
    """The trainer's CLI under the file store, once per argv of
    ``inp["argvs"]`` (each joins and leaves a world of its own)."""
    import contextlib
    import io

    from repro_torch.launch import train
    logs = []
    for i, argv in enumerate(inp["argvs"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.main(argv + ["--init-method", "file://" + os.path.join(
                tmp_dir, f"store_cli{i}")])
        logs.append(buf.getvalue())
    return {"logs": logs}


def lm_decode(model, params, tok, stub, P, G, total, mesh=None,
              keep=None):
    """Prompt ``tok[:, :P]`` into a ``total``-long cache (seeded from a
    prefill for the attention families, stepped for the others; audio
    after ``seed_cross_cache``), then G greedy tokens, each from the
    logits before it. With a ``mesh`` of M = 1 the cache's K/V length is
    split over its data group; with M > 1 the model and the cache are
    split over it (``params`` this rank's share) and the greedy pick is
    over the split vocabulary; with
    ``keep`` (a dict) the cache's leaf shapes land in ``keep["cache"]``.
    Returns (tokens (B, G), those logits (G, B, V), whole)."""
    from repro_torch.launch import steps
    from repro_torch.models import encdec
    from repro_torch.models import tensor_parallel as tp
    cfg = model.cfg
    kw = {"mesh": mesh}
    if cfg.family in ("dense", "moe", "vlm"):
        lg, cache, pos = steps.make_seeded_prefill(model, total, **kw)(
            params, {"tokens": tok[:, :P], **stub})
    else:
        cache = model.init_cache(tok.shape[0], total, tok.device, **kw)
        if cfg.family == "audio":
            encdec.seed_cross_cache(params, cfg, cache, encdec.encode(
                params, cfg, stub["frames"], mesh=mesh), mesh)
        for pos in range(P):
            lg, cache = model.decode_step(params, cache,
                                          tok[:, pos:pos + 1], pos, **kw)
        pos = P
    out, logits = [], []
    for _ in range(G):
        lg = lg[:, -1]
        nxt = tp.greedy(lg, cfg, mesh)[:, None].to(torch.int32)
        out.append(nxt)
        logits.append(tp.gather_logits(lg, cfg, mesh))
        lg, cache = model.decode_step(params, cache, nxt, pos, **kw)
        pos += 1
    if keep is not None:
        keep["cache"] = {k: tuple(v.shape) for k, v in cache.items()}
    return torch.cat(out, 1), torch.stack(logits)


def decode(inp, mesh, dev):
    """``lm_decode`` for each case with the K/V length split over the
    world; the collectives' bytes."""
    from repro_torch import configs
    from repro_torch.dist import collectives as coll
    from repro_torch.models.registry import build_model
    out = {}
    for name, case in inp["cases"].items():
        cfg = configs.scaled(configs.get_smoke_config(case["arch"]),
                             dtype="float32")
        coll.reset_counters()
        toks, logits = lm_decode(build_model(cfg), case["params"],
                                 case["tok"], case["stub"], case["P"],
                                 case["G"], case["total"], mesh)
        out[name] = {"tokens": toks, "logits": logits,
                     "bytes": coll.stats()["bytes"]}
    return out


def serve_split(inp, mesh, dev):
    """The serving path split over the (W, M) mesh for each case: this
    rank's share of the reference's weights (``convert.lm_params_share``)
    through ``lm_decode`` with the mesh; the split prefill's logits over
    the whole vocabulary; the cache's leaf shapes; whether this rank's
    own seed-0 init (``tensor_parallel.init_params``) equals its slice of
    the whole init, bit for bit; the parameters' bytes this rank holds;
    the MoE routes dropped; the collectives' bytes by group."""
    from repro_torch import configs, tree
    from repro_torch.convert import lm_params_share
    from repro_torch.dist import collectives as coll
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.models.registry import build_model
    d, m = mesh.cell()
    M = mesh.shape["model"]
    dropped = [0]
    dispatch = moe_lib._dispatch

    def counted(idx, E, capacity):
        flat, slot, keep = dispatch(idx, E, capacity)
        dropped[0] += int((~keep).sum())
        return flat, slot, keep

    moe_lib._dispatch = counted
    out = {}
    for name, case in inp["cases"].items():
        cfg = configs.scaled(configs.get_smoke_config(case["arch"]),
                             dtype="float32")
        if "capacity_factor" in case:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=case["capacity_factor"]))
        model = build_model(cfg)
        params = lm_params_share(case["params"], cfg, M, m)
        own = tp.init_params(model, 0, mesh, dev)
        want = lm_params_share(model.init(0, device=dev), cfg, M, m)
        res = {"init_equal": all(torch.equal(a, b) for a, b in zip(
            tree.leaves(own), tree.leaves(want))),
            "param_bytes": sum(x.numel() * x.element_size()
                               for x in tree.leaves(params)),
            "param_shapes": [tuple(x.shape) for x in tree.leaves(params)]}
        dropped[0] = 0
        coll.reset_counters()
        keep = {}
        res["tokens"], res["logits"] = lm_decode(
            model, params, case["tok"], case["stub"], case["P"], case["G"],
            case["total"], mesh, keep)
        res["by_group"] = coll.by_group()
        res["bytes"] = coll.stats()["bytes"]
        res["cache"], res["dropped"] = keep["cache"], dropped[0]
        batch = {"tokens": case["tok"][:, :case["P"]], **case["stub"]}
        res["prefill"] = tp.gather_logits(model.prefill(
            params, batch, mesh=mesh)[0], cfg, mesh)
        out[name] = res
    moe_lib._dispatch = dispatch
    return out


def serve_bytes(inp, mesh, dev):
    """Each case's split prefill over ``rows`` zero sequences of
    ``seq``, and one split decode step of a ``batch`` x ``seq`` cache at
    its last position, from this rank's share of the seed-0 init: the
    collectives' bytes by kind of each, and the bytes of the share and
    of the cache this rank holds."""
    from repro_torch import configs, tree
    from repro_torch.configs import InputShape
    from repro_torch.dist import collectives as coll
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.models.registry import build_model
    out = {}
    for name, case in inp["cases"].items():
        cfg = configs.scaled(configs.get_smoke_config(case["arch"]),
                             dtype="float32")
        model = build_model(cfg)
        params = tp.init_params(model, 0, mesh, dev)
        specs = model.input_specs(InputShape("p", case["seq"], case["rows"],
                                             "prefill"))
        batch = {k: torch.zeros(s, dtype=d, device=dev)
                 for k, (s, d) in specs.items()}
        coll.reset_counters()
        model.prefill(params, batch, mesh=mesh)
        res = {"prefill": coll.stats()["bytes"]}
        cache = model.init_cache(case["batch"], case["seq"], dev, mesh=mesh)
        tokens = torch.zeros((case["batch"], 1), dtype=torch.int32,
                             device=dev)
        coll.reset_counters()
        model.decode_step(params, cache, tokens, case["seq"] - 1, mesh=mesh)
        res["decode"] = coll.stats()["bytes"]
        res["params"] = sum(x.numel() * x.element_size()
                            for x in tree.leaves(params))
        res["cache"] = sum(x.numel() * x.element_size()
                           for x in cache.values())
        out[name] = res
    return out


def main(argv) -> int:
    case, tmp_dir, rank, world = argv[0], argv[1], int(argv[2]), int(argv[3])
    device = argv[4] if len(argv) > 4 else "cpu"
    mp = int(argv[5]) if len(argv) > 5 else 1
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    inp = torch.load(os.path.join(tmp_dir, "inputs.pt"))
    if case == "zoo_cli":
        out = zoo_cli(inp, rank, tmp_dir)
        torch.save(out, os.path.join(tmp_dir, f"out_{rank}.pt"))
        return 0
    from repro_torch.launch.mesh import join_world, leave_world
    mesh, dev = join_world(device, model_parallel=mp,
                           init_method="file://" + os.path.join(tmp_dir,
                                                                "store"))
    out = {"collectives": collectives, "aggregate": aggregate,
           "train": train, "train_split": train_split, "zoo": zoo,
           "zoo_train": zoo_train, "zoo_sweep": zoo_sweep,
           "decode": decode, "serve_split": serve_split,
           "serve_bytes": serve_bytes, "sweep": sweep}[case](inp, mesh, dev)
    torch.save(out, os.path.join(tmp_dir, f"out_{rank}.pt"))
    leave_world()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
