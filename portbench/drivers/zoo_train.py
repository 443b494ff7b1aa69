"""The zoo round with real gradients at LM scale: rounds back to back
through ``ZooTrainRound.round_train`` on one round and carry built in
set-up.

Inputs, all made here from ``--seed`` and handed to the program and the
reference alike: the weights (``reference/zoo.make_params``, drawn on
the device leaf by leaf; the program lays them out itself), Φ (N(0, 1/S)
from the configuration's ``phi_seed``), every round's batches (the frozen
token streams, worker u of round t seeded from (seed, t, u)) and every
round's fades and AWGN (``ZooDraws``, from (seed, t)).

Set-up runs the first ``setup_rounds`` rounds through the window's own
call, which warms every shape the window uses, and keeps the carry after
the first and after the last of them. The window then dispatches rounds
until ``--seconds`` have passed, nothing in between waiting on the card,
waits for all of them and reads the clock after that wait. After it, the
reference (``reference/zoo.py``) follows the set-up's rounds from the
same weights, batches and draws, and the comparison reads the share of
the first round's MAC lanes (Σ over the workers of each measurement's
sign) that differ, and, as a training step is read, each leaf's norm of
the first round's ĝ (from the carry after it, (p0 − p1)/α) and of the
change over the set-up's rounds: each leaf's gap of norms over the
larger of its own and the median leaf's, the median leaf.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from portbench import harness
from portbench.frozen import zoo as fz
from portbench.reference import zoo as ref


def model_config(mc: dict):
    """The program's ``ModelConfig`` for the configuration file."""
    from repro_torch.configs.base import AttentionConfig, ModelConfig
    return ModelConfig(
        name=mc["name"], family="vlm", num_layers=mc["num_layers"],
        d_model=mc["d_model"], d_ff=mc["d_ff"], vocab_size=mc["vocab_size"],
        attention=AttentionConfig(num_heads=mc["num_heads"],
                                  num_kv_heads=mc["num_kv_heads"],
                                  head_dim=mc["head_dim"],
                                  rope_theta=mc["rope_theta"]),
        num_image_tokens=mc["num_image_tokens"], tie_embeddings=True,
        gated_mlp=True, norm_eps=mc["norm_eps"], dtype=mc["compute_dtype"])


class Inputs:
    """What the benchmark makes from the seed, for both sides."""

    def __init__(self, mc: dict, tr: dict, seed: int, device):
        self.mc, self.tr, self.seed = mc, tr, seed
        self.device = torch.device(device)
        self.layout = ref.Layout(mc, mc["model_parallel"], mc["chunk"],
                                 mc["workers"] * mc["block_chunks"])
        gen = torch.Generator(device=self.device).manual_seed(
            mc["phi_seed"])
        self.phi = torch.randn((mc["measure"], mc["chunk"]), generator=gen,
                               device=self.device) / math.sqrt(mc["measure"])
        self.image = torch.full(
            (tr["seqs_per_worker"], mc["num_image_tokens"], mc["d_model"]),
            0.01, dtype=torch.bfloat16, device=self.device)

    def params(self):
        gen = torch.Generator(device=self.device).manual_seed(
            harness.mix(self.seed, 1))
        return ref.make_params(self.mc, gen, self.device)

    def batch(self, t: int) -> dict:
        U = self.mc["workers"]
        return fz.zoo_batch([harness.mix(self.seed, 5, t, u)
                             for u in range(U)], self.tr["seqs_per_worker"],
                            self.tr["text_len"], self.mc["vocab_size"],
                            self.image, self.device)

    def draws(self, t: int):
        """(h (U,), z (n_chunks, S_c)) of round t."""
        gen = torch.Generator(device=self.device).manual_seed(
            harness.mix(self.seed, 6, t))
        U = self.mc["workers"]
        re = torch.randn((U,), generator=gen, device=self.device)
        im = torch.randn((U,), generator=gen, device=self.device)
        h = torch.clamp(torch.complex(re, im).abs() / math.sqrt(2.0),
                        min=1e-3)
        z = torch.randn((self.layout.n_chunks, self.mc["measure"]),
                        generator=gen, device=self.device)
        return h, z


class Program:
    """The program's round and carry."""

    def __init__(self, mc: dict, inp: Inputs):
        from repro_torch.core.obcsaa import OBCSAAConfig
        from repro_torch.engine.zoo_train import ZooTrainRound
        from repro_torch.launch.mesh import make_zoo_mesh
        from repro_torch.models.registry import build_model

        self.mc, self.inp = mc, inp
        ob = OBCSAAConfig(chunk=mc["chunk"], measure=mc["measure"],
                          topk=mc["topk"], biht_iters=mc["iht_iters"],
                          recon_alg=mc["decoder"], recon_tau=mc["recon_tau"],
                          spmd_topk=mc["spmd_topk"], packed=mc["packed"],
                          bisect_iters=mc["bisect_iters"],
                          use_kernels=mc["use_kernels"],
                          noise_var=mc["noise_var"], p_max=mc["p_max"],
                          phi_seed=mc["phi_seed"])
        self.zr = ZooTrainRound(
            build_model(model_config(mc)),
            make_zoo_mesh(mc["workers"], mc["model_parallel"]), ob,
            compute_dtype=getattr(torch, mc["compute_dtype"]),
            remat=mc["remat"], optimizer=mc["optimizer"],
            block_chunks=mc["block_chunks"], device=inp.device, phi=inp.phi)
        if self.zr.n_chunks != inp.layout.n_chunks:
            raise ValueError(f"the program lays the parameters out in "
                             f"{self.zr.n_chunks} chunks, the configuration "
                             f"in {inp.layout.n_chunks}")
        params = ref.nested(inp.params())
        master = self.zr.layout.tree_to_master(params)
        del params
        self.state = self.zr.init_state(master)

    def round(self, t: int, hook=None):
        from repro_torch.engine.zoo import ZooDraws
        mc = self.mc
        self.state, st = self.zr.round_train(
            self.state, self.inp.batch(t), t, 0, mc["noise_var"],
            mc["p_max"], mc["learning_rate"],
            draws=ZooDraws(*self.inp.draws(t)), hook=hook)
        return st


def setup_rounds(prog: Program, n: int) -> dict:
    """The first ``n`` rounds through the window's own call: each round's
    loss, the first round's MAC sums (through ``round_train``'s hook) and
    the carry after the first and the last round, on the host."""
    out = {"losses": []}

    def keep_mac(stage, **info):
        if stage == "mac":
            out["mac"] = info["y_sum"].detach().to("cpu", copy=True)

    for t in range(n):
        out["losses"].append(float(prog.round(t, keep_mac if t == 0
                                              else None).loss))
        if t == 0:
            out["p1"] = prog.state.master.detach().to("cpu", copy=True)
    out["p_last"] = prog.state.master.detach().to("cpu", copy=True)
    return out


def compare(inp: Inputs, run: dict, checks: harness.Checks, limits: dict,
            look=None) -> int:
    """The reference over the set-up's rounds against what the program
    made of them (``run``: ``losses``, the MAC's sums of the first round
    ``mac`` and the masters after the first and the last round ``p1``,
    ``p_last``, on the host). Returns the numbers that failed. ``look``: a
    dict that gets every leaf's gaps and the losses."""
    losses, p1, p_last = run["losses"], run["p1"], run["p_last"]
    mc, lay = inp.mc, inp.layout
    lr = mc["learning_rate"]
    p0 = lay.to_master(inp.params())
    rnd = ref.Round(mc, lay, inp.phi)
    master = p0.clone()
    ref_losses, ref_p1, grad_norms = [], None, None
    with torch.no_grad():
        for t in range(len(losses)):
            h, z = inp.draws(t)
            b = inp.batch(t)
            batches = [{k: v[u] for k, v in b.items()}
                       for u in range(mc["workers"])]
            lv, gn, signs = rnd.step(master, batches, h, z)
            ref_losses.append(lv)
            if t == 0:
                ref_p1, grad_norms = master.clone(), gn
                lanes = float(torch.mean(
                    (run["mac"].to(signs.device).float() != signs).float()))
        keep = ref.kept_leaves(grad_norms)
        dev = p0.device
        g_ref = lay.leaf_norms((p0 - ref_p1) / lr)
        g_prog = lay.leaf_norms((p0 - p1.to(dev)) / lr)
        d_ref = lay.leaf_norms(master - p0)
        d_prog = lay.leaf_norms(p_last.to(dev) - p0)
    grad = ref.norm_gaps(g_prog, g_ref, keep)
    change = ref.norm_gaps(d_prog, d_ref, keep)
    if look is not None:
        look.update(grad={"/".join(k): v for k, v in grad.items()},
                    change={"/".join(k): v for k, v in change.items()},
                    losses=[losses, ref_losses], loss_gap=max(
                        abs(a - b) / abs(b)
                        for a, b in zip(losses, ref_losses)))
    # the median leaf: a leaf of a few chunks, shared with others, moves
    # by which of its entries the decode's top-k takes (PERF.md)
    numbers = {"mac_lane_share": lanes,
               "grad_gap": statistics.median(grad.values()),
               "change_gap": statistics.median(change.values())}
    failed = 0
    for name, v in numbers.items():
        checks.add(name, v, limits[name])
        failed += not v <= limits[name]
    return failed


def run(ctx: harness.Context, seed: int, seconds: float, t_start: float,
        device="cuda") -> harness.Checks:
    from repro_torch.kernels import build

    mc, tr = ctx.cell.config, ctx.cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and mc["use_kernels"]:
        build.lib()
    inp = Inputs(mc, tr, seed, dev)
    prog = Program(mc, inp)
    n0 = int(tr["setup_rounds"])
    first = setup_rounds(prog, n0)
    if cuda:
        torch.cuda.synchronize()
    # the set-up's objects out of the collector's way: a full collection
    # in the window would otherwise walk them all, with the card idle
    gc.collect()
    gc.freeze()
    clock = fz.ZooClock() if (ctx.trace and cuda) else None
    stages = {}
    t = n0
    t0 = time.perf_counter()
    ctx.setup_s = t0 - t_start
    while True:
        ts = time.perf_counter()
        if clock is not None:
            clock.start()
        prog.round(t, clock)
        if clock is not None:
            for k, v in clock.stages().items():
                stages.setdefault(k, []).append(v)
        stages.setdefault("step_s", []).append(time.perf_counter() - ts)
        t += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    ctx.window_s = time.perf_counter() - t0
    ctx.units = t - n0
    ctx.spans["step_s"] = stages.pop("step_s")
    ctx.spans.update({f"stage_{k}": v for k, v in stages.items()})
    if ctx.trace and cuda:
        def rounds():
            nonlocal t
            before = build.launch_counts()
            for _ in range(int(tr["traced_rounds"])):
                prog.round(t)
                t += 1
            after = build.launch_counts()
            ctx.counters["launches"] = {k: after[k] - before[k]
                                        for k in after}
            return int(tr["traced_rounds"])
        ctx.profile = harness.profile(rounds)
    ctx.counters["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(dev) if cuda else 0)
    del prog
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = harness.Checks()
    t = time.perf_counter()
    with torch.no_grad():
        ctx.counters["failed"] = compare(inp, first, checks, tr["limits"])
    ctx.counters["check_s"] = time.perf_counter() - t
    return checks


def tiny(mc: dict, traffic: dict):
    """The configuration and traffic cut to a size a CPU test run holds,
    the checks and limits as they stand."""
    mc = dict(mc, num_layers=2, d_model=256, d_ff=512, vocab_size=512,
              num_heads=4, num_kv_heads=2, head_dim=64, num_image_tokens=16,
              block_chunks=1, chunk=1024)
    return mc, dict(traffic, seqs_per_worker=3, text_len=16)


def control_readings(cell, args):
    """``portbench.control``'s readings for this driver: the program's
    numbers (the set-up's rounds only, no window) for ``--seeds``; the
    reference put in the program's place with its products in float8
    (the control) for ``--control-seeds``, and with half of each worker's
    batch left out, the mean over the rest, for ``--fault-seeds``."""
    from repro_torch.kernels import build
    build.lib()
    mc, tr = cell.config, cell.traffic
    n0 = int(tr["setup_rounds"])
    big = {k: float("inf") for k in tr["limits"]}
    out = []

    def read(kind, seed, inp, run):
        checks, look = harness.Checks(), {}
        compare(inp, run, checks, big, look)
        out.append({"kind": kind, "seed": seed, **checks.report(),
                    "look": look})

    for seed in args.seeds:
        inp = Inputs(mc, tr, seed, "cuda")
        prog = Program(mc, inp)
        run = setup_rounds(prog, n0)
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        read("program", seed, inp, run)
    for kind, seeds in (("control_fp8", args.control_seeds),
                        ("half", args.fault_seeds)):
        for seed in seeds:
            inp = Inputs(mc, tr, seed, "cuda")
            batch = inp.batch
            if kind == "half":
                def half(t):
                    b = batch(t)
                    n = b["tokens"].shape[1] // 2
                    return {k: v[:, :n] for k, v in b.items()}
                inp.batch = half
            master = inp.layout.to_master(inp.params())
            rnd = ref.Round(mc, inp.layout, inp.phi)
            run = {"losses": []}
            with torch.no_grad():
                for t in range(n0):
                    h, z = inp.draws(t)
                    b = inp.batch(t)
                    lv, _, signs = rnd.step(
                        master, [{k: v[u] for k, v in b.items()}
                                 for u in range(mc["workers"])], h, z,
                        low=kind == "control_fp8")
                    run["losses"].append(lv)
                    if t == 0:
                        run["p1"], run["mac"] = master.cpu(), signs.cpu()
            run["p_last"] = master.cpu()
            del master
            inp.batch = batch
            read(kind, seed, inp, run)
    return out
