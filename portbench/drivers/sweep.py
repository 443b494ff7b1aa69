"""The §V sweep: whole sweeps of a grid of arms, back to back, through
``EngineRun.run_sweep`` on one engine built in set-up.

Inputs, all made here from ``--seed`` and handed to the program and the
reference alike: the workers' data and the held-out set (the frozen
synthetic MNIST, drawn on the device), the initial weights (N(0, 2/fan_in),
zero biases), Φ (N(0, 1/S) from the configuration's ``phi_seed``) and each
sweep's arm seeds (from the run's seed, the sweep's index and the arm's).
The traffic file gives the grid (σ² values × seeds per σ²) and the rounds
of a sweep; the configuration file everything else.

The window runs sweeps until ``--seconds`` have passed, each to its end.
An evaluation after every stretch of rounds (the configuration's
``eval_every``) is the harness's: loss and accuracy on the held-out set,
and a copy of the parameters it was handed, which is what the check
compares. After the window, for ``check.sweeps`` of the sweeps drawn from
the seed, the reference (``reference/sec5.py``) recomputes every arm's
b_t of every round, and follows every round of ``check.arms`` arms drawn
from the seed: every stage of a round, from the workers' gradients to the
update. It runs round 0 from the benchmark's weights (the captured
graph's first replay) and each later stretch between two evaluations
from the program's parameters at the first of them.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import harness
from portbench.frozen import synthetic
from portbench.reference import sec5 as ref


def make_inputs(cfg: dict, seed: int, device):
    """(worker data {x (U, K, 784), y (U, K)}, held-out (x, y), initial
    weights, Φ) on ``device``."""
    U, K, n_eval = cfg["workers"], cfg["samples_per_worker"], \
        cfg["eval_samples"]
    gen = torch.Generator(device=device).manual_seed(harness.mix(seed, 1))
    x, y = synthetic.samples(U * K + n_eval, gen, device)
    data = {"x": x[:U * K].reshape(U, K, 784).contiguous(),
            "y": y[:U * K].reshape(U, K).contiguous()}
    held = (x[U * K:].contiguous(), y[U * K:].contiguous())
    d_in, d_h, d_out = cfg["d_in"], cfg["d_hidden"], cfg["n_classes"]
    params = {
        "w1": torch.randn((d_in, d_h), generator=gen, device=device)
        * math.sqrt(2.0 / d_in),
        "b1": torch.zeros((d_h,), device=device),
        "w2": torch.randn((d_h, d_out), generator=gen, device=device)
        * math.sqrt(2.0 / d_h),
        "b2": torch.zeros((d_out,), device=device)}
    pgen = torch.Generator(device=device).manual_seed(cfg["phi_seed"])
    phi = torch.randn((cfg["measure"], cfg["chunk"]), generator=pgen,
                      device=device) / math.sqrt(cfg["measure"])
    return data, held, params, phi


def grid(traffic: dict):
    """σ² of every arm: each value of the grid ``seeds_per_noise`` times."""
    return [float(nv) for nv in traffic["noise_vars"]
            for _ in range(traffic["seeds_per_noise"])]


def arm_seeds(seed: int, sweep: int, n: int):
    return [harness.mix(seed, 2, sweep, a) for a in range(n)]


class Sweeps:
    """The engine and the sweeps run on it."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch.core.obcsaa import OBCSAAConfig
        from repro_torch.engine import EngineRun, FLConfig
        from repro_torch.models.mlp_mnist import mlp_mnist_loss

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.data, (xe, ye), self.params0, self.phi = make_inputs(
            cfg, seed, self.device)
        self.noise = grid(traffic)
        self.rounds = int(traffic["rounds"])
        ob = OBCSAAConfig(chunk=cfg["chunk"], measure=cfg["measure"],
                          topk=cfg["topk"], biht_iters=cfg["biht_iters"],
                          recon_alg=cfg["decoder"],
                          recon_tau=cfg["recon_tau"], p_max=cfg["p_max"],
                          phi_seed=cfg["phi_seed"],
                          use_kernels=cfg["use_kernels"])
        self.fl = FLConfig(aggregator=cfg["aggregator"],
                           scheduler=cfg["scheduler"],
                           learning_rate=cfg["learning_rate"],
                           rounds=self.rounds, eval_every=cfg["eval_every"],
                           channel_rho=cfg["channel_rho"], obcsaa=ob,
                           mode=cfg["mode"])
        self.snaps = []

        def eval_fn(p):
            h = torch.relu(xe @ p["w1"] + p["b1"])
            logits = h @ p["w2"] + p["b2"]
            loss = torch.nn.functional.cross_entropy(logits, ye)
            acc = (logits.argmax(-1) == ye).float().mean()
            self.snaps.append((np.float32(loss.item()),
                               np.float32(acc.item()),
                               {k: v.detach().to("cpu", copy=True)
                                for k, v in p.items()}))
            return loss, acc

        k_weights = np.full(cfg["workers"], float(cfg["samples_per_worker"]))
        self.k_weights = torch.tensor(k_weights, dtype=torch.float32,
                                      device=self.device)
        self.run = EngineRun(
            self.fl, lambda p, d: mlp_mnist_loss(p, d["x"], d["y"]),
            self.params0, self.data, k_weights, eval_fn=eval_fn,
            phi=self.phi, device=self.device)
        self.done = []          # per sweep: what the check needs

    def sweep(self, s: int) -> int:
        """Sweep ``s`` to its end; returns its arm-rounds."""
        from repro_torch.engine import make_arms
        seeds = arm_seeds(self.seed, s, len(self.noise))
        arms = make_arms(self.fl, seeds=seeds, noise_var=self.noise)
        self.snaps = []
        out = self.run.run_sweep(arms, rounds=self.rounds,
                                 eval_every=self.cfg["eval_every"])
        self.done.append({"seeds": seeds, "b_t": np.asarray(out["b_t"]),
                          "eval_rounds": np.asarray(out["eval_rounds"]),
                          "loss": np.asarray(out["loss"], np.float32),
                          "accuracy": np.asarray(out["accuracy"],
                                                 np.float32),
                          "snaps": self.snaps})
        return len(seeds) * self.rounds

    def time_chunks(self, ctx: harness.Context) -> None:
        """CUDA events around every ``run_chunk`` call, from the harness's
        side: the calls that capture an arm's graph apart from those that
        only replay it."""
        inner = self.run.run_chunk
        log = self.run.capture_log
        ctx.spans.setdefault("replay_ms", [])
        ctx.counters.setdefault("replay_rounds", 0)

        def run_chunk(state, arm, t0, n):
            before = len(log)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = inner(state, arm, t0, n)
            b.record()
            if len(log) == before:
                b.synchronize()
                ctx.spans["replay_ms"].append(a.elapsed_time(b))
                ctx.counters["replay_rounds"] += n
            return out

        self.run.run_chunk = run_chunk


def eval_rounds(traffic: dict, cfg: dict):
    """The rounds after which a sweep evaluates: every ``eval_every``-th
    from round 0, and the last."""
    R, E = int(traffic["rounds"]), int(cfg["eval_every"])
    return sorted({t for t in range(R) if t % E == 0} | {R - 1})


def snapshot(rec: dict, a: int, k: int):
    """The parameters evaluation k of arm ``a`` was handed. ``run_sweep``
    evaluates stretch by stretch, every arm in turn, so it is copy
    k·A + a; None unless its loss and accuracy are the sweep's own record
    of that evaluation."""
    A = rec["loss"].shape[0]
    i = k * A + a
    want = (rec["loss"][a, k], rec["accuracy"][a, k])
    if i < len(rec["snaps"]) and rec["snaps"][i][:2] == want:
        return rec["snaps"][i][2]
    return None


def compare_arm(sw: Sweeps, seed_a: int, noise_var: float, snaps: list,
                checks: harness.Checks) -> int:
    """The reference follows an arm's sweep stretch by stretch: from the
    benchmark's weights through round 0, then from the program's
    parameters at each evaluation to the next. ``first_round_gap`` reads
    round 0, ``stretch_gap`` each later stretch (``ref.chunk_gap`` of the
    stretch's change). ``snaps``: the parameters at every evaluation.
    Returns the numbers that failed."""
    cfg, limits = sw.cfg, sw.traffic["limits"]
    n_chunks = -(-sum(v.numel() for v in sw.params0.values())
                 // cfg["chunk"])
    draws = iter(ref.ArmDraws(seed_a, cfg["workers"], n_chunks,
                              cfg["measure"], sw.device))
    start, t, failed = sw.params0, 0, 0
    for k, end in enumerate(eval_rounds(sw.traffic, cfg)):
        want = ref.follow(start, draws, sw.data["x"], sw.data["y"],
                          sw.k_weights, sw.phi, noise_var, cfg, end + 1 - t)
        gap = ref.chunk_gap(snaps[k], want, start, cfg["chunk"])
        name = "first_round_gap" if k == 0 else "stretch_gap"
        checks.add(name, gap, limits[name])
        failed += not gap <= limits[name]
        start, t = snaps[k], end + 1
    return failed


def check(sw: Sweeps, checks: harness.Checks, seed: int) -> int:
    """The reference against ``check.sweeps`` sweeps drawn from the seed:
    every arm's b_t of every round, and every round of ``check.arms``
    arms drawn from the seed (``compare_arm``). Returns the numbers that
    failed."""
    cfg, tr = sw.cfg, sw.traffic
    c, limits = tr["check"], tr["limits"]
    rng = np.random.default_rng(harness.mix(seed, 3))
    picks = rng.choice(len(sw.done), size=min(c["sweeps"], len(sw.done)),
                       replace=False)
    n_chunks = -(-sum(v.numel() for v in sw.params0.values())
                 // cfg["chunk"])
    ends = eval_rounds(tr, cfg)
    failed = 0
    with ref.Precision(tf32=False):
        for s in sorted(int(p) for p in picks):
            rec = sw.done[s]
            A = len(rec["seeds"])
            if list(rec["eval_rounds"]) != ends:
                checks.fail(f"sweep {s}: evaluated after rounds "
                            f"{list(rec['eval_rounds'])}, not {ends}")
                failed += 1
                continue
            for a in range(A):
                want = np.array(ref.b_ts(rec["seeds"][a], cfg["workers"],
                                         n_chunks, cfg["measure"], sw.rounds,
                                         sw.k_weights, cfg["p_max"],
                                         sw.device))
                gap = float(np.max(np.abs(rec["b_t"][a] - want) / want))
                checks.add("b_t_gap", gap, limits["b_t_gap"])
                failed += not gap <= limits["b_t_gap"]
            for a in sorted(int(v) for v in rng.choice(
                    A, size=min(c["arms"], A), replace=False)):
                snaps = [snapshot(rec, a, k) for k in range(len(ends))]
                if any(p is None for p in snaps):
                    checks.fail(f"sweep {s} arm {a}: an evaluation's copy "
                                f"is not the sweep's record of it")
                    failed += 1
                    continue
                failed += compare_arm(sw, rec["seeds"][a], sw.noise[a],
                                      snaps, checks)
    return failed


def run(ctx: harness.Context, seed: int, seconds: float, t_start: float,
        device="cuda") -> harness.Checks:
    """Set-up, the window, the traced sweep (``ctx.trace``) and the check.
    ``t_start``: the process's start on the host clock."""
    from repro_torch.kernels import build

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev = torch.device(device)
    if dev.type == "cuda" and cfg["use_kernels"]:
        build.lib()
    sw = Sweeps(cfg, tr, seed, dev)
    # warm-up: one whole sweep of the grid, not timed and not checked
    sw.sweep(-1)
    sw.done.clear()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if ctx.trace:
        sw.time_chunks(ctx)
    n_log = len(sw.run.capture_log)
    s = 0
    t0 = time.perf_counter()
    ctx.setup_s = t0 - t_start
    units = 0
    steps = ctx.spans.setdefault("step_s", [])
    while True:
        ts = time.perf_counter()
        units += sw.sweep(s)
        steps.append(time.perf_counter() - ts)
        s += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ctx.window_s = time.perf_counter() - t0
    ctx.units = units
    ctx.counters["captures"] = sw.run.capture_log[n_log:]
    if ctx.trace and dev.type == "cuda":
        def one():
            nonlocal s
            before = build.launch_counts()
            n = sw.sweep(s)
            s += 1
            after = build.launch_counts()
            ctx.counters["launches"] = {k: after[k] - before[k]
                                        for k in after}
            return n
        ctx.profile = harness.profile(one)
    ctx.counters["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    sw.run = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = harness.Checks()
    t = time.perf_counter()
    ctx.counters["failed"] = check(sw, checks, seed)
    ctx.counters["check_s"] = time.perf_counter() - t
    return checks


def tiny(cfg: dict, traffic: dict):
    """The configuration and traffic cut to a size a CPU test run holds,
    the checks and limits as they stand."""
    cfg = dict(cfg, workers=3, samples_per_worker=64, eval_samples=50,
               chunk=512, measure=128, topk=16, biht_iters=3, eval_every=4)
    traffic = dict(traffic, noise_vars=[1e-4, 1.0], seeds_per_noise=2,
                   rounds=9, check={"sweeps": 2, "arms": 4})
    return cfg, traffic


def _planted(inp, seed_a: int, noise_var: float, kind: str):
    """The parameters at every evaluation of one arm, from the reference
    put in the program's place with a fault: ``control_tf32`` its products
    in TF32; ``half`` half of the workers' gradients left out, the mean
    taken over the rest; ``stale_carry`` every round of a stretch run from
    the stretch's first parameters, the carry not advanced."""
    cfg, dev = inp.cfg, inp.device
    n_chunks = -(-sum(v.numel() for v in inp.params0.values())
                 // cfg["chunk"])
    draws = iter(ref.ArmDraws(seed_a, cfg["workers"], n_chunks,
                              cfg["measure"], dev))
    x, y = inp.data["x"], inp.data["y"]
    saved = ref.worker_grads
    if kind == "half":
        def half(p, xx, yy):
            g = saved(p, xx, yy)
            u = g.shape[0] // 2
            return torch.cat([g[:u], g[:g.shape[0] - u]])
        ref.worker_grads = half
    p, t, snaps = dict(inp.params0), 0, []
    try:
        with ref.Precision(tf32=kind == "control_tf32"):
            for end in eval_rounds(inp.traffic, cfg):
                start = p
                while t <= end:
                    base = start if kind == "stale_carry" else p
                    p = ref.follow(base, draws, x, y, inp.k_weights, inp.phi,
                                   noise_var, cfg, 1)
                    t += 1
                snaps.append({k: v.cpu() for k, v in p.items()})
    finally:
        ref.worker_grads = saved
    return snaps


def control_readings(cell, args):
    """``portbench.control``'s readings for this driver. For every seed of
    ``--seeds`` the program's numbers, one sweep of the grid with
    ``--arms`` arms followed, as a run's check reads them; for every seed
    of ``--control-seeds`` the control's (``_planted``'s
    ``control_tf32``), and of ``--fault-seeds`` the planted faults'
    (``half``, ``stale_carry``, and ``stale_draws``: the first round's
    draws replayed every round, read by b_t), each over ``--arms`` arms
    drawn from the seed and read by the same comparison."""
    from types import SimpleNamespace

    from repro_torch.kernels import build
    build.lib()
    cfg = cell.config
    tr = dict(cell.traffic, check={"sweeps": 1, "arms": args.arms})
    tr["limits"] = {k: float("inf") for k in tr["limits"]}
    out = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        sw = Sweeps(cfg, tr, seed, "cuda")
        sw.sweep(0)
        sw.run = None
        checks = harness.Checks()
        check(sw, checks, seed)
        out.append({"kind": "program", "seed": seed,
                    "s": time.perf_counter() - t0, **checks.report()})
    planted = [("control_tf32", s) for s in args.control_seeds] + [
        (k, s) for s in args.fault_seeds
        for k in ("half", "stale_carry", "stale_draws")]
    for kind, seed in planted:
        dev = torch.device("cuda")
        data, _, params0, phi = make_inputs(cfg, seed, dev)
        noise = grid(tr)
        inp = SimpleNamespace(
            cfg=cfg, traffic=tr, device=dev, data=data, params0=params0,
            phi=phi, k_weights=torch.full((cfg["workers"],),
                                          float(cfg["samples_per_worker"]),
                                          device=dev))
        seeds_a = arm_seeds(seed, 0, len(noise))
        rng = np.random.default_rng(harness.mix(seed, 4))
        n_chunks = -(-sum(v.numel() for v in params0.values())
                     // cfg["chunk"])
        for a in (int(v) for v in rng.choice(len(noise), size=args.arms,
                                             replace=False)):
            if kind == "stale_draws":
                with ref.Precision(tf32=False):
                    bts = ref.b_ts(seeds_a[a], cfg["workers"], n_chunks,
                                   cfg["measure"], tr["rounds"],
                                   inp.k_weights, cfg["p_max"], dev)
                gap = max(abs(bts[0] - w) / w for w in bts)
                out.append({"kind": kind, "seed": seed, "arm": a,
                            "b_t_gap": gap})
                continue
            snaps = _planted(inp, seeds_a[a], noise[a], kind)
            checks = harness.Checks()
            with ref.Precision(tf32=False):
                compare_arm(inp, seeds_a[a], noise[a], snaps, checks)
            out.append({"kind": kind, "seed": seed, "arm": a,
                        **checks.report()})
    return out
