"""Rounds in chunks cut at the eval cadence, and sweeps over arms, with
checkpoint and resume; port of ``repro/engine/runner.py``.

The reference advances a chunk of rounds as one jitted ``lax.scan`` and
vmaps it over an ``Arms`` grid. Here a chunk is, on the card, the arm's
round replayed from a CUDA graph (``engine/graph.py``), one replay a
round, with the stats read back only at the chunk's end; on the CPU, and
in ``mode="host"``, it is the eager loop over ``EngineFns.full_round``.
Each arm has its own generator. The sweep runs chunk-major — for each
chunk, every arm — so that at each chunk boundary all A arms stand at the
same round, which is what a checkpoint holds; each arm keeps its graph
until the sweep ends. Arms share nothing, so the order changes no bit.

``run_sweep`` returns the reference's keys: the per-round
``n_scheduled``/``b_t`` (A, rounds − t_start), the Theorem-1 ``budget``
and its ``rt_bound`` for ``obcsaa``, ``agg_err`` with the probe, the eval
streams ``eval_rounds``/``loss``/``accuracy`` (A, n_evals) with an
``eval_fn``, the final ``params`` stacked (A, ...), ``state`` (one
``EngineState`` per arm), ``arms`` and ``t_start``.

Checkpoints: with ``ckpt_dir`` a ``SweepCheckpoint`` is saved at every
chunk boundary (``checkpoint.save``: the carry of every arm stacked, each
generator's state as a uint8 leaf, the arms, ``t_next``); ``resume``
restores the latest step, puts each generator back in the state it had,
and continues bit for bit as the uninterrupted sweep would.

Over processes (``mesh=`` a ``launch.mesh.world_mesh``): the arm axis
is laid out as ``dist.sharding.infer_batch_sharding`` lays it out, split
over the worker axes where their product W divides A (worker d runs the
arms ``[d·A/W, (d+1)·A/W)``, the ranks of one model group the same
ones; W = 1, a world of one, is a split too) and replicated where it
does not. Each rank initialises, captures and runs only its own arms;
at each chunk boundary the chunk's stats and evals of every arm, and
the carries where a save or the result needs them, are gathered over
the worker group (``dist.collectives.gather_rows``), so every rank
returns the whole result. World rank 0 alone writes each checkpoint, in
the same format, with every arm; every rank waits for it on a barrier,
and the ranks that hold the same arms are checked equal at each save.
The gathers and the checks take their records on the device that the
group's backend takes (``collectives.wire_device``: the card under
NCCL, the CPU under gloo); the result and the checkpoint get them back
on the CPU. At restore every rank reads the whole checkpoint and takes
its own arms, so a sweep saved by W ranks resumes under any other
layout, one process included. Arms share nothing: the layout changes no
bit.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import checkpoint, tree
from repro_torch.core.sparsify import flatten_pytree
from repro_torch.device import resolve_device
from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import batch_indices
from repro_torch.engine.core import EngineFns, build_engine
from repro_torch.engine.graph import RoundGraph
from repro_torch.engine.state import (Arms, EngineState, RoundStats,
                                      SweepCheckpoint, arm_at, make_arms,
                                      n_arms, single_arm,
                                      with_generator_state)
from repro_torch.optim.optimizers import sgd
from repro_torch.theory.bounds import ErrorBudget


def eval_points(rounds: int, eval_every: int) -> List[int]:
    """Rounds after which the host evaluates: t % eval_every == 0 plus
    the final round."""
    return sorted({t for t in range(rounds) if t % eval_every == 0}
                  | {rounds - 1})


def chunk_spans(rounds: int, eval_every: Optional[int]) -> List[tuple]:
    """(t0, n) chunks whose ends land on the eval points; one chunk of
    every round when nothing is evaluated."""
    if not eval_every:
        return [(0, rounds)]
    spans, t0 = [], 0
    for t in eval_points(rounds, eval_every):
        spans.append((t0, t - t0 + 1))
        t0 = t + 1
    return spans


class Draws(NamedTuple):
    """Random draws that replace the arms' generators, for ``mode="host"``
    (how tests replay the reference's ``fold_in`` draws): per arm the
    initial fade draw (A, U) complex; per round the fade innovation
    (A, rounds, U) complex and the AWGN (A, rounds, ...), (n_chunks, S_c)
    for ``obcsaa`` and (D,) for ``topk_aa`` (``None`` for ``perfect``)."""
    fade0: torch.Tensor
    fade_w: torch.Tensor
    noise: Optional[torch.Tensor] = None


def _join(stats: List[RoundStats], join=torch.stack) -> RoundStats:
    """RoundStats joined field by field: rounds' 0-d stats with
    ``torch.stack``, chunks' (n,) stats with ``torch.cat``."""
    first = stats[0]
    budget = agg_err = None
    if first.budget is not None:
        budget = ErrorBudget(*(join(f) for f in
                               zip(*(s.budget for s in stats))))
    if first.agg_err is not None:
        agg_err = join([s.agg_err for s in stats])
    return RoundStats(n_scheduled=join([s.n_scheduled for s in stats]),
                      b_t=join([s.b_t for s in stats]),
                      budget=budget, agg_err=agg_err)


class EngineRun:
    """One built engine and its chunk runners.

    ``device=None`` means CUDA and raises without a card; pass
    ``device="cpu"`` to run the plain versions of the kernels. ``phi``
    injects the (S_c, D_c) measurement matrix, else it is drawn from
    ``cfg.obcsaa.phi_seed``. ``capture_log`` lists, per arm whose round
    this run captured, its warm-up and capture seconds, launch counts, the
    number of graphs in the round's program, and ``trips``, the extra ADMM
    chunks of each replayed round (filled as the replays run)."""

    def __init__(self, cfg, loss_fn: Callable, params, worker_data,
                 k_weights, eval_fn: Optional[Callable] = None,
                 optimizer=None, *, phi: Optional[torch.Tensor] = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.worker_data = {k: v.to(self.device)
                            for k, v in worker_data.items()}
        self.k_weights = torch.as_tensor(k_weights, dtype=torch.float32,
                                         device=self.device)
        self.opt = optimizer or sgd()
        self._params0 = {k: v.to(self.device) for k, v in params.items()}
        flat, unflatten = flatten_pytree(self._params0)
        self.D = int(flat.shape[0])
        ob = cfg.obcsaa
        self.phi = (ob.phi(self.device) if phi is None
                    else phi.to(self.device, torch.float32).contiguous())
        self.fns: EngineFns = build_engine(
            cfg, loss_fn, self.opt, self.D, int(self.k_weights.shape[0]),
            unflatten, phi=self.phi)
        self.mode = cfg.resolved_mode()
        self._graphs: Dict[tuple, RoundGraph] = {}
        self.capture_log: List[dict] = []

    def _on_device(self, arm: Arms) -> Arms:
        f32 = torch.float32
        return Arms(seed=arm.seed,
                    noise_var=arm.noise_var.to(self.device, f32),
                    p_max=arm.p_max.to(self.device, f32),
                    lr=arm.lr.to(self.device, f32))

    # -- one arm -----------------------------------------------------------

    def init(self, arm: Optional[Arms] = None, *,
             fade0_w: Optional[torch.Tensor] = None):
        """(state, arm on the device) for ``arm`` (default: the config's
        single arm); ``fade0_w`` replaces the initial fade draw."""
        arm = self._on_device(single_arm(self.cfg) if arm is None else arm)
        return self.fns.init_state(self._params0, arm, fade0_w), arm

    def run_chunk(self, state: EngineState, arm: Arms, t0: int, n: int):
        """Advance ``n`` rounds from round ``t0``. In scan mode on the card,
        by replaying the arm's CUDA graph (captured at its first chunk):
        the returned state's tensors are then the graph's static buffers,
        overwritten by the next chunk. In host mode, and on the CPU,
        eagerly, round by round. Returns (state', RoundStats of (n,)
        fields). The draws follow the generator's order, so ``t0`` only
        labels the chunk."""
        if self.device.type != "cuda" or self.mode == "host":
            return self._eager_chunk(state, arm, t0, n)
        key = (id(state.generator), id(arm))
        graph = self._graphs.get(key)
        if graph is None:
            graph = RoundGraph(self.fns.full_round, state, arm,
                               self.worker_data, self.k_weights)
            self._graphs[key] = graph
            self.capture_log.append({
                "warmup_s": graph.warmup_s, "capture_s": graph.capture_s,
                "warmup_launches": graph.warmup_launches,
                "captured": graph.captured, "graphs": len(graph.program),
                "trips": graph.trips})
        else:
            graph.load(state)
        return graph.state(), graph.run(n)

    def release(self, state: EngineState, arm: Arms) -> None:
        """Drop the CUDA graph of this arm, if one was captured."""
        self._graphs.pop((id(state.generator), id(arm)), None)

    def _eager_chunk(self, state, arm, t0: int, n: int,
                     draws: Optional[Draws] = None, a: int = 0):
        stats = []
        for t in range(t0, t0 + n):
            fade_w = noise = None
            if draws is not None:
                fade_w = draws.fade_w[a, t]
                if draws.noise is not None:
                    noise = draws.noise[a, t]
            state, st, _ = self.fns.full_round(
                state, arm, self.worker_data, self.k_weights,
                fade_w=fade_w, noise=noise)
            stats.append(st)
        return state, _join(stats)

    # -- checkpoints -------------------------------------------------------

    @staticmethod
    def _stack(items: list, device="cpu") -> tuple:
        """(leaves, treedef) of the trees ``items`` stacked (A, ...) on
        ``device``, leaf by leaf."""
        flats = [tree.flatten(x) for x in items]
        cols = zip(*(leaves for leaves, _ in flats))
        return ([torch.stack([x.detach().to(device) for x in col])
                 for col in cols], flats[0][1])

    def _unstacked(self, stacked: EngineState, arms) -> Dict[int, EngineState]:
        """Arms ``arms`` of a stacked carry as states on the run's device,
        each generator rebuilt from its state."""
        flat, treedef = tree.flatten(stacked)
        states = {}
        for a in arms:
            st = tree.unflatten(treedef, [x[a].clone().to(self.device)
                                          for x in flat])
            gen = torch.Generator(device=self.device)
            gen.set_state(st.generator.cpu())   # a view here crashes torch
            states[a] = st._replace(generator=gen)
        return states

    def sweep_template(self, arms: Arms) -> SweepCheckpoint:
        """The shape and dtype template of the sweep checkpoint, on the
        ``meta`` device (nothing allocated on the card), structurally what
        ``run_sweep`` saves, so ``checkpoint.restore`` checks it leaf by
        leaf before touching the carry."""
        A = n_arms(arms)
        state, _ = self.init(arm_at(arms, 0) if arms.noise_var.ndim
                             else arms)
        flat, treedef = tree.flatten(with_generator_state(state))
        meta = [torch.empty((A,) + tuple(x.shape), dtype=x.dtype,
                            device="meta") for x in flat]
        return SweepCheckpoint(
            state=tree.unflatten(treedef, meta), arms=arms,
            t_next=torch.empty((), dtype=torch.int32, device="meta"))

    def _restore_sweep(self, ckpt_dir: str, arms: Arms, own):
        """({arm: state} for the arms ``own``, t_start) from the latest
        checkpoint step, or None. The whole checkpoint is read,
        whoever wrote it. The saved arms must equal the requested ones bit
        for bit: a sweep resumed under other seeds, σ², P^Max or learning
        rates would mix two trajectories."""
        step = checkpoint.latest_step(ckpt_dir)
        if step is None:
            return None
        ck = checkpoint.restore(ckpt_dir, step, self.sweep_template(arms))
        for name, saved, want in zip(Arms._fields, ck.arms, arms):
            if not torch.equal(saved, want.cpu()):
                raise ValueError(
                    f"checkpoint {ckpt_dir!r} step {step} was written "
                    f"under different arms (field {name!r} differs); "
                    f"resuming would mix trajectories — pass the arms the "
                    f"sweep was started with")
        return self._unstacked(ck.state, own), int(ck.t_next)

    # -- arms sweep --------------------------------------------------------

    def run_sweep(self, arms: Arms, rounds: Optional[int] = None,
                  eval_every: Optional[int] = None, *,
                  ckpt_dir: Optional[str] = None,
                  resume: Optional[bool] = None, mesh=None,
                  draws: Optional[Draws] = None) -> Dict:
        """Run every arm for ``rounds`` rounds in chunks cut at the eval
        cadence (``run_chunk``: graph replays in scan mode on the card, the
        eager loop otherwise), chunk-major. ``ckpt_dir`` (or
        ``cfg.ckpt_dir``) saves a ``SweepCheckpoint`` at every chunk
        boundary, with its seconds in ``self.save_s``; ``resume`` (or
        ``cfg.ckpt_resume``) restores the latest step and continues, the
        streams then covering [t_start, rounds). ``mesh``: the arms over
        the processes of a ``world_mesh`` (see the module's docstring); a
        mesh without a world runs every arm here, as ``None`` does.
        ``draws`` replaces the generators' draws, in ``mode="host"``,
        indexed by the arm's place in ``arms``."""
        cfg = self.cfg
        rounds = rounds or cfg.rounds
        eval_every = eval_every if eval_every is not None \
            else (cfg.eval_every if self.eval_fn else None)
        ckpt_dir = ckpt_dir if ckpt_dir is not None else cfg.ckpt_dir
        resume = cfg.ckpt_resume if resume is None else resume
        if draws is not None and self.mode != "host":
            raise ValueError("run_sweep: injected draws replace the "
                             "generators in mode='host' only")
        A = n_arms(arms)
        spans = chunk_spans(rounds, eval_every)
        world = None if mesh is None else mesh.world
        own = batch_indices(A, mesh)
        # the worker group the arms are split over (W = 1 too: a world of
        # one gathers as any other), and the ranks that hold the same arms
        # as this one
        split = world is not None and A % coll.axis_size(mesh.group) == 0
        group = mesh.group if split else None
        replicas = mesh.model_group if split else world
        states, devarms = {}, {}
        for a in own:
            arm_a = arm_at(arms, a) if arms.noise_var.ndim else arms
            states[a], devarms[a] = self.init(
                arm_a, fade0_w=None if draws is None else draws.fade0[a])
        t_start = 0
        if resume:
            if not ckpt_dir:
                raise ValueError("run_sweep(resume=True) needs ckpt_dir "
                                 "(or FLConfig.ckpt_dir)")
            restored = self._restore_sweep(ckpt_dir, arms, own)
            if restored is not None:
                states, t_start = restored
        stats = [[] for _ in range(A)]
        losses = [[] for _ in range(A)]
        accs = [[] for _ in range(A)]
        eval_ts = []
        self.save_s = []
        for t0, n in spans:
            if t0 + n <= t_start:
                continue                    # chunk covered by the resume
            if t0 < t_start:
                raise ValueError(
                    f"checkpoint t_next={t_start} does not land on a chunk "
                    f"boundary for rounds={rounds}, eval_every={eval_every} "
                    f"— resume must use the cadence the sweep was saved "
                    f"with (boundary before it: t0={t0})")
            recs = []
            for a in own:
                if draws is None:
                    states[a], st = self.run_chunk(states[a], devarms[a],
                                                   t0, n)
                else:
                    states[a], st = self._eager_chunk(
                        states[a], devarms[a], t0, n, draws, a)
                rec = {"stats": st}
                if self.eval_fn:
                    rec["eval"] = tuple(torch.as_tensor(v).detach().cpu()
                                        for v in self.eval_fn(
                                            states[a].params))
                if ckpt_dir:
                    rec["carry"] = with_generator_state(states[a])
                recs.append(rec)
            recs = self._collect(recs, group)
            for a, rec in enumerate(recs):
                stats[a].append(rec["stats"])
                if self.eval_fn:
                    losses[a].append(rec["eval"][0])
                    accs[a].append(rec["eval"][1])
            eval_ts.append(t0 + n - 1)
            if ckpt_dir:
                t = time.perf_counter()
                self._save(ckpt_dir, t0 + n, [rec["carry"] for rec in recs],
                           arms, world, replicas)
                self.save_s.append(time.perf_counter() - t)
        for a in own:
            self.release(states[a], devarms[a])
        if group is not None:               # every arm's final carry here
            recs = self._collect([{"carry": with_generator_state(states[a])}
                                  for a in own], group)
            leaves, treedef = self._stack([rec["carry"] for rec in recs])
            states = self._unstacked(tree.unflatten(treedef, leaves),
                                     range(A))
        states = [states[a] for a in range(A)]
        joined = [_join(s, torch.cat) if s else None for s in stats]

        def host(get):
            if joined[0] is None:
                return np.zeros((A, 0), np.float32)
            return np.stack([get(s).detach().cpu().numpy() for s in joined])

        out = {"n_scheduled": host(lambda s: s.n_scheduled).astype(np.int32),
               "b_t": host(lambda s: s.b_t), "state": states,
               "params": {k: torch.stack([st.params[k] for st in states])
                          for k in states[0].params},
               "arms": arms, "t_start": t_start}
        assert out["n_scheduled"].shape == (A, rounds - t_start)
        if joined[0] is not None and joined[0].budget is not None:
            out["budget"] = ErrorBudget(*(host(lambda s, i=i: s.budget[i])
                                          for i in range(6)))
            out["rt_bound"] = np.asarray(out["budget"].rt())
        if joined[0] is not None and joined[0].agg_err is not None:
            out["agg_err"] = host(lambda s: s.agg_err)
        if self.eval_fn and eval_ts:
            out["eval_rounds"] = np.asarray(eval_ts)
            out["loss"] = np.stack([torch.stack(l).numpy() for l in losses])
            out["accuracy"] = np.stack([torch.stack(a).numpy()
                                        for a in accs])
        return out

    def _collect(self, recs: list, group) -> list:
        """Every arm's record (a tree of tensors) from the records of this
        rank's arms: gathered over the worker ``group`` in one
        ``gather_rows`` (counted as ``all_gather_arms``) on the device its
        backend takes, returned on the CPU; no group: ``recs``, every
        arm's already."""
        if group is None:
            return recs
        leaves, treedef = self._stack(recs, coll.wire_device(group,
                                                             self.device))
        got = [x.cpu() for x in coll.gather_rows(leaves, group,
                                                 kind="all_gather_arms")]
        return [tree.unflatten(treedef, [x[a] for x in got])
                for a in range(int(got[0].shape[0]))]

    def _save(self, ckpt_dir: str, step: int, carries: list, arms: Arms,
              world, replicas) -> None:
        """Save every arm's carry at ``step``: world rank 0 alone writes,
        from the CPU; the ranks that hold the same arms are checked equal
        first, on the device their group's backend takes, and every rank
        waits on a barrier over the world for the step to be on disk."""
        leaves, treedef = self._stack(
            carries, "cpu" if replicas is None
            else coll.wire_device(replicas, self.device))
        if not coll.replicated(leaves, replicas):
            raise RuntimeError(
                f"run_sweep: the ranks that hold the same arms differ at "
                f"the save of step {step}")
        if coll.axis_index(world) == 0:
            checkpoint.save(ckpt_dir, step, SweepCheckpoint(
                state=tree.unflatten(treedef, [x.cpu() for x in leaves]),
                arms=arms, t_next=torch.tensor(step, dtype=torch.int32)))
        coll.barrier(world)


def run_sweep(cfg, loss_fn, params, worker_data, k_weights, *,
              arms: Optional[Arms] = None, eval_fn=None, optimizer=None,
              rounds: Optional[int] = None,
              eval_every: Optional[int] = None,
              ckpt_dir: Optional[str] = None,
              resume: Optional[bool] = None, mesh=None, phi=None,
              device=None, draws: Optional[Draws] = None,
              **arm_axes) -> Dict:
    """One-call sweep: build the engine, broadcast ``arm_axes`` (seeds /
    noise_var / p_max / lr) into ``Arms`` and run them. See
    ``EngineRun.run_sweep`` for the result."""
    run = EngineRun(cfg, loss_fn, params, worker_data, k_weights,
                    eval_fn=eval_fn, optimizer=optimizer, phi=phi,
                    device=device)
    arms = arms if arms is not None else make_arms(cfg, **arm_axes)
    return run.run_sweep(arms, rounds=rounds, eval_every=eval_every,
                         ckpt_dir=ckpt_dir, resume=resume, mesh=mesh,
                         draws=draws)
