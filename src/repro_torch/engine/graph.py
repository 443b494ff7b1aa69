"""One arm's round captured as CUDA graphs and replayed once per round:
the port's counterpart of the reference's ``lax.scan`` chunk
(``repro/engine/runner.py``'s ``_chunk_fn``).

``RoundGraph`` owns the arm's carry as static tensors — every leaf of the
``EngineState`` but the generator, walked by ``repro_torch.tree``:
parameters, optimizer state (momentum's moments; Adam's moments and its
step counter, which the graph increments), fade state, previous β, the
decoder's warm start, the EF residuals and the ADMM multipliers — and a
stats buffer on the card. Its capture runs ``EngineFns.full_round`` on
the carry, copies the new carry over the old in place, and writes the
round's stats into the next row of the buffer (a slot counter on the
card, advanced in the graph). The host reads the buffer only at the end
of a chunk.

The capture is a ``control.SegmentedCapture``. Under ``all`` and
``greedy_batched`` nothing in the round tests a tensor on the host, and
the round is one graph, replayed once. Under ``admm_batched`` the round
holds ADMM's convergence loop and its polish test; the capture is cut
there, and a round replays: the fade draw, the solver's start and its
first chunk of 8 outer iterations; one more chunk while a lane still runs
(a one-byte read after each); the projection; the polish if a lane needs
it (one more read); the rest of the round. Usually that is four graph
launches and two reads. PyTorch 2.11's CUDA graphs have no conditional
node that would keep this on the card.

Capture, in order:

1. warm-up: ``WARMUP`` eager rounds on the capture stream, so that the
   kernels are built and loaded, cuBLAS and autograd have set up, and the
   stats buffer exists: nothing is built or allocated lazily under capture.
   Every capture on a device shares one side stream (``capture_stream``):
   cuBLAS keeps a 32 MiB workspace for each stream it has run on, for the
   life of the process, so a stream of its own per arm kept 64 MiB an arm
   (the forward's and the backward's threads) after the sweep;
2. the carry and the arm's generator state are put back as they were
   before the warm-up, so the warm-up consumes no draw the host path
   would not make;
3. the generator is registered with each graph (its Philox seed and
   offset are read on the card at each replay, and each replay advances
   the offset by what that graph draws), and one round is captured.

A capture that fails raises; nothing falls back to running the round
eagerly. The kernel wrappers count a launch when they are called, which
under capture records it and runs nothing; so the capture's counts are
taken back, and every replay adds them again (``kernels.build``).
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from repro_torch import control, tree
from repro_torch.engine.state import Arms, EngineState, RoundStats
from repro_torch.kernels import build
from repro_torch.theory.bounds import ErrorBudget

_STREAMS: Dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every capture on ``device`` runs on, made at the
    first."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


def _diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


class RoundGraph:
    """``full_round`` of one arm as CUDA graphs over a static carry."""

    WARMUP = 2      # eager rounds before the capture
    CAP = 256       # rounds the stats buffer holds between host reads

    def __init__(self, full_round, state: EngineState, arm: Arms,
                 worker_data, k_weights):
        self.device = state.fade.device
        self._full_round = full_round
        self.arm = arm
        self.worker_data = worker_data
        self.k_weights = k_weights
        self.generator = state.generator
        leaves, self._treedef = tree.flatten(
            state._replace(generator=None))
        self._leaves = [t.detach().clone() for t in leaves]
        self._fade = self.state().fade      # load()'s test for our own carry
        self.slot = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self.buf = None         # (CAP, n_stats) f32, made in the warm-up
        self.has_budget = self.has_err = False
        self.program: List[tuple] = []      # control.replay's graphs
        self.trips: List[int] = []  # extra ADMM chunks, per replayed round
        self.warmup_launches: Dict[str, int] = {}
        self.captured: Dict[str, int] = {}
        self.warmup_s = self.capture_s = 0.0
        self._capture()

    # -- the carry ---------------------------------------------------------

    def state(self) -> EngineState:
        """The carry as an ``EngineState``: these tensors are the graph's
        static buffers, which every replay overwrites in place."""
        return tree.unflatten(self._treedef, self._leaves)._replace(
            generator=self.generator)

    def load(self, state: EngineState) -> None:
        """Copy a carry into the static buffers (no-op for our own)."""
        if state.fade is self._fade:
            return
        if state.generator is not self.generator:
            raise ValueError("RoundGraph.load: the state belongs to another "
                             "arm's generator")
        self._copy_in(state)

    def _copy_in(self, state: EngineState) -> None:
        for dst, src in zip(self._leaves,
                            tree.leaves(state._replace(generator=None))):
            dst.copy_(src)

    # -- one round ---------------------------------------------------------

    def _step(self) -> None:
        new, stats, _ = self._full_round(self.state(), self.arm,
                                         self.worker_data, self.k_weights)
        self._copy_in(new)
        fields = [stats.n_scheduled.to(torch.float32), stats.b_t]
        if stats.budget is not None:
            fields += list(stats.budget)
        if stats.agg_err is not None:
            fields.append(stats.agg_err)
        row = torch.stack(fields)
        if self.buf is None:                   # first warm-up round only
            self.has_budget = stats.budget is not None
            self.has_err = stats.agg_err is not None
            self.buf = torch.zeros((self.CAP, row.numel()),
                                   device=self.device)
        self.buf.index_copy_(0, self.slot, row[None])
        self.slot.add_(1)

    def _capture(self) -> None:
        saved = [t.clone() for t in self._leaves]
        gen_state = self.generator.get_state()
        stream = capture_stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        t0 = time.perf_counter()
        before = build.launch_counts()
        with torch.cuda.stream(stream):
            for _ in range(self.WARMUP):
                self._step()
        torch.cuda.synchronize(self.device)
        self.warmup_launches = _diff(build.launch_counts(), before)
        self.warmup_s = time.perf_counter() - t0
        for dst, src in zip(self._leaves, saved):
            dst.copy_(src)
        # the warm-up made the stats buffer on the capture stream; make
        # the kept one on the caller's, where the replays run
        self.buf = torch.zeros_like(self.buf)
        self.slot.zero_()
        self.generator.set_state(gen_state)
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                "this PyTorch cannot capture draws from a torch.Generator "
                "other than the default one (torch.cuda.CUDAGraph has no "
                "register_generator_state); use FLConfig(mode='host')")
        t0 = time.perf_counter()
        before = build.launch_counts()
        torch.cuda.synchronize(self.device)
        with control.SegmentedCapture(stream, [self.generator]) as cap:
            self._step()
        self.program = cap.program
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.captured = _diff(build.launch_counts(), before)
        build.set_launch_counts(before)     # recorded, not launched
        self.generator.set_state(gen_state)

    # -- replay ------------------------------------------------------------

    def run(self, n: int) -> RoundStats:
        """Replay ``n`` rounds; their stats as (n,) tensors on the card."""
        rows = []
        for done in range(0, n, self.CAP):
            k = min(self.CAP, n - done)
            self.slot.zero_()
            for _ in range(k):
                self.trips.append(sum(control.replay(self.program)))
            build.add_launches(self.captured, k)
            rows.append(self.buf[:k].clone())
        return self._stats(torch.cat(rows) if rows else
                           self.buf[:0].clone())

    def _stats(self, rows: torch.Tensor) -> RoundStats:
        budget = agg_err = None
        if self.has_budget:
            budget = ErrorBudget(*(rows[:, 2 + i] for i in range(6)))
        if self.has_err:
            agg_err = rows[:, -1]
        return RoundStats(n_scheduled=rows[:, 0].to(torch.int32),
                          b_t=rows[:, 1], budget=budget, agg_err=agg_err)
