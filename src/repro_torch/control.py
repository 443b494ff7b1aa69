"""Data-dependent control flow that a CUDA-graph capture can cut at.

A loop that runs until a tensor says stop, or a branch taken when a
tensor says so, reads that tensor on the host; a CUDA graph cannot hold
such a read. ``while_loop`` and ``cond`` run eagerly by default (the host
reads the predicate, as ``bool(pred)`` does anywhere). Inside
``SegmentedCapture`` they cut the capture instead: one Python pass over
the code records a *program* of CUDA graphs,

    ("run", g)          replay g
    ("while", flag, g)  replay g while the 0-d bool ``flag`` is true
    ("if", flag, g)     replay g once if ``flag`` is true

that ``replay`` runs with one small device-to-host read per ``while``
test and per ``if``. The graphs compute what the eager pass computes, on
the same kernels, so a replayed program gives the eager pass's bits. The
loop carry becomes static buffers that the body graph updates in place,
and a branch's result a static buffer that holds ``otherwise`` unless the
branch ran.

PyTorch's CUDA graphs (2.11) have no conditional node: with one, the same
program would need no host read. Here a program that has no ``while`` or
``if`` is one graph, replayed once.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

_ACTIVE = None      # the SegmentedCapture in progress, if any


def while_loop(pred_fn: Callable, body_fn: Callable,
               carry: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """``while pred_fn(carry): carry = body_fn(carry)``; ``carry`` is a
    tuple of tensors and ``pred_fn`` returns a 0-d bool tensor."""
    if _ACTIVE is not None:
        return _ACTIVE.while_loop(pred_fn, body_fn, carry)
    while bool(pred_fn(carry)):
        carry = body_fn(carry)
    return carry


def cond(pred: torch.Tensor, fn: Callable[[], torch.Tensor],
         otherwise: torch.Tensor) -> torch.Tensor:
    """``fn()`` if the 0-d bool ``pred`` is true, else ``otherwise``;
    ``fn()`` returns a tensor of ``otherwise``'s shape and type."""
    if _ACTIVE is not None:
        return _ACTIVE.cond(pred, fn, otherwise)
    return fn() if bool(pred) else otherwise


class SegmentedCapture:
    """Capture what runs inside ``with`` as a program of CUDA graphs, cut
    at each ``while_loop`` and ``cond``. Every graph is captured on
    ``stream`` in its own memory pool, with ``generators`` registered, so
    that each replay reads and advances their Philox offsets as the eager
    calls do. A capture error raises; nothing runs eagerly instead."""

    def __init__(self, stream: torch.cuda.Stream,
                 generators: Sequence[torch.Generator] = ()):
        self.stream = stream
        self.generators = list(generators)
        self.program: List[tuple] = []
        self._graph = None

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("SegmentedCapture does not nest")
        self._ctx = torch.cuda.stream(self.stream)
        self._ctx.__enter__()
        _ACTIVE = self
        try:
            self._begin()
        except BaseException:
            _ACTIVE = None
            self._ctx.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, exc_type, exc, tb):
        global _ACTIVE
        _ACTIVE = None
        try:
            if exc_type is None:
                self._end("run", None)
            elif self._graph is not None:
                try:    # leave the stream out of capture; the error stands
                    self._graph.capture_end()
                except RuntimeError:
                    pass
        finally:
            self._ctx.__exit__(exc_type, exc, tb)
        return False

    def _begin(self) -> None:
        g = torch.cuda.CUDAGraph()
        for gen in self.generators:
            g.register_generator_state(gen)
        g.capture_begin()
        self._graph = g

    def _end(self, kind: str, flag) -> None:
        self._graph.capture_end()
        self.program.append((kind, flag, self._graph))
        self._graph = None

    def while_loop(self, pred_fn, body_fn, carry):
        carry = tuple(t.clone() for t in carry)     # one buffer per leaf
        flag = pred_fn(carry).clone()
        self._end("run", None)
        self._begin()
        for dst, src in zip(carry, body_fn(carry)):
            dst.copy_(src)
        flag.copy_(pred_fn(carry))
        self._end("while", flag)
        self._begin()
        return carry

    def cond(self, pred, fn, otherwise):
        out = otherwise.clone()
        flag = pred.clone()
        self._end("run", None)
        self._begin()
        out.copy_(fn())
        self._end("if", flag)
        self._begin()
        return out


def replay(program: Sequence[tuple]) -> List[int]:
    """Run a captured program; returns how many times each ``while`` body
    ran, in program order."""
    trips = []
    for kind, flag, graph in program:
        if kind == "run":
            graph.replay()
        elif kind == "while":
            n = 0
            while bool(flag):
                graph.replay()
                n += 1
            trips.append(n)
        elif bool(flag):
            graph.replay()
    return trips
