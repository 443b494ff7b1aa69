"""Full FL rounds at model-zoo scale; port of ``repro/engine/zoo.py``.

The scan engine (``engine/core.py``) holds every worker's gradient as a
dense (U, D) tensor, which is hopeless at ≥1B parameters. This module
runs the same round (eq. 3 local gradients → eq. 6-7 compression → eq. 10
power scaling → eq. 12-13 MAC and AWGN → eq. 43 decode → eq. 14 update)
with nothing of size U·D ever held:

* Parameters live chunked, as a (n_chunks, D_c) f32 tensor. The chunk
  count is padded so that the mesh (``launch/mesh.ZooMesh``) splits it
  evenly: model-major, the cell (worker d, model m) owns the chunk rows
  ``m·n_half + d·n_local`` (n_half = n_chunks / n_model,
  n_local = n_half / n_workers), as in the reference.
* Worker d compresses its gradient over each model half m a block at a
  time, the blocks cut relative to each cell's rows: rows
  ``m·n_half + o·n_local + k·block_rows`` onward for every owner o. The
  compressed uplink is tiny (one uint32 word a chunk at S_c = 32 when
  ``ob.packed``) and is superposed as the exact int32 lane sums of the
  reference's packed MAC. Then cell (d, m) decodes its own n_local rows
  and updates them in place.
* Work goes in blocks of ``block_rows`` chunk rows, sized by bytes
  (``BLOCK_BYTES`` of f32 a block). The reference's ``block`` and
  ``block_dec`` (the largest divisor of n_half and n_local under
  ``block_chunks``) pin XLA's compiled loop shape; they are kept as
  attributes, but rows are independent in compression, decode and
  update, so the port's blocks need not divide anything.

Two ways to run the cells. On a mesh without a ``world`` they run in
turn in one process, and the round is its own single-device oracle
(``reference_round`` is the same round on a copy). On a mesh of
``launch.mesh.world_mesh`` every cell is a rank and holds only its own
n_local rows (``shard_params``); each round, as the reference's
``shard_map`` body (``zoo.py:296-336``):

1. the rank gathers its half's rows over the worker group, a block of
   every owner's rows at a time (never the half whole), and takes its
   worker's gradient on them (the surrogate, or the one handed in);
2. compresses them in the same blocks as the in-turn path;
3. superposes them through ``collectives.psum_bits_mac`` over the worker
   group (exact int32 lane sums); ``ksum`` and ``mag_sum`` go through
   ``psum`` over the same group;
4. draws the round's full (n_chunks, S_c) AWGN field, as every rank does
   from the same generator, and takes its own rows;
5. decodes and updates its own rows in place. ‖ĝ‖² is the ``psum`` of
   the ranks' parts over the world.

With two workers every f32 sum over the worker group adds two terms,
which commute exactly, so the ranks' round equals the in-turn round bit
for bit; with more, the all-reduce's order may move the magnitude sums
by ulps.

Gradients are real ones handed in as (U, n_chunks, D_c)
(``round_from_grads``) or the surrogate of ½‖p − c_u‖² whose anchors c_u
hash the global element index (``_surrogate_grads``), exact against the
reference: an integer splitmix hash computed in int64 and cut to 32 bits
after every multiply and shift.

Every draw of a round can be injected (``ZooDraws``: the fades h (U,)
and the standard normal AWGN field z (n_chunks, S_c), scaled by √σ² in
the round). Otherwise they come from a generator seeded by (key, t), the
absolute round index, so a resume needs no generator state; the port does
not replicate threefry, and parity tests inject the reference's
``fold_in(key, t)`` draws.

``round_gen`` and ``round_from_grads`` update ``params`` in place and
return it. ``hook(stage, **info)``, when given, is called where a piece
of a stage ends ("gather" over processes, "compress", "mac", "decode",
"update"; the zoo-train round adds "backward"), so CUDA events can split
a round's time; "mac" passes the MAC sums before the AWGN (``y_sum``,
the exact int32 lane sums under ``ob.packed``, and ``mag_sum``: over
processes those of this rank's half).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.obcsaa import (OBCSAAConfig, compress_chunks,
                                     reconstruct_chunks)
from repro_torch.core import channel as chan
from repro_torch.core.sparsify import flatten_pytree
from repro_torch.device import resolve_device
from repro_torch.dist import collectives as coll
from repro_torch.engine.core import budget_geometry
from repro_torch.kernels.sign import unpack_bits
from repro_torch.launch.mesh import num_workers, worker_axes
from repro_torch.sched.admm import admm_solve_batched_jit
from repro_torch.sched.greedy import greedy_solve_batched
from repro_torch.sched.problem import BatchedProblem
from repro_torch.theory.bounds import (AnalysisConstants, ErrorBudget,
                                       error_budget)

#: f32 bytes of one block of chunk rows: a block's temporaries (the
#: surrogate hash's int64 index, the top-κ selection, the decode iterate)
#: are a few times this.
BLOCK_BYTES = 1 << 28

_M32 = 0xFFFFFFFF


class ZooStats(NamedTuple):
    """Per-round diagnostics of one zoo round."""
    n_scheduled: torch.Tensor           # |M_t| (i32)
    b_t: torch.Tensor                   # eq. 10 power scale (f32)
    ghat_norm: torch.Tensor             # ‖ĝ_t‖ over the full vector (f32)
    budget: Optional[ErrorBudget]       # Theorem-1 eq. 19 terms


class ZooDraws(NamedTuple):
    """One round's draws: fade magnitudes h (U,) and the standard normal
    AWGN field z (n_chunks, S_c)."""
    h: torch.Tensor
    z: torch.Tensor


def round_seed(key: int, t: int) -> int:
    """The generator seed of round t under ``key``: a splitmix64 of the
    two, so every round's draws depend only on (key, t)."""
    x = (int(key) * 0x9E3779B97F4A7C15 + int(t) + 1) & (2 ** 64 - 1)
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return (x ^ (x >> 31)) & (2 ** 63 - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x · c mod 2³² for int64 x in [0, 2³²): the constant split in 16-bit
    halves keeps every product below 2⁴⁹."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_u01(idx: torch.Tensor, widx: int, t: int) -> torch.Tensor:
    """U(0,1) from (global element index, worker, round): the reference's
    splitmix-style uint32 hash, in int64 cut to 32 bits after every
    multiply and shift. ``idx`` holds values in [0, 2³²)."""
    x = _mul32(idx.to(torch.int64) & _M32, 0x9E3779B1)
    x = x ^ (((int(widx) + 1) * 0x85EBCA77) & _M32)
    x = x ^ (((int(t) + 1) * 0xC2B2AE3D) & _M32)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x85EBCA77)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE3D)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (2.0 ** -24)


def param_spec(mesh) -> tuple:
    """Partition spec of the chunked (n_chunks, D_c) parameters: the
    chunk axis over model-major ``("model",) + worker_axes``."""
    parts = (("model",) if "model" in mesh.axis_names else ()) \
        + worker_axes(mesh)
    return (parts if len(parts) > 1 else parts[0], None)


def grads_spec(mesh) -> tuple:
    """Partition spec of a (U, n_chunks, D_c) per-worker gradient:
    workers over the worker axes, chunks over the model axis."""
    waxes = worker_axes(mesh)
    w = waxes if len(waxes) > 1 else waxes[0]
    m = "model" if "model" in mesh.axis_names else None
    return (w, m, None)


def _surrogate_d(D: int) -> None:
    raise ValueError(
        f"ZooRound(D={D}): the zoo surrogate hashes uint32 element "
        "indices, so D must stay below 2**32 (a 64-bit index path "
        "is the escape hatch)")


class ZooRound:
    """One zoo round for (ob, D, mesh). See module docstring.

    ``round_gen(params, t, key, noise_var, p_max, lr)`` and
    ``round_from_grads(params, grads, t, ...)`` take the (n_chunks, D_c)
    f32 tensor of :meth:`chunk_params` (over processes: this rank's
    (n_local, D_c) rows, :meth:`shard_params`) and update it in place;
    ``key`` is an int seed, ``draws`` a ``ZooDraws`` that replaces the
    round's draws. ``phi`` replaces Φ (the port draws its own from
    ``ob.phi_seed``, not the reference's bits)."""

    #: whether the round is built for the surrogate, whose uint32 element
    #: hash caps D below 2**32 (a round fed real gradients needs no cap)
    SURROGATE = True

    def __init__(self, ob: OBCSAAConfig, D: int, mesh, *,
                 scheduler: str = "all",
                 const: Optional[AnalysisConstants] = None,
                 sched_cfg=None, grad_scale: float = 0.05,
                 block_chunks: int = 64, n_chunks: Optional[int] = None,
                 device=None, phi: Optional[torch.Tensor] = None):
        if D >= 2 ** 32 and self.SURROGATE:
            _surrogate_d(D)
        self.ob, self.D, self.mesh = ob, int(D), mesh
        # over processes: this rank's cell and the mesh's groups
        self.world = getattr(mesh, "world", None)
        self.wgroup = getattr(mesh, "group", None)
        self.mgroup = getattr(mesh, "model_group", None)
        self.device = resolve_device(device)
        self.waxes = worker_axes(mesh)
        self.U = num_workers(mesh)
        self.n_model = int(mesh.shape.get("model", 1))
        self.grad_scale = float(np.float32(grad_scale))
        self.scheduler = scheduler
        if scheduler not in ("all", "greedy_batched", "admm_batched",
                             "admm_batched_jit"):
            raise ValueError(f"zoo scheduler {scheduler!r} must be "
                             "jittable: all | greedy_batched | admm_batched")
        self.const = const or AnalysisConstants()
        self.sched_cfg = sched_cfg
        # chunk count padded so every cell owns an equal block; callers
        # with their own flat layout (zoo-train) pass n_chunks explicitly
        gran = self.n_model * self.U
        if n_chunks is None:
            n_raw = -(-self.D // ob.chunk)
            n_chunks = -(-n_raw // gran) * gran
        elif n_chunks % gran or n_chunks * ob.chunk < self.D:
            raise ValueError(
                f"ZooRound(n_chunks={n_chunks}): with OBCSAAConfig.chunk="
                f"{ob.chunk} the chunk count must cover D={self.D} and "
                f"divide evenly over the mesh granularity {gran} "
                f"(= model {self.n_model} x workers {self.U}); every "
                "device owns a whole chunk block (DESIGN.md §14)")
        self.n_chunks = n_chunks
        self.D_pad = self.n_chunks * ob.chunk
        self.n_half = self.n_chunks // self.n_model
        self.n_local = self.n_half // self.U
        self.block = next(b for b in range(min(block_chunks, self.n_half),
                                           0, -1) if self.n_half % b == 0)
        self.block_dec = next(b for b in range(min(block_chunks,
                                                   self.n_local),
                                               0, -1) if self.n_local % b == 0)
        self.block_rows = max(1, BLOCK_BYTES // (4 * ob.chunk))
        self.cell = mesh.cell() if self.world is not None else None
        if self.cell is not None:
            d, m = self.cell
            self.half0 = m * self.n_half
            self.row0 = self.half0 + d * self.n_local
        self.spec = param_spec(mesh)
        self.grads_spec = grads_spec(mesh)
        _, s_eff, kappa_eff = budget_geometry(ob, self.D_pad)
        self._s_eff, self._kappa_eff = s_eff, kappa_eff
        self._kw = torch.ones((self.U,), dtype=torch.float32,
                              device=self.device)
        self.phi = (ob.phi(self.device) if phi is None
                    else torch.as_tensor(phi).to(self.device, torch.float32))

    # -- host-side layout helpers ------------------------------------------

    def chunk_params(self, params) -> torch.Tensor:
        """Flat (D,) tensor or pytree -> padded f32 (n_chunks, D_c) on the
        round's device."""
        flat = params if isinstance(params, torch.Tensor) \
            and params.ndim == 1 else flatten_pytree(params)[0]
        out = torch.zeros((self.n_chunks, self.ob.chunk),
                          dtype=torch.float32, device=self.device)
        out.view(-1)[:self.D] = flat
        return out

    def shard_params(self, chunked) -> torch.Tensor:
        """The (n_chunks, D_c) chunks on the round's device; over
        processes a copy of this rank's own (n_local, D_c) rows."""
        chunked = torch.as_tensor(chunked)
        if self.cell is None:
            return chunked.to(self.device)
        return chunked[self.row0:self.row0 + self.n_local].to(
            self.device, copy=True)

    def chunk_worker_grads(self, grads) -> torch.Tensor:
        """(U, D) per-worker grads -> (U, n_chunks, D_c) f32. U must equal
        the mesh's worker count: the FL workers are the worker-axis
        cells."""
        g = torch.as_tensor(grads).to(self.device, torch.float32)
        if tuple(g.shape) != (self.U, self.D):
            raise ValueError(f"chunk_worker_grads: grads {tuple(g.shape)} "
                             f"!= (U, D) = ({self.U}, {self.D})")
        g = torch.nn.functional.pad(g, (0, self.D_pad - self.D))
        return g.reshape(self.U, self.n_chunks, self.ob.chunk)

    def unchunk(self, chunked) -> torch.Tensor:
        """(n_chunks, D_c) -> flat (D,) (drops the padding)."""
        return torch.as_tensor(chunked).reshape(-1)[:self.D]

    # -- round pieces ------------------------------------------------------

    def cells(self):
        """(worker u, model shard m, first row of half m) in the order
        the card runs the cells; cell (u, m) decodes rows
        ``m·n_half + u·n_local`` onward."""
        for u in range(self.U):
            for m in range(self.n_model):
                yield u, m, m * self.n_half

    def _blocks(self, r0: int, n: int):
        for a in range(r0, r0 + n, self.block_rows):
            yield a, min(a + self.block_rows, r0 + n)

    def _half_blocks(self, m: int):
        """The compression blocks of model half m: each owner's n_local
        rows in blocks of ``block_rows``, owner by owner (the cut the
        ranks make when they gather a block of every owner's rows)."""
        for o in range(self.U):
            yield from self._blocks(m * self.n_half + o * self.n_local,
                                    self.n_local)

    def draws(self, key: int) -> Callable[[int], ZooDraws]:
        """The round's own draws under ``key``: round t -> its draws from
        a generator on the round's device seeded by ``round_seed(key,
        t)``, the fades first, then the AWGN field."""
        def draw(t: int) -> ZooDraws:
            gen = torch.Generator(device=self.device).manual_seed(
                round_seed(key, t))
            h, _ = chan.draw_fades(gen, (self.U,), device=self.device)
            z = torch.randn((self.n_chunks, self.ob.measure), generator=gen,
                            device=self.device)
            return ZooDraws(h=h, z=z)

        return draw

    def _schedule(self, h, noise_var, p_max):
        """P2 at this round's channels (eq. 24), as the scan engine
        schedules it (``engine/core.py``)."""
        ob = self.ob
        bp = BatchedProblem.from_arrays(
            h[None], self._kw[None], p_max, noise_var, D=self.D,
            S=ob.measure, kappa=ob.topk, const=self.const,
            device=self.device)
        if self.scheduler == "all":
            beta = torch.ones_like(bp.h)
            b_t = bp.optimal_bt(beta)
        elif self.scheduler == "greedy_batched":
            beta, b_t, _ = greedy_solve_batched(bp, self.sched_cfg)
        else:
            beta, b_t, _ = admm_solve_batched_jit(bp, self.sched_cfg)
        return beta[0], b_t[0]

    def _prologue(self, t, key, noise_var, p_max, draws):
        """(β, b_t, z) of round t: the draws (injected, or the generator's
        for (key, t)), then the schedule."""
        dr = draws if draws is not None else self.draws(key)(int(t))
        h = torch.as_tensor(dr.h).to(self.device, torch.float32)
        beta, b_t = self._schedule(h, noise_var, p_max)
        z = torch.as_tensor(dr.z).to(self.device, torch.float32)
        if tuple(z.shape) != (self.n_chunks, self.ob.measure):
            raise ValueError(f"ZooDraws.z has shape {tuple(z.shape)}, the "
                             f"round needs (n_chunks, S_c) = "
                             f"({self.n_chunks}, {self.ob.measure})")
        return beta, b_t, z

    def _surrogate_grads(self, p_blk, chunk_off: int, widx: int, t: int):
        """Worker ``widx``'s gradient of ½‖p − c_u‖² on a block of chunk
        rows starting at global row ``chunk_off``: g = p − c_u, anchors
        c_u = grad_scale·(U(0,1) − ½) hashed from the global element
        index (uint32, as the reference's, wrapping). Elements at index ≥
        D get zero gradients."""
        nb, dc = p_blk.shape
        rows = torch.arange(nb, dtype=torch.int64, device=p_blk.device)
        cols = torch.arange(dc, dtype=torch.int64, device=p_blk.device)
        idx = (((int(chunk_off) + rows) & _M32)[:, None] * dc
               + cols[None, :]) & _M32
        c = self.grad_scale * (_hash_u01(idx, widx, t) - 0.5)
        return torch.where(idx < self.D, p_blk - c, torch.zeros_like(p_blk))

    def _upload(self, worker_rows, beta, b_t, hook=None, compress=None):
        """Every cell's compression, superposed over the MAC (eq. 12).

        ``worker_rows(u)`` returns worker u's ``rows(r0, r1)``, its f32
        gradient rows. Cell (u, m) compresses rows of model half m, a
        block at a time, through ``compress(u, rows, r0)`` (default:
        ``compress_chunks``, eq. 6-7). With ``ob.packed`` the sum is the exact int32
        Σ_u β_u·(2·bit − 1) (times b_t after); otherwise Σ_u (β_u·b_t)·s_u
        in f32. Returns (y_sum (n_chunks, S_c), mag_sum (n_chunks,)),
        ``mag_sum = Σ_u β_u·‖sparse_u‖``."""
        ob = self.ob
        compress = compress or (
            lambda u, rows, r0: compress_chunks(ob, rows, self.phi))
        S, dev = ob.measure, self.device
        y = torch.zeros((self.n_chunks, S), device=dev,
                        dtype=torch.int32 if ob.packed else torch.float32)
        mag_sum = torch.zeros((self.n_chunks,), dtype=torch.float32,
                              device=dev)
        beta_int = beta.to(torch.int32)
        for u in range(self.U):
            rows_of = worker_rows(u)
            for m in range(self.n_model):
                for a, b in self._half_blocks(m):
                    signs, mags = compress(u, rows_of(a, b), a)
                    if ob.packed:
                        y[a:b] += (2 * unpack_bits(signs, torch.int32) - 1) \
                            * beta_int[u]
                    else:
                        y[a:b] += (beta[u] * b_t) * signs
                    mag_sum[a:b] += beta[u] * mags
                    if hook is not None:
                        hook("compress")
        return y, mag_sum

    def _gathered(self, local, hook=None):
        """Over processes: this rank's half, gathered over the worker
        group a block of every owner's rows at a time, as (first global
        row, rows) pairs in ``_half_blocks``' cut."""
        for a, b in self._blocks(0, self.n_local):
            parts = coll.all_gather(local[a:b], self.wgroup)
            if hook is not None:
                hook("gather")
            for o in range(self.U):
                yield self.half0 + o * self.n_local + a, parts[o]

    def _upload_procs(self, blocks, beta, b_t, hook=None, compress=None):
        """Over processes: this rank's worker's compression of its model
        half (``blocks()`` yields (first global row, f32 gradient rows)),
        superposed over the worker group (eq. 12): the exact int32 lane
        sums of ``psum_bits_mac`` under ``ob.packed``, else the f32
        ``psum`` of (β·b_t)·s. Returns the half's (y_sum (n_half, S_c),
        mag_sum (n_half,))."""
        ob = self.ob
        compress = compress or (
            lambda u, rows, r0: compress_chunks(ob, rows, self.phi))
        d, _ = self.cell
        signs = None
        mags = torch.zeros((self.n_half,), dtype=torch.float32,
                           device=self.device)
        for a, rows in blocks():
            s, mg = compress(d, rows, a)
            if signs is None:
                signs = s.new_empty((self.n_half,) + tuple(s.shape[1:]))
            lo = a - self.half0
            signs[lo:lo + rows.shape[0]] = s
            mags[lo:lo + rows.shape[0]] = mg
            if hook is not None:
                hook("compress")
        if ob.packed:
            y = coll.psum_bits_mac(signs, self.wgroup, beta_i=beta[d])
        else:
            y = coll.psum((beta[d] * b_t) * signs, self.wgroup)
        return y, coll.psum(beta[d] * mags, self.wgroup)

    def _mac_decode(self, y_sum, mag_sum, beta, b_t, z, noise_var, apply,
                    hook=None):
        """MAC + decode of every round body: post-processing (eq. 12-13),
        (y + AWGN) / (Σβ·b_t) and the mean transmitted magnitude, then
        the decode (eq. 43), whose rows ``apply(a, b, ghat_rows)``
        updates: the update is the caller's, so the stateful optimizers
        (``engine/zoo_train.py``) reuse this path. In one process the
        rows are global and every cell's are decoded; over processes
        ``y_sum``/``mag_sum`` are the half's, the rank decodes its own
        rows and ``apply`` gets local ones. Returns ‖ĝ‖² over the full
        vector."""
        ob = self.ob
        if self.cell is None:
            ksum = torch.sum(beta)
            spans = [blk for u, m, half0 in self.cells() for blk in
                     self._blocks(half0 + u * self.n_local, self.n_local)]
            y, mags = y_sum, mag_sum
        else:
            d, _ = self.cell
            ksum = coll.psum(beta[d:d + 1], self.wgroup)[0]
            spans = list(self._blocks(0, self.n_local))
            own = slice(d * self.n_local, (d + 1) * self.n_local)
            y, mags = y_sum[own], mag_sum[own]
            z = z[self.row0:self.row0 + self.n_local]
        y = y.to(torch.float32) * b_t if ob.packed else y
        denom = torch.clamp(ksum * b_t, min=1e-12)
        nv = torch.as_tensor(noise_var, dtype=torch.float32,
                             device=self.device)
        y = (y + z * torch.sqrt(nv)) / denom
        mbar = (mags / torch.clamp(ksum, min=1e-12)
                if ob.magnitude_tracking else None)
        if hook is not None:
            hook("mac", y_sum=y_sum, mag_sum=mag_sum)
        gn2 = self._decode_blocks(y, mbar, apply, spans, hook)
        return gn2 if self.cell is None else coll.psum(gn2, self.world)

    def _decode_blocks(self, y, mbar, apply, spans, hook=None):
        """Decode (eq. 43) the rows of ``y`` a block ``(a, b)`` of
        ``spans`` at a time, and ``apply(a, b, ghat_rows)`` updates them.
        Returns the blocks' ‖ĝ‖²."""
        ob = self.ob
        gn2 = torch.zeros((), dtype=torch.float32, device=self.device)
        for a, b in spans:
            ghat = reconstruct_chunks(
                ob, y[a:b], None if mbar is None else mbar[a:b],
                self.phi).reshape(b - a, ob.chunk)
            gn2 += torch.sum(ghat * ghat)
            if hook is not None:
                hook("decode")
            apply(a, b, ghat)
            if hook is not None:
                hook("update")
        return gn2

    def _stats(self, beta, b_t, gn2, noise_var) -> ZooStats:
        budget = error_budget(self.const, D=self.D_pad, S=self._s_eff,
                              kappa=self._kappa_eff, beta=beta,
                              k_weights=self._kw, b_t=b_t,
                              noise_var=noise_var)
        return ZooStats(n_scheduled=torch.sum(beta > 0).to(torch.int32),
                        b_t=b_t, ghat_norm=torch.sqrt(gn2), budget=budget)

    def _round(self, params, source, t, key, noise_var, p_max, lr,
               draws, hook):
        """``source`` is ``worker_rows`` in one process (``_upload``) and
        ``blocks`` over processes (``_upload_procs``)."""
        beta, b_t, z = self._prologue(t, key, noise_var, p_max, draws)
        upload = self._upload if self.cell is None else self._upload_procs
        y_sum, mag_sum = upload(source, beta, b_t, hook)
        lr = float(np.float32(lr))

        def apply(a, b, ghat):
            params[a:b] -= lr * ghat                        # eq. (14)

        gn2 = self._mac_decode(y_sum, mag_sum, beta, b_t, z, noise_var,
                               apply, hook)
        return params, self._stats(beta, b_t, gn2, noise_var)

    # -- the round ---------------------------------------------------------

    def round_gen(self, params, t, key, noise_var, p_max, lr, *,
                  draws: Optional[ZooDraws] = None, hook=None):
        """One surrogate-gradient round from absolute round ``t``; updates
        ``params`` in place. Returns (params, ZooStats)."""
        if self.D >= 2 ** 32:
            _surrogate_d(self.D)
        self._check_params(params)
        if self.cell is not None:
            d, _ = self.cell

            def blocks():
                for a, rows in self._gathered(params, hook):
                    yield a, self._surrogate_grads(rows, a, d, int(t))

            return self._round(params, blocks, t, key, noise_var, p_max,
                               lr, draws, hook)

        def worker_rows(u):
            return lambda a, b: self._surrogate_grads(params[a:b], a, u,
                                                      int(t))

        return self._round(params, worker_rows, t, key, noise_var, p_max,
                           lr, draws, hook)

    def round_from_grads(self, params, grads, t, key, noise_var, p_max, lr,
                         *, draws: Optional[ZooDraws] = None, hook=None):
        """One round on real per-worker gradients ``grads`` (U, n_chunks,
        D_c) from :meth:`chunk_worker_grads` (over processes also this
        rank's worker's (n_half, D_c) rows of its half); updates
        ``params`` in place."""
        self._check_params(params)
        want = (self.U, self.n_chunks, self.ob.chunk)
        if self.cell is not None:
            d, _ = self.cell
            if tuple(grads.shape) == want:
                grads = grads[d, self.half0:self.half0 + self.n_half]
            elif tuple(grads.shape) != (self.n_half, self.ob.chunk):
                raise ValueError(
                    f"round_from_grads: grads {tuple(grads.shape)} != (U, "
                    f"n_chunks, D_c) = {want} or this rank's (n_half, D_c)"
                    f" = {(self.n_half, self.ob.chunk)}")

            def blocks():
                for a, b in self._half_blocks(self.cell[1]):
                    yield a, grads[a - self.half0:b - self.half0].to(
                        torch.float32)

            return self._round(params, blocks, t, key, noise_var, p_max,
                               lr, draws, hook)
        if tuple(grads.shape) != want:
            raise ValueError(f"round_from_grads: grads {tuple(grads.shape)}"
                             f" != (U, n_chunks, D_c) = {want}")

        def worker_rows(u):
            return lambda a, b: grads[u, a:b].to(torch.float32)

        return self._round(params, worker_rows, t, key, noise_var, p_max,
                           lr, draws, hook)

    def _check_params(self, params):
        rows = self.n_chunks if self.cell is None else self.n_local
        want = (rows, self.ob.chunk)
        if tuple(params.shape) != want or params.dtype != torch.float32:
            raise ValueError(f"zoo round: params {params.dtype} "
                             f"{tuple(params.shape)}, expected f32 "
                             f"{want} from chunk_params (over processes: "
                             f"this rank's rows, from shard_params)")

    def reference_round(self, chunked, t, key, noise_var, p_max, lr,
                        grads=None, *, draws: Optional[ZooDraws] = None):
        """The single-device oracle: on one card, the same round on a copy
        of ``chunked`` (which stays as it was)."""
        p = chunked.clone()
        if grads is not None:
            return self.round_from_grads(p, grads, t, key, noise_var, p_max,
                                         lr, draws=draws)
        return self.round_gen(p, t, key, noise_var, p_max, lr, draws=draws)

    # -- multi-round loop --------------------------------------------------

    def run_rounds(self, params, rounds: int, *, key, noise_var, p_max, lr,
                   grads=None, t0: int = 0, draws=None):
        """Host loop over ``rounds`` rounds from absolute round ``t0``.
        ``draws``: optional callable t -> ZooDraws. Returns (params, list
        of host ZooStats)."""
        out = []
        for t in range(t0, t0 + rounds):
            dr = draws(t) if draws is not None else None
            if grads is not None:
                params, st = self.round_from_grads(
                    params, grads, t, key, noise_var, p_max, lr, draws=dr)
            else:
                params, st = self.round_gen(params, t, key, noise_var,
                                            p_max, lr, draws=dr)
            out.append(host_stats(st))
        return params, out


def host_stats(st):
    """A stats NamedTuple with every tensor leaf as a NumPy array."""
    return tree.tree_map(lambda x: x.detach().cpu().numpy()
                         if isinstance(x, torch.Tensor) else np.asarray(x),
                         st)


def build_zoo_round(ob: OBCSAAConfig, D: int, mesh, **kw) -> ZooRound:
    """Build the zoo round for (ob, D, mesh)."""
    return ZooRound(ob, D, mesh, **kw)
