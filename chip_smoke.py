"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. banner   card name and power limit, torch/CUDA/nvcc versions; TF32 off
2. build    compile the port's CUDA kernels from src/repro_torch/kernels/csrc
3. kernels  every kernel against its plain PyTorch version on the card, at
            the main path's shapes and at ragged ones, with times (warm
            L2 from CUDA graph replay, and cold after a 256 MB read), and
            an empty kernel timed the same way: the launch floor
4. slice    the paper's §V federated round (784-64-10 MLP, D = 50,890,
            13 chunks of 4096, S = 1024, κ = 80, BIHT 30 iterations, U = 10)
            through ``FederatedTrainer`` with ``use_kernels=True``; the
            launch counters must show every kernel of the path
5a. packed  the packed 1-bit BIHT decode (``decode`` with packed=True) of
            one worker's §V gradient: equal to the f32 kernel decode, and
            through K5 / K6
5b. greedy  the §V round again with the packed codec and the
            ``greedy_batched`` scheduler through the prefix_eval kernel
5c. fleet   ``schedule`` on 64 instances of 8192 workers (the fleet
            shape of benchmarks/sched_bench.py), kernel against plain
6.  sweep   ``EngineRun.run_sweep`` over 3 arms (fig5's σ² = 1e-6, 1e-4,
            1e-2) x 20 rounds, BIHT 25, with ``mode="scan"`` (each arm's
            round replayed from a CUDA graph) and ``mode="host"``: equal
            bit for bit, loss falling and rt_bound finite in every arm, the
            same launches per round; for ``all`` and for
            ``greedy_batched`` + the packed codec. Times both modes in
            turns, the capture, the device-busy share and the decode stage
7a. admm    ``run_sweep`` with ``admm_batched`` (Algorithm 2 in the round)
            at Fig. 3's U = 10 x K = 1000, 3 arms (seeds 0-2) x 20 rounds,
            scan (the round as graphs cut at ADMM's loop and polish tests)
            against host, cold and with ``sched_warm_duals``: all bit for
            bit equal; ADMM's iterations and chunks per round, the times
7b. host    ``FederatedTrainer(mode="host")`` with the NumPy oracles
            ``enum`` (U = 6) and ``admm`` (U = 10), 5 rounds: each round's
            β equal to ``schedule_round``'s, loss falling
7c. fleet   Algorithm 2 on B = 1024 instances of U = 64: the compacted
            and in-round forms equal per lane, 12 against float64
8a. ef      error feedback at §V width (benchmarks/ablations.py's
            ablate/obcsaa_ef arm: U = 10 x K = 1000, seeds 0 and 1, 20
            of its 80 rounds), ``all`` with SGD, ``greedy_batched`` with
            momentum and with Adam: scan ≡ host bit for bit in every stat
            and every carry leaf (moments, residuals, generator state);
            the compression launches no topk_select
8b. warm    warm-start IHT (τ = 0.25, ``decode_validate="raise"``) with
            EF under ``admm_batched``: scan ≡ host, ``decode_x0`` too
8c. resume  8a's Adam arms with ``ckpt_dir``, cut after the middle
            boundary and resumed: ≡ the uninterrupted run bit for bit;
            save ms per boundary, peak device memory
8d. serve   ``repro_torch.serve``: the cache-parity and warm-parity gates
            of benchmarks/serve_bench.py, then 10,000 cells under
            ``admm_batched`` and 100,000 under ``greedy_batched`` (K7),
            8 timed ticks each: p50/p99 tick ms, hit rate, solved/s,
            served/s, the movement read and the solve apart; then the CLI
            ``python -m repro_torch.serve`` at the 100k row, through K7
9.  lm      the LM trainer at gemma2-2b's full width (D = 2,614,222,080,
            one card = one FL worker, batch 4 x 128, the CLI's
            ``--cs-chunk 1024 --cs-measure 256 --cs-topk 64``, BIHT 10):
            3 ``mean`` steps, the loss falling; 3 ``obcsaa`` steps, every
            decoded chunk finite, at most decode_k nonzeros and of norm
            ‖top-κ(g_chunk)‖; a timed step split into stages by CUDA
            events, the largest leaves' ms, a profiled step, peak memory;
            no launch of K1-K7 (the reference's trainer runs no Pallas
            kernel); then ``python -m repro_torch.launch.train --arch
            gemma2-2b --steps 2``
10. decode  the LM decode path at full width, f32: (10a) gemma2-2b, B = 2,
            ``make_seeded_prefill`` over a 4,160-token prompt (past the
            4,096 window) into a 4,176-long cache, 16 decode steps on
            their own argmax, the 16 decode logits against the full
            forward's last 16 positions at the reference test's gate
            (argmax equal, rtol = atol = 2e-2), and the same decode with
            window 0 beside it; (10b) deepseek-v2-lite-16b (MLA, 64
            experts top-6 + 2 shared, D = 16,210,324,992), B = 4, prompt
            32, capacity_factor 8, the same gate and no dropped route;
            init s, prefill ms, ms per decode step, tokens/s, peak memory
            and the device-busy share of decode steps; (10c) ``python -m
            repro_torch.launch.decode_demo --arch gemma2-2b --batch 4
            --prompt-len 32 --gen 16`` in bf16; no launch of K1-K7

Each path's launch counters are set to 0 just before it and read just
after; a kernel of the path that was not launched fails the run.

The last three lines are ``{"kernels": [...]}``, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device
the script exits 1.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# §V geometry (examples/fl_mnist.py)
CHUNK, MEASURE, KAPPA, BIHT_ITERS = 4096, 1024, 80, 30
D_MLP = 784 * 64 + 64 + 64 * 10 + 10
N_CHUNKS = -(-D_MLP // CHUNK)
U_WORKERS, SAMPLES = 10, 3000
DECODE_K = min(4 * KAPPA, MEASURE // 2)
# the fleet scheduling shape and instance recipe of benchmarks/sched_bench.py
FLEET_B, FLEET_U = 64, 8192
# the 100k-cell service's first bucket (benchmarks/serve_bench.py:155)
# the 100k-cell service's buckets: the cold first tick's, and the one
# every later tick solves (update_frac 0.5: about 50,000 dirty cells)
SERVE_B, SERVE_B_STEADY, SERVE_U = 131072, 65536, 16
FLEET_K, FLEET_PMAX, FLEET_NV = 3000.0, 10.0, 1e-4
FLEET_GEOM = dict(D=50890, S=1000, kappa=1000)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def call_ms(fn, reps: int = 50) -> float:
    """Time per call of ``fn`` called back to back (CUDA events around
    ``reps`` calls): what a Python caller sees, the larger of the kernel's
    device time and its wrapper's host time."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def time_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA
    graph and replayed ``reps`` times between CUDA events, so the host's
    cost of launching is not in the number (back to back, a 15 µs kernel
    would measure the ~30 µs its Python wrapper takes). Inputs stay in L2
    where they fit, as in the BIHT loop."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (reps * calls)


def cold_ms(fn, reps: int = 21) -> float:
    """Device time of one ``fn()`` with a cold L2: before each call a
    256 MB buffer (five times the 50 MB L2) is read, and CUDA events
    bracket the call alone. The read takes ~80 µs of device time, longer
    than the host needs to enqueue the events and the call, so the queue
    runs ahead of the card and the kernel starts right after its event.
    Median of the calls after the first."""
    flush = torch.ones(64 << 20, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.sum()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return median([a.elapsed_time(b) for a, b in events[1:]])


def host_ms(fn, reps: int = 10) -> list:
    """Host-clock ms of ``fn()`` calls, each ended by a synchronise."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


# -- phase 1 ------------------------------------------------------------------

def banner() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}; CUDA-graph conditional nodes "
        f"(CUDAGraph.begin_capture_to_if_node): "
        f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')}")
    from repro_torch.kernels import build
    nv = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                        text=True, timeout=60)
    log("nvcc: " + nv.stdout.strip().splitlines()[-1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# -- phase 2 ------------------------------------------------------------------

def ptxas_entries(ptxas_log: str) -> list:
    """(source, kernel, registers line, spill line) for every entry
    function of the ``-Xptxas -v`` log; the kernel is named by its
    identifier and template arguments (``cs_project_wide_kernel<1>``)."""
    out, src, name, spill = [], "", None, ""
    for line in ptxas_log.splitlines():
        if line.startswith("=="):
            src = line[2:].strip()
        elif "Compiling entry function" in line:
            mangled = line.split("'")[1]
            ident = re.findall(r"\d+([a-z_]+_kernel)", mangled)
            args = (re.findall(r"Li(\d+)E", mangled)
                    + re.findall(r"(Dense|Packed)Resid", mangled))
            name = (f"{ident[-1]}<{','.join(args)}>" if ident else mangled)
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append((src, name, line.split(":", 1)[1].strip(), spill))
            name = None
    return out


def build_kernels() -> None:
    from repro_torch.kernels import build
    info = build.build()
    log(f"build: {info.seconds:.1f} s -> {os.path.relpath(info.path, ROOT)}")
    for src, name, regs, spill in ptxas_entries(info.ptxas_log):
        log(f"  {src} {name}: {regs}; {spill}")
    build.lib()


# -- phase 3 ------------------------------------------------------------------

def sign_flips(phi, x, got, want):
    """Lanes where two ±1 outputs differ, and how many of those are not
    borderline. A lane is borderline when |x·Φ_s| ≤ 2·D·2⁻²⁴·‖x‖·‖Φ_s‖:
    two f32 sums of D products in different orders can each be off by
    D·2⁻²⁴·Σ|x_d Φ_sd| ≤ D·2⁻²⁴·‖x‖‖Φ_s‖, so only there may they
    disagree on the sign."""
    d = x.shape[1]
    acc = x.double() @ phi.double().T
    lim = 2 * d * 2.0 ** -24 * (torch.linalg.vector_norm(x.double(), dim=1)
                                [:, None]
                                * torch.linalg.vector_norm(phi.double(),
                                                           dim=1)[None])
    diff = got != want
    return int(diff.sum()), int((diff & (acc.abs() > lim)).sum())


def sparse_rows(n, d, k, gen, dev, scale=1e-2):
    """Rows shaped like the path's data: k-sparse, gradient-sized."""
    from repro_torch.kernels import ref
    x = torch.randn(n, d, generator=gen, device=dev) * scale
    return ref.topk_select_ref(x, k)[0].contiguous()


def adversarial_rows(d, k, gen, dev):
    """Gaussian, heavy ties, fewer than k nonzeros, zeros, -0.0, mixed
    signed zeros, a +inf entry, some subnormal entries, all subnormal."""
    x = torch.randn(9, d, generator=gen, device=dev)
    x[1] = torch.round(x[1] * 3)
    x[2, k // 2:] = 0.0
    x[3] = 0.0
    x[4] = -0.0
    x[5, ::2] = -0.0
    x[6, d // 3] = float("inf")
    x[7, ::3] *= 1e-40
    x[8] *= 1e-39
    return x


def close(got, want, rtol=1e-5, atol=1e-5) -> float:
    err = (got - want).abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        fail(f"float output off by {float(err.max()):.3e} "
             f"(rtol {rtol}, atol {atol})")
    return float(err.max())


def same_bits(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(u, v) for u, v in zip(a, b))
    return torch.equal(a, b)


def repeats_bitwise(fn) -> bool:
    """``fn()`` gives the same bits launched again, replayed three times
    from a CUDA graph, and launched once more after the replays: the
    split sums meet in a fixed order, and the n <= 16 body's arrival
    tickets are back at 0 after every launch."""
    want = fn()
    if not same_bits(fn(), want):
        return False
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        if not same_bits(got, want):
            return False
    return same_bits(fn(), want)


def check_kernels(dev) -> dict:
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.backproject import packed_residual
    from repro_torch.kernels.cs_project import project
    from repro_torch.kernels.sign import pack_signs, unpack_signs
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def phi_of(s, d):
        return torch.randn(s, d, generator=gen, device=dev) / s ** 0.5

    # K1 topk_select: compression (130, κ=80), decode (13, κ=320), ragged,
    # and the zero-padded tail chunk (1738 live entries of 4096)
    tail = torch.zeros(U_WORKERS, CHUNK, device=dev)
    tail[:, :D_MLP - (N_CHUNKS - 1) * CHUNK] = torch.randn(
        U_WORKERS, D_MLP - (N_CHUNKS - 1) * CHUNK, generator=gen,
        device=dev)
    tail[:, 1700:] = 0  # fewer than κ nonzeros in one row's window
    tail[0, 40:] = 0
    cases = [(torch.randn(130, CHUNK, generator=gen, device=dev), KAPPA),
             (torch.randn(13, CHUNK, generator=gen, device=dev), DECODE_K),
             (torch.randn(7, 1000, generator=gen, device=dev), 33),
             (tail, KAPPA)]
    # adversarial rows (ties, few nonzeros, zeros and -0.0, +inf,
    # subnormals) at k = 0, 1, κ, D, D + 3; D = 1000 and 16384 (the
    # largest); rows off a 16-byte boundary (the scalar body); no rows
    for d, k in [(CHUNK, DECODE_K), (1000, 33), (16384, KAPPA)]:
        adv = adversarial_rows(d, k, gen, dev)
        cases += [(adv, kk) for kk in (0, 1, k, d, d + 3)]
    off = torch.empty(13 * CHUNK + 1, device=dev)[1:].view(13, CHUNK)
    cases += [(off.copy_(cases[1][0]), DECODE_K),
              (torch.empty(0, CHUNK, device=dev), KAPPA)]
    for x, k in cases:
        v, m = ops.topk_select(x, k)
        pv, pm = ref.topk_select_ref(x, k)
        if not (torch.equal(m, pm) and torch.equal(v.view(torch.int32),
                                                   pv.view(torch.int32))):
            fail(f"topk_select {tuple(x.shape)} k={k}: mask or values "
                 f"differ from the plain version")
    for x, k in cases[:2]:
        if not repeats_bitwise(lambda: ops.topk_select(x, k)):
            fail(f"topk_select {tuple(x.shape)}: a repeat launch or a graph "
                 "replay gave other bits")
    # timed at the decode shape, 31 of its 32 launches a round, and at the
    # compression shape (1 a round)
    x, k = cases[1]
    n, d = x.shape
    xc, kc = cases[0]
    results["topk_select"] = dict(
        shape=f"n={n} D={d} k={k}", max_abs_err=0.0,
        ms=time_ms(lambda: ops.topk_select(x, k)),
        cold_ms=cold_ms(lambda: ops.topk_select(x, k)),
        call_ms=call_ms(lambda: ops.topk_select(x, k)),
        plain_ms=time_ms(lambda: ref.topk_select_ref(x, k)),
        library_ms=time_ms(lambda: torch.topk(x.abs(), k, dim=-1)),
        bound=bound(9 * n * d, n * d * (2 * 33 + 2)),
        ms_compress=time_ms(lambda: ops.topk_select(xc, kc)),
        cold_ms_compress=cold_ms(lambda: ops.topk_select(xc, kc)))
    log(f"K1 topk_select ok: masks and values exact on {len(cases)} cases "
        f"({sorted({tuple(c[0].shape) for c in cases})}); repeat launches "
        "and graph replays bit-identical at n=130 and n=13")

    # K2 cs_project none/sign/pack at the compression shape and a ragged
    # one past its 144-row tile (the n > 16 body), and at n <= 16 (the
    # streamed body): the decode shape, 16 rows, one row, and D = 1000,
    # not a multiple of a 128-deep stage; K5 equal to K3 at each shape
    # (one accumulation for every mode)
    for n, s, d in [(N_CHUNKS * U_WORKERS, MEASURE, CHUNK), (145, 96, 1000),
                    (N_CHUNKS, MEASURE, CHUNK), (16, MEASURE, 1000),
                    (7, 96, 1000), (1, 96, 1000)]:
        phi = phi_of(s, d)
        x = sparse_rows(n, d, max(1, d * KAPPA // CHUNK), gen, dev)
        raw = ops.cs_project(phi, x)
        err = close(raw, ref.cs_project_ref(phi, x))
        sg = ops.cs_project_sign(phi, x)
        flips, hard = sign_flips(phi, x, sg, ref.cs_project_sign_ref(phi, x))
        words = ops.cs_project_pack(phi, x)
        pflips, phard = sign_flips(phi, x, unpack_signs(words),
                                   unpack_signs(ref.cs_project_pack_ref(
                                       phi, x)))
        if hard or phard:
            fail(f"cs_project {n, s, d}: {hard} sign / {phard} packed "
                 "lanes differ beyond the borderline bound")
        if not torch.equal(unpack_signs(words), sg):
            fail(f"cs_project {n, s, d}: pack and sign epilogues disagree")
        y = torch.where(torch.randn(n, s, generator=gen, device=dev) >= 0,
                        1.0, -1.0)
        if not torch.equal(
                packed_residual(*ops.cs_pack_sign_residual(phi, x,
                                                           pack_signs(y))),
                project(phi, x, mode="sign_residual", y=y)):
            fail(f"cs_project {n, s, d}: K5's planes differ from K3's sign "
                 "residual")
        if not (torch.equal(ops.cs_project(phi, x), raw)
                and torch.equal(ops.cs_project_sign(phi, x), sg)):
            fail(f"cs_project {n, s, d}: a second launch gave other bits")
        log(f"K2 cs_project ok at n={n} S={s} D={d}: none max err "
            f"{err:.2e}, {flips} sign / {pflips} packed borderline flips; "
            "pack = sign, K5 = K3, repeat launch bit-identical")
        if n == N_CHUNKS * U_WORKERS:
            results["cs_project"] = dict(
                shape=f"n={n} S={s} D={d} sign", max_abs_err=err,
                ms=time_ms(lambda: ops.cs_project_sign(phi, x)),
                cold_ms=cold_ms(lambda: ops.cs_project_sign(phi, x)),
                call_ms=call_ms(lambda: ops.cs_project_sign(phi, x)),
                plain_ms=time_ms(lambda: ref.cs_project_sign_ref(phi, x)),
                library_ms=time_ms(lambda: torch.matmul(x, phi.T)),
                bound=bound(4 * (n * d + s * d + n * s), 2 * n * s * d))

    # K3 cs_project sign_residual/residual at the decode shape and ragged
    # ones at 1 and 16 rows; at the decode shape also repeated and
    # replayed from a CUDA graph, bit for bit
    for n, s, d in [(N_CHUNKS, MEASURE, CHUNK), (7, 96, 1000),
                    (16, 96, 1000), (1, MEASURE, CHUNK)]:
        phi = phi_of(s, d)
        x = sparse_rows(n, d, max(1, d * DECODE_K // CHUNK), gen, dev)
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
        y = torch.where(torch.randn(n, s, generator=gen, device=dev) >= 0,
                        1.0, -1.0)
        res = project(phi, x, mode="residual", y=y)
        err = close(res, ref.cs_project_ref(phi, x, mode="residual", y=y))
        sr = project(phi, x, mode="sign_residual", y=y)
        want = ref.cs_project_ref(phi, x, mode="sign_residual", y=y)
        flips, hard = sign_flips(phi, x, y - sr, y - want)
        if hard:
            fail(f"cs_project sign_residual {n, s, d}: {hard} lanes differ "
                 "beyond the borderline bound")
        repeat = ""
        if n == N_CHUNKS:
            for mode in ("sign_residual", "residual"):
                if not repeats_bitwise(lambda: project(phi, x, mode=mode,
                                                       y=y)):
                    fail(f"cs_project {mode} {n, s, d}: a repeat launch or "
                         "a graph replay gave other bits")
            repeat = "; repeat launches and graph replays bit-identical"
        log(f"K3 cs_project_resid ok at n={n} S={s} D={d}: residual max "
            f"err {err:.2e}, {flips} borderline sign flips{repeat}")
        if n == N_CHUNKS:
            results["cs_project_resid"] = dict(
                shape=f"n={n} S={s} D={d} sign_residual", max_abs_err=err,
                ms=time_ms(lambda: project(phi, x, mode="sign_residual",
                                           y=y)),
                cold_ms=cold_ms(lambda: project(phi, x, mode="sign_residual",
                                                y=y)),
                call_ms=call_ms(lambda: project(phi, x, mode="sign_residual",
                                                y=y)),
                plain_ms=time_ms(lambda: ref.cs_project_ref(
                    phi, x, mode="sign_residual", y=y)),
                library_ms=time_ms(lambda: torch.matmul(x, phi.T)),
                bound=bound(4 * (n * d + s * d + 2 * n * s),
                            2 * n * s * d + 2 * n * s))

    # K4 backproject at the decode shape, the compression row count and
    # a ragged one, for the two step sizes the decode uses
    for n, s, d in [(N_CHUNKS, MEASURE, CHUNK), (130, MEASURE, CHUNK),
                    (7, 96, 1000)]:
        phi = phi_of(s, d)
        x = sparse_rows(n, d, max(1, d * DECODE_K // CHUNK), gen, dev)
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
        y = torch.where(torch.randn(n, s, generator=gen, device=dev) >= 0,
                        1.0, -1.0)
        r = ref.cs_project_ref(phi, x, mode="sign_residual", y=y)
        err = 0.0
        for tau in (1.0 / s, 1.0):
            err = max(err, close(ops.backproject(x, r, phi, tau),
                                 ref.backproject_ref(x, r, phi, tau)))
        if not torch.equal(ops.backproject(x, r, phi, 1.0),
                           ops.backproject(x, r, phi, 1.0)):
            fail(f"backproject {n, s, d}: a second launch gave other bits")
        log(f"K4 backproject ok at n={n} S={s} D={d}: max err {err:.2e}, "
            "repeat launch bit-identical")
        if n == N_CHUNKS:
            tau = 1.0 / s
            results["backproject"] = dict(
                shape=f"n={n} S={s} D={d}", max_abs_err=err,
                ms=time_ms(lambda: ops.backproject(x, r, phi, tau)),
                cold_ms=cold_ms(lambda: ops.backproject(x, r, phi, tau)),
                call_ms=call_ms(lambda: ops.backproject(x, r, phi, tau)),
                plain_ms=time_ms(lambda: ref.backproject_ref(x, r, phi,
                                                             tau)),
                library_ms=time_ms(lambda: torch.matmul(r, phi)),
                bound=bound(4 * (2 * n * d + n * s + s * d),
                            2 * n * s * d + 2 * n * d))
    check_packed_kernels(dev, gen, phi_of, results)
    check_prefix_kernel(dev, gen, results)
    torch.cuda.synchronize()
    # the floor under the latency-bound kernels: an empty kernel of one
    # block, timed by the same graph replay
    floor = time_ms(lambda: build.empty_launch(dev))
    for r in results.values():
        r["launch_floor_ms"] = floor
    log(f"launch floor (empty kernel, CUDA graph replay): {floor:.4f} ms")
    log(f"topk_select at the compression shape n=130 k={KAPPA}: kernel "
        f"{results['topk_select']['ms_compress']:.4f} ms (cold L2 "
        f"{results['topk_select']['cold_ms_compress']:.4f} ms)")
    for name, r in results.items():
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        extra = (f" (cumsum only {r['cumsum_only_ms']:.4f} ms; at the "
                 f"greedy round's B=1 U={U_WORKERS} {r['ms_greedy']:.4f} ms)"
                 if name == "prefix_eval" else "")
        log(f"{name}: {r['shape']}: kernel {r['ms']:.4f} ms (cold L2 "
            f"{r['cold_ms']:.4f} ms, back to back "
            f"{r['call_ms']:.4f} ms a call), plain "
            f"{r['plain_ms']:.4f} ms, library {lib}{extra}, "
            f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    build.reset_launch_counts()
    return results


def check_packed_kernels(dev, gen, phi_of, results) -> None:
    """K5 cs_project pack_sign_residual and K6 backproject_packed at the
    packed decode's shape and ragged ones at 7, 16 and 1 rows (K5 also
    repeated and replayed from a CUDA graph at the decode shape). Exact,
    kernel against kernel:
    K5's planes are K3's sign residual (one accumulation), K6 on the
    planes is K4 on 2·(plus − minus). Against the plain versions: signs
    outside the borderline bound, K6 within rtol = atol = 1e-5."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.backproject import packed_residual
    from repro_torch.kernels.cs_project import project
    from repro_torch.kernels.sign import pack_signs

    for n, s, d in [(N_CHUNKS, MEASURE, CHUNK), (7, 96, 1000),
                    (16, MEASURE, 1000), (1, 96, 1000)]:
        phi = phi_of(s, d)
        x = sparse_rows(n, d, max(1, d * DECODE_K // CHUNK), gen, dev)
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
        y = torch.where(torch.randn(n, s, generator=gen, device=dev) >= 0,
                        1.0, -1.0)
        yp = pack_signs(y)
        plus, minus = ops.cs_pack_sign_residual(phi, x, yp)
        got = packed_residual(plus, minus)
        if not torch.equal(got, project(phi, x, mode="sign_residual", y=y)):
            fail(f"cs_project pack_sign_residual {n, s, d}: the planes "
                 "differ from K3's sign residual")
        pplus, pminus = ref.cs_pack_sign_residual_ref(phi, x, yp)
        want = packed_residual(pplus, pminus)
        flips, hard = sign_flips(phi, x, y - got, y - want)
        if hard:
            fail(f"cs_project pack_sign_residual {n, s, d}: {hard} lanes "
                 "differ beyond the borderline bound")
        repeat = ""
        if n == N_CHUNKS:
            if not repeats_bitwise(lambda: ops.cs_pack_sign_residual(phi, x,
                                                                     yp)):
                fail(f"cs_project pack_sign_residual {n, s, d}: a repeat "
                     "launch or a graph replay gave other bits")
            repeat = "; repeat launches and graph replays bit-identical"
        log(f"K5 cs_project_pack_resid ok at n={n} S={s} D={d}: equal to "
            f"K3, {flips} borderline flips against plain{repeat}")
        w = s // 32
        if n == N_CHUNKS:
            results["cs_project_pack_resid"] = dict(
                shape=f"n={n} S={s} D={d} pack_sign_residual",
                max_abs_err=float((got - want).abs().max()),
                ms=time_ms(lambda: ops.cs_pack_sign_residual(phi, x, yp)),
                cold_ms=cold_ms(lambda: ops.cs_pack_sign_residual(phi, x,
                                                                  yp)),
                call_ms=call_ms(lambda: ops.cs_pack_sign_residual(phi, x,
                                                                  yp)),
                plain_ms=time_ms(lambda: ref.cs_pack_sign_residual_ref(
                    phi, x, yp)),
                library_ms=time_ms(lambda: torch.matmul(x, phi.T)),
                bound=bound(4 * (n * d + s * d + 3 * n * w),
                            2 * n * s * d))

        r = packed_residual(pplus, pminus)
        err = 0.0
        for tau in (1.0 / s, 1.0):
            got = ops.backproject_packed(x, pplus, pminus, phi, tau)
            err = max(err, close(got, ref.backproject_packed_ref(
                x, pplus, pminus, phi, tau)))
            if not torch.equal(got, ops.backproject(x, r, phi, tau)):
                fail(f"backproject_packed {n, s, d}: differs from K4 on "
                     "the equivalent f32 residual")
            if not torch.equal(got, ops.backproject_packed(
                    x, pplus, pminus, phi, tau)):
                fail(f"backproject_packed {n, s, d}: a second launch gave "
                     "other bits")
        log(f"K6 backproject_packed ok at n={n} S={s} D={d}: equal to K4, "
            f"max err {err:.2e} against plain, repeat launch bit-identical")
        if n == N_CHUNKS:
            tau = 1.0 / s
            results["backproject_packed"] = dict(
                shape=f"n={n} S={s} D={d}", max_abs_err=err,
                ms=time_ms(lambda: ops.backproject_packed(x, pplus, pminus,
                                                          phi, tau)),
                cold_ms=cold_ms(lambda: ops.backproject_packed(
                    x, pplus, pminus, phi, tau)),
                call_ms=call_ms(lambda: ops.backproject_packed(
                    x, pplus, pminus, phi, tau)),
                plain_ms=time_ms(lambda: ref.backproject_packed_ref(
                    x, pplus, pminus, phi, tau)),
                library_ms=time_ms(lambda: torch.matmul(r, phi)),
                bound=bound(4 * (2 * n * d + s * d + 2 * n * w),
                            2 * n * s * d + 2 * n * d))


def fleet_problem(h, dev):
    """benchmarks/sched_bench.py's instances for the channels ``h``."""
    from repro_torch.sched import BatchedProblem
    from repro_torch.theory import AnalysisConstants
    return BatchedProblem.from_arrays(
        h, FLEET_K, FLEET_PMAX, FLEET_NV,
        const=AnalysisConstants(rho1=200.0, G=1.0), device=dev,
        **FLEET_GEOM)


def check_prefix_kernel(dev, gen, results) -> None:
    """K7 prefix_eval at the fleet shape, the FL round's (1, U) and ragged
    ones (U past a 16-byte multiple, shorter than a block's segment, and
    a segment of more than two tiles), K_i = 3000: every prefix sum is
    exact in f32, so R equals the plain version exactly; on real K_i at
    the first two, repeat launches and graph replays give the same bits.
    No one PyTorch call computes the function:
    ``library_ms`` is null, and ``torch.cumsum`` over the same (B, U) is
    timed beside it as "cumsum only"."""
    from repro_torch.kernels import ops, ref
    from repro_torch.sched import pack_coefs

    for b, u in [(FLEET_B, FLEET_U), (1, U_WORKERS), (5, 1000), (2, 8193),
                 (FLEET_B, 100), (1, 3), (300, 3000), (SERVE_B, SERVE_U),
                 (SERVE_B_STEADY, SERVE_U)]:
        h = torch.randn(b, u, generator=gen, device=dev).abs() + 1e-3
        bp = fleet_problem(h, dev)
        caps = bp.caps()
        order = torch.sort(-caps, dim=-1, stable=True).indices
        caps_s = torch.gather(caps, -1, order)
        k_s = torch.gather(bp.k_weights, -1, order)
        coefs = pack_coefs(bp)
        got = ops.prefix_eval(caps_s, k_s, coefs)
        if not torch.equal(got, ref.prefix_eval_ref(caps_s, k_s, coefs)):
            fail(f"prefix_eval ({b}, {u}): R differs from the plain version")
        repeat = ""
        if (b, u) in ((FLEET_B, FLEET_U), (1, U_WORKERS)):
            # real K_i: the sums' order matters, and is fixed
            k_real = 1000.0 + 4000.0 * torch.rand(b, u, generator=gen,
                                                  device=dev)
            if not repeats_bitwise(lambda: ops.prefix_eval(caps_s, k_real,
                                                           coefs)):
                fail(f"prefix_eval ({b}, {u}): a repeat launch or a graph "
                     "replay gave other bits")
            repeat = "; on real K_i repeat launches and graph replays " \
                "bit-identical"
        if (b, u) == (1, U_WORKERS):   # the greedy round's launch
            results["prefix_eval"]["ms_greedy"] = time_ms(
                lambda: ops.prefix_eval(caps_s, k_s, coefs))
        if u == SERVE_U and b in (SERVE_B, SERVE_B_STEADY):
            # the 100k-cell service's cold first and steady buckets
            r = results["prefix_eval"]
            r[f"ms_serve_b{b}_u16"] = time_ms(
                lambda: ops.prefix_eval(caps_s, k_s, coefs))
            r[f"plain_ms_serve_b{b}_u16"] = time_ms(
                lambda: ref.prefix_eval_ref(caps_s, k_s, coefs))
            r[f"bound_ms_serve_b{b}_u16"] = bound(
                4 * (3 * b * u + 8 * b), 11 * b * u)[0]
        log(f"K7 prefix_eval ok at B={b} U={u}: R exact{repeat}")
        if (b, u) == (FLEET_B, FLEET_U):
            results["prefix_eval"] = dict(
                shape=f"B={b} U={u} K=3000", max_abs_err=0.0,
                ms=time_ms(lambda: ops.prefix_eval(caps_s, k_s, coefs)),
                cold_ms=cold_ms(lambda: ops.prefix_eval(caps_s, k_s, coefs)),
                call_ms=call_ms(lambda: ops.prefix_eval(caps_s, k_s,
                                                        coefs)),
                plain_ms=time_ms(lambda: ref.prefix_eval_ref(caps_s, k_s,
                                                             coefs)),
                library_ms=None,
                cumsum_only_ms=time_ms(lambda: torch.cumsum(k_s, dim=-1)),
                bound=bound(4 * (3 * b * u + 8 * b), 11 * b * u))

# -- phase 4 ------------------------------------------------------------------

ROUNDS, EVAL_EVERY = 30, 10
PER_ROUND = {"topk_select": 2 + BIHT_ITERS, "cs_project": 1,
             "cs_project_resid": BIHT_ITERS, "backproject": 1 + BIHT_ITERS}


def cosine(a, b) -> float:
    return float(torch.dot(a, b) / (torch.linalg.vector_norm(a)
                                    * torch.linalg.vector_norm(b)))


def check_round_against_plain(dev) -> None:
    """One OBCSAA round with the kernels against the same round on the
    plain versions (sort top-κ, matmul projections), same gradients and
    AWGN: at a small input (the CPU tests' width, whose plain path is held
    to the JAX package) and at the §V width. Tolerance: cosine ≥ 0.999
    and ≥ 0.99, since one borderline sign flip changes every later BIHT
    iterate."""
    from repro_torch.core.obcsaa import OBCSAAConfig, simulate_round
    gen = torch.Generator(device=dev).manual_seed(1)
    for u, d, chunk, s, k, iters, tol in [
            (4, 6370, 1024, 256, 32, 5, 0.999),
            (U_WORKERS, D_MLP, CHUNK, MEASURE, KAPPA, BIHT_ITERS, 0.99)]:
        g = torch.randn(u, d, generator=gen, device=dev) * 1e-2
        kw = torch.full((u,), float(SAMPLES), device=dev)
        beta = torch.ones(u, device=dev)
        b_t = torch.tensor(1e-3, device=dev)
        h = torch.ones(u, device=dev)
        n_chunks = -(-d // chunk)
        noise = torch.randn(n_chunks, s, generator=gen, device=dev) * 1e-2
        out = {}
        for name, use_kernels, where in [
                ("kernels", True, dev), ("plain on the card", False, dev),
                ("plain on the CPU", False, torch.device("cpu"))]:
            cfg = OBCSAAConfig(chunk=chunk, measure=s, topk=k,
                               biht_iters=iters, use_kernels=use_kernels)
            phi = cfg.phi(dev).to(where)
            ghat, _ = simulate_round(
                cfg, g.to(where), kw.to(where), beta.to(where),
                b_t.to(where), h.to(where), phi=phi, noise=noise.to(where))
            out[name] = ghat.to(dev)
        got = out.pop("kernels")
        if got.shape != (d,) or not bool(torch.isfinite(got).all()):
            fail(f"round at D={d}: output not finite of shape ({d},)")
        for name, want in out.items():
            c = cosine(got, want)
            log(f"round at D={d}: kernels vs {name}: cosine {c:.6f}")
            if c < tol:
                fail(f"round at D={d}: kernels vs {name}: cosine {c:.6f} "
                     f"< {tol}")


def median(xs):
    return float(np.median(np.asarray(xs)))


def device_busy(fn, setup: bool = True):
    """torch.profiler around one ``fn()`` (after a first profiled call
    that sets CUPTI up, unless ``setup`` is false). Returns (wall ms,
    device-busy ms, device events, every event's self device time in ms): the busy time sums the events
    that ran on the card (kernels, copies, fills). The last number counts
    a kernel twice when an aten op launched it (``aten::bmm`` carries its
    GEMMs' time); it is printed to compare with records that used it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if setup:
        with profile(activities=acts):
            fn()
            torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    every_us = sum(getattr(e, "self_device_time_total", 0)
                   for e in prof.key_averages())
    return wall_us / 1e3, busy_us / 1e3, events, every_us / 1e3


def where_the_time_goes(tr, agg: str) -> float:
    """After the counted run: ten more rounds timed one by one (host
    clock, synchronised), the stages of one round timed apart (median of
    five, synchronised between stages; the scheduler's alone under
    ``greedy_batched``), and a torch.profiler trace of three rounds for
    the device's busy share and its top kernels. Returns the median
    ms/round of the ten."""
    from repro_torch.core.obcsaa import compress_chunks, reconstruct_chunks
    from repro_torch.core.sparsify import flatten_pytree
    from repro_torch.engine.core import stacked_grads

    t_next = len(tr.sched_logs)
    rounds = iter(range(t_next, t_next + 10))
    per_round = host_ms(lambda: tr.run_round(next(rounds)), 10)
    log(f"{agg}: per-round ms after the run: median {median(per_round):.3f}"
        f", min {min(per_round):.3f}, max {max(per_round):.3f}")

    if tr.cfg.scheduler == "greedy_batched":
        h, _ = tr.fns.fade_step(tr.state.fade, tr.generator)
        sched = host_ms(lambda: tr.fns.schedule(
            h, tr.k_weights, tr.arm.noise_var, tr.arm.p_max), 5)
        log(f"{agg}: schedule stage {median(sched):.3f} ms (median of 5)")

    if agg == "obcsaa":
        ob = tr.cfg.obcsaa
        st = tr.state
        stages = {"grads": [], "compress": [], "mac": [], "decode": [],
                  "update": []}

        def timed(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stages[name].append((time.perf_counter() - t0) * 1e3)
            return out

        u = tr.k_weights.shape[0]
        unflatten = flatten_pytree(st.params)[1]
        for _ in range(5):
            g = timed("grads", lambda: stacked_grads(
                tr.loss_fn, st.params, tr.worker_data))
            gpad = torch.nn.functional.pad(g, (0, (-tr.D) % ob.chunk))
            signs, mags = timed("compress", lambda: compress_chunks(
                ob, gpad.reshape(u, -1, ob.chunk), tr.phi))
            y = timed("mac", lambda: (torch.einsum(
                "u,ucs->cs", tr.k_weights * 1e-3, signs)
                + torch.randn(signs.shape[1:], device=signs.device) * 1e-2)
                / (tr.k_weights.sum() * 1e-3))
            ghat = timed("decode", lambda: reconstruct_chunks(
                ob, y, mags.mean(0), tr.phi))
            timed("update", lambda: tr.opt.update(
                unflatten(ghat[:tr.D]), st.opt_state, st.params,
                tr.cfg.learning_rate))
        log("obcsaa: stage ms (median of 5, synchronised): " + ", ".join(
            f"{k} {median(v):.3f}" for k, v in stages.items()))

    wall, busy, events, every = device_busy(
        lambda: [tr.run_round(t) for t in range(t_next + 10, t_next + 13)])
    log(f"{agg}: profiler, 3 rounds: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}%; every event's self "
        f"device time {every:.3f} ms)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
            f"{e.key[:70]}")
    return median(per_round)


class Task:
    """The §V task on the card: data, MLP at seed 0, loss and eval."""

    def __init__(self, dev, workers: int = U_WORKERS,
                 samples: int = SAMPLES):
        from repro_torch.data import load_mnist, partition_workers
        from repro_torch.models import mlp_mnist as mm

        t0 = time.perf_counter()
        self.workers, self.samples = workers, samples
        xtr, ytr, xte, yte = load_mnist()
        wx, wy = partition_workers(xtr, ytr, workers, samples, seed=0)
        self.data = {"x": torch.from_numpy(wx), "y": torch.from_numpy(wy)}
        xe, ye = torch.from_numpy(xte).to(dev), torch.from_numpy(yte).to(dev)
        log(f"data: {len(xtr)} train / {len(xte)} test samples, "
            f"{time.perf_counter() - t0:.1f} s")
        self.eval_fn = lambda p: (mm.mlp_mnist_loss(p, xe, ye),
                                  mm.mlp_mnist_accuracy(p, xe, ye))
        self.loss_fn = lambda p, d: mm.mlp_mnist_loss(p, d["x"], d["y"])
        self.params0 = mm.init_mlp_mnist(seed=0, device=dev)
        if mm.param_dim(self.params0) != D_MLP:
            fail(f"MLP has {mm.param_dim(self.params0)} parameters, not "
                 f"{D_MLP}")
        self.loss0, self.acc0 = (float(v) for v in self.eval_fn(self.params0))

    def obcsaa(self, **kw):
        from repro_torch.core.obcsaa import OBCSAAConfig
        return OBCSAAConfig(**{**dict(
            chunk=CHUNK, measure=MEASURE, topk=KAPPA, biht_iters=BIHT_ITERS,
            noise_var=1e-4, p_max=10.0, use_kernels=True), **kw})

    def trainer(self, dev, **cfg_kw):
        """Phases 4-5 drive the eager per-round loop (``mode="host"``);
        phase 6 drives the graph."""
        from repro_torch.engine import FLConfig
        from repro_torch.fl import FederatedTrainer
        cfg = FLConfig(**{**dict(learning_rate=0.1, rounds=ROUNDS,
                                 eval_every=EVAL_EVERY, seed=0, mode="host"),
                          **cfg_kw})
        return FederatedTrainer(cfg, self.loss_fn, self.params0, self.data,
                                self.k_weights(), eval_fn=self.eval_fn,
                                device=dev)

    def k_weights(self):
        return np.full(self.workers, float(self.samples))

    def run(self, tr, label: str):
        """The counted 30-round run: counters set to 0 just before it and
        read just after. Returns (ms/round, logs, launch counts)."""
        from repro_torch.kernels import build
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t = time.perf_counter()
        logs = tr.run(ROUNDS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / ROUNDS
        counts = build.launch_counts()
        log(f"{label}: {ms:.2f} ms/round (host clock, eval cadence "
            f"included); loss {self.loss0:.4f} -> "
            + " -> ".join(f"{l.loss:.4f}@{l.round}" for l in logs)
            + f"; accuracy {self.acc0:.4f} -> {logs[-1].accuracy:.4f}")
        if not all(np.isfinite([l.loss, l.accuracy]).all() for l in logs):
            fail(f"{label}: non-finite loss or accuracy")
        if not logs[-1].loss < self.loss0:
            fail(f"{label}: loss did not fall ({self.loss0} -> "
                 f"{logs[-1].loss})")
        return ms, logs, counts


def expect_counts(path: str, counts: dict, per_call: dict,
                  calls: int) -> None:
    """The path launched each of its kernels ``per_call[k] * calls`` times
    and no other kernel."""
    want = {k: per_call.get(k, 0) * calls for k in counts}
    if counts != want:
        fail(f"{path}: launch counts {counts} != {want} ({per_call} per "
             "call)")
    log(f"{path}: launches {({k: v for k, v in counts.items() if v})} = "
        f"{calls} x {per_call}")


def run_slice(dev, task: Task):
    """Phase 4: the §V experiment through ``FederatedTrainer`` on the
    card: 30 rounds, eval every 10, kernels on; then the same rounds with
    the perfect aggregator beside it. Returns the launch counts and the
    steady ms/round of the kernel run."""
    from repro_torch.core.obcsaa import comm_stats

    ob = task.obcsaa()
    st = comm_stats(ob, D_MLP)
    log(f"slice: D={D_MLP}, {st['n_chunks']} chunks of {CHUNK}, S={MEASURE}"
        f", κ={KAPPA}, decode k={ob.decode_k}, BIHT {BIHT_ITERS}, "
        f"U={U_WORKERS} x {SAMPLES} samples, {ROUNDS} rounds")
    runs = {}
    for agg in ("obcsaa", "perfect"):
        tr = task.trainer(dev, aggregator=agg, obcsaa=ob)
        ms, logs, counts = task.run(tr, agg)
        if agg == "obcsaa":
            slice_counts = counts
            state = [*tr.state.params.values(), tr.state.fade,
                     tr.state.prev_beta, tr.phi, tr.k_weights]
            off = [tuple(x.shape) for x in state if x.device.type != "cuda"]
            if off:
                fail(f"carried state off the card: {off}")
        runs[agg] = (ms, logs, where_the_time_goes(tr, agg))
    expect_counts("slice", slice_counts, PER_ROUND, ROUNDS)
    log("slice: obcsaa vs perfect final loss "
        f"{runs['obcsaa'][1][-1].loss:.4f} vs {runs['perfect'][1][-1].loss:.4f}"
        f", accuracy {runs['obcsaa'][1][-1].accuracy:.4f} vs "
        f"{runs['perfect'][1][-1].accuracy:.4f}")
    return slice_counts, runs["obcsaa"][2]


# -- phase 5 ------------------------------------------------------------------

def run_packed_decode(dev, task: Task) -> dict:
    """Phase 5a: one worker's §V gradient (the MLP at seed 0, worker 0),
    13 chunks top-κ'd through K1 and compressed to packed y through K2
    ``pack``, decoded by ``decode(..., packed=True, use_kernels=True)``.
    It must equal the f32 kernel decode of ``unpack_signs(y)`` exactly
    and agree with the plain decode on the card (cosine ≥ 0.99 per
    chunk)."""
    from dataclasses import replace

    from repro_torch.decode import DecodeConfig, decode
    from repro_torch.engine.core import stacked_grads
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.sign import unpack_signs

    phi = task.obcsaa().phi(dev)
    one = {k: v[:1].to(dev) for k, v in task.data.items()}
    g = stacked_grads(task.loss_fn, task.params0, one)[0]
    gc = torch.nn.functional.pad(g, (0, N_CHUNKS * CHUNK - D_MLP)).reshape(
        N_CHUNKS, CHUNK).contiguous()
    sparse, _ = ops.topk_select(gc, KAPPA)
    y_packed = ops.cs_project_pack(phi, sparse)
    y_f32 = unpack_signs(y_packed)
    cfg = DecodeConfig(algorithm="biht", iters=BIHT_ITERS, packed=True,
                       use_kernels=True)
    cfg_f32 = replace(cfg, packed=False)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    xhat = decode(y_packed, phi, DECODE_K, cfg)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    expect_counts("packed decode", counts,
                  {"topk_select": 1 + BIHT_ITERS, "backproject": 1,
                   "cs_project_pack_resid": BIHT_ITERS,
                   "backproject_packed": BIHT_ITERS}, 1)
    if xhat.shape != (N_CHUNKS, CHUNK) or not bool(
            torch.isfinite(xhat).all()):
        fail(f"packed decode: not finite of shape ({N_CHUNKS}, {CHUNK})")
    if not torch.equal(xhat, decode(y_f32, phi, DECODE_K, cfg_f32)):
        fail("packed decode differs from the f32 kernel decode")
    plain = decode(y_packed, phi, DECODE_K, replace(cfg, use_kernels=False))

    def row_cos(a, b):
        return (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                                  * torch.linalg.vector_norm(b, dim=-1))

    cos = row_cos(xhat, plain)
    if float(cos.min()) < 0.99:
        fail(f"packed decode vs plain: cosine {cos.tolist()} < 0.99")
    sent = row_cos(xhat, sparse)
    log(f"packed decode: equal to the f32 kernel decode; cosine against "
        f"the plain decode min {float(cos.min()):.6f}; against the sent "
        f"sparse chunks min {float(sent.min()):.4f}, mean "
        f"{float(sent.mean()):.4f}")
    tp, tf = [], []
    for _ in range(5):      # in turns: packed, f32, f32, packed
        tp += host_ms(lambda: decode(y_packed, phi, DECODE_K, cfg), 1)
        tf += host_ms(lambda: decode(y_f32, phi, DECODE_K, cfg_f32), 2)
        tp += host_ms(lambda: decode(y_packed, phi, DECODE_K, cfg), 1)
    log(f"packed decode: {median(tp):.3f} ms (median of {len(tp)}, host "
        f"clock) against the f32 kernel decode's {median(tf):.3f} ms")
    return counts


def run_greedy_slice(dev, task: Task, slice_steady_ms: float) -> dict:
    """Phase 5b: the §V round with the packed codec (K2 ``pack``) and the
    ``greedy_batched`` scheduler through K7, 30 rounds, eval every 10."""
    from repro_torch.sched import SchedConfig

    tr = task.trainer(dev, aggregator="obcsaa",
                      obcsaa=task.obcsaa(packed=True),
                      scheduler="greedy_batched",
                      sched_cfg=SchedConfig(use_kernel=True))
    label = "greedy_batched + packed"
    ms, logs, counts = task.run(tr, label)
    per_round = dict(PER_ROUND, prefix_eval=1)
    expect_counts(label, counts, per_round, ROUNDS)
    log(f"{label}: n_scheduled per round "
        f"{[s.n_scheduled for s in tr.sched_logs]}")
    steady = where_the_time_goes(tr, label)
    log(f"{label}: {steady:.3f} ms/round steady against the slice's "
        f"{slice_steady_ms:.3f} ms")
    return counts


def run_fleet(dev) -> dict:
    """Phase 5c: ``schedule(BatchedProblem, "greedy_batched")`` on
    benchmarks/sched_bench.py's fleet: 64 instances of 8192 workers,
    instance i drawn from numpy's default_rng(20000 + i), K_i = 3000,
    P^Max = 10, σ² = 1e-4, ρ1 = 200, G = 1. β and b_t (and R) must equal
    the plain route's exactly."""
    from repro_torch.kernels import build
    from repro_torch.sched import SchedConfig, schedule

    h = np.stack([np.abs(np.random.default_rng(20_000 + i).normal(
        size=FLEET_U)) + 1e-3 for i in range(FLEET_B)])
    bp = fleet_problem(h, dev)
    kcfg, pcfg = SchedConfig(use_kernel=True), SchedConfig()
    schedule(bp, "greedy_batched", kcfg)             # warm
    torch.cuda.synchronize()
    build.reset_launch_counts()
    beta, b_t, r = schedule(bp, "greedy_batched", kcfg)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    expect_counts("fleet", counts, {"prefix_eval": 1}, 1)
    pbeta, pb_t, pr = schedule(bp, "greedy_batched", pcfg)
    if not (torch.equal(beta, pbeta) and torch.equal(b_t, pb_t)
            and torch.equal(r, pr)):
        fail("fleet: the kernel route's β, b_t or R differ from the plain "
             "route's")
    n = beta.sum(-1)
    if not (bool((n >= 1).all()) and bool((b_t > 0).all())):
        fail("fleet: an instance scheduled nobody")
    tk, tp = [], []
    for _ in range(10):     # in turns: kernel, plain, plain, kernel
        tk += host_ms(lambda: schedule(bp, "greedy_batched", kcfg), 1)
        tp += host_ms(lambda: schedule(bp, "greedy_batched", pcfg), 2)
        tk += host_ms(lambda: schedule(bp, "greedy_batched", kcfg), 1)
    log(f"fleet: B={FLEET_B} U={FLEET_U}: β and b_t equal to the plain "
        f"route; scheduled {int(n.min())}..{int(n.max())} of {FLEET_U}; "
        f"kernel route {median(tk):.3f} ms a call = "
        f"{FLEET_B / median(tk) * 1e3:.0f} instances/s, plain route "
        f"{median(tp):.3f} ms = {FLEET_B / median(tp) * 1e3:.0f} "
        "instances/s (median of 20, host clock)")
    return counts


# -- phase 6 ------------------------------------------------------------------

# benchmarks/common.py:80 decodes with 25 BIHT iterations; fig5's σ² axis
SWEEP_ROUNDS, SWEEP_EVAL, SWEEP_ITERS = 20, 10, 25
SWEEP_NV, SWEEP_SEEDS = [1e-6, 1e-4, 1e-2], [0, 1, 2]
SWEEP_PER_ROUND = {"topk_select": 2 + SWEEP_ITERS, "cs_project": 1,
                   "cs_project_resid": SWEEP_ITERS,
                   "backproject": 1 + SWEEP_ITERS}


def run_sweep_phase(dev, task: Task, label: str, sched_kw: dict,
                    ob_kw: dict) -> dict:
    """Phase 6: ``EngineRun.run_sweep`` over 3 arms (σ² = 1e-6, 1e-4,
    1e-2; seeds 0, 1, 2) × 20 rounds, eval every 10, BIHT 25, once with
    ``mode="scan"`` (each arm's round captured as a CUDA graph and
    replayed) and once with ``mode="host"`` (the eager loop). The two must
    agree bit for bit; the graph's launches per round must equal the eager
    round's. Then the steady ms per arm-round of both, in turns, the
    profiler's device-busy share of 3 rounds of each, and the decode stage
    alone under replay. Returns the launch counts of the scan run."""
    from repro_torch.core.obcsaa import compress_chunks, reconstruct_chunks
    from repro_torch.engine import (EngineRun, FLConfig, RoundGraph,
                                    make_arms, stacked_grads)
    from repro_torch.engine.state import arm_at
    from repro_torch.kernels import build
    from repro_torch.theory import ErrorBudget

    ob = task.obcsaa(biht_iters=SWEEP_ITERS, **ob_kw)
    A, R, W = len(SWEEP_NV), SWEEP_ROUNDS, RoundGraph.WARMUP
    runs, outs, counts, secs = {}, {}, {}, {}
    for mode in ("scan", "host"):
        cfg = FLConfig(aggregator="obcsaa", learning_rate=0.1, rounds=R,
                       eval_every=SWEEP_EVAL, seed=0, mode=mode, obcsaa=ob,
                       **sched_kw)
        runs[mode] = EngineRun(cfg, task.loss_fn, task.params0, task.data,
                               np.full(U_WORKERS, float(SAMPLES)),
                               eval_fn=task.eval_fn, device=dev)
        arms = make_arms(cfg, seeds=SWEEP_SEEDS, noise_var=SWEEP_NV)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        outs[mode] = runs[mode].run_sweep(arms)
        torch.cuda.synchronize()
        secs[mode] = time.perf_counter() - t0
        counts[mode] = build.launch_counts()
    sc, ho = outs["scan"], outs["host"]
    diffs = [k for k in ("n_scheduled", "b_t", "rt_bound", "eval_rounds",
                         "loss", "accuracy")
             if not np.array_equal(sc[k], ho[k])]
    diffs += [f"budget.{f}" for f, a, b in zip(ErrorBudget._fields,
                                               sc["budget"], ho["budget"])
              if not np.array_equal(a, b)]
    diffs += [f"params.{k}" for k in sc["params"]
              if not torch.equal(sc["params"][k], ho["params"][k])]
    if diffs:
        fail(f"{label}: scan (CUDA graph) differs from host in {diffs}")
    if not np.isfinite(sc["rt_bound"]).all():
        fail(f"{label}: rt_bound not finite")
    if not (sc["loss"][:, -1] < task.loss0).all():
        fail(f"{label}: loss did not fall in every arm ({task.loss0} -> "
             f"{sc['loss'][:, -1].tolist()})")
    per_round = dict(SWEEP_PER_ROUND, **(
        {"prefix_eval": 1} if sched_kw.get("scheduler") == "greedy_batched"
        else {}))
    want = {k: per_round.get(k, 0) for k in counts["scan"]}
    for entry in runs["scan"].capture_log:
        if entry["captured"] != want:
            fail(f"{label}: a replay launches {entry['captured']}, an eager"
                 f" round {want}")
    expect_counts(f"{label} host", counts["host"], per_round, A * R)
    expect_counts(f"{label} scan (warm-up + replays)", counts["scan"],
                  per_round, A * (W + R))
    caps = runs["scan"].capture_log
    log(f"{label}: scan (CUDA graph) equals host bit for bit over {A} arms "
        f"x {R} rounds (params, n_scheduled, b_t, budget, rt_bound, loss, "
        f"accuracy); capture per arm: warm-up "
        + ", ".join(f"{c['warmup_s'] * 1e3:.1f}" for c in caps)
        + " ms, capture " + ", ".join(f"{c['capture_s'] * 1e3:.1f}"
                                      for c in caps) + " ms")
    for a, nv in enumerate(SWEEP_NV):
        log(f"  arm σ²={nv:g}: loss {task.loss0:.4f} -> "
            + " -> ".join(f"{x:.4f}" for x in sc["loss"][a])
            + f", accuracy {sc['accuracy'][a, -1]:.4f}, rt_bound "
            f"{sc['rt_bound'][a].min():.4g}..{sc['rt_bound'][a].max():.4g}"
            f", n_scheduled {sc['n_scheduled'][a].tolist()}")
    log(f"{label}: whole sweep (captures included) {secs['scan'] * 1e3:.1f}"
        f" ms scan, {secs['host'] * 1e3:.1f} ms host = "
        f"{secs['scan'] * 1e3 / (A * R):.3f} / "
        f"{secs['host'] * 1e3 / (A * R):.3f} ms per arm-round")

    steady = {}
    for mode, run in runs.items():
        state, arm = run.init(arm_at(make_arms(run.cfg, seeds=SWEEP_SEEDS,
                                               noise_var=SWEEP_NV), 0))
        state, _ = run.run_chunk(state, arm, 0, 1)    # scan: the capture
        steady[mode] = [run, state, arm]

    def chunk(mode, n):
        run, state, arm = steady[mode]
        steady[mode][1], _ = run.run_chunk(state, arm, 0, n)

    times = {"scan": [], "host": []}
    for _ in range(3):      # in turns: scan, host, host, scan
        for mode in ("scan", "host", "host", "scan"):
            times[mode] += [t / 10 for t in host_ms(lambda: chunk(mode, 10),
                                                    1)]
    log(f"{label}: steady ms per arm-round (chunks of 10, host clock, "
        f"median of {len(times['scan'])}): scan {median(times['scan']):.3f}"
        f", host {median(times['host']):.3f}")
    for mode in ("scan", "host"):
        wall, busy, events, every = device_busy(lambda: chunk(mode, 3))
        log(f"{label}: profiler, 3 {mode} rounds: wall {wall:.3f} ms, "
            f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%; every "
            f"event's self device time {every:.3f} ms)")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x"
                f"  {e.key[:70]}")

    phi = ob.phi(dev)
    data = {k: v.to(dev) for k, v in task.data.items()}
    g = stacked_grads(task.loss_fn, task.params0, data)
    gpad = torch.nn.functional.pad(g, (0, N_CHUNKS * CHUNK - D_MLP))
    signs, mags = compress_chunks(ob, gpad.reshape(U_WORKERS, N_CHUNKS,
                                                   CHUNK), phi)
    if ob.packed:
        from repro_torch.kernels.sign import unpack_signs
        signs = unpack_signs(signs)
    y, mbar = signs.mean(0), mags.mean(0)
    dec_graph = time_ms(lambda: reconstruct_chunks(ob, y, mbar, phi),
                        calls=5, reps=10)
    dec_eager = median(host_ms(lambda: reconstruct_chunks(ob, y, mbar, phi),
                               10))
    log(f"{label}: decode stage (BIHT {SWEEP_ITERS}, 13 chunks): "
        f"{dec_graph:.3f} ms under graph replay (device), {dec_eager:.3f} "
        "ms eager (host clock)")
    return counts["scan"]

# -- phase 7 ------------------------------------------------------------------

# benchmarks/fig3_scheduling.py:54-66: U = 10 (and 6) workers of K = 1000
# samples, BIHT 25, seeds 0-2 as arms; benchmarks/sched_bench.py:36 the
# fleet shape of Algorithm 2 and its instance recipe
FIG3_U, FIG3_U_ENUM, FIG3_K, FIG3_SEEDS = 10, 6, 1000, [0, 1, 2]
HOST_ROUNDS = 5
ADMM_B, ADMM_U, ADMM_PARITY = 1024, 64, 12


def dist(xs) -> str:
    xs = np.asarray(xs)
    if xs.size == 0:
        return "none"
    return (f"min {xs.min()}, median {float(np.median(xs)):g}, max "
            f"{xs.max()}")


def admm_iterations(run, arms) -> list:
    """Outer iterations of every round's solve (eager, arm by arm): each
    round's h from ``full_round``, solved again with ``return_duals``."""
    from repro_torch.engine.state import arm_at
    from repro_torch.sched import BatchedProblem, admm_solve_batched_jit
    cfg, iters = run.cfg, []
    for a in range(len(FIG3_SEEDS)):
        state, arm = run.init(arm_at(arms, a))
        for _ in range(cfg.rounds):
            state, _, info = run.fns.full_round(state, arm, run.worker_data,
                                                run.k_weights)
            bp = BatchedProblem.from_arrays(
                info["h"][None], run.k_weights[None], arm.p_max,
                arm.noise_var, D=run.D, S=cfg.obcsaa.measure,
                kappa=cfg.obcsaa.topk, const=cfg.const)
            *_, solve = admm_solve_batched_jit(bp, cfg.sched_cfg,
                                               return_duals=True)
            iters.append(int(solve.iters[0]))
    return iters


def admm_stage_ms(run, dev) -> tuple:
    """The schedule stage alone (one ``admm_batched`` solve at B = 1, U =
    10), eager and as its captured program replayed (host clock, each
    ended by a synchronise; median of 20)."""
    from repro_torch import control
    state, arm = run.init()
    h, _ = run.fns.fade_step(state.fade, state.generator)

    def solve():
        return run.fns.schedule(h, run.k_weights, arm.noise_var, arm.p_max)

    eager = median(host_ms(solve, 20))
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    torch.cuda.synchronize()
    with control.SegmentedCapture(stream) as cap:
        solve()
    torch.cuda.synchronize()
    replayed = median(host_ms(lambda: control.replay(cap.program), 20))
    return eager, replayed, len(cap.program)


def run_admm_sweep_phase(dev, task: Task) -> dict:
    """Phase 7a: ``EngineRun.run_sweep`` with ``admm_batched`` (Algorithm
    2 in the round) over 3 arms (seeds 0-2) × 20 rounds, eval every 10,
    BIHT 25, at Fig. 3's worker set, in scan mode (the round captured as a
    program of CUDA graphs cut at ADMM's loop and polish tests) and host
    mode (the eager round, ADMM's while loop reading the host); then again
    with ``sched_warm_duals``. Scan must equal host bit for bit, and the
    warm run the cold one. Returns the launch counts of the cold scan
    run."""
    from repro_torch.engine import EngineRun, FLConfig, RoundGraph, make_arms
    from repro_torch.engine.state import arm_at
    from repro_torch.kernels import build
    from repro_torch.theory import ErrorBudget

    ob = task.obcsaa(biht_iters=SWEEP_ITERS)
    A, R, W = len(FIG3_SEEDS), SWEEP_ROUNDS, RoundGraph.WARMUP
    outs, runs, counts, secs = {}, {}, {}, {}
    for warm in (False, True):
        for mode in ("scan", "host"):
            cfg = FLConfig(aggregator="obcsaa", scheduler="admm_batched",
                           learning_rate=0.1, rounds=R, eval_every=SWEEP_EVAL,
                           seed=0, mode=mode, obcsaa=ob,
                           sched_warm_duals=warm)
            run = EngineRun(cfg, task.loss_fn, task.params0, task.data,
                            task.k_weights(), eval_fn=task.eval_fn,
                            device=dev)
            arms = make_arms(cfg, seeds=FIG3_SEEDS)
            torch.cuda.synchronize()
            build.reset_launch_counts()
            t0 = time.perf_counter()
            outs[warm, mode] = run.run_sweep(arms)
            torch.cuda.synchronize()
            secs[warm, mode] = time.perf_counter() - t0
            counts[warm, mode] = build.launch_counts()
            runs[warm, mode] = run

    def diffs(x, y, duals=False):
        bad = [k for k in ("n_scheduled", "b_t", "rt_bound", "eval_rounds",
                           "loss", "accuracy")
               if not np.array_equal(x[k], y[k])]
        bad += [f"budget.{f}" for f, a, b in zip(
            ErrorBudget._fields, x["budget"], y["budget"])
            if not np.array_equal(a, b)]
        bad += [f"params.{k}" for k in x["params"]
                if not torch.equal(x["params"][k], y["params"][k])]
        bad += [f"beta of arm {a}'s last round" for a in range(A)
                if not torch.equal(x["state"][a].prev_beta,
                                   y["state"][a].prev_beta)]
        if duals:
            bad += [f"duals of arm {a}" for a in range(A)
                    if not all(torch.equal(p.view(torch.int32),
                                           q.view(torch.int32))
                               for p, q in zip(x["state"][a].sched_duals,
                                               y["state"][a].sched_duals))]
        return bad

    for warm in (False, True):
        bad = diffs(outs[warm, "scan"], outs[warm, "host"], duals=warm)
        if bad:
            fail(f"admm sweep (warm duals {warm}): scan differs from host "
                 f"in {bad}")
    bad = diffs(outs[True, "scan"], outs[False, "scan"])
    if bad:
        fail(f"admm sweep: the warm-dual run differs from the cold run in "
             f"{bad}")
    sc = outs[False, "scan"]
    if not np.isfinite(sc["rt_bound"]).all():
        fail("admm sweep: rt_bound not finite")
    if not (sc["loss"][:, -1] < task.loss0).all():
        fail(f"admm sweep: loss did not fall in every arm ({task.loss0} -> "
             f"{sc['loss'][:, -1].tolist()})")
    want = {k: SWEEP_PER_ROUND.get(k, 0) for k in counts[False, "scan"]}
    for entry in runs[False, "scan"].capture_log:
        if entry["captured"] != want:
            fail(f"admm sweep: a replay launches {entry['captured']}, an "
                 f"eager round {want}")
    expect_counts("admm sweep host", counts[False, "host"], SWEEP_PER_ROUND,
                  A * R)
    expect_counts("admm sweep scan (warm-up + replays)",
                  counts[False, "scan"], SWEEP_PER_ROUND, A * (W + R))
    log(f"admm sweep: launches per replayed round "
        f"{ {k: v for k, v in want.items() if v} }, as an eager round's")
    log(f"admm sweep: U={task.workers} x K={task.samples}, {A} arms x {R} "
        f"rounds: scan equals host bit for bit (params, β of the last "
        f"round, n_scheduled, b_t, budget, rt_bound, loss, accuracy), and "
        f"with sched_warm_duals (duals too); the warm run equals the cold "
        f"run bit for bit")
    for warm in (False, True):
        caps = runs[warm, "scan"].capture_log
        trips = [t for c in caps for t in c["trips"]]
        n_graphs = caps[0]["graphs"] if caps else 0
        log(f"admm sweep (warm duals {warm}): {n_graphs} graphs a "
            f"round; chunks of 8 iterations per replayed round: "
            f"{dist([1 + t for t in trips])} ({sum(1 + t for t in trips)} "
            f"over {len(trips)} rounds); capture per arm: warm-up "
            + ", ".join(f"{c['warmup_s'] * 1e3:.1f}" for c in caps)
            + " ms, capture " + ", ".join(f"{c['capture_s'] * 1e3:.1f}"
                                          for c in caps) + " ms")
        log(f"admm sweep (warm duals {warm}): whole sweep (captures "
            f"included) {secs[warm, 'scan'] * 1e3:.1f} ms scan, "
            f"{secs[warm, 'host'] * 1e3:.1f} ms host = "
            f"{secs[warm, 'scan'] * 1e3 / (A * R):.3f} / "
            f"{secs[warm, 'host'] * 1e3 / (A * R):.3f} ms per arm-round")
    for a in range(A):
        log(f"  arm seed {FIG3_SEEDS[a]}: loss {task.loss0:.4f} -> "
            + " -> ".join(f"{x:.4f}" for x in sc["loss"][a])
            + f", accuracy {sc['accuracy'][a, -1]:.4f}, n_scheduled "
            f"{sc['n_scheduled'][a].tolist()}")
    arms = make_arms(runs[False, "host"].cfg, seeds=FIG3_SEEDS)
    iters = admm_iterations(runs[False, "host"], arms)
    log(f"admm sweep: outer iterations per round ({len(iters)} solves): "
        f"{dist(iters)}")

    steady = {}
    for mode in ("scan", "host"):
        run = runs[False, mode]
        state, arm = run.init(arm_at(arms, 0))
        state, _ = run.run_chunk(state, arm, 0, 1)    # scan: the capture
        steady[mode] = [run, state, arm]

    def chunk(mode, n):
        run, state, arm = steady[mode]
        steady[mode][1], _ = run.run_chunk(state, arm, 0, n)

    times = {"scan": [], "host": []}
    for _ in range(3):      # in turns: scan, host, host, scan
        for mode in ("scan", "host", "host", "scan"):
            times[mode] += [t / 10 for t in host_ms(lambda: chunk(mode, 10),
                                                    1)]
    log(f"admm sweep: steady ms per arm-round (chunks of 10, host clock, "
        f"median of {len(times['scan'])}): scan {median(times['scan']):.3f}"
        f", host {median(times['host']):.3f}")
    for mode in ("scan", "host"):
        wall, busy, events, every = device_busy(lambda: chunk(mode, 3))
        log(f"admm sweep: profiler, 3 {mode} rounds: wall {wall:.3f} ms, "
            f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%; every "
            f"event's self device time {every:.3f} ms)")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x"
                f"  {e.key[:70]}")
    eager, replayed, n_graphs = admm_stage_ms(runs[False, "scan"], dev)
    log(f"admm sweep: the schedule stage alone (B=1, U={task.workers}): "
        f"{eager:.3f} ms eager, {replayed:.3f} ms replayed ({n_graphs} "
        f"graphs; host clock, median of 20) against "
        f"{median(times['scan']):.3f} ms for a replayed round")
    return counts[False, "scan"]


def run_host_schedulers(dev) -> None:
    """Phase 7b: ``FederatedTrainer(mode="host")`` with the NumPy oracles
    of Fig. 3 between the fade draw and the round: ``enum`` at U = 6 and
    ``admm`` at U = 10, K = 1000, 5 rounds each. Every round's β must be
    ``schedule_round``'s for that round's h, and the loss must fall."""
    from repro_torch.fl import schedule_round
    for sched, workers in (("enum", FIG3_U_ENUM), ("admm", FIG3_U)):
        task = Task(dev, workers=workers, samples=FIG3_K)
        tr = task.trainer(dev, aggregator="obcsaa", scheduler=sched,
                          rounds=HOST_ROUNDS, eval_every=HOST_ROUNDS - 1,
                          obcsaa=task.obcsaa(biht_iters=SWEEP_ITERS))
        solver_ms, round_ms, sched_n = [], [], []
        for t in range(HOST_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info = tr.run_round(t)
            torch.cuda.synchronize()
            round_ms.append((time.perf_counter() - t0) * 1e3)
            h = info["h"].cpu().numpy().astype(np.float64)
            t0 = time.perf_counter()
            beta, bt = schedule_round(sched, h, task.k_weights(),
                                      tr.cfg.obcsaa, tr.cfg.const, tr.D)
            solver_ms.append((time.perf_counter() - t0) * 1e3)
            if not (np.array_equal(info["beta"].cpu().numpy(), beta)
                    and float(info["b_t"]) == np.float32(bt)):
                fail(f"host path {sched}: round {t}'s β or b_t differs from "
                     "schedule_round's for its h")
            sched_n.append(int(beta.sum()))
        loss, acc = (float(v) for v in task.eval_fn(tr.params))
        if not (np.isfinite(loss) and loss < task.loss0):
            fail(f"host path {sched}: loss did not fall ({task.loss0} -> "
                 f"{loss})")
        log(f"host path {sched}: U={workers} x K={FIG3_K}, {HOST_ROUNDS} "
            f"rounds: β equals schedule_round's every round; n_scheduled "
            f"{sched_n}; loss {task.loss0:.4f} -> {loss:.4f}, accuracy "
            f"{acc:.4f}; ms per round {median(round_ms):.3f} (median; first "
            f"{round_ms[0]:.3f}), the float64 solver alone "
            f"{median(solver_ms):.3f} ms (host clock)")


def run_admm_fleet(dev) -> None:
    """Phase 7c: benchmarks/sched_bench.py's Algorithm-2 fleet, B = 1024
    instances of U = 64 (instance i from numpy's default_rng(10000 + i),
    K_i = 3000, P^Max = 10, σ² = 1e-4, ρ1 = 200, G = 1): the compacted
    form against the in-round form per lane, bit for bit; 12 instances
    against the float64 ``admm_solve`` (at most one β differs, R_t and b_t
    within rtol 1e-4); instances per second of each form."""
    from repro_torch.sched import (BatchedProblem, Problem, admm_solve,
                                   admm_solve_batched,
                                   admm_solve_batched_jit)
    from repro_torch.theory import AnalysisConstants
    const = AnalysisConstants(rho1=200.0, G=1.0)
    probs = []
    for i in range(ADMM_B):
        rng = np.random.default_rng(10_000 + i)
        probs.append(Problem(h=np.abs(rng.normal(size=ADMM_U)) + 1e-3,
                             k_weights=np.full(ADMM_U, 3000.0), p_max=10.0,
                             noise_var=1e-4, const=const, **FLEET_GEOM))
    bp = BatchedProblem.from_problems(probs, device=dev)
    a = admm_solve_batched(bp, return_duals=True)
    b = admm_solve_batched_jit(bp, return_duals=True)
    for name, x, y in (("β", a[0], b[0]), ("b_t", a[1], b[1]),
                       ("R_t", a[2], b[2]), ("iters", a[3].iters, b[3].iters),
                       *((f"dual {n}", p, q) for n, p, q in zip(
                           "ν ξ ζ".split(), a[3].duals, b[3].duals))):
        bits = (lambda t: t.view(torch.int32)
                if t.dtype == torch.float32 else t)
        if not torch.equal(bits(x), bits(y)):
            fail(f"admm fleet: compacted and in-round forms differ in {name}")
    flips, r_rel, b_rel = 0, 0.0, 0.0
    for i in range(ADMM_PARITY):
        beta_n, bt_n, r_n = admm_solve(probs[i])
        flips += not np.array_equal(a[0][i].cpu().numpy(), beta_n)
        r_rel = max(r_rel, abs(float(a[2][i]) - r_n) / r_n)
        b_rel = max(b_rel, abs(float(a[1][i]) - bt_n) / max(bt_n, 1e-12))
    if flips > 1 or r_rel > 1e-4 or b_rel > 1e-4:
        fail(f"admm fleet vs float64 admm_solve on {ADMM_PARITY}: {flips} β "
             f"differ, R_t rel {r_rel:.2e}, b_t rel {b_rel:.2e}")
    tc, tj = [], []
    for _ in range(3):      # in turns: compacted, jit, jit, compacted
        tc += host_ms(lambda: admm_solve_batched(bp), 1)
        tj += host_ms(lambda: admm_solve_batched_jit(bp), 2)
        tc += host_ms(lambda: admm_solve_batched(bp), 1)
    iters = b[3].iters.cpu().numpy()
    chunks = -(-iters // 8)
    log(f"admm fleet: B={ADMM_B} U={ADMM_U}: compacted equals in-round per "
        f"lane bit for bit (β, b_t, R_t, iterations, duals); vs float64 "
        f"on {ADMM_PARITY}: {flips} β differ, R_t rel {r_rel:.2e}, b_t rel "
        f"{b_rel:.2e}; compacted {median(tc):.1f} ms a call = "
        f"{ADMM_B / median(tc) * 1e3:.0f} instances/s, in-round "
        f"{median(tj):.1f} ms = {ADMM_B / median(tj) * 1e3:.0f} "
        f"instances/s (median of 6, host clock); outer iterations "
        f"{dist(iters)}; lanes by chunks "
        + ", ".join(f"{c}: {int((chunks == c).sum())}"
                    for c in np.unique(chunks)))


# -- phase 8 ------------------------------------------------------------------

# benchmarks/ablations.py:19-26, the ablate/obcsaa_ef arm: §V geometry,
# BIHT 25, U = 10 x K = 1000, seeds 0 and 1; 80 rounds cut to 20
EF_SEEDS = [0, 1]
# the EF round selects its top-κ with the plain sort (the reference calls
# no kernel there) and compresses that presparsified: no compress K1
EF_PER_ROUND = {"topk_select": 1 + SWEEP_ITERS, "cs_project": 1,
                "cs_project_resid": SWEEP_ITERS,
                "backproject": 1 + SWEEP_ITERS}
# benchmarks/engine_bench.py:249-252's decoder: fixed-step IHT at τ = 0.25,
# warm-started, through K3 (residual epilogue), K4 and K1 each iteration
WARM_PER_ROUND = {"topk_select": SWEEP_ITERS, "cs_project": 1,
                  "cs_project_resid": SWEEP_ITERS,
                  "backproject": SWEEP_ITERS}
# benchmarks/serve_bench.py:46-52 and :148-155
SERVE_CORR, SERVE_THRESHOLD, SERVE_FRAC = 0.999, 0.05, 0.5
SERVE_WARMUP, SERVE_TICKS = 2, 8
# (row, cells, scheduler)
SERVE_ROWS = (("serve/slo-10k-admm", 10_000, "admm_batched"),
              ("serve/slo-100k-greedy", 100_000, "greedy_batched"))


def sweep_diffs(x: dict, y: dict) -> list:
    """What differs between two ``run_sweep`` results, bit for bit: the
    stat and eval streams, and every leaf of every arm's carry."""
    from repro_torch import tree
    from repro_torch.engine.state import with_generator_state
    from repro_torch.theory import ErrorBudget
    keys = ("n_scheduled", "b_t", "rt_bound", "eval_rounds", "loss",
            "accuracy")
    bad = [k for k in keys if (k in x) != (k in y)
           or (k in x and not np.array_equal(x[k], y[k]))]
    bad += [f"budget.{f}" for f, a, b in zip(ErrorBudget._fields,
                                             x["budget"], y["budget"])
            if not np.array_equal(a, b)]
    for a, (sx, sy) in enumerate(zip(x["state"], y["state"])):
        lx, ly = (tree.leaves(with_generator_state(s)) for s in (sx, sy))
        if len(lx) != len(ly) or not all(
                torch.equal(p.cpu(), q.cpu()) for p, q in zip(lx, ly)):
            bad.append(f"carry of arm {a}")
    return bad


def scan_host_pair(dev, task: Task, label: str, per_round: dict,
                   cfg_kw: dict, ob_kw: dict, optimizer=None) -> dict:
    """One phase-8 configuration: ``run_sweep`` over the EF seeds x 20
    rounds in scan (the CUDA graph) and host mode, equal bit for bit in
    every stat and every leaf of the carry (generator state included:
    a generator registered with the graphs reports the replays' Philox
    offset), the loss falling in every arm, each mode launching
    ``per_round`` a round; then the steady ms per arm-round of both, in
    turns. Returns the launch counts of the scan run and the times."""
    from repro_torch import tree
    from repro_torch.engine import EngineRun, FLConfig, RoundGraph, make_arms
    from repro_torch.engine.state import arm_at
    from repro_torch.kernels import build
    from repro_torch.optim import make

    ob = task.obcsaa(biht_iters=SWEEP_ITERS, **ob_kw)
    A, R, W = len(EF_SEEDS), SWEEP_ROUNDS, RoundGraph.WARMUP
    runs, outs, counts, secs = {}, {}, {}, {}
    for mode in ("scan", "host"):
        cfg = FLConfig(aggregator="obcsaa", learning_rate=0.1, rounds=R,
                       eval_every=SWEEP_EVAL, seed=0, mode=mode, obcsaa=ob,
                       error_feedback=True, **cfg_kw)
        opt = make(optimizer[0], **optimizer[1]) if optimizer else None
        runs[mode] = EngineRun(cfg, task.loss_fn, task.params0, task.data,
                               task.k_weights(), eval_fn=task.eval_fn,
                               optimizer=opt, device=dev)
        arms = make_arms(cfg, seeds=EF_SEEDS)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        outs[mode] = runs[mode].run_sweep(arms)
        torch.cuda.synchronize()
        secs[mode] = time.perf_counter() - t0
        counts[mode] = build.launch_counts()
    sc, ho = outs["scan"], outs["host"]
    bad = sweep_diffs(sc, ho)
    if bad:
        fail(f"{label}: scan (CUDA graph) differs from host in {bad}")
    st = sc["state"][0]
    if float(st.residual.abs().sum()) == 0:
        fail(f"{label}: the EF residual stayed zero")
    if st.decode_x0 is not None and float(st.decode_x0.abs().sum()) == 0:
        fail(f"{label}: the decoder's warm start stayed zero")
    if optimizer and not any(float(x.abs().sum()) > 0
                             for x in tree.leaves(st.opt_state)):
        fail(f"{label}: the optimizer state stayed zero")
    if not np.isfinite(sc["rt_bound"]).all():
        fail(f"{label}: rt_bound not finite")
    if not (sc["loss"][:, -1] < task.loss0).all():
        fail(f"{label}: loss did not fall in every arm ({task.loss0} -> "
             f"{sc['loss'][:, -1].tolist()})")
    want = {k: per_round.get(k, 0) for k in counts["scan"]}
    for entry in runs["scan"].capture_log:
        if entry["captured"] != want:
            fail(f"{label}: a replay launches {entry['captured']}, an eager"
                 f" round {want}")
    expect_counts(f"{label} host", counts["host"], per_round, A * R)
    expect_counts(f"{label} scan (warm-up + replays)", counts["scan"],
                  per_round, A * (W + R))
    log(f"{label}: scan equals host bit for bit over {A} arms x {R} rounds "
        f"(stats, loss, and every carry leaf: params, opt_state, fade, β, "
        f"decode_x0, residual, generator state); loss {task.loss0:.4f} -> "
        + ", ".join(f"{x:.4f}" for x in sc["loss"][:, -1])
        + f"; accuracy " + ", ".join(f"{x:.4f}" for x in
                                     sc["accuracy"][:, -1])
        + f"; n_scheduled {sc['n_scheduled'][0].tolist()}")
    log(f"{label}: whole sweep (captures included) {secs['scan'] * 1e3:.1f}"
        f" ms scan, {secs['host'] * 1e3:.1f} ms host")

    steady = {}
    arms = make_arms(runs["scan"].cfg, seeds=EF_SEEDS)
    for mode, run in runs.items():
        state, arm = run.init(arm_at(arms, 0))
        state, _ = run.run_chunk(state, arm, 0, 1)    # scan: the capture
        steady[mode] = [run, state, arm]

    def chunk(mode, n):
        run, state, arm = steady[mode]
        steady[mode][1], _ = run.run_chunk(state, arm, 0, n)

    times = {"scan": [], "host": []}
    for _ in range(3):      # in turns: scan, host, host, scan
        for mode in ("scan", "host", "host", "scan"):
            times[mode] += [t / 10 for t in host_ms(lambda: chunk(mode, 10),
                                                    1)]
    ms = {m: median(v) for m, v in times.items()}
    log(f"{label}: steady ms per arm-round (chunks of 10, host clock, "
        f"median of {len(times['scan'])}): scan {ms['scan']:.3f}, host "
        f"{ms['host']:.3f}")
    for mode in ("scan", "host"):
        run, state, arm = steady[mode]
        run.release(state, arm)
    return {"counts": counts["scan"], "ms": ms}


def run_ef_phase(dev, task: Task) -> dict:
    """Phase 8a: error feedback at §V width (benchmarks/ablations.py's
    ablate/obcsaa_ef arm, 20 rounds of its 80), scheduler ``all`` with
    SGD, then ``greedy_batched`` (through K7) with momentum (β = 0.9) and
    with Adam: scan ≡ host bit for bit each time."""
    from repro_torch.sched import SchedConfig
    greedy = {"scheduler": "greedy_batched",
              "sched_cfg": SchedConfig(use_kernel=True)}
    per_greedy = dict(EF_PER_ROUND, prefix_eval=1)
    out = {"ef_all": scan_host_pair(dev, task, "ef all", EF_PER_ROUND, {},
                                    {})}
    out["ef_momentum"] = scan_host_pair(
        dev, task, "ef greedy momentum", per_greedy, greedy, {},
        ("momentum", {"beta": 0.9}))
    out["ef_adam"] = scan_host_pair(dev, task, "ef greedy adam", per_greedy,
                                    greedy, {}, ("adam", {}))
    return out


def run_warm_phase(dev, task: Task) -> dict:
    """Phase 8b: warm-start IHT at §V width (engine_bench.py's decoder:
    iht, τ = 0.25, warm_start; with EF and ``admm_batched``), validated
    (``decode_validate="raise"``: an unstable τ·λ̂ fails here)."""
    return scan_host_pair(dev, task, "warm iht admm", WARM_PER_ROUND,
                          {"scheduler": "admm_batched"},
                          dict(recon_alg="iht", recon_tau=0.25,
                               warm_start=True, decode_validate="raise"))


def run_resume_phase(dev, task: Task) -> None:
    """Phase 8c: 8a's Adam arms in scan mode with ``ckpt_dir``; the steps
    past the middle boundary deleted and the sweep resumed in a fresh
    run: its final carry of every arm (params, opt_state, fade, β,
    decode_x0, residual, generator state) and its stat tail equal the
    uninterrupted run's bit for bit. Prints the save ms per boundary and
    the peak device memory of the chunk-major run (every arm's graph
    alive at once)."""
    import shutil
    import tempfile
    from repro_torch import checkpoint
    from repro_torch.engine import EngineRun, FLConfig, make_arms
    from repro_torch.optim import make
    from repro_torch.sched import SchedConfig

    ob = task.obcsaa(biht_iters=SWEEP_ITERS)
    cfg = FLConfig(aggregator="obcsaa", learning_rate=0.1,
                   rounds=SWEEP_ROUNDS, eval_every=SWEEP_EVAL, seed=0,
                   mode="scan", obcsaa=ob, error_feedback=True,
                   scheduler="greedy_batched",
                   sched_cfg=SchedConfig(use_kernel=True))
    arms = make_arms(cfg, seeds=EF_SEEDS)

    def run():
        return EngineRun(cfg, task.loss_fn, task.params0, task.data,
                         task.k_weights(), eval_fn=task.eval_fn,
                         optimizer=make("adam"), device=dev)

    from repro_torch.kernels.build import BUILD_DIR
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        full_run = run()
        full = full_run.run_sweep(arms, ckpt_dir=d)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(d))
        mid = steps[(len(steps) - 1) // 2]
        for n in steps:
            if n > mid:
                shutil.rmtree(checkpoint.step_dir(d, n))
        res = run().run_sweep(arms, ckpt_dir=d, resume=True)
    if res["t_start"] != mid:
        fail(f"resume: started at {res['t_start']}, the kept step is {mid}")
    tail = {k: (v[:, -res[k].shape[1]:] if k in ("n_scheduled", "b_t",
                                                 "rt_bound", "loss",
                                                 "accuracy") else v)
            for k, v in full.items()}
    tail["eval_rounds"] = full["eval_rounds"][-len(res["eval_rounds"]):]
    tail["budget"] = type(full["budget"])(*(
        b[:, -res["n_scheduled"].shape[1]:] for b in full["budget"]))
    bad = sweep_diffs(res, tail)
    if bad:
        fail(f"resume: the resumed sweep differs from the uninterrupted one"
             f" in {bad}")
    log(f"resume: steps saved {steps}, kept up to {mid}, resumed at "
        f"t={res['t_start']}: final carry of {len(EF_SEEDS)} arms (params, "
        f"opt_state, fade, β, decode_x0, residual, generator state) and "
        f"the stat tail equal the uninterrupted run bit for bit; save ms "
        f"per boundary " + ", ".join(f"{x * 1e3:.1f}"
                                     for x in full_run.save_s)
        + f"; peak device memory {peak:.1f} MiB with {len(EF_SEEDS)} "
        f"arms' graphs alive")


def serve_cfg(cells, scheduler, **kw):
    from repro_torch.sched import ScenarioConfig
    from repro_torch.serve import ServeConfig
    base = dict(scenario=ScenarioConfig(cells=cells, workers=SERVE_U,
                                        corr=SERVE_CORR),
                scheduler=scheduler, stale_threshold=SERVE_THRESHOLD,
                update_frac=SERVE_FRAC)
    base.update(kw)
    return ServeConfig(**base)


def run_serve_phase(dev) -> dict:
    """Phase 8d: the service (benchmarks/serve_bench.py:81-155): the cache
    parity gate (384 cells, threshold 0, update_frac 0.35, 6 ticks, both
    solvers: cache ≡ ``fresh_solve`` bit for bit), the warm parity gate
    (B = 256: β cold ≡ β warm bit for bit), then the SLO rows
    serve/slo-10k-admm and serve/slo-100k-greedy (2 warm-up ticks, 8
    timed), then ``python -m repro_torch.serve``'s ``main`` at the 100k
    row's settings for 3 ticks on its default device. Returns the launch
    counts of the timed 100k-cell ticks."""
    from repro_torch.core.channel import draw_cn, draw_fades
    from repro_torch.kernels import build
    from repro_torch.sched import (BatchedProblem, admm_solve_batched,
                                   greedy_solve_batched, take)
    from repro_torch.serve import (fresh_solve, init_service, movement,
                                   run_ticks, slo_summary)
    from repro_torch.serve.service import _problem as problem_of
    from repro_torch.theory import AnalysisConstants

    for scheduler in ("admm_batched", "greedy_batched"):
        cfg = serve_cfg(384, scheduler, stale_threshold=0.0,
                        update_frac=0.35)
        st, stats, _ = run_ticks(cfg, init_service(cfg, 1, device=dev), 6)
        beta, b_t, rt = fresh_solve(cfg, st)
        if not (torch.equal(beta, st.beta) and torch.equal(b_t, st.b_t)
                and torch.equal(rt, st.rt)):
            fail(f"serve cache parity ({scheduler}): the cache differs from "
                 "a fresh full-fleet solve")
        log(f"serve cache parity ({scheduler}, 384 cells, 6 ticks): cache "
            f"equals fresh_solve bit for bit; hit rate after the cold tick "
            f"{np.mean([s.hit_rate for s in stats[1:]]):.3f}")

    const = AnalysisConstants(rho1=200.0, G=1.0)

    def problem(g):
        h = torch.clamp(g.abs().to(torch.float32), min=1e-3)
        return BatchedProblem.from_arrays(h, 3000.0, 10.0, 1e-4, D=50890,
                                          S=1000, kappa=1000, const=const)

    gen = torch.Generator(device=dev).manual_seed(2)
    g0 = draw_cn(gen, (256, SERVE_U), dev)
    *_, info0 = admm_solve_batched(problem(g0), return_duals=True)
    _, g1 = draw_fades(gen, rho=SERVE_CORR, prev=g0, clamp=False)
    beta_c, _, _, ic = admm_solve_batched(problem(g1), return_duals=True)
    beta_w, _, _, iw = admm_solve_batched(problem(g1), duals=info0.duals,
                                          return_duals=True)
    if not torch.equal(beta_c, beta_w):
        fail("serve warm parity: the warm-started β differs from the cold β")
    log(f"serve warm parity (B=256, U={SERVE_U}): β warm equals β cold bit "
        f"for bit; mean outer iterations cold "
        f"{float(ic.iters.float().mean()):.2f}, warm "
        f"{float(iw.iters.float().mean()):.2f}")

    counts = {}
    for name, cells, scheduler in SERVE_ROWS:
        cfg = serve_cfg(cells, scheduler)
        state = init_service(cfg, 0, device=dev)
        state, _, _ = run_ticks(cfg, state, SERVE_WARMUP)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        state, stats, lat = run_ticks(cfg, state, SERVE_TICKS, timed=True)
        counts[name] = build.launch_counts()
        want = sum(1 for s in stats if s.n_dirty) \
            if scheduler == "greedy_batched" else 0
        expect_counts(name, counts[name], {"prefix_eval": 1}
                      if want else {}, want)
        slo = slo_summary(stats, lat, cells)
        mov = median(host_ms(lambda: movement(cfg, state), 10))
        # the bucketed solve alone, on a bucket of the last tick's size;
        # for ADMM cold and seeded with the cells' duals, as a tick does
        idx = torch.arange(stats[-1].n_solved, device=dev) % cells
        prob = problem_of(cfg, state.h_seen[idx])
        if scheduler == "admm_batched":
            duals = take(state.duals, idx)
            solves = {
                "cold": lambda: admm_solve_batched(prob, cfg.solver,
                                                   return_duals=True),
                "warm": lambda: admm_solve_batched(
                    prob, cfg.solver, duals=duals, return_duals=True)}
            solve_ms = "; ".join(
                f"{k} {median(host_ms(fn, 5)):.3f} ms, outer iterations "
                f"{dist(fn()[3].iters.cpu().numpy())}"
                for k, fn in solves.items())
        else:
            ms = median(host_ms(
                lambda: greedy_solve_batched(prob, cfg.solver), 5))
            solve_ms = f"{ms:.3f} ms"
        wall, busy, events, _ = device_busy(
            lambda: run_ticks(cfg, state, 1))
        if not (torch.isfinite(state.rt).all()
                and bool((state.beta.sum(-1) >= 1).all())):
            fail(f"{name}: a served schedule is empty or R_t not finite")
        buckets = sorted({s.n_solved for s in stats})
        log(f"{name}: {cells} cells x {SERVE_U}, rho={SERVE_CORR}, "
            f"threshold {SERVE_THRESHOLD}, update_frac {SERVE_FRAC}, "
            f"{SERVE_TICKS} timed ticks: p50 {slo['p50_ms']:.3f} ms, p99 "
            f"{slo['p99_ms']:.3f} ms, mean {slo['mean_ms']:.3f} ms; hit "
            f"rate {slo['hit_rate']:.3f}; solved/s {slo['solved_per_s']:.0f}"
            f", served/s {slo['served_per_s']:.0f}; buckets {buckets}; "
            f"movement (the host read of the dirty set) {mov:.3f} ms "
            f"(median of 10, host clock); the solve alone at the last "
            f"bucket (median of 5, host clock): {solve_ms}; "
            f"profiler, one tick: wall {wall:.3f} ms, device busy "
            f"{busy:.3f} ms ({100 * busy / wall:.1f}%)"
            + ("; mean ADMM iterations " + ", ".join(
                f"{s.mean_iters:.1f}" for s in stats)
               if scheduler == "admm_batched" else ""))
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x"
                f"  {e.key[:70]}")

    # the CLI, as a user starts it, on the 100k row's settings: every tick
    # solves a bucket, so K7 launches once a tick
    from repro_torch.serve.cli import main as serve_main
    out = io.StringIO()
    build.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = serve_main(["--cells", "100000", "--workers", str(SERVE_U),
                         "--scheduler", "greedy_batched", "--ticks", "3",
                         "--corr", str(SERVE_CORR), "--threshold",
                         str(SERVE_THRESHOLD), "--update-frac",
                         str(SERVE_FRAC)])
    if rc != 0:
        fail(f"python -m repro_torch.serve exited {rc}")
    expect_counts("serve CLI (100k, greedy, 3 ticks)",
                  build.launch_counts(), {"prefix_eval": 1}, 3)
    log("serve CLI: " + out.getvalue().strip().splitlines()[-1])
    return counts["serve/slo-100k-greedy"]


# -- phase 9 ------------------------------------------------------------------

# the LM trainer's CLI defaults (src/repro/launch/train.py:153-205):
# gemma2-2b at full width, batch 4 x 128 synthetic tokens, SGD at lr 3e-2,
# chunks of 1024, S_c = 256, κ_c = 64, BIHT 10 (decode sparsity 128)
LM_ARCH, LM_BATCH, LM_SEQ = "gemma2-2b", 4, 128
LM_TRAIN = dict(learning_rate=3e-2, cs_chunk=1024, cs_measure=256,
                cs_topk=64, biht_iters=10)
LM_D = 2_614_222_080


class StageClock:
    """The train step's hook: a CUDA event where each stage ends and one
    where the next begins, so whatever the hook does in between (the
    leaf gates) is outside every interval. ``stages()`` sums the device
    ms of forward+backward, compression, decode and update; ``leaves()``
    gives each leaf's compression + decode ms."""

    def __init__(self, gate=None):
        self.gate = gate
        self.marks = []

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def start(self):
        self.marks = [("start", -1, None, self._event())]

    def __call__(self, stage, i, grad, out):
        end = self._event()
        if self.gate is not None and stage == "decode":
            self.gate(i, grad, out)
        self.marks.append((stage, i, end, self._event()))

    def intervals(self):
        torch.cuda.synchronize()
        return [(stage, i, prev[3].elapsed_time(end))
                for prev, (stage, i, end, _) in zip(self.marks,
                                                    self.marks[1:])]

    def stages(self) -> dict:
        out = {"backward": 0.0, "compress": 0.0, "decode": 0.0,
               "update": 0.0}
        for stage, _, ms in self.intervals():
            out[stage] += ms
        return out

    def leaves(self) -> dict:
        per = {}
        for stage, i, ms in self.intervals():
            if stage in ("compress", "decode"):
                per[i] = per.get(i, 0.0) + ms
        return per


class LeafGate:
    """Phase 9's check of one decoded leaf against its gradient, chunk by
    chunk: finite; at most ``decode_k`` nonzeros; with U = 1 and β = 1
    magnitude tracking rescales a chunk to the norm it transmitted, so
    its norm equals ‖top-κ(g_chunk)‖ (rtol 1e-4), where top-κ keeps every
    entry tied with the κ-th magnitude, as the bisection selects (weight
    gradients computed in bf16 hold many exact ties); a chunk whose
    gradient is all zero decodes to exactly 0. The chunks are the decoded
    ones before the cut back to the leaf's size: a leaf's last chunk
    holds its zero-padded tail, where the decode may put mass."""

    def __init__(self, ob, names):
        self.ob, self.names = ob, names
        self.chunks = self.zero = 0
        self.max_nnz, self.max_rel = 0, 0.0

    def __call__(self, i, grad, decoded):
        ob = self.ob
        pad = (-grad.numel()) % ob.chunk
        g = torch.nn.functional.pad(grad.reshape(-1).float(), (0, pad))
        g, o = g.reshape(-1, ob.chunk), decoded.reshape(-1, ob.chunk)
        name = self.names[i]
        if not bool(torch.isfinite(o).all()):
            fail(f"lm obcsaa: decoded {name} is not finite")
        nnz = int((o != 0).sum(-1).max())
        if nnz > ob.decode_k:
            fail(f"lm obcsaa: a decoded chunk of {name} has {nnz} nonzeros "
                 f"> decode_k = {ob.decode_k}")
        # the κ-th largest magnitude; every entry tied with it is sent too
        kth = torch.topk(g.abs(), ob.topk, dim=-1).values[:, -1:]
        want = torch.linalg.vector_norm(g * (g.abs() >= kth), dim=-1)
        got = torch.linalg.vector_norm(o, dim=-1)
        zero = want == 0
        if bool((o[zero] != 0).any()):
            fail(f"lm obcsaa: a chunk of {name} with an all-zero gradient "
                 "decoded to nonzeros")
        rel = float(((got - want).abs() / want.clamp(min=1e-30))[~zero]
                    .max()) if bool((~zero).any()) else 0.0
        if rel > 1e-4:
            fail(f"lm obcsaa: {name}: a decoded chunk's norm is off "
                 f"‖top-κ(g)‖ by {rel:.3e} relative (> 1e-4)")
        self.chunks += g.shape[0]
        self.zero += int(zero.sum())
        self.max_nnz = max(self.max_nnz, nnz)
        self.max_rel = max(self.max_rel, rel)


def run_lm_phase(dev, card: str) -> dict:
    """Phase 9: the LM trainer at gemma2-2b's full width, one card = one
    FL worker. 3 ``mean`` steps (the loss finite and falling), then 3
    ``obcsaa`` steps whose every decoded leaf is gated (``LeafGate``),
    one more timed on the host clock with its stages split by CUDA
    events, one under the profiler; the launch counters of K1-K7 must
    read 0 over all of it (the reference's trainer calls no Pallas
    kernel). Then ``python -m repro_torch.launch.train --arch gemma2-2b
    --steps 2`` as a user starts it. Returns the path's launch counts."""
    import gc

    from repro_torch import tree
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels import build
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.train import make_batch
    from repro_torch.models.registry import build_model

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(LM_ARCH)
    model = build_model(cfg)
    batch = make_batch(cfg, LM_BATCH, LM_SEQ, device=dev)
    build.reset_launch_counts()
    losses, step_s, peak = {}, {}, {}
    for agg in ("mean", "obcsaa"):
        tcfg = TrainConfig(aggregation=agg, **LM_TRAIN)
        t0 = time.perf_counter()
        params = model.init(0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        paths = tree.flatten_with_paths(params)[0]
        D = sum(p.numel() for _, p in paths)
        if D != LM_D or D != cfg.param_count():
            fail(f"lm: D = {D:,}, want {LM_D:,} = param_count()")
        opt_state = steps_lib.make_optimizer(tcfg).init(params)
        step = steps_lib.make_train_step(model, tcfg)
        losses[agg], step_s[agg] = [], []
        gate = None
        if agg == "obcsaa":
            ob = steps_lib.obcsaa_config(tcfg)
            gate = LeafGate(ob, [p for p, _ in paths])
        clock = StageClock(gate)
        torch.cuda.reset_peak_memory_stats()
        for t in range(3):
            ctx = steps_lib.default_round_ctx(seed=t, device=dev)
            ctx["hook"] = clock
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clock.start()
            params, opt_state, m = step(params, opt_state, batch, ctx)
            losses[agg].append(float(m["loss"]))
            step_s[agg].append(time.perf_counter() - t0)
        if not all(np.isfinite(losses[agg])):
            fail(f"lm {agg}: a loss is not finite: {losses[agg]}")
        log(f"lm {agg}: {cfg.name} D={D:,} (init {init_s:.2f} s); losses "
            + ", ".join(f"{x:.4f}" for x in losses[agg])
            + "; s per step (host clock, synchronised) "
            + ", ".join(f"{x:.3f}" for x in step_s[agg]))
        if agg == "mean":
            peak["mean"] = torch.cuda.max_memory_allocated() / 2 ** 30
            if not losses[agg][2] < losses[agg][1] < losses[agg][0]:
                fail(f"lm mean: the loss does not fall: {losses[agg]}")
        else:
            log(f"lm obcsaa gates (3 steps): {gate.chunks:,} decoded chunks "
                f"finite, at most {gate.max_nnz} nonzeros (decode_k "
                f"{ob.decode_k}), norms = ‖top-κ(g)‖ within "
                f"{gate.max_rel:.2e} relative, {gate.zero:,} all-zero "
                f"chunks decoded to exactly 0")
            # one more step, ungated: host s/step and the device stages
            clock = StageClock()
            ctx = steps_lib.default_round_ctx(seed=3, device=dev)
            ctx["hook"] = clock
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            clock.start()
            params, opt_state, m = step(params, opt_state, batch, ctx)
            torch.cuda.synchronize()
            ungated = time.perf_counter() - t0
            peak["obcsaa"] = torch.cuda.max_memory_allocated() / 2 ** 30
            st = clock.stages()
            log(f"lm obcsaa step 3 (ungated): {ungated:.3f} s host clock, "
                f"loss {float(m['loss']):.4f}; device ms: forward+backward "
                f"{st['backward']:.1f}, compression {st['compress']:.1f}, "
                f"decode {st['decode']:.1f}, update {st['update']:.1f} "
                f"(sum {sum(st.values()):.1f})")
            per = clock.leaves()
            big = sorted(range(len(paths)),
                         key=lambda i: -paths[i][1].numel())[:3]
            log("lm obcsaa: the three largest leaves' aggregation ms "
                "(compression + decode): " + ", ".join(
                    f"{paths[i][0]} ({paths[i][1].numel():,}) "
                    f"{per[i]:.1f}" for i in big))

            def one_step():
                nonlocal params, opt_state
                ctx = steps_lib.default_round_ctx(seed=4, device=dev)
                params, opt_state, _ = step(params, opt_state, batch, ctx)

            wall, busy, events, _ = device_busy(one_step)
            log(f"lm obcsaa, profiler, one step: wall {wall:.1f} ms, device "
                f"busy {busy:.1f} ms ({100 * busy / wall:.1f}%)")
            for e in sorted(events,
                            key=lambda e: -e.self_device_time_total)[:6]:
                log(f"  {e.self_device_time_total / 1e3:9.1f} ms  "
                    f"{e.count:6d}x  {e.key[:70]}")
        del params, opt_state, step
        gc.collect()
    counts = build.launch_counts()
    expect_counts("lm (gemma2-2b, mean + obcsaa)", counts, {}, 0)
    log(f"lm: s per step, median of steps 1-2: mean "
        f"{median(step_s['mean'][1:]):.3f}, obcsaa (gated) "
        f"{median(step_s['obcsaa'][1:]):.3f}; peak device memory "
        f"(max_memory_allocated): 3 mean steps {peak['mean']:.2f} GiB, the "
        f"ungated obcsaa step {peak['obcsaa']:.2f} GiB; {card}")
    del batch
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI as a user starts it: full width, obcsaa, on the card
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", LM_ARCH, "--steps", "2"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    if r.returncode:
        fail(f"python -m repro_torch.launch.train exited {r.returncode}: "
             f"{r.stderr.strip()[-2000:]}")
    for line in r.stdout.strip().splitlines():
        log(f"lm CLI: {line}")
    log(f"lm CLI: exit 0 in {time.perf_counter() - t0:.1f} s; phase 9 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return counts


# -- phase 10 -----------------------------------------------------------------

# 10a: gemma2-2b in f32, B = 2, a prompt past the 4,096-token window so the
# local layers' mask bites; 10b: deepseek-v2-lite-16b in f32 (60.39 GiB),
# B = 4, capacity_factor 8 as tests/test_decode_consistency.py sets it so
# that prefill and decode compute the same function; 10c: the decode demo's
# CLI in the model's own bf16
DECODE_CELLS = (("10a", "gemma2-2b", 2, 4160, 2_614_222_080),
                ("10b", "deepseek-v2-lite-16b", 4, 32, 16_210_324_992))
DECODE_GEN = 16


def _decode(model, params, cache, first, start: int, feed=None):
    """``DECODE_GEN`` steps from ``pos = start``, each on the previous
    step's argmax (from ``first``) or on ``feed``'s tokens. Returns the
    logits (B, G, V), the tokens fed (B, G) and each step's host ms
    (synchronised)."""
    tok, logits, fed, ms = first, [], [], []
    for i in range(DECODE_GEN):
        if feed is not None:
            tok = feed[:, i:i + 1]
        fed.append(tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = model.decode_step(params, cache, tok, start + i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(out[:, 0])
        tok = torch.argmax(out[:, -1], dim=-1)[:, None].to(torch.int32)
    return torch.stack(logits, dim=1), torch.cat(fed, dim=1), ms


def run_decode_cell(dev, card: str, label: str, arch: str, B: int, P: int,
                    D_want: int) -> None:
    """One full-width model: ``make_seeded_prefill`` over a P-token
    prompt into a (P + 16)-long cache, 16 decode steps on the argmax of
    the step before, then the full forward over the same P + 16 tokens;
    its last 16 positions (the tail alone unembedded) must agree with the
    16 decode logits at the reference test's gate: argmax equal, rtol =
    atol = 2e-2."""
    import dataclasses
    import gc

    from repro_torch import tree
    from repro_torch.configs import get_config, scaled
    from repro_torch.launch.steps import make_seeded_prefill
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer
    from repro_torch.models.layers import unembed
    from repro_torch.models.registry import build_model

    cfg = scaled(get_config(arch), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    D = sum(p.numel() for p in tree.leaves(params))
    if D != D_want or D != cfg.param_count():
        fail(f"{label} {arch}: D = {D:,}, want {D_want:,} = param_count()")
    drops = []
    dispatch = moe_lib._dispatch

    def counted(idx, E, capacity):
        flat, slot, keep = dispatch(idx, E, capacity)
        drops.append((~keep).sum())
        return flat, slot, keep

    moe_lib._dispatch = counted
    try:
        gen = torch.Generator(device="cpu").manual_seed(0)
        prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                               dtype=torch.int32).to(dev)
        total = P + DECODE_GEN
        seeded = make_seeded_prefill(model, total)
        prefill_ms = []
        for _ in range(2):      # cold (the process's first such GEMMs), warm
            cache = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache, offset = seeded(params, {"tokens": prompt})
            first = torch.argmax(logits[:, -1], dim=-1)[:, None].to(
                torch.int32)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            del logits
        if offset != P:
            fail(f"{label}: seeded prefill offset {offset} != {P}")
        dec, fed, step_ms = _decode(model, params, cache, first, P)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        def steps4():
            # the last four steps again: the same tokens at the same
            # positions rewrite the same cache rows
            for i in range(DECODE_GEN - 4, DECODE_GEN):
                model.decode_step(params, cache, fed[:, i:i + 1], P + i)

        wall, busy, events, _ = device_busy(steps4)
        top = [("decode, 4 steps", events)]
        # one more prefill under the profiler (CUPTI is set up by now)
        wall_p, busy_p, events_p, _ = device_busy(
            lambda: seeded(params, {"tokens": prompt}), setup=False)
        top.append(("prefill", events_p))
        with torch.no_grad():
            hidden, _, _ = transformer.lm_forward(
                params, cfg, torch.cat([prompt, fed], dim=1), remat=False,
                return_hidden=True)
            full = unembed(hidden[:, P:], embedding=params.get("embedding")
                           if cfg.tie_embeddings else None,
                           lm_head=params.get("lm_head"),
                           final_softcap=cfg.final_logit_softcap)
        del hidden
        n_drop = int(torch.stack(drops).sum()) if drops else 0
    finally:
        moe_lib._dispatch = dispatch
    err = float((full - dec).abs().max())
    same = bool(torch.equal(full.argmax(-1), dec.argmax(-1)))
    ok = bool(torch.allclose(dec, full, rtol=2e-2, atol=2e-2))
    if not torch.isfinite(dec).all():
        fail(f"{label} {arch}: non-finite decode logits")
    if not (same and ok):
        fail(f"{label} {arch}: decode != forward over the last "
             f"{DECODE_GEN} positions (argmax equal {same}, max |diff| "
             f"{err:.3e}, gate rtol = atol = 2e-2)")
    log(f"{label} {arch}: D={D:,} f32, B={B}, prompt {P}, cache {total}; "
        f"init {init_s:.2f} s; prefill {prefill_ms[0]:.1f} ms cold, "
        f"{prefill_ms[1]:.1f} ms warm; decode ms per "
        f"step (host clock, synchronised) median {median(step_ms):.2f}, "
        f"min {min(step_ms):.2f}, max {max(step_ms):.2f} (16 steps: "
        + ", ".join(f"{x:.2f}" for x in step_ms) + f"); "
        f"{1e3 * B / median(step_ms):.1f} tokens/s at the median step; "
        f"peak device memory {peak:.2f} GiB; profiler, 4 decode steps: "
        f"wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f}%); profiler, one prefill: wall "
        f"{wall_p:.1f} ms, device busy {busy_p:.1f} ms "
        f"({100 * busy_p / wall_p:.1f}%); {card}")
    for what, evs in top:
        log(f"{label} {arch}: top device events, {what} "
            f"({sum(e.count for e in evs):,} on the card in all):")
        for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"  {e.self_device_time_total / 1e3:9.2f} ms  "
                f"{e.count:6d}x  {e.key[:90]}")
    log(f"{label} {arch}: decode = forward over the last {DECODE_GEN} "
        f"positions: argmax equal, max |diff| {err:.3e} (gate rtol = atol = "
        f"2e-2)" + (f"; dropped routes {n_drop} (prefill, decode and the "
                    f"check forward; capacity_factor 8)"
                    if cfg.moe is not None else ""))
    if cfg.moe is not None and n_drop:
        fail(f"{label} {arch}: {n_drop} routes dropped at capacity_factor "
             "8; prefill and decode then compute different functions")
    if cfg.attention.window:
        # the same decode with window = 0: does the window change anything
        cfg0 = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, window=0))
        model0 = build_model(cfg0)
        _, cache0, _ = make_seeded_prefill(model0, total)(
            params, {"tokens": prompt})
        dec0, _, _ = _decode(model0, params, cache0, None, P, feed=fed)
        log(f"{label} {arch}: max |decode logits with window "
            f"{cfg.attention.window} - with window 0| = "
            f"{float((dec0 - dec).abs().max()):.3e} (prompt {P} > window)")
        del cache0, dec0
    del params, cache, full, dec
    gc.collect()
    torch.cuda.empty_cache()


def run_lm_decode_phase(dev, card: str) -> dict:
    """Phase 10: the LM decode path at full width (10a gemma2-2b, 10b
    deepseek-v2-lite-16b, ``run_decode_cell``), then 10c the CLI ``python
    -m repro_torch.launch.decode_demo --arch gemma2-2b --batch 4
    --prompt-len 32 --gen 16`` as a user starts it. The launch counters
    of K1-K7 must read 0 over all of it (the reference's decode calls no
    Pallas kernel). Returns the path's launch counts."""
    import gc

    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lm decode: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
        f"allocated after phases 1-9")
    build.reset_launch_counts()
    for cell in DECODE_CELLS:
        run_decode_cell(dev, card, *cell)
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.decode_demo",
                        "--arch", "gemma2-2b", "--batch", "4", "--prompt-len",
                        "32", "--gen", "16"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        fail(f"python -m repro_torch.launch.decode_demo exited "
             f"{r.returncode}: {r.stderr.strip()[-2000:]}")
    for line in r.stdout.strip().splitlines():
        log(f"10c decode_demo CLI: {line}")
    if "tok/s" not in r.stdout:
        fail("the decode_demo CLI printed no tokens/s")
    log(f"10c decode_demo CLI: exit 0 in {time.perf_counter() - t0:.1f} s "
        f"(bf16, CUDA start-up and init included); {card}")
    counts = build.launch_counts()
    # 10c's CLI runs in a process of its own, which these counters miss
    expect_counts("lm decode (10a, 10b)", counts, {}, 0)
    log(f"lm decode: phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return counts


SOURCES = {
    "topk_select": ("src/repro_torch/kernels/csrc/topk_select.cu",
                    "src/repro/kernels/topk_select.py:23"),
    "cs_project": ("src/repro_torch/kernels/csrc/cs_project.cu",
                   "src/repro/kernels/cs_project.py:57"),
    "cs_project_resid": ("src/repro_torch/kernels/csrc/cs_project.cu",
                         "src/repro/kernels/cs_project.py:78"),
    "backproject": ("src/repro_torch/kernels/csrc/backproject.cu",
                    "src/repro/kernels/backproject.py:42"),
    "cs_project_pack_resid": ("src/repro_torch/kernels/csrc/cs_project.cu",
                              "src/repro/kernels/cs_project.py:96"),
    "backproject_packed": ("src/repro_torch/kernels/csrc/backproject.cu",
                           "src/repro/kernels/backproject.py:60"),
    "prefix_eval": ("src/repro_torch/kernels/csrc/prefix_eval.cu",
                    "src/repro/kernels/prefix_eval.py:45"),
}
# the path whose run gives a kernel's ``launches``
MAIN_PATH = {"topk_select": "slice", "cs_project": "slice",
             "cs_project_resid": "slice", "backproject": "slice",
             "cs_project_pack_resid": "packed_decode",
             "backproject_packed": "packed_decode",
             "prefix_eval": "greedy_round"}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA device")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, src)
    dev = torch.device("cuda")
    card = banner()
    build_kernels()
    results = check_kernels(dev)
    check_round_against_plain(dev)
    task = Task(dev)
    paths = {}
    paths["slice"], slice_steady = run_slice(dev, task)
    paths["packed_decode"] = run_packed_decode(dev, task)
    paths["greedy_round"] = run_greedy_slice(dev, task, slice_steady)
    paths["fleet"] = run_fleet(dev)
    from repro_torch.sched import SchedConfig
    paths["sweep_all"] = run_sweep_phase(dev, task, "sweep all", {}, {})
    paths["sweep_greedy_packed"] = run_sweep_phase(
        dev, task, "sweep greedy_batched + packed",
        {"scheduler": "greedy_batched",
         "sched_cfg": SchedConfig(use_kernel=True)}, {"packed": True})
    paths["sweep_admm"] = run_admm_sweep_phase(
        dev, Task(dev, workers=FIG3_U, samples=FIG3_K))
    run_host_schedulers(dev)
    run_admm_fleet(dev)
    fig3 = Task(dev, workers=FIG3_U, samples=FIG3_K)
    for name, r in run_ef_phase(dev, fig3).items():
        paths[name] = r["counts"]
    paths["warm_iht"] = run_warm_phase(dev, fig3)["counts"]
    run_resume_phase(dev, fig3)
    paths["serve_100k"] = run_serve_phase(dev)
    paths["lm"] = run_lm_phase(dev, card)
    paths["lm_decode"] = run_lm_decode_phase(dev, card)
    kernels = []
    for name, r in results.items():
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": paths[MAIN_PATH[name]][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "cold_ms": r["cold_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "result": "ok", "shape": r["shape"], "call_ms": r["call_ms"],
            "launches_by_path": {p: c[name] for p, c in paths.items()
                                 if c[name]},
            "launch_floor_ms": r["launch_floor_ms"],
            **({"ms_compress_n130": r["ms_compress"],
                "cold_ms_compress_n130": r["cold_ms_compress"]}
               if "ms_compress" in r else {}),
            **({"cumsum_only_ms": r["cumsum_only_ms"],
                "ms_greedy_b1_u10": r["ms_greedy"],
                **{k: v for k, v in r.items() if k.startswith(
                    ("ms_serve_", "plain_ms_serve_", "bound_ms_serve_"))}}
               if name == "prefix_eval" else {})})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
