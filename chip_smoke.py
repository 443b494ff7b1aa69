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
            3 ``mean`` steps, the loss falling; 2 ``obcsaa`` steps, every
            decoded chunk finite, at most decode_k nonzeros and of norm
            ‖top-κ(g_chunk)‖; a timed step split into stages by CUDA
            events, the largest leaves' ms, a profiled step, peak memory;
            no launch of K1-K7 (the reference's trainer runs no Pallas
            kernel); its CLI ``python -m repro_torch.launch.train --arch
            gemma2-2b --steps 1`` runs with the CLI groups
10. decode  the LM decode path at full width, f32: (10a) gemma2-2b, B = 2,
            ``make_seeded_prefill`` over a 4,160-token prompt (past the
            4,096 window) into a 4,176-long cache, 16 decode steps on
            their own argmax, the 16 decode logits against the full
            forward's last 16 positions at the reference test's gate
            (argmax equal, rtol = atol = 2e-2), and the same decode with
            window 0 beside it; (10b) deepseek-v2-lite-16b (MLA, 64
            experts top-6 + 2 shared, D = 16,210,324,992), B = 4, prompt
            32, capacity_factor 8, the same gate and no dropped route,
            and 15d's oracles (its first 8 steps with every MoE route
            recorded, within 1e-5 of the decode's logits, and with its
            rows decoded in two blocks: its own f32 spread, of the
            logits and of the router logits);
            init s, prefill ms, ms per decode step, tokens/s, peak memory
            and the device-busy share of decode steps; (10c, with the CLI
            groups) ``python -m repro_torch.launch.decode_demo --arch
            gemma2-2b --batch 4 --prompt-len 32 --gen 16`` in bf16; no
            launch of K1-K7
11. family  the other model families at full width, f32: (11a)
            mamba2-2.7b, B = 2, a 368-token prompt stepped through
            ``decode_step`` (an SSM has no prefill seeding) and 16 tokens
            on their own argmax, all 384 positions against the forward
            (three SSD chunks of 128) at the reference test's gate; (11b)
            zamba2-7b, 48 + 16 tokens, the same gate, and the 13
            shared-block layers' k/v rows against prefill's seeds, the
            other 68 layers' rows exactly zero; ms per step, tokens/s,
            forward ms, peak memory and the busy share of 4 steps; (11c)
            the trainer on mamba2-2.7b (batch 4 x 128): 2 ``mean`` steps,
            the loss falling, 1 gated ``obcsaa`` step split into stages,
            and ``python -m repro_torch.launch.train --arch mamba2-2.7b
            --agg mean --steps 2``; (11d) internvl2-1b,
            ``make_seeded_prefill`` over 256 image embeddings and a
            32-token prompt, 16 steps against the forward with the image
            prefix, and its trainer CLI; (11e) whisper-base, ``encode``
            over 1,500 frames, ``seed_cross_cache``, 32 steps against
            ``decode_full``, and its trainer CLI; (11f) ``python -m
            repro_torch.launch.decode_demo --arch mamba2-2.7b --batch 4
            --prompt-len 32 --gen 16`` in bf16 (the CLIs with the CLI
            groups); no launch of K1-K7
12. zoo     the zoo round (``engine/zoo.py``, ``engine/zoo_train.py``) at
            gemma2-2b's full width with benchmarks/zoo_bench.py's >=1B
            geometry (D_c = 16,384, S_c = 32, κ_c = 8, IHT 2, packed): K1-K4
            against their plain versions at that geometry, with times;
            (12a) the surrogate round on the logical 4 x 2 mesh with
            ``greedy_batched`` through K7 and K1-K4 on: a warm-up and two
            timed rounds split into stages by CUDA events, the launches,
            then the plain round from the same parameters and draws: the
            MAC's magnitude sums equal, its lane sums equal but on
            borderline lanes, ĝ by NMSE and support overlap, the
            parameters within a share of their movement; a profiled
            round's busy share, peak memory; (12b) zoo_bench's real-
            gradient row: 2 x 4, batch 1 x 32, SGD, bf16, remat full, two
            rounds (loss and budget finite, the master moved,
            params_from_master ∘ chunk_params the identity on the seed-0
            init); (12c, with the CLI groups) ``python -m
            repro_torch.launch.train --zoo-train --smoke`` with Adam, EF
            and token shards: resume ≡ uninterrupted bit for bit, then
            ``--arms 3``
CLIs    the CLIs of phases 9-12, whose times no phase reports, after
            phase 12 in two groups that each run at once
            (``run_cli_groups``), phase 17's ranks beside them
13. fed.    the federation over processes at internvl2-1b's full width
            (D = 493,982,720), U = 4 ranks sharing the card over gloo
            (NCCL refuses two ranks on one device): (13a) the collectives
            in 4 ranks (``chip_smoke.py --federation-rank``):
            ``psum_bits_mac`` at the zoo's geometry against the einsum
            of the symbols bit for bit, f32 ``psum``/``pmean``, the
            gathers and their backward passes, an NCCL group of one
            against ``group=None``, the bytes counter; (13b) the trainer
            CLI's ``main(["--arch", "internvl2-1b", "--steps", "2",
            ...])`` in the 4 ranks of phase 14's launch, which are up and
            idle by then (``obcsaa``, batch 4 x 128, one sequence a
            worker; 13c's runs the same way): s per
            step, the all-reduce's and the broadcast's share from CUDA
            events, peak memory per rank, the ranks' parameters bit-
            identical; each step again with the 4 workers in turn in
            this process from the process group's parameters before it:
            ĝ by NMSE and support, the parameters within 1e-4 of their
            movement; beside it the witness: the two paths' parameters
            after step 0 in ulps, and the in-turn step 1 from both
            carries; (13c) ``--scan-rounds 2 --steps 4`` with the
            greedy-scheduled span, and a run of ``--steps 2`` that stops
            at step 2 then ``--resume``s to 4: equal to the uninterrupted
            run bit for bit at steps 2 and 4; (13d) an NCCL world of one
            (``chip_smoke.py --nccl-rank``, one rank under ``torchrun``)
            through the same CLI's ``main``, one step, equal to the
            single-process step bit for bit, then 17d in the same rank;
            no launch of K1-K7 in this process. The runs whose times are
            not reported share the card with others (13c's stopped run
            and its resume with 13a, 13d and 17d, the check of 13d and
            phase 14's oracles)
14. zoo/proc the zoo over processes: one 4-rank launch (``chip_smoke.py
            --zoo-rank``), started with the script, its ranks asleep until
            this phase but for phases 17 and 13; 2 x 2 ranks, one a (worker, model-shard) cell,
            sharing the card over gloo. (14a) 12a's surrogate round at
            gemma2-2b's D with K1-K4 and K7, two rounds: each rank's rows
            against the in-turn round's row checksums (written by this
            process first), s a round, the all-gather's and the MAC's ms
            and MB, peak memory per rank, the launches; (14c) 10a's f32
            gemma2-2b decode, the K/V cache of 4,176 rows split four ways
            over its length and seeded with each rank's rows of 10a's
            prefill: 16 greedy tokens equal 10a's, logits within 1e-5 of
            their max; (14b) ``--zoo-train --model-parallel 2 --kernels``
            at internvl2-1b's full width (bf16, SGD, one sequence of 128 a
            worker, 2 rounds, ``--ckpt-dir``) through the CLI's own
            ``main``: the ranks' checkpoint equals this process's in-turn
            carry after round 1, and round 2 from it the uninterrupted
            in-turn round 2, bit for bit; K1-K4 launch in every rank
15. serve   the model axis of the serving path in phase 14's launch,
            after 14c: prefill and ``decode_step`` split over the model
            group (``models/tensor_parallel.py``; each rank 1/2 of every
            large weight, its own share of the seed-0 init) and every
            cache leaf laid out as ``cache_shardings`` gives it, f32 at
            full width: (15a) 10a's gemma2-2b case, a split prefill over
            the 4,160-token prompt into a 4,176-row cache and 8 greedy
            steps, tokens equal to 10a's and logits within 1e-5 of their
            max; (15b) minicpm3-4b (MLA, the latent cache split by batch
            and columns), B = 2, prompt 32, 8 steps; (15c) mamba2-2.7b
            (the SSM state split by batch and heads), prompt 32 stepped,
            8 steps; 15b and 15c held the same way to the decode run
            whole in this process before the launch wakes (the logits'
            gate there: 1e-5, or the whole decode's own spread with its
            rows decoded apart, where larger). Each rank's
            parameter bytes equal the product rule over
            ``param_shardings``, its cache blocks ``cache_shardings``';
            ms a step, the prefill's ms, a step's collectives by group,
            peak memory a rank; no launch of K1-K7
15d. moe    (after phase 10, before 11) deepseek-v2-lite-16b f32 served
            split over a 1 x 2 model group at full width (MLA heads and
            latent, the routed and shared experts' hidden columns, the
            vocabulary; the router gathered whole): its own 2-rank launch,
            started with the script, whose ranks touch the card only once
            this process has freed 10b's weights; each rank's init stages
            its shares on the host until the last draw
            (``tensor_parallel.draw_staged``, then ``unstage``), so both
            draw at once; 10b's
            config (capacity_factor 8) and prompt, a split prefill and 8
            greedy steps, then the same decode with its MoE routes pinned
            to 10b's (recorded in phase 10): the first token and the fed
            tokens of both equal 10b's; the pinned decode's logits within
            1e-5 of their max (or 10b's own spread with its rows decoded
            apart, capped at ``SERVE_SPREAD_CAP``); the free decode's
            too, unless its first route that parts from 10b's is a near
            tie within the two runs' measured router-logit difference (an
            f32 reordering flips it, and its logits then part further);
            the router logits of both decodes (the free one's up to its
            first flip) within ``ROUTE_NOISE_FACTOR`` times 10b's own
            router-logit spread, whatever the gap;
            no route dropped, each rank's parameter bytes the product
            rule and its cache blocks ``cache_shardings``'; init s and
            each rank's device peak during the draws, the dry run's
            estimate beside the measured peak, prefill ms, ms a step,
            collectives a step by group; no launch of K1-K7
16. split   the train step's model axis in phase 14's launch, after 14b:
            the plain trainer's CLI ``--model-parallel 2
            --check-replicas`` through its own ``main`` at internvl2-1b's
            full width (bf16, batch 2 x 128: one sequence a worker, W = 2,
            M = 2, each rank 1/2 of every weight ``param_shardings``
            splits): (16a) ``--agg mean --optimizer adam --steps 2``, the
            ranks' checkpoint after step 2 equal bit for bit to this
            process's two steps with the weights whole and the workers in
            turn (each worker's gradient, summed, over 2, Adam), moments
            included; (16b) ``--agg obcsaa --steps 2 --ckpt-every 1``,
            each step again in this process with ``make_train_step`` on
            ``make_zoo_mesh(2, 1)`` from the ranks' carry before it: bit
            for bit, or ĝ by NMSE and support and the parameters within
            1e-4 of their movement (≤ 1% of its chunks parted), the ulps
            printed; each rank's parameter and optimizer bytes equal the
            product rule, the loss finite, s a step, the gathers' (per
            layer, and the uplink's), the all-reduce's and the
            broadcast's ms, MB and calls, peak memory per rank beside
            the dry run's estimate for 16a's configuration; no launch of
            K1-K7 (alone: ``python3 chip_smoke.py --split-train``)
17. sweep   the §V sweep's arm axis over processes
            (``EngineRun.run_sweep(mesh=world_mesh(M))``), after phase 12:
            fig5's grid (4 σ² x seeds 0-2 = 12 arms, 100 rounds, U = 10 x
            K = 3000, ``all``, eval every 20, BIHT 25) in scan mode on
            phase 6's data and weights, first in this process with a
            checkpoint at every boundary (the oracle, timed alone), then
            by phase 14's launch, whose ranks run it in a world of 4 of
            their own before 13, sharing the card with the CLI groups
            (their seconds so shared; ``--sweep-procs`` has them alone): (17a) ``world_mesh(1)``, 3
            arms a rank, a checkpoint at every boundary (world rank 0
            writes); (17b) ``world_mesh(2)``, 6 arms a worker group, the 2
            ranks of its model group checked equal at each save; (17c)
            1 -> 4, this process's checkpoint cut after its middle
            boundary and resumed by the ranks, and 4 -> 1, 17a's cut the
            same way and resumed here: every rank's whole result, and the
            resumed ones, bit for bit the one-process grid (every stream
            and every arm's carry, generator states included); K1-K4
            launched in every rank, 27/1/25/26 an arm-round; s for the
            grid in one process and by rank, the gathers' MB and ms a
            boundary, save ms, peak memory by rank (alone: ``python3
            chip_smoke.py --sweep-procs``, its own 4-rank launch). 17a-17c
            run over gloo, their records on the CPU. (17d) in 13d's rank
            after its step, an NCCL world of one of its own: the grid
            over ``world_mesh(1)`` (W = 1: every boundary's records go
            through NCCL's all-gather, on the card) with a checkpoint at
            every boundary, then this process's checkpoint cut after its
            middle boundary resumed; both bit for bit the one-process
            grid, the backend NCCL, K1-K4 27/1/25/26 an arm-round; s, the
            gathers' MB, ms (CUDA events) and calls, save ms, peak memory
            (13d and 17d alone: ``python3 chip_smoke.py --nccl-world``)

Each path's launch counters are set to 0 just before it and read just
after; a kernel of the path that was not launched fails the run.

The last three lines are ``{"kernels": [...]}``, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device
the script exits 1.
"""
from __future__ import annotations

import atexit
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
    every = prof.key_averages()         # one pass: a long trace takes s
    events = [e for e in every if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    every_us = sum(getattr(e, "self_device_time_total", 0) for e in every)
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


_MNIST: list = []      # load_mnist()'s arrays, loaded once a process


def mnist_arrays() -> tuple:
    """``load_mnist()``'s arrays, loaded at the first call of the
    process."""
    from repro_torch.data import load_mnist
    if not _MNIST:
        _MNIST.append(load_mnist())
    return _MNIST[0]


class Task:
    """The §V task on the card: data, MLP at seed 0, loss and eval."""

    def __init__(self, dev, workers: int = U_WORKERS,
                 samples: int = SAMPLES):
        from repro_torch.data import partition_workers
        from repro_torch.models import mlp_mnist as mm

        t0 = time.perf_counter()
        self.workers, self.samples = workers, samples
        xtr, ytr, xte, yte = mnist_arrays()
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


# the CLIs started and not yet finished: stopped when the script exits
_STARTED: list = []


def _stop_started() -> None:
    """Stop every CLI still running (its whole process group: torchrun's
    ranks too)."""
    import signal
    for h in _STARTED:
        p = h["proc"]
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGTERM)
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()


atexit.register(_stop_started)


def start_cli(label, module, args) -> dict:
    """Start ``python -m module args`` as a user starts it, from the
    checkout's ``src``, its output into files (so that two CLIs may run
    at once); ``finish_cli`` waits for it."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out, err = (tempfile.TemporaryFile("w+") for _ in range(2))
    proc = subprocess.Popen([sys.executable, "-m", module] + args, cwd=ROOT,
                            env=env, stdout=out, stderr=err, text=True,
                            start_new_session=True)
    h = {"label": label, "module": module, "args": args, "proc": proc,
         "out": out, "err": err, "t0": time.perf_counter()}
    _STARTED.append(h)
    return h


def finish_cli(h, card, limit: float = 600.0) -> str:
    """Wait for a ``start_cli``; fails the run on a non-zero exit or
    ``limit`` s after its start. Returns its stdout."""
    label, module, args = h["label"], h["module"], " ".join(h["args"])
    try:
        code = h["proc"].wait(timeout=max(1.0, limit - (time.perf_counter()
                                                        - h["t0"])))
    except subprocess.TimeoutExpired:
        fail(f"{label}: python -m {module} {args} ran past {limit:.0f} s")
    secs = h.get("t_end", time.perf_counter()) - h["t0"]
    _STARTED.remove(h)
    for f in (h["out"], h["err"]):
        f.seek(0)
    out, err = h["out"].read(), h["err"].read()
    h["out"].close()
    h["err"].close()
    if code:
        # torchrun's own summary takes ~2 kB after the rank's traceback
        fail(f"{label}: python -m {module} {args} exited {code}: "
             f"{err.strip()[-12000:]}")
    for line in out.strip().splitlines():
        log(f"{label} CLI: {line}")
    log(f"{label} CLI: python -m {module} {args}: exit 0 in {secs:.1f} s "
        f"(start-up and init included); {card}")
    return out


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
# steps of each aggregation before the ungated and the profiled obcsaa step
# (3 mean steps: the loss must fall twice; 2 gated obcsaa steps)
LM_STEPS = {"mean": 3, "obcsaa": 2}


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
    """Phase 9's and 11c's check of one decoded leaf against its gradient,
    chunk by chunk (a block of chunks at a time): finite; at most ``decode_k`` nonzeros; with U = 1 and β = 1
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
        rows = 1 << 17      # a block of chunks at a time, as the trainer
        pad = (-grad.numel()) % ob.chunk
        flat = grad.reshape(-1)
        out = decoded.reshape(-1, ob.chunk)
        for r in range(0, out.shape[0], rows):
            g = flat[r * ob.chunk:(r + rows) * ob.chunk].float()
            if r + rows >= out.shape[0]:
                g = torch.nn.functional.pad(g, (0, pad))
            self.check(self.names[i], g.reshape(-1, ob.chunk),
                       out[r:r + rows])

    def check(self, name, g, o):
        ob = self.ob
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
    --steps 1`` as a user starts it. Returns the path's launch counts."""
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
        for t in range(LM_STEPS[agg]):
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
            log(f"lm obcsaa gates ({LM_STEPS['obcsaa']} steps): "
                f"{gate.chunks:,} decoded chunks "
                f"finite, at most {gate.max_nnz} nonzeros (decode_k "
                f"{ob.decode_k}), norms = ‖top-κ(g)‖ within "
                f"{gate.max_rel:.2e} relative, {gate.zero:,} all-zero "
                f"chunks decoded to exactly 0")
            # one more step, ungated: host s/step and the device stages
            clock = StageClock()
            t_un = LM_STEPS["obcsaa"]
            ctx = steps_lib.default_round_ctx(seed=t_un, device=dev)
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
            log(f"lm obcsaa step {t_un} (ungated): {ungated:.3f} s host clock, "
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
                ctx = steps_lib.default_round_ctx(seed=t_un + 1, device=dev)
                params, opt_state, _ = step(params, opt_state, batch, ctx)

            # CUPTI is set up by an empty profile, not by a whole step
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]):
                torch.zeros(1, device=dev).add_(1)
                torch.cuda.synchronize()
            wall, busy, events, _ = device_busy(one_step, setup=False)
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
    log(f"lm: s per step, median of the steps after the first: mean "
        f"{median(step_s['mean'][1:]):.3f}, obcsaa (gated) "
        f"{median(step_s['obcsaa'][1:]):.3f}; peak device memory "
        f"(max_memory_allocated): 3 mean steps {peak['mean']:.2f} GiB, the "
        f"ungated obcsaa step {peak['obcsaa']:.2f} GiB; {card}")
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lm: phase 9 took {time.perf_counter() - t_phase:.1f} s (its CLI "
        "runs with the CLI groups after phase 12)")
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
# what a later phase holds its run against, kept from an earlier one
ORACLES: dict = {}


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


def moe_oracle(label, model, params, prompt, fed, dec, first) -> dict:
    """15d's oracles from 10b's weights: the decode (tokens, logits, the
    first token), the same ``SERVE_GEN`` steps through ``serve_decode``
    with every MoE route recorded (``routes_recorded``: each call's router
    logits and experts), its tokens 10b's and its logits within 1e-5 of
    the decode's max (what 15d's run pinned to these routes is held to),
    and its own spread (``decode_spread``)."""
    with routes_recorded() as routes:
        whole = serve_decode(model, params, prompt)
    w_log = dec[:, :SERVE_GEN].cpu()
    apart = float((whole["logits"] - w_log).abs().max() / w_log.abs().max())
    if not torch.equal(whole["fed"], fed[:, :SERVE_GEN].cpu()) or apart > 1e-5:
        fail(f"{label}: serve_decode's tokens != the decode's, or its logits "
             f"{apart:.2e} of their max from the decode's (gate 1e-05)")
    log(f"{label}: serve_decode over the same prompt: the decode's tokens, "
        f"logits within {apart:.2e} of its max (gate 1e-05); {len(routes)} "
        "route calls recorded")
    spread, route_spread = decode_spread(label, model, params, prompt, fed,
                                         dec, routes)
    return {"fed": fed.cpu(), "logits": dec.cpu(), "first": first.cpu(),
            "spread": spread, "route_spread": route_spread,
            "whole": whole["logits"], "routes": routes}


def decode_spread(label, model, params, prompt, fed, dec, routes):
    """The whole decode's own f32 spread: its first ``SERVE_GEN`` steps
    run again with the rows in two blocks of B / 2 (a GEMM of another
    shape: a mere reordering), against the B-row run: the logits' largest
    difference in units of their max, and the router logits' largest
    difference from the B-row run's ``routes`` (``router_noise``). The
    tokens must not move."""
    B = prompt.shape[0]
    rows, recs = [], []
    for a in (0, B // 2):
        with routes_recorded() as rec:
            rows.append(serve_decode(model, params, prompt[a:a + B // 2]))
        recs.append(rec)
    r_fed, r_log = (torch.cat([g[k] for g in rows]) for k in ("fed",
                                                               "logits"))
    w_log = dec[:, :SERVE_GEN].cpu()
    if not torch.equal(r_fed, fed[:, :SERVE_GEN].cpu()):
        fail(f"{label}: the decode's tokens change with its rows decoded "
             "apart")
    spread = float((r_log - w_log).abs().max() / w_log.abs().max())
    # the blocks' token rows of each call, in the B-row run's order
    apart = [tuple(torch.cat(x) for x in zip(*calls))
             for calls in zip(*recs)]
    flip = first_route_flip(apart, routes)
    route_spread = router_noise(apart, routes)
    log(f"{label}: its first {SERVE_GEN} steps with the rows decoded in "
        f"two blocks of {B // 2} within {spread:.2e} of the logits' max "
        f"(the whole decode's own f32 spread); its router logits within "
        f"{route_spread:.3e} of the B-row run's over "
        + ("all its" if flip is None else f"the first {flip[0] + 1} of its")
        + f" {len(routes)} route calls")
    return spread, route_spread


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
        if label == "10a":          # 14c's prompt state and oracle
            ORACLES["10a"] = {
                "fed": fed.cpu(), "logits": dec.cpu(), "first": first.cpu(),
                "seeds": tuple(cache[k][:, :, :P].cpu() for k in ("k", "v"))}
        if label == "10b":          # 15d's oracles
            ORACLES["10b"] = moe_oracle(label, model, params, prompt, fed,
                                        dec, first)
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
    counts = build.launch_counts()
    # 10c's CLI runs with the CLI groups, in a process of its own
    expect_counts("lm decode (10a, 10b)", counts, {}, 0)
    log(f"lm decode: phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return counts


# -- phase 11 -----------------------------------------------------------------

# 11a mamba2-2.7b: a 368-token prompt stepped through decode_step (the SSM
# families have no prefill seeding) plus 16 tokens on their own argmax: 384
# positions, three SSD chunks of 128 in the forward it is held against, so
# the state crosses chunk boundaries; 11b zamba2-7b: 48 + 16 (one SSD
# chunk), the 13 shared-block layers' k/v rows against prefill's seeds. f32
# weights and compute, TF32 off.
FAMILY_DECODE = (("11a", "mamba2-2.7b", 2, 368, 2_996_753_920),
                 ("11b", "zamba2-7b", 2, 48, 6_673_653_584))
# 11c: the trainer's CLI defaults (as phase 9) on mamba2-2.7b
SSM_TRAIN_ARCH = "mamba2-2.7b"


def _gate(label, full, dec):
    """The reference test's gate (tests/test_decode_consistency.py):
    argmax equal, rtol = atol = 2e-2. Returns the max |diff|."""
    if not (torch.isfinite(dec).all() and torch.isfinite(full).all()):
        fail(f"{label}: non-finite logits")
    err = float((full - dec).abs().max())
    same = bool(torch.equal(full.argmax(-1), dec.argmax(-1)))
    if not (same and torch.allclose(dec, full, rtol=2e-2, atol=2e-2)):
        fail(f"{label}: decode != forward (argmax equal {same}, max |diff| "
             f"{err:.3e}, gate rtol = atol = 2e-2)")
    return err


def _full_width(arch, label, D_want, dev):
    """(cfg in f32, model, params from seed 0, init s)."""
    from repro_torch import tree
    from repro_torch.configs import get_config, scaled
    from repro_torch.models.registry import build_model

    cfg = scaled(get_config(arch), dtype="float32")
    model = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    D = sum(p.numel() for p in tree.leaves(params))
    if D != D_want:
        fail(f"{label} {arch}: D = {D:,}, want {D_want:,}")
    return cfg, model, params, init_s


def _steps(model, params, cache, tokens, start, prompt_len, B):
    """Step every token of ``tokens`` (B, T) through ``decode_step`` from
    ``pos = start``; past ``prompt_len`` each token is the argmax of the
    step before, written into ``tokens``. Returns (logits (B, T, V), each
    generated step's host ms, synchronised)."""
    logits, ms = [], []
    for i in range(tokens.shape[1]):
        if i >= max(prompt_len, 1):
            tokens[:, i] = torch.argmax(logits[-1], dim=-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = model.decode_step(params, cache, tokens[:, i:i + 1],
                                       start + i)
        torch.cuda.synchronize()
        if i >= prompt_len:
            ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(out[:, 0])
    return torch.stack(logits, dim=1), ms


def _busy(label, card, fn, what):
    wall, busy, events, _ = device_busy(fn)
    log(f"{label}: profiler, {what}: wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(e.count for e in events):,} events on the card; {card}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")


def run_recurrent_decode(dev, card, label, arch, B, P, D_want) -> None:
    """11a/11b: a P-token prompt stepped through ``decode_step`` from an
    empty cache, then ``DECODE_GEN`` tokens on their own argmax; every
    position's decode logits against ``prefill``'s (the full forward,
    which also returns the cache seeds) at the reference test's gate. For
    the hybrid, each shared-block layer's k/v cache rows against
    prefill's seeds (the same gate), and every other layer's rows exactly
    zero."""
    import gc

    from repro_torch.models.transformer import layer_flags

    torch.cuda.reset_peak_memory_stats()
    cfg, model, params, init_s = _full_width(arch, label, D_want, dev)
    total = P + DECODE_GEN
    gen = torch.Generator(device="cpu").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, total), generator=gen,
                           dtype=torch.int32).to(dev)
    cache = model.init_cache(B, total, dev)
    t0 = time.perf_counter()
    dec, step_ms = _steps(model, params, cache, tokens, 0, P, B)
    steps_s = time.perf_counter() - t0
    fwd_ms = []
    for _ in range(2):          # cold, warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full, seeds = model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
    err = _gate(f"{label} {arch}", full, dec)
    kv = ""
    if cfg.family == "hybrid":
        attn = layer_flags(cfg)["apply_attn"].to(dev)
        errs = []
        for name, seed in zip(("k", "v"), seeds[2:]):
            if bool(cache[name][~attn].any()) or bool(seed[~attn].any()):
                fail(f"{label}: {name} rows of a layer without attention "
                     "are not zero")
            got, want = cache[name][attn], seed[attn]
            errs.append(float((got - want).abs().max()))
            if not torch.allclose(got, want, rtol=2e-2, atol=2e-2):
                fail(f"{label}: decoded {name} rows off prefill's seeds by "
                     f"up to {errs[-1]:.3e} (gate rtol = atol = 2e-2)")
        kv = (f"; k/v cache rows of the {int(attn.sum())} shared-block "
              f"layers against prefill's seeds: max |diff| {errs[0]:.3e} / "
              f"{errs[1]:.3e}, the other {int((~attn).sum())} layers' rows "
              f"all zero")
    del full, seeds
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{label} {arch}: D={int(D_want):,} f32, B={B}, {P} prompt + "
        f"{DECODE_GEN} generated tokens stepped in {steps_s:.1f} s; init "
        f"{init_s:.2f} s; decode ms per generated step (host clock, "
        f"synchronised) median {median(step_ms):.2f}, min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}; "
        f"{1e3 * B / median(step_ms):.1f} tokens/s at the median; forward "
        f"(prefill) over {total} tokens {fwd_ms[0]:.1f} ms cold, "
        f"{fwd_ms[1]:.1f} warm; peak device memory {peak:.2f} GiB; "
        f"decode = forward over all {total} positions: argmax equal, max "
        f"|diff| {err:.3e} (gate rtol = atol = 2e-2){kv}; {card}")

    def steps4():
        # the state moves on: timing only, after every check
        for i in range(total - 4, total):
            model.decode_step(params, cache, tokens[:, i:i + 1], i)

    _busy(f"{label} {arch}", card, steps4, "4 decode steps")
    del params, cache, dec
    gc.collect()
    torch.cuda.empty_cache()


def run_ssm_trainer(dev, card) -> None:
    """11c: the trainer at mamba2-2.7b's full width (D = 2,996,753,920),
    batch 4 x 128, the CLI's defaults: 2 ``mean`` steps, the loss falling;
    1 ``obcsaa`` step (BIHT 10) whose every decoded leaf passes
    ``LeafGate``, its stages split by CUDA events; peak memory."""
    import gc

    from repro_torch import tree
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.train import make_batch
    from repro_torch.models.registry import build_model

    cfg = get_config(SSM_TRAIN_ARCH)
    model = build_model(cfg)
    batch = make_batch(cfg, LM_BATCH, LM_SEQ, device=dev)
    for agg, n in (("mean", 2), ("obcsaa", 1)):
        gc.collect()
        torch.cuda.empty_cache()
        tcfg = TrainConfig(aggregation=agg, **LM_TRAIN)
        params = model.init(0, device=dev)
        paths = tree.flatten_with_paths(params)[0]
        D = sum(p.numel() for _, p in paths)
        opt_state = steps_lib.make_optimizer(tcfg).init(params)
        step = steps_lib.make_train_step(model, tcfg)
        gate = None
        if agg == "obcsaa":
            ob = steps_lib.obcsaa_config(tcfg)
            gate = LeafGate(ob, [p for p, _ in paths])
        clock = StageClock(gate)
        losses, secs = [], []
        torch.cuda.reset_peak_memory_stats()
        for t in range(n):
            ctx = steps_lib.default_round_ctx(seed=t, device=dev)
            ctx["hook"] = clock
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clock.start()
            params, opt_state, m = step(params, opt_state, batch, ctx)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not all(np.isfinite(losses)):
            fail(f"11c {agg}: a loss is not finite: {losses}")
        if agg == "mean" and not losses[1] < losses[0]:
            fail(f"11c mean: the loss does not fall: {losses}")
        msg = (f"11c {SSM_TRAIN_ARCH} {agg}: D={D:,}, batch {LM_BATCH} x "
               f"{LM_SEQ}; losses " + ", ".join(f"{x:.4f}" for x in losses)
               + "; s per step (host clock, synchronised) "
               + ", ".join(f"{x:.3f}" for x in secs)
               + f"; peak device memory {peak:.2f} GiB")
        if agg == "obcsaa":
            st = clock.stages()
            msg += (f"; gated: {gate.chunks:,} decoded chunks finite, at "
                    f"most {gate.max_nnz} nonzeros (decode_k "
                    f"{ob.decode_k}), norms = ‖top-κ(g)‖ within "
                    f"{gate.max_rel:.2e}; device ms: forward+backward "
                    f"{st['backward']:.1f}, compression "
                    f"{st['compress']:.1f}, decode {st['decode']:.1f} (the "
                    f"gate's checks outside), update {st['update']:.1f}")
        log(msg + f"; {card}")
        del params, opt_state, step, clock, gate
    del batch
    gc.collect()
    torch.cuda.empty_cache()


def run_vlm_decode(dev, card) -> None:
    """11d: internvl2-1b at full width in f32: ``make_seeded_prefill``
    over 256 image embeddings (random, seed 0) and a 32-token prompt,
    then 16 decode steps on their own argmax, held against the forward
    with the image prefix over the same text (its last 16 positions)."""
    import gc

    from repro_torch.launch.steps import make_seeded_prefill

    torch.cuda.reset_peak_memory_stats()
    cfg, model, params, init_s = _full_width("internvl2-1b", "11d",
                                             493_982_720, dev)
    B, P, N = 2, 32, cfg.num_image_tokens
    gen = torch.Generator(device="cpu").manual_seed(0)
    img = torch.randn((B, N, cfg.d_model), generator=gen).to(dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, P + DECODE_GEN),
                           generator=gen, dtype=torch.int32).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, off = make_seeded_prefill(model, N + P + DECODE_GEN)(
        params, {"tokens": tokens[:, :P], "image_embeds": img})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if off != N + P:
        fail(f"11d: seeded prefill offset {off} != {N + P}")
    tokens[:, P] = torch.argmax(logits[:, -1], dim=-1)
    dec, step_ms = _steps(model, params, cache, tokens[:, P:], off, 0, B)
    with torch.no_grad():
        full = model.forward(params, {"tokens": tokens, "image_embeds": img},
                             remat=False)[:, N + P:]
    err = _gate("11d internvl2-1b", full, dec)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"11d internvl2-1b: D=493,982,720 f32, B={B}, {N} image embeddings "
        f"+ {P} prompt tokens (offset {off}); init {init_s:.2f} s; seeded "
        f"prefill {prefill_ms:.1f} ms (cold); decode ms per step median "
        f"{median(step_ms):.2f}, min {min(step_ms):.2f}, max "
        f"{max(step_ms):.2f}; peak device memory {peak:.2f} GiB; decode = "
        f"forward with the image prefix over the last {DECODE_GEN} "
        f"positions: argmax equal, max |diff| {err:.3e}; {card}")
    del params, cache, full, dec, logits
    gc.collect()
    torch.cuda.empty_cache()


def run_encdec_decode(dev, card) -> None:
    """11e: whisper-base at full width in f32, B = 2: ``encode`` over
    1,500 random frames (seed 0), ``seed_cross_cache``, 32 decode steps
    (a random first token, then each step's argmax), held against
    ``decode_full`` over the same tokens."""
    import gc

    from repro_torch.models import encdec

    torch.cuda.reset_peak_memory_stats()
    cfg, model, params, init_s = _full_width("whisper-base", "11e",
                                             72_708_608, dev)
    B, T = 2, 32
    gen = torch.Generator(device="cpu").manual_seed(0)
    frames = torch.randn((B, cfg.encoder_seq_len, cfg.d_model),
                         generator=gen).to(dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           dtype=torch.int32).to(dev)
    enc_ms = []
    for _ in range(2):          # cold, warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            enc = encdec.encode(params, cfg, frames)
        torch.cuda.synchronize()
        enc_ms.append((time.perf_counter() - t0) * 1e3)
    cache = encdec.seed_cross_cache(params, cfg,
                                    model.init_cache(B, T, dev), enc)
    dec, step_ms = _steps(model, params, cache, tokens, 0, 1, B)
    with torch.no_grad():
        full = encdec.decode_full(params, cfg, tokens, enc, remat=False)
    err = _gate("11e whisper-base", full, dec)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"11e whisper-base: D=72,708,608 f32, B={B}, {cfg.encoder_seq_len} "
        f"frames; init {init_s:.2f} s; encode {enc_ms[0]:.1f} ms cold, "
        f"{enc_ms[1]:.1f} warm; decode ms per step median "
        f"{median(step_ms):.2f}, min {min(step_ms):.2f}, max "
        f"{max(step_ms):.2f}; peak device memory {peak:.2f} GiB; decode = "
        f"decode_full over {T} positions: argmax equal, max |diff| "
        f"{err:.3e}; {card}")
    del params, cache, full, dec, enc
    gc.collect()
    torch.cuda.empty_cache()


def run_families_phase(dev, card: str) -> dict:
    """Phase 11: the SSM, hybrid, VLM and encoder-decoder families at
    full width (11a-11e above), each path's CLI as a user starts it, and
    11f ``python -m repro_torch.launch.decode_demo --arch mamba2-2.7b``
    in bf16. The launch counters of K1-K7 must read 0 (no reference path
    of these families reaches a Pallas kernel). Returns the counts."""
    import gc

    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    build.reset_launch_counts()
    for cell in FAMILY_DECODE:
        run_recurrent_decode(dev, card, *cell)
    run_ssm_trainer(dev, card)
    run_vlm_decode(dev, card)
    run_encdec_decode(dev, card)
    counts = build.launch_counts()
    # the CLIs run with the CLI groups, in processes of their own
    expect_counts("families (11a-11e)", counts, {}, 0)
    log(f"families: phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return counts


# -- phase 12 -----------------------------------------------------------------

# benchmarks/zoo_bench.py's >=1B geometry (FULL_OB, :220-222): D_c = 16,384
# (K1's MAX_D), S_c = 32 (one packed word a chunk), κ_c = 8, IHT 2 (decode
# k = 16); its rounds' σ², P^Max and lr
ZOO_OB = dict(chunk=16384, measure=32, topk=8, biht_iters=2,
              recon_alg="iht", spmd_topk=True, packed=True, bisect_iters=10)
ZOO_KEY, ZOO_NV, ZOO_PMAX, ZOO_LR = 0, 1e-4, 10.0, 0.05
# 12a, the kernel round against the plain round from the same parameters
# and draws: ĝ's NMSE, its support overlap, and the parameters' distance
# as a share of their movement (first card run: 4.7e-06, 0.999998,
# 2.2e-03). A chunk parts where K3/K4 and the plain GEMMs round a near tie
# of the decode's threshold apart; at most 1% of the chunks may
ZOO_GHAT_NMSE, ZOO_SUPPORT, ZOO_PARAM_TOL = 1e-4, 0.999, 1e-2
ZOO_ROWS = 4096          # the zoo's block of chunk rows (BLOCK_BYTES / 4 D_c)


class ZooClock:
    """The zoo round's hook: an event where each piece of a stage ends and
    one where the next begins, so what the hook does between them (a copy
    of the MAC sums) is outside every interval. ``stages()`` sums device
    ms per stage."""

    def __init__(self, keep_mac: bool = False):
        self.keep_mac, self.mac, self.marks = keep_mac, None, []
        self.mem = []       # (stage, allocated, peak so far) at each mark

    @staticmethod
    def _event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def start(self):
        self.marks = [("start", None, self._event())]

    def __call__(self, stage, **info):
        end = self._event()
        if self.keep_mac and stage == "mac":
            self.mac = (info["y_sum"].clone(), info["mag_sum"].clone())
        self.mem.append((stage, torch.cuda.memory_allocated(),
                         torch.cuda.max_memory_allocated()))
        self.marks.append((stage, end, self._event()))

    def stages(self) -> dict:
        torch.cuda.synchronize()
        out = {}
        for prev, (stage, end, _) in zip(self.marks, self.marks[1:]):
            out[stage] = out.get(stage, 0.0) + prev[2].elapsed_time(end)
        return out


def zoo_counts(zr) -> dict:
    """K1-K4 launches of one zoo round with the kernels: per compression
    block (every worker's model halves, each owner's rows of a half in
    blocks) one K1 and one K2 (pack); per decode block (each cell's own
    rows in blocks) ``biht_iters`` IHT iterations of K3, K4 and K1."""
    nd = zr.U * zr.n_model * -(-zr.n_local // zr.block_rows)
    nc = zr.U * nd
    it = zr.ob.biht_iters
    return {"topk_select": nc + it * nd, "cs_project": nc,
            "cs_project_resid": it * nd, "backproject": it * nd}


def check_zoo_kernels(dev, results) -> None:
    """K1-K4 against their plain versions at the zoo's shapes: a block of
    4,096 chunk rows of D_c = 16,384, S_c = 32, κ = 8 (compression) and
    decode k = 16. K1's values and masks exact, K2's packed signs equal
    but on borderline lanes, K3 and K4 to rtol = atol = 1e-5. Times:
    back-to-back calls between CUDA events (a call moves 0.3-0.6 GB, so
    the host's launch cost is hidden)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.backproject import backproject_plain
    from repro_torch.kernels.cs_project import project, project_plain
    from repro_torch.kernels.sign import unpack_bits
    from repro_torch.kernels.topk_select import topk_select_plain

    n, d, s = ZOO_ROWS, ZOO_OB["chunk"], ZOO_OB["measure"]
    kappa, k_dec = ZOO_OB["topk"], min(4 * ZOO_OB["topk"], s // 2)
    gen = torch.Generator(device=dev).manual_seed(12)
    phi = torch.randn(s, d, generator=gen, device=dev) / s ** 0.5
    g = torch.randn(n, d, generator=gen, device=dev) * 0.025
    for k in (kappa, k_dec):
        got, want = ops.topk_select(g, k), topk_select_plain(g, k)
        if not (torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1])):
            fail(f"zoo K1 at ({n}, {d}), k = {k}: values or masks differ "
                 "from the plain version")
    sparse = ops.topk_select(g, kappa)[0]
    flips, hard = sign_flips(
        phi, sparse, unpack_bits(ops.cs_project_pack(phi, sparse),
                                 torch.float32),
        unpack_bits(project_plain(phi, sparse, mode="pack"), torch.float32))
    if hard:
        fail(f"zoo K2 pack at S = {s}: {hard} non-borderline sign flips")
    x = ops.topk_select(g, k_dec)[0]
    y = torch.randn(n, s, generator=gen, device=dev)
    r = torch.randn(n, s, generator=gen, device=dev)
    e3 = close(project(phi, x, mode="residual", y=y),
               project_plain(phi, x, mode="residual", y=y))
    e4 = close(ops.backproject(x, r, phi, 0.5),
               backproject_plain(x, r, phi, 0.5))
    nb, pb = n * d * 4, s * d * 4
    rows = {
        "topk_select": (lambda: ops.topk_select(g, kappa),
                        lambda: topk_select_plain(g, kappa),
                        lambda: torch.topk(g.abs(), kappa, dim=-1),
                        bound(2 * nb + n * d, 0), 0.0),
        "cs_project": (lambda: ops.cs_project_pack(phi, sparse),
                       lambda: project_plain(phi, sparse, mode="pack"),
                       lambda: sparse @ phi.T,
                       bound(nb + pb + 4 * n, 2 * n * d * s), 0.0),
        "cs_project_resid": (lambda: project(phi, x, mode="residual", y=y),
                             lambda: project_plain(phi, x, mode="residual",
                                                   y=y),
                             lambda: torch.addmm(y, x, phi.T, alpha=-1),
                             bound(nb + pb + 8 * n * s, 2 * n * d * s), e3),
        "backproject": (lambda: ops.backproject(x, r, phi, 0.5),
                        lambda: backproject_plain(x, r, phi, 0.5),
                        lambda: torch.addmm(x, r, phi, alpha=0.5),
                        bound(2 * nb + pb + 4 * n * s, 2 * n * d * s), e4),
    }
    for name, (fn, plain, lib, bnd, err) in rows.items():
        ms, pms, lms = (call_ms(f, reps=10) for f in (fn, plain, lib))
        results[name].update({"ms_zoo": ms, "plain_ms_zoo": pms,
                              "library_ms_zoo": lms, "bound_ms_zoo": bnd[0],
                              "max_abs_err_zoo": err})
        log(f"zoo kernels: {name} at ({n}, {d}), S = {s}: {ms:.3f} ms, "
            f"plain {pms:.3f}, library {lms:.3f}, bound {bnd[0]:.3f} "
            f"({bnd[1]}), max abs err {err:.2e}")
    log(f"zoo kernels: K1 exact at k = {kappa}, {k_dec}; K2 {flips} "
        f"borderline flips of {n * s} lanes; K3 {e3:.2e}, K4 {e4:.2e}")


def _zoo_log_round(label, card, secs, clocks, launches):
    for i, (s, clk) in enumerate(zip(secs, clocks)):
        st = clk.stages()
        log(f"{label}: round {i}: {s:.3f} s host clock; device ms "
            + ", ".join(f"{k} {v:.1f}" for k, v in st.items())
            + f" (sum {sum(st.values()):.1f}); {card}")
    log(f"{label}: launches per round {launches}")


def _zoo_borderline_lanes(zr, before, rows, t):
    """(rows, S_c) bool: lanes of those chunk rows where some scheduled
    worker's projection is borderline (``sign_flips``' bound) on the
    round's surrogate gradient."""
    from repro_torch.engine.zoo import _M32, _hash_u01
    from repro_torch.kernels.topk_select import topk_select_plain

    dc = zr.ob.chunk
    phi = zr.phi.double()
    pn = torch.linalg.vector_norm(phi, dim=1)
    cols = torch.arange(dc, dtype=torch.int64, device=before.device)
    idx = (rows[:, None].to(torch.int64) * dc + cols[None]) & _M32
    out = torch.zeros((rows.numel(), zr.ob.measure), dtype=torch.bool,
                      device=before.device)
    for u in range(zr.U):
        c = zr.grad_scale * (_hash_u01(idx, u, t) - 0.5)
        g = torch.where(idx < zr.D, before[rows] - c,
                        torch.zeros_like(c))
        x = topk_select_plain(g, zr.ob.topk)[0].double()
        acc = x @ phi.T
        lim = 2 * dc * 2.0 ** -24 * torch.linalg.vector_norm(
            x, dim=1)[:, None] * pn[None]
        out |= acc.abs() <= lim
    return out


def _zoo_compare(before, pk, pp):
    """ĝ of the kernel round against the plain round through the
    parameters' movement Δ = p − p_before = −lr·ĝ, a block at a time:
    (NMSE, support overlap, ‖pk − pp‖ / ‖Δ_plain‖, chunks parted: those
    whose Δ differs by more than 1e-4 of the chunk's own norm)."""
    num = den = inter = supp = 0.0
    parted = 0
    for a in range(0, before.shape[0], ZOO_ROWS):
        b0 = before[a:a + ZOO_ROWS]
        dk, dp = pk[a:a + ZOO_ROWS] - b0, pp[a:a + ZOO_ROWS] - b0
        err = torch.linalg.vector_norm((dk - dp).double(), dim=1)
        nrm = torch.linalg.vector_norm(dp.double(), dim=1)
        num += float(torch.sum(err ** 2))
        den += float(torch.sum(nrm ** 2))
        parted += int((err > 1e-4 * nrm).sum())
        inter += float(((dk != 0) & (dp != 0)).sum())
        supp += float((dp != 0).sum())
    nmse = num / max(den, 1e-30)
    return nmse, inter / max(supp, 1.0), nmse ** 0.5, parted


def run_zoo_surrogate(dev, card) -> dict:
    """12a: the surrogate round at gemma2-2b's full width on the logical
    4 x 2 mesh, K1-K4 and K7 on; held against the plain round. Returns
    the kernel rounds' launch counts."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core.obcsaa import OBCSAAConfig
    from repro_torch.engine.zoo import build_zoo_round
    from repro_torch.kernels import build
    from repro_torch.kernels.topk_select import N_BISECT
    from repro_torch.launch.mesh import make_zoo_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.sched import SchedConfig

    shapes = build_model(get_config("gemma2-2b")).init(0, device="meta")
    D = sum(p.numel() for p in tree.leaves(shapes))
    if D != LM_D:
        fail(f"12a: gemma2-2b has D = {D:,}, want {LM_D:,}")
    mesh = make_zoo_mesh(4, 2)
    zr = build_zoo_round(OBCSAAConfig(**ZOO_OB, use_kernels=True), D, mesh,
                         scheduler="greedy_batched",
                         sched_cfg=SchedConfig(use_kernel=True), device=dev)
    per_round = {**zoo_counts(zr), "prefix_eval": 1}
    log(f"12a: D = {D:,}, D_pad = {zr.n_chunks:,} x {zr.ob.chunk:,}, mesh "
        f"{zr.U} x {zr.n_model} (n_half {zr.n_half:,}, n_local "
        f"{zr.n_local:,}); the reference's block / block_dec {zr.block} / "
        f"{zr.block_dec}, the port's blocks {zr.block_rows} rows")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = torch.zeros((zr.n_chunks, zr.ob.chunk), device=dev)
    params.view(-1)[:D].normal_(0.0, 0.02, generator=gen)
    args = (ZOO_KEY, ZOO_NV, ZOO_PMAX, ZOO_LR)
    t0 = time.perf_counter()
    zr.round_gen(params, 0, *args)                          # warm-up
    torch.cuda.synchronize()
    log(f"12a: warm-up round {time.perf_counter() - t0:.3f} s")
    dr = zr.draws(ZOO_KEY)(2)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    secs, clocks, stats = [], [], []
    for t in (1, 2):
        if t == 2:
            before = params.clone()
        clk = ZooClock(keep_mac=t == 2)
        torch.cuda.synchronize()
        clk.start()
        t0 = time.perf_counter()
        _, st = zr.round_gen(params, t, *args, draws=dr if t == 2 else None,
                             hook=clk)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        clocks.append(clk)
        stats.append(st)
        if t == 1:
            peak_round = torch.cuda.max_memory_allocated()
    counts = build.launch_counts()
    expect_counts("12a zoo kernel rounds", counts, per_round, 2)
    _zoo_log_round("12a", card, secs, clocks, per_round)
    for st in stats:
        if not (bool(torch.isfinite(st.ghat_norm)) and float(st.ghat_norm)
                > 0 and all(bool(torch.isfinite(x).all())
                            for x in st.budget)):
            fail("12a: ĝ's norm or a budget term is not finite and positive")
    log(f"12a: |M_t| = {int(stats[1].n_scheduled)}, b_t = "
        f"{float(stats[1].b_t):.4f}, ‖ĝ‖ = {float(stats[1].ghat_norm):.4f}; "
        f"peak memory of a round {peak_round / 2**30:.2f} GiB")
    # the plain path from the same parameters and draws
    zp = build_zoo_round(OBCSAAConfig(**{**ZOO_OB, "bisect_iters": N_BISECT}),
                         D, mesh, scheduler="greedy_batched",
                         sched_cfg=SchedConfig(), device=dev)
    plain = before.clone()
    clk = ZooClock(keep_mac=True)
    build.reset_launch_counts()
    torch.cuda.synchronize()
    clk.start()
    t0 = time.perf_counter()
    _, stp = zp.round_gen(plain, 2, *args, draws=dr, hook=clk)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    expect_counts("12a zoo plain round", build.launch_counts(), {}, 0)
    _zoo_log_round("12a plain", card, [plain_s], [clk], {})
    (yk, mk), (yp, mp) = clocks[1].mac, clk.mac
    if not torch.equal(mk, mp):
        fail("12a: the MAC's magnitude sums differ: K1 and the 32-step "
             "bisection selected different entries")
    diff = yk != yp
    rows = diff.any(dim=1).nonzero()[:, 0]
    lanes = int(diff.sum())
    if lanes:
        border = _zoo_borderline_lanes(zr, before, rows, 2)
        hard = int((diff[rows] & ~border).sum())
        if hard:
            fail(f"12a: {hard} MAC lanes differ where no worker's sign is "
                 "borderline")
    nmse, overlap, pdist, parted = _zoo_compare(before, params, plain)
    log(f"12a kernel vs plain: MAC sums equal but on {lanes} borderline "
        f"lanes of {yk.numel():,} ({rows.numel()} chunks); magnitude sums "
        f"equal; ĝ NMSE {nmse:.3e} (gate {ZOO_GHAT_NMSE:g}), support "
        f"overlap {overlap:.6f} (gate {ZOO_SUPPORT:g}), ‖Δp‖ {pdist:.3e} "
        f"of the movement (gate {ZOO_PARAM_TOL:g}), {parted} of "
        f"{zr.n_chunks:,} chunks parted by more than 1e-4 of their norm "
        f"(gate 1%); ‖ĝ‖ {float(stats[1].ghat_norm):.6f} / "
        f"{float(stp.ghat_norm):.6f}")
    if nmse > ZOO_GHAT_NMSE or overlap < ZOO_SUPPORT \
            or pdist > ZOO_PARAM_TOL or parted > zr.n_chunks // 100:
        fail("12a: the kernel round parts from the plain round beyond "
             "its gates")
    del before, plain
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev).add_(1)       # sets CUPTI up
        torch.cuda.synchronize()
    wall, busy, events, _ = device_busy(
        lambda: zr.round_gen(params, 3, *args), setup=False)
    log(f"12a: profiler, one kernel round: wall {wall:.1f} ms, device "
        f"busy {busy:.1f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(e.count for e in events):,} events on the card; {card}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    log(f"12a: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB with the comparison's two copies; plain round "
        f"{plain_s:.3f} s")
    return counts


def run_zoo_train_full(dev, card) -> dict:
    """12b: benchmarks/zoo_bench.py's >=1B real-gradient row
    (``_train_full_rows``): gemma2-2b on the logical 2 x 4 mesh, batch 1 x
    32, SGD, bf16 compute, remat full, K1-K4 on; two rounds. Returns
    their launch counts."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core.obcsaa import OBCSAAConfig
    from repro_torch.engine.zoo_train import build_zoo_train_round
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_zoo_mesh
    from repro_torch.models.registry import build_model

    cfg = get_config("gemma2-2b")
    model = build_model(cfg)
    zr = build_zoo_train_round(
        model, make_zoo_mesh(2, 4), OBCSAAConfig(**ZOO_OB, use_kernels=True),
        compute_dtype=torch.bfloat16, remat="full", optimizer="sgd",
        device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    master = zr.chunk_params(params)
    back = zr.params_from_master(master)
    same = all(torch.equal(a, b) for a, b in zip(tree.leaves(params),
                                                  tree.leaves(back)))
    torch.cuda.synchronize()
    if not same:
        fail("12b: params_from_master(chunk_params(init)) != init")
    del params, back
    log(f"12b: D = {zr.D:,} in {zr.n_chunks:,} chunks, mesh {zr.U} x "
        f"{zr.n_model}; init + chunk_params + params_from_master "
        f"{time.perf_counter() - t0:.1f} s, the round trip bit for bit")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (zr.U, 1, 32)).astype(np.int32)
    batch = zr.shard_batch({"tokens": tok,
                            "targets": np.roll(tok, -1, -1)})
    state = zr.init_state(master)
    per_round = zoo_counts(zr)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    secs, clocks = [], []
    for t in range(2):
        digest = float(state.master.sum(dtype=torch.float64))
        clk = ZooClock()
        torch.cuda.synchronize()
        clk.start()
        t0 = time.perf_counter()
        state, st = zr.round_train(state, batch, t, ZOO_KEY, ZOO_NV,
                                   ZOO_PMAX, ZOO_LR, hook=clk)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        clocks.append(clk)
        if not bool(torch.isfinite(st.loss)):
            fail(f"12b: round {t} loss is not finite")
        if not all(bool(torch.isfinite(x).all()) for x in st.budget):
            fail(f"12b: round {t}: a budget term is not finite")
        if float(state.master.sum(dtype=torch.float64)) == digest:
            fail(f"12b: round {t} left the master where it was")
        log(f"12b: round {t}: loss {float(st.loss):.4f}, b_t "
            f"{float(st.b_t):.4f}, ‖ĝ‖ {float(st.ghat_norm):.4f}")
    counts = build.launch_counts()
    expect_counts("12b zoo-train rounds", counts, per_round, 2)
    _zoo_log_round("12b", card, secs, clocks, per_round)
    bw = clocks[-1].stages().get("backward", 0.0)
    log(f"12b: per-worker backward {bw / zr.U:.1f} ms (device); peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    first = {}
    for stage, alloc, peak in clocks[0].mem:
        first.setdefault(stage, (alloc, peak))
    log("12b: round 0's memory where a stage first ends (allocated / peak "
        "so far, GiB): " + ", ".join(
            f"{k} {a / 2**30:.2f} / {p / 2**30:.2f}"
            for k, (a, p) in first.items()))
    return counts


def _ckpt_arrays(path):
    with np.load(os.path.join(path, "arrays.npz")) as f:
        return {k: f[k] for k in f.files}


def await_exits(hs, limit: float = 600.0) -> None:
    """Wait for CLIs that run at once to exit (or ``limit`` s after the
    first's start), each one's exit time noted for ``finish_cli``."""
    t0 = min(h["t0"] for h in hs)
    while time.perf_counter() - t0 < limit:
        for h in hs:
            if "t_end" not in h and h["proc"].poll() is not None:
                h["t_end"] = time.perf_counter()
        if all("t_end" in h for h in hs):
            break
        time.sleep(0.2)


def finish_clis(hs, card, limit: float = 600.0) -> list:
    """``finish_cli`` for CLIs that run at once, each one's time taken to
    its own exit. Returns their stdouts."""
    await_exits(hs, limit)
    return [finish_cli(h, card, limit) for h in hs]


def run_cli_groups(card) -> None:
    """The CLIs of phases 9-12, whose times no phase reports, as a user
    starts them, in two groups that each run at once on the card (their
    peaks fit it together), B once all of A but 11e has exited (11e's
    whisper-base, ~2.5 GiB, ends beside B): (A) 11c ``--arch mamba2-2.7b --agg mean
    --steps 2``, 11d ``--arch internvl2-1b --steps 2``, 11e ``--arch
    whisper-base --steps 2`` and 12c's uninterrupted 3 rounds and 2
    rounds of ``--zoo-train --smoke`` with Adam, EF and token shards
    from ``write_token_shards``; (B) 9's ``--arch gemma2-2b --steps 1``,
    10c ``decode_demo --arch gemma2-2b``, 11f ``decode_demo --arch
    mamba2-2.7b`` (bf16, batch 4, prompt 32, 16 tokens), 12c's resume of
    the 2-round run to 3 (its checkpoint equal to the uninterrupted run's
    bit for bit) and ``--arms 3``."""
    import tempfile
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import write_token_shards

    t0 = time.perf_counter()
    vocab = get_smoke_config("gemma2-2b").vocab_size
    rng = np.random.default_rng(0)
    train, demo = "repro_torch.launch.train", "repro_torch.launch.decode_demo"
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        data = write_token_shards(os.path.join(tmp, "tok"), [
            rng.integers(0, vocab, n) for n in (4096, 3000, 5000)])
        base = ["--zoo-train", "--smoke", "--arch", "gemma2-2b",
                "--optimizer", "adam", "--error-feedback", "--data", data,
                "--batch", "2", "--seq", "32"]
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        group_a = [start_cli(*x) for x in (
            ("11c", train, ["--arch", SSM_TRAIN_ARCH, "--agg", "mean",
                            "--steps", "2"]),
            ("11d", train, ["--arch", "internvl2-1b", "--steps", "2"]),
            ("11e", train, ["--arch", "whisper-base", "--steps", "2"]),
            ("12c", train, base + ["--steps", "3", "--ckpt-dir", a]),
            ("12c", train, base + ["--steps", "2", "--ckpt-dir", b]))]
        await_exits([h for h in group_a if h["label"] != "11e"])
        group_b = [start_cli(*x) for x in (
            ("lm", train, ["--arch", LM_ARCH, "--steps", "1"]),
            ("10c decode_demo", demo, ["--arch", "gemma2-2b", "--batch",
                                       "4", "--prompt-len", "32", "--gen",
                                       "16"]),
            ("11f", demo, ["--arch", "mamba2-2.7b", "--batch", "4",
                           "--prompt-len", "32", "--gen", "16"]),
            ("12c", train, base + ["--steps", "3", "--ckpt-dir", b,
                                   "--resume"]),
            ("12c", train, base + ["--steps", "2", "--arms", "3"]))]
        finish_clis(group_a, card)
        outs = finish_clis(group_b, card)
        for label, out in zip(("10c", "11f"), outs[1:3]):
            if "tok/s" not in out:
                fail(f"{label}: the decode_demo CLI printed no tokens/s")
        if "resumed zoo-train at round 2" not in outs[3]:
            fail("12c: --resume did not resume at round 2")
        x, y = (_ckpt_arrays(os.path.join(p, "step_00000003"))
                for p in (a, b))
        if x.keys() != y.keys() or not all(np.array_equal(x[k], y[k])
                                           for k in x):
            fail("12c: resumed != uninterrupted")
        if sum(ln.startswith("arm ") for ln in outs[4].splitlines()) != 3:
            fail("12c: --arms 3 did not report 3 arms")
    log(f"12c: resume ≡ uninterrupted bit for bit in all {len(x)} leaves")
    log(f"the CLI groups of phases 9-12 took {time.perf_counter() - t0:.1f} s")


def run_zoo_phase(dev, card: str, results: dict) -> dict:
    """Phase 12, the zoo. Returns {path: launch counts}."""
    t_phase = time.perf_counter()
    check_zoo_kernels(dev, results)
    paths = {"zoo_surrogate": run_zoo_surrogate(dev, card)}
    torch.cuda.empty_cache()
    paths["zoo_train"] = run_zoo_train_full(dev, card)
    torch.cuda.empty_cache()
    log(f"zoo: phase 12 took {time.perf_counter() - t_phase:.1f} s (12c "
        "runs with the CLI groups)")
    return paths


# -- phase 13 -----------------------------------------------------------------

# the federation over processes: U = 4 FL workers of internvl2-1b (the
# CLI's defaults: batch 4 x 128, one sequence a worker, SGD lr 3e-2, chunks
# of 1024, S_c 256, κ_c 64, BIHT 10), four ranks sharing the card over gloo
FED_ARCH, FED_U, FED_D, FED_STEPS = "internvl2-1b", 4, 493_982_720, 2
# 13b, the process group against the U workers in turn in one process:
# ĝ (from the SGD steps' checkpoints) by NMSE and support overlap, the
# parameters within a share of their movement (Queue 3's contract)
FED_GHAT_NMSE, FED_SUPPORT, FED_PARAM_TOL = 1e-4, 0.999, 1e-4
FED_STEP = re.compile(r"step +(\d+) loss=(\S+) \(([\d.]+)s\) wire: "
                      r"all_reduce ([\d.]+) MB ([\d.]+) ms, broadcast "
                      r"([\d.]+) MB ([\d.]+) ms")


def federation_rank() -> None:
    """13a in each rank that ``torchrun`` starts (``chip_smoke.py
    --federation-rank``): the ranks share the card over gloo. The int32
    lane sums of ``psum_bits_mac`` at the zoo's geometry (4,096 rows, S_c
    32, β = 1, 0, 1, 1) scaled by 0.5 against the one-process einsum of
    every rank's unpacked symbols, bit for bit; f32 ``psum`` and
    ``pmean`` of 2^20 values against the one-process sum (rtol 1e-6), the
    same on every rank; ``all_gather`` stacked and tiled, exact; the
    gather's backward (the summed cotangent's block) and
    ``replicated_gather``'s (the local slice); an NCCL group of one on
    rank 0 against ``group=None``, bit for bit; the bytes counter; no
    launch of K1-K7. Exits 1 on a mismatch."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.distributed as dist

    from repro_torch.core.quantize import pack_signs, unpack_signs
    from repro_torch.dist import collectives as coll
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import join_world, leave_world

    mesh, dev = join_world()
    g = mesh.group
    r, n = coll.axis_index(g), coll.axis_size(g)

    def say(msg):
        if r == 0:
            log(msg)

    def randn(seed, shape):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev)

    say(f"13a: {n} ranks on {torch.cuda.get_device_name(dev)} over "
        f"{dist.get_backend(g)}")
    build.reset_launch_counts()
    coll.reset_counters()
    beta = torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev)[:n]
    words = [pack_signs(randn(1000 + u, (ZOO_ROWS, 32))) for u in range(n)]
    lanes = coll.psum_bits_mac(words[r], g, beta_i=beta[r])
    want = torch.einsum("u,urs->rs", beta * 0.5,
                        torch.stack([unpack_signs(w) for w in words]))
    if not torch.equal(lanes.to(torch.float32) * 0.5, want):
        fail(f"13a rank {r}: psum_bits_mac != the einsum of the symbols")
    xs = [randn(2000 + u, (1 << 20,)) for u in range(n)]
    total = torch.stack(xs).sum(0)
    y, m = coll.psum(xs[r], g), coll.pmean(xs[r], g)
    err = float((y - total).abs().max())
    if not (torch.allclose(y, total, rtol=1e-6, atol=1e-6)
            and torch.allclose(m, total / n, rtol=1e-6, atol=1e-6)
            and coll.replicated([y, m], g)):
        fail(f"13a rank {r}: psum/pmean off the one-process sum ({err:.2e}) "
             "or unequal across ranks")
    head = [x[:4096] for x in xs]
    if not (torch.equal(coll.all_gather(head[r], g), torch.stack(head))
            and torch.equal(coll.all_gather(head[r], g, tiled=True),
                            torch.cat(head))):
        fail(f"13a rank {r}: all_gather != the ranks' tensors")
    cots = [randn(3000 + u, (n * 4096,)) for u in range(n)]
    x = head[r].clone().requires_grad_()
    torch.sum(cots[r] * coll.all_gather(x, g, tiled=True)).backward()
    block = torch.stack(cots).sum(0)[r * 4096:(r + 1) * 4096]
    if not torch.allclose(x.grad, block, rtol=1e-6, atol=1e-6):
        fail(f"13a rank {r}: all_gather's backward != the summed block")
    x = head[r].clone().requires_grad_()
    full = coll.replicated_gather(g, n)(x)
    torch.sum(cots[0] * full).backward()
    if not (torch.equal(full.detach(), torch.cat(head)) and torch.equal(
            x.grad, cots[0][r * 4096:(r + 1) * 4096])):
        fail(f"13a rank {r}: replicated_gather != cat / its local slice")
    stats = coll.stats()
    one = dist.new_group([0], backend="nccl")
    if r == 0:
        got = coll.psum_bits_mac(words[0], one, beta_i=beta[0])
        if not (torch.equal(got, coll.psum_bits_mac(words[0], None,
                                                    beta_i=beta[0]))
                and torch.equal(coll.psum(xs[0], one), xs[0])
                and torch.equal(coll.pmean(xs[0], one), xs[0])):
            fail("13a: an NCCL group of one != group=None")
    counts = build.launch_counts()
    if any(counts.values()):
        fail(f"13a rank {r}: kernel launches {counts}")
    say(f"13a: psum_bits_mac ({ZOO_ROWS} x 32 lanes) == the einsum bit for "
        f"bit; psum/pmean of 2^20 f32 within {err:.2e} of the one-process "
        "sum (max |diff|) and equal on every rank; all_gather (stacked, "
        "tiled) exact; the gather's backward = the summed block; "
        "replicated_gather's = the local slice; an NCCL group of one == "
        "group=None bit for bit; no K1-K7 launch")
    say("13a: rank 0's collectives by kind (bytes, calls, ms from CUDA "
        "events): " + ", ".join(
            f"{k} {stats['bytes'][k]:,} B / {stats['calls'][k]} / "
            f"{stats['ms'][k]:.2f} ms" for k in sorted(stats["bytes"])))
    leave_world()


def start_torchrun(label, nproc: int, args) -> dict:
    """Start ``python -m torch.distributed.run --standalone
    --nproc-per-node nproc args`` from the checkout (``finish_cli``
    waits)."""
    return start_cli(label, "torch.distributed.run",
                     ["--standalone", "--nproc-per-node", str(nproc)] + args)


def run_torchrun(label, nproc: int, args, card) -> str:
    """``start_torchrun`` and wait; fails the run on a non-zero exit.
    Returns its stdout."""
    return finish_cli(start_torchrun(label, nproc, args), card)


# the trainer CLI at the federation's width
FED_ARGV = ["--arch", FED_ARCH]


def fed_ckpts(tmp: str) -> dict:
    """Phase 13's checkpoint directories, under phase 14's launch's
    directory."""
    return {r: os.path.join(tmp, "fed", r)
            for r in ("b", "stopped", "whole", "d")}


def fed_rank_runs(tmp: str) -> list:
    """(label, argv) of the trainer CLI runs that phase 14's ranks make
    for phase 13, in their order: 13c's stopped run, its resume, 13b,
    13c's uninterrupted run."""
    ck = fed_ckpts(tmp)
    scan = FED_ARGV + ["--scan-rounds", "2"]
    return [("13c stopped", scan + ["--steps", "2", "--ckpt-dir",
                                    ck["stopped"]]),
            ("13c resumed", scan + ["--steps", "4", "--ckpt-dir",
                                    ck["stopped"], "--resume"]),
            ("13b", FED_ARGV + ["--steps", str(FED_STEPS), "--ckpt-dir",
                                ck["b"], "--ckpt-every", "1",
                                "--check-replicas"]),
            ("13c whole", scan + ["--steps", "4", "--ckpt-dir", ck["whole"],
                                  "--check-replicas"])]


def _tag(label: str) -> str:
    return label.replace(" ", "_")


def _go(tmp: str, label: str) -> None:
    """Wake the ranks' step ``label``."""
    open(os.path.join(tmp, f"go_{_tag(label)}"), "w").close()


def federation_in_ranks(tmp: str, rank: int) -> None:
    """Phase 13's trainer runs on this rank of phase 14's launch
    (``fed_rank_runs``), each through the CLI's own ``main`` (which joins
    and leaves a world of its own, a file store) once the parent writes
    its go. Rank 0 writes the CLI's lines and its seconds to
    ``fed_TAG.json``."""
    import gc

    from repro_torch.launch import train
    for label, argv in fed_rank_runs(tmp):
        tag = _tag(label)
        _wait_for(os.path.join(tmp, f"go_{tag}"), f"{label}'s go",
                  timeout=ZP_LIMIT)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            code = train.main(argv + ["--init-method", "file://"
                                      + os.path.join(tmp, f"store_{tag}")])
        secs = time.perf_counter() - t0
        if code:
            fail(f"{label} rank {rank}: the CLI returned {code}")
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            path = os.path.join(tmp, f"fed_{tag}.json")
            with open(path + ".tmp", "w") as f:
                json.dump({"out": buf.getvalue(), "s": secs}, f)
            os.replace(path + ".tmp", path)


def fed_rank_out(tmp: str, label: str, card: str, launch) -> str:
    """Wait for the ranks' run ``label`` (``federation_in_ranks``) and log
    its lines as a CLI's. Returns its stdout."""
    path = os.path.join(tmp, f"fed_{_tag(label)}.json")
    _wait_for(path, f"the ranks' {label}", timeout=ZP_LIMIT, launch=launch)
    with open(path) as f:
        got = json.load(f)
    argv = dict(fed_rank_runs(tmp))[label]
    for line in got["out"].strip().splitlines():
        log(f"{label} CLI: {line}")
    log(f"{label} CLI: main({' '.join(argv)}) in phase 14's 4 ranks: "
        f"{got['s']:.1f} s on rank 0 (its world's start, the init, the "
        f"steps and the checkpoints); {card}")
    return got["out"]


def _ckpt_params(path: str, step: int) -> list:
    """The parameter leaves (in tree order) of ``path``'s step, on the
    CPU."""
    arrays = _ckpt_arrays(os.path.join(path, f"step_{step:08d}"))
    from repro_torch.checkpoint import msgpack_meta
    with open(os.path.join(path, f"step_{step:08d}", "tree.msgpack"),
              "rb") as f:
        keys = msgpack_meta.unpackb(f.read())["keys"]
    return [torch.from_numpy(arrays[f"a{i}"]) for i, k in enumerate(keys)
            if k.startswith("['params']")]


def _flat(ps) -> torch.Tensor:
    return torch.cat([p.reshape(-1) for p in ps])


def _nmse_support(got, want) -> tuple:
    """(NMSE, support overlap) of two flat ĝ."""
    nmse = float(torch.sum((got - want) ** 2) / torch.sum(want ** 2))
    overlap = float(((got != 0) & (want != 0)).sum()
                    / max(int((want != 0).sum()), 1))
    return nmse, overlap


def _ulps(a, b, before) -> tuple:
    """(elements that differ, the largest |a − b| in units of the last
    place of max(|before|, |b|)) of flat f32 parameters after a step from
    ``before``: p − lr·ĝ rounds at the scale of the larger of the two, so
    an element that the step brings near 0 is not counted in the ulps of
    its tiny result."""
    scale = torch.maximum(before.abs(), b.abs())
    step = torch.nextafter(scale, torch.full_like(scale, float("inf"))) \
        - scale
    d = (a - b).abs()
    return int((d > 0).sum()), float((d / step).max())


def federation_trainer_steps(out: str, card: str) -> list:
    """13b: the trainer CLI in 4 ranks on the card (gloo), ``--steps 2
    --ckpt-every 1 --check-replicas``: s per step, the all-reduce's and
    the broadcast's share (CUDA events), peak memory per rank, the loss
    finite, the ranks' parameters bit-identical. Returns the steps'
    matches, what ``check_federation_trainer`` holds it against."""
    steps = [FED_STEP.search(ln) for ln in out.splitlines()]
    steps = [m for m in steps if m]
    if len(steps) != FED_STEPS or not all(
            np.isfinite(float(m.group(2))) for m in steps):
        fail(f"13b: want {FED_STEPS} steps with finite losses: {out}")
    if f"replicas: parameters bit-identical on all {FED_U} ranks" not in out:
        fail("13b: the ranks' parameters are not bit-identical")
    for m in steps:
        s, ar, bc = (float(m.group(3)), float(m.group(5)),
                     float(m.group(7)))
        log(f"13b: step {m.group(1)}: {s:.2f} s, all_reduce "
            f"{m.group(4)} MB in {ar:.1f} ms ({100 * ar / (1e3 * s):.1f}% "
            f"of the step), broadcast {m.group(6)} MB in {bc:.1f} ms "
            f"({100 * bc / (1e3 * s):.1f}%; the wait for the PS's decode "
            f"included); {card}")
    return steps


def check_federation_trainer(dev, card, ck, steps) -> None:
    """13b against the 4 workers in turn in this process: each step from
    the process group's parameters before it (its checkpoint; SGD keeps
    no state), ĝ ((p_t − p_t+1) / lr) by NMSE and support, the
    parameters within 1e-4 of their movement; no launch of K1-K7. Then
    the witness of why each step starts from the same carry: after step 0
    the two paths' parameters are ulps apart (the MAC's magnitude sum
    adds its 4 f32 terms in the all-reduce's order, not in turn), and the
    in-turn step 1 from its own carry against the in-turn step 1 from
    the process group's, one path from two carries that far apart (the
    bf16 forward turns those ulps into other top-κ selections and signs:
    ROADMAP Queue 3)."""
    import gc

    from repro_torch import tree
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels import build
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_zoo_mesh
    from repro_torch.launch.train import make_batch
    from repro_torch.models.registry import build_model

    cfg = get_config(FED_ARCH)
    model = build_model(cfg)
    tcfg = TrainConfig(aggregation="obcsaa", **LM_TRAIN)
    mesh = make_zoo_mesh(FED_U, 1)
    params = model.init(0, device=dev)
    D = sum(p.numel() for p in tree.leaves(params))
    if D != FED_D:
        fail(f"13b: D = {D:,}, want {FED_D:,}")
    treedef = tree.flatten(params)[1]
    theirs = [[p.cpu() for p in tree.leaves(params)]] + [
        _ckpt_params(ck, t + 1) for t in range(FED_STEPS)]
    del params
    step = steps_lib.make_train_step(model, tcfg, mesh)
    batch = make_batch(cfg, FED_U, LM_SEQ, device=dev)
    opt = steps_lib.make_optimizer(tcfg)
    lr = LM_TRAIN["learning_rate"]

    def in_turn(start, t):
        params = tree.unflatten(treedef, [p.to(dev) for p in start])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, _, m = step(params, opt.init(params), batch,
                            steps_lib.default_round_ctx(seed=t, device=dev,
                                                        mesh=mesh))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out = [p.cpu() for p in tree.leaves(params)]
        del params
        return out, float(m["loss"]), secs

    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    mine = []
    for t in range(FED_STEPS):
        got, loss, secs = in_turn(theirs[t], t)
        mine.append(got)
        before, want = _flat(theirs[t]), _flat(theirs[t + 1])
        got = _flat(got)
        nmse, overlap = _nmse_support((before - got) / lr,
                                      (before - want) / lr)
        if not (nmse <= FED_GHAT_NMSE and overlap >= FED_SUPPORT):
            fail(f"13b step {t}: ĝ NMSE {nmse:.3e} (gate {FED_GHAT_NMSE}), "
                 f"support overlap {overlap:.6f} (gate {FED_SUPPORT})")
        share = float(torch.linalg.vector_norm(got - want)
                      / torch.linalg.vector_norm(want - before))
        if share > FED_PARAM_TOL:
            fail(f"13b step {t}: parameters {share:.3e} of their movement "
                 f"apart (gate {FED_PARAM_TOL})")
        log(f"13b in turn: step {t}: {secs:.2f} s, loss {loss:.4f} (the "
            f"process group's {steps[t].group(2)}); ĝ against the process "
            f"group's, from the same carry: NMSE {nmse:.3e}, support "
            f"overlap {overlap:.6f}; parameters {share:.3e} of their "
            f"movement apart; peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    # the witness: the carries after step 0, and step 1 from each
    n_diff, ulps = _ulps(_flat(mine[0]), _flat(theirs[1]),
                         _flat(theirs[0]))
    own, _, _ = in_turn(mine[0], 1)
    nmse, overlap = _nmse_support((_flat(mine[0]) - _flat(own)) / lr,
                                  (_flat(theirs[1]) - _flat(mine[1])) / lr)
    log(f"13b witness: after step 0 the in-turn parameters differ from "
        f"the process group's in {n_diff:,} of {FED_D:,} elements, by at "
        f"most {ulps:.1f} ulp (of max(|p_0|, |p_1|)); in-turn step 1 from "
        f"its own carry against in-turn step 1 from the process group's "
        f"(one path, two carries): ĝ NMSE {nmse:.3e}, support overlap "
        f"{overlap:.6f}")
    expect_counts("federation in turn (13b)", build.launch_counts(), {}, 0)
    del step, batch
    gc.collect()
    torch.cuda.empty_cache()


def check_federation_scan(outs: dict, ck: dict) -> None:
    """13c: ``--scan-rounds 2 --steps 4`` (the greedy-scheduled span,
    two chunks of 2 rounds), a run of ``--steps 2`` that stops at the
    first chunk's end and its ``--resume`` to 4: the stopped run's step
    2 and the resumed run's step 4 equal the uninterrupted run's, bit for
    bit."""
    if sum(ln.startswith("rounds ") for ln in outs["whole"].splitlines()) \
            != 2:
        fail("13c: want two chunks of 2 rounds")
    if "resumed from step 2" not in outs["resumed"]:
        fail("13c: --resume did not resume at step 2")
    if f"replicas: parameters bit-identical on all {FED_U} ranks" \
            not in outs["whole"]:
        fail("13c: the ranks' parameters are not bit-identical")
    for step, run in ((2, "stopped"), (4, "resumed")):
        x, y = (_ckpt_arrays(os.path.join(ck[r], f"step_{step:08d}"))
                for r in ("whole", run))
        if x.keys() != y.keys() or not all(np.array_equal(x[k], y[k])
                                           for k in x):
            fail(f"13c: the {run} run's step {step} != the uninterrupted "
                 "run's")
    log(f"13c: the run stopped at step 2 and its resume to 4 ≡ the "
        f"uninterrupted run bit for bit at steps 2 and 4 in all {len(x)} "
        "leaves")


def check_federation_nccl(dev, ck) -> None:
    """13d: the NCCL world of one's step (its checkpoint) equals the
    single-process step (one worker, batch 4 x 128) bit for bit."""
    import gc

    from repro_torch import tree
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels import build
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.train import make_batch
    from repro_torch.models.registry import build_model

    cfg = get_config(FED_ARCH)
    model = build_model(cfg)
    tcfg = TrainConfig(aggregation="obcsaa", **LM_TRAIN)
    params = model.init(0, device=dev)
    step = steps_lib.make_train_step(model, tcfg)
    build.reset_launch_counts()
    params, _, _ = step(params, steps_lib.make_optimizer(tcfg).init(params),
                        make_batch(cfg, FED_U, LM_SEQ, device=dev),
                        steps_lib.default_round_ctx(seed=0, device=dev))
    expect_counts("federation, one process (13d)", build.launch_counts(),
                  {}, 0)
    got = _ckpt_params(ck, 1)
    mine = [p.cpu() for p in tree.leaves(params)]
    del params, step
    gc.collect()
    torch.cuda.empty_cache()
    if len(got) != len(mine) or not all(torch.equal(a, b)
                                        for a, b in zip(got, mine)):
        fail("13d: the NCCL world of one != the single-process step")
    log(f"13d: an NCCL world of one ≡ the single-process step bit for bit "
        f"in all {len(mine)} parameter leaves")


def run_federation_phase(dev, card: str, started: dict, beside=None):
    """Phase 13, the federation over processes on the one card (13a-13d
    above), and 17d. 13a and 13d are launches of their own (``torchrun``;
    13d's rank runs 17d after its step, ``nccl_rank``); 13b and 13c's
    three runs are made by phase 14's launch ``started``, whose 4 ranks
    are up and idle by then (``federation_in_ranks``), each on its go.
    What is not timed shares the card: 13c's stopped run and its resume
    beside 13a, 13d and 17d, this process's check of 13d and
    ``beside()``; 13b, then this process's check of it, then 13c's
    uninterrupted run, whose times are reported, run alone. Returns (the
    in-process checks' launch counts, all 0; what ``beside()``
    returned)."""
    import shutil

    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tmp, h = started["tmp"].name, started["launch"]
    ck = fed_ckpts(tmp)
    nccl = start_nccl_rank(tmp)
    _go(tmp, "13c stopped")
    _go(tmp, "13c resumed")
    run_torchrun("13a", FED_U, [os.path.join(ROOT, "chip_smoke.py"),
                                "--federation-rank"], card)
    got = beside() if beside is not None else None
    counts = check_nccl_world(dev, card, tmp, nccl,
                              beside="13d's check in this process and "
                              "13c's runs in 14's ranks")
    outs = {r: fed_rank_out(tmp, f"13c {r}", card, h)
            for r in ("stopped", "resumed")}
    _go(tmp, "13b")
    b_steps = federation_trainer_steps(fed_rank_out(tmp, "13b", card, h),
                                       card)
    build.reset_launch_counts()
    check_federation_trainer(dev, card, ck["b"], b_steps)
    counts = {k: v + counts[k] for k, v in build.launch_counts().items()}
    _go(tmp, "13c whole")
    outs["whole"] = fed_rank_out(tmp, "13c whole", card, h)
    ck["resumed"] = ck["stopped"]
    check_federation_scan(outs, ck)
    shutil.rmtree(os.path.join(tmp, "fed"))
    expect_counts("federation (13)", counts, {}, 0)
    log(f"federation: phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return counts, got

# -- phase 14 -----------------------------------------------------------------

# the zoo over processes: one rank per (worker, model-shard) cell of a 2 x 2
# mesh, the four ranks sharing the card over gloo (one torchrun launch).
# 14a the surrogate round at gemma2-2b's D (12a's geometry and kernels),
# 14c gemma2-2b's f32 decode (10a's) with the K/V cache split over the
# four ranks' length, then 14b the --zoo-train CLI at internvl2-1b's full
# width (bf16, SGD, K1-K4, one sequence of 128 a worker). Two workers: a
# sum of two f32 terms over the worker group is exact in either order, so
# 14a and 14b hold the ranks bit for bit against the in-turn rounds
ZP_W, ZP_M = 2, 2
ZP_ROUNDS = 2
ZP_LIMIT = 1500.0        # s from the launch (at the script's start) to its end
ZP_TRAIN_ARCH, ZP_TRAIN_D = "internvl2-1b", 493_982_720
ZP_TRAIN_ARGV = ["--zoo-train", "--model-parallel", str(ZP_M), "--arch",
                 ZP_TRAIN_ARCH, "--batch", "1", "--seq", "128", "--steps",
                 str(ZP_ROUNDS), "--kernels"]


def zoo_procs_params(zr, r0: int, n: int, dev) -> torch.Tensor:
    """Rows [r0, r0 + n) of 14a's parameters: 0.04·(U(0,1) − ½) hashed
    from the global element index (the zoo's own hash), zero at and past
    D, so that every rank can make its own rows alone."""
    from repro_torch.engine.zoo import _hash_u01
    dc = zr.ob.chunk
    out = torch.empty((n, dc), device=dev)
    cols = torch.arange(dc, dtype=torch.int64, device=dev)
    for a in range(0, n, ZOO_ROWS):
        b = min(a + ZOO_ROWS, n)
        rows = torch.arange(r0 + a, r0 + b, dtype=torch.int64, device=dev)
        idx = rows[:, None] * dc + cols[None]
        v = 0.04 * (_hash_u01(idx, 1000, 0) - 0.5)
        out[a:b] = torch.where(idx < zr.D, v, torch.zeros_like(v))
    return out


def row_sums(rows: torch.Tensor) -> torch.Tensor:
    """Each row's int64 sum of its f32 bits read as int32: the checksum
    the ranks' rows are held to."""
    return rows.view(torch.int32).to(torch.int64).sum(dim=1).cpu()


def zoo_surrogate_round(dev, mesh):
    """14a's round on ``mesh``: 12a's, K1-K4 and K7 on."""
    from repro_torch.core.obcsaa import OBCSAAConfig
    from repro_torch.engine.zoo import build_zoo_round
    from repro_torch.sched import SchedConfig
    return build_zoo_round(OBCSAAConfig(**ZOO_OB, use_kernels=True), LM_D,
                           mesh, scheduler="greedy_batched",
                           sched_cfg=SchedConfig(use_kernel=True),
                           device=dev)


def zoo_procs_oracle(dev, path: str) -> None:
    """14a's in-turn rounds on the logical 2 x 2 mesh in this process:
    each cell's row checksums after each round, written to ``path`` for
    the ranks (which wait for it)."""
    from repro_torch.launch.mesh import make_zoo_mesh
    t0 = time.perf_counter()
    zr = zoo_surrogate_round(dev, make_zoo_mesh(ZP_W, ZP_M))
    params = zoo_procs_params(zr, 0, zr.n_chunks, dev)
    sums = {}
    for t in range(ZP_ROUNDS):
        zr.round_gen(params, t, ZOO_KEY, ZOO_NV, ZOO_PMAX, ZOO_LR)
        for d in range(ZP_W):
            for m in range(ZP_M):
                r0 = m * zr.n_half + d * zr.n_local
                sums.setdefault(f"{d},{m}", []).append(
                    row_sums(params[r0:r0 + zr.n_local]))
    torch.cuda.synchronize()
    del params
    torch.cuda.empty_cache()
    torch.save(sums, path + ".tmp")
    os.replace(path + ".tmp", path)
    log(f"14a oracle: {ZP_ROUNDS} in-turn rounds on the logical {ZP_W} x "
        f"{ZP_M} mesh and the cells' row checksums in "
        f"{time.perf_counter() - t0:.1f} s")


def _wait_for(path: str, what: str, timeout: float = 600.0,
              launch=None) -> None:
    """Wait for ``path`` to exist; fails after ``timeout`` s, or at once
    when ``launch`` (a ``start_cli`` that should write it) has exited,
    with its output."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout:
            fail(f"waited {timeout:.0f} s for {what}")
        if launch is not None and launch["proc"].poll() is not None:
            finish_cli(launch, "")
            fail(f"the launch that writes {what} exited "
                 f"{launch['proc'].returncode}")
        time.sleep(0.2)


def zoo_rank_surrogate(dev, mesh, tmp, say) -> dict:
    """14a on this rank: its own rows, two rounds, each held to the
    in-turn rows' checksums. Returns its launch counts."""
    from repro_torch.dist import collectives as coll
    from repro_torch.kernels import build
    held = torch.cuda.memory_allocated(dev)      # what earlier phases left
    zr = zoo_surrogate_round(dev, mesh)
    d, m = zr.cell
    t_start = time.perf_counter()
    want = torch.load(os.path.join(tmp, "oracle_14a.pt"))[f"{d},{m}"]
    params = zoo_procs_params(zr, zr.row0, zr.n_local, dev)
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    nb = -(-zr.n_local // zr.block_rows)
    it = zr.ob.biht_iters
    per_round = {"topk_select": zr.U * nb + it * nb,
                 "cs_project": zr.U * nb, "cs_project_resid": it * nb,
                 "backproject": it * nb, "prefix_eval": 1}
    for t in range(ZP_ROUNDS):
        coll.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, st = zr.round_gen(params, t, ZOO_KEY, ZOO_NV, ZOO_PMAX, ZOO_LR)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        stats = coll.stats()
        bad = int((row_sums(params) != want[t]).sum())
        flags = coll.all_gather(torch.tensor([bad], device=dev),
                                mesh.world, tiled=True).tolist()
        if any(flags):
            fail(f"14a round {t}: rows whose checksums differ from the "
                 f"in-turn round's, by rank: {flags}")
        say(f"14a: round {t}: {secs:.3f} s on rank 0 (host clock); "
            + ", ".join(f"{k} {stats['bytes'][k] / 1e6:.1f} MB in "
                        f"{stats['ms'][k]:.1f} ms ({stats['calls'][k]} "
                        f"calls)" for k in sorted(stats["bytes"]))
            + f"; ‖ĝ‖ {float(st.ghat_norm):.4f}, |M_t| "
            f"{int(st.n_scheduled)}; every rank's {zr.n_local:,} rows "
            "equal the in-turn round's checksums")
    counts = build.launch_counts()
    want = {k: per_round.get(k, 0) * ZP_ROUNDS for k in counts}
    if counts != want:
        fail(f"14a rank {d},{m}: launch counts {counts} != {want}")
    say(f"14a: launches on every rank "
        f"{({k: v for k, v in counts.items() if v})} = {ZP_ROUNDS} x "
        f"{per_round}")
    peak = coll.all_gather(torch.tensor(
        [torch.cuda.max_memory_allocated(dev) - held, held], device=dev),
        mesh.world)
    say("14a: peak memory by rank over what the rank held before 14a "
        "(GiB): " + ", ".join(f"{v / 2**30:.2f}" for v, _ in peak.tolist())
        + "; held before 14a, left by phases 17 and 13 (MiB): "
        + ", ".join(f"{h / 2**20:.1f}" for _, h in peak.tolist())
        + f"; {time.perf_counter() - t_start:.1f} s from the oracle's file")
    del params
    torch.cuda.empty_cache()
    return counts


def zoo_rank_decode(dev, mesh, tmp, say) -> None:
    """14c on this rank: 10a's f32 gemma2-2b greedy decode, the K/V cache
    of P + 16 rows split over the world's length, seeded with each rank's
    own rows of 10a's prefill (``seed_cache_from_prefill`` with the
    group). Rank 0 writes the tokens and logits for the parent to hold
    against 10a's."""
    from repro_torch.configs import get_config, scaled
    from repro_torch.dist import collectives as coll
    from repro_torch.launch.mesh import ZooMesh
    from repro_torch.models import transformer
    from repro_torch.models.registry import build_model
    _, arch, B, P, _ = DECODE_CELLS[0]
    R = coll.axis_size(mesh.world)
    torch.cuda.reset_peak_memory_stats()
    cfg = scaled(get_config(arch), dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device=dev)
    total = P + DECODE_GEN
    # 10a's prefill (the parent's) seeds the cache: every rank keeps its
    # own rows of the seeds, read from a memmap of the parent's file
    path = os.path.join(tmp, "seeds_14c.pt")
    _wait_for(path, "14c's cache seeds", timeout=900)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prompt_state = torch.load(path, mmap=True)
    first = prompt_state["first"].to(dev)
    # the (R, 1) mesh: the K/V length over the whole world
    length = ZooMesh(("data", "model"), (R, 1), group=mesh.world,
                     world=mesh.world)
    cache = model.init_cache(B, total, dev, mesh=length)
    transformer.seed_cache_from_prefill(cfg, cache, prompt_state["seeds"],
                                        start=0, mesh=length)
    del prompt_state
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    if tuple(cache["k"].shape[2:3]) != (total // R,):
        fail(f"14c: the k cache {tuple(cache['k'].shape)} is not split "
             f"over the length of {total} by {R} ranks")
    coll.reset_counters()
    tok, logits, fed, ms = first, [], [], []
    for i in range(DECODE_GEN):
        fed.append(tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = model.decode_step(params, cache, tok, P + i,
                                       mesh=length)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(out[:, 0])
        tok = torch.argmax(out[:, -1], dim=-1)[:, None].to(torch.int32)
    stats = coll.stats()
    fed = torch.cat(fed, dim=1)
    same = coll.replicated([fed], mesh.world)
    if not same:
        fail("14c: the ranks drew different tokens")
    if coll.axis_index(mesh.world) == 0:
        torch.save((fed.cpu(), torch.stack(logits, dim=1).cpu()),
                   os.path.join(tmp, "decode_14c.pt"))
    say(f"14c: {arch} f32, B = {B}, prompt {P} (past the window of "
        f"{cfg.attention.window}), cache {total} rows split {R} ways "
        f"({total // R} a rank): the own rows of 10a's seeds in "
        f"{seed_s:.2f} s, decode step "
        f"median {sorted(ms)[len(ms) // 2]:.1f} ms (host clock, "
        f"synchronised); a step's collectives " + ", ".join(
            f"{k} {stats['bytes'][k] / DECODE_GEN / 1e3:.1f} kB in "
            f"{stats['calls'][k] // DECODE_GEN} calls"
            for k in sorted(stats["bytes"]))
        + f"; peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
        " on rank 0; the ranks' tokens equal")
    del params, cache
    torch.cuda.empty_cache()


# -- phase 15 -----------------------------------------------------------------

# the serving path's model axis: prefill and decode_step split over the
# model group of the same 2 x 2 launch (tensor parallel: heads, hidden
# columns, vocabulary; models/tensor_parallel.py), every cache leaf laid out
# as cache_shardings gives it, f32 at full width. 15a 10a's gemma2-2b case
# (the split prefill over its 4,160-token prompt, held to 10a's one-process
# decode), 15b minicpm3-4b (MLA: the latent cache split by batch over data
# and by columns over model), 15c mamba2-2.7b (the SSM state split by batch
# and by heads, its prompt stepped), each held to the same decode run whole
# in this process before the launch wakes
SERVE_CELLS = (("15a", "gemma2-2b", 2, 4160, 2_614_222_080),
               ("15b", "minicpm3-4b", 2, 32, 4_073_875_968),
               ("15c", "mamba2-2.7b", 2, 32, 2_996_753_920))
SERVE_GEN = 8
# the bound on a whole decode's own spread (``serve_oracles``), which may
# widen 15b's and 15c's gate past 1e-5: 1.5 times the largest reading on
# the H100 (15c, 1.74e-05; PERF.md §6)
SERVE_SPREAD_CAP = 2.6e-5


def serve_prompt(cfg, B: int, P: int, dev) -> torch.Tensor:
    """10a's prompt recipe (a CPU generator seeded 0)."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    return torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                         dtype=torch.int32).to(dev)


def serve_decode(model, params, prompt, mesh=None) -> dict:
    """The prompt into a fresh cache (a seeded prefill for the attention
    families, stepped through ``decode_step`` for the SSM), then
    ``SERVE_GEN`` greedy steps, split over ``mesh`` or whole. Returns
    the first token, the tokens fed (B, G), each step's logits over the
    whole vocabulary (B, G, V) on the CPU, the prefill's and each step's
    host ms (synchronised), a step's collectives by group (the greedy
    pick's gather apart) and the cache."""
    from repro_torch.dist import collectives as coll
    from repro_torch.launch.steps import make_seeded_prefill
    from repro_torch.models import tensor_parallel as tp
    cfg = model.cfg
    B, P = prompt.shape
    total = P + DECODE_GEN          # 10a's cache: a multiple of the W = 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if cfg.family in ("dense", "moe", "vlm"):
        lg, cache, pos = make_seeded_prefill(model, total, mesh=mesh)(
            params, {"tokens": prompt})
        lg = lg[:, -1]
    else:
        cache = model.init_cache(B, total, prompt.device, mesh=mesh)
        for pos in range(P):
            lg, cache = model.decode_step(params, cache,
                                          prompt[:, pos:pos + 1], pos,
                                          mesh=mesh)
        lg, pos = lg[:, -1], P
    tok = tp.greedy(lg, cfg, mesh)[:, None].to(torch.int32)
    del lg
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    first, fed, logits, ms, by_group = tok, [], [], [], {}
    for i in range(SERVE_GEN):
        fed.append(tok)
        coll.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = model.decode_step(params, cache, tok, pos + i,
                                       mesh=mesh)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        for g, kinds in coll.by_group().items():
            for k, v in kinds.items():
                t = by_group.setdefault(g, {}).setdefault(k, [0, 0])
                t[0] += v["bytes"]
                t[1] += v["calls"]
        logits.append(out[:, 0])
        tok = tp.greedy(out[:, -1], cfg, mesh)[:, None].to(torch.int32)
    whole = tp.gather_logits(torch.stack(logits, dim=1), cfg, mesh).cpu()
    return {"first": first.cpu(), "fed": torch.cat(fed, dim=1).cpu(),
            "logits": whole, "prefill_ms": prefill_ms, "ms": ms,
            "by_group": by_group, "cache": cache}


def serve_oracles(dev) -> dict:
    """15b's and 15c's decodes whole in this process (15a's is 10a's):
    {label: (fed, logits, floor)}. The floor is the whole decode's own
    spread: its logits run again with the data split's blocks of B / W
    rows one after the other (what a data rank runs alone), against the
    B-row run, in units of the max: the f32 noise of a mere reordering,
    which at mamba2-2.7b's width passes 1e-05 (PERF.md §6)."""
    from repro_torch.configs import get_config, scaled
    from repro_torch.models.registry import build_model
    out = {}
    for label, arch, B, P, _ in SERVE_CELLS[1:]:
        t0 = time.perf_counter()
        model = build_model(scaled(get_config(arch), dtype="float32"))
        params = model.init(0, device=dev)
        prompt, bl = serve_prompt(model.cfg, B, P, dev), B // ZP_W
        whole = serve_decode(model, params, prompt)
        rows = [serve_decode(model, params, prompt[d * bl:(d + 1) * bl])
                for d in range(ZP_W)]
        w_log = whole["logits"]
        r_fed, r_log = (torch.cat([g[k] for g in rows])
                        for k in ("fed", "logits"))
        if not torch.equal(r_fed, whole["fed"]):
            fail(f"{label} oracle: the whole decode's tokens change with "
                 "its rows decoded apart")
        floor = float((r_log - w_log).abs().max() / w_log.abs().max())
        out[label] = (whole["fed"], w_log, floor)
        del params, whole, rows
        torch.cuda.empty_cache()
        log(f"{label} oracle: {arch} whole in this process in "
            f"{time.perf_counter() - t0:.1f} s; its logits with the "
            f"{ZP_W} blocks of {bl} rows decoded apart within {floor:.2e} "
            "of their max")
    return out


def serve_cell(dev, mesh, logical, cell, say, cfg=None, staged_ranks=None,
               extra=None) -> dict:
    """One cell of phase 15 on this rank of ``mesh`` (``logical``: its
    (W, M) shape): the split decode (``serve_decode``) from the rank's own
    share of the seed-0 init (``init_params``: each weight cut to the
    share as it is drawn; with ``staged_ranks``, the ranks that share this
    host, ``draw_staged`` keeps the shares on the host until the last
    draw and ``unstage`` moves them to the card), its parameter and cache
    bytes held to the product rule over ``param_shardings`` and to
    ``cache_shardings``' blocks, the ranks' tokens equal. Returns the
    decode's result, the init's seconds and each rank's device peak
    during the init (the draws: when staged, before the shares move to
    the card), and what ``extra(model, params)`` returns, called before
    the weights go."""
    from repro_torch import tree
    from repro_torch.configs import get_config, scaled
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.sharding import local_shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import cache_shardings, param_shardings
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.models.registry import build_model
    label, arch, B, P, D_want = cell
    W, M = logical.shape["data"], logical.shape["model"]
    cfg = cfg or scaled(get_config(arch), dtype="float32")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if staged_ranks is None:
        params = tp.init_params(model, 0, mesh, dev)
        draw_peak = torch.cuda.max_memory_allocated(dev)
    else:
        # the draws' peak read before the shares move to the card
        sp = tp.split_of(cfg, mesh)
        staged = tp.draw_staged(model, 0, sp.M, sp.m, dev, staged_ranks)
        draw_peak = torch.cuda.max_memory_allocated(dev)
        params = tp.unstage(staged, dev)
        del staged
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = coll.all_gather(torch.tensor([draw_peak], device=dev),
                                mesh.world, tiled=True).tolist()
    torch.cuda.reset_peak_memory_stats()
    shapes = model.init(0, device="meta")
    if sum(x.numel() for x in tree.leaves(shapes)) != D_want:
        fail(f"{label} {arch}: D != {D_want:,}")
    specs, _ = param_shardings(model, logical)
    want_p = dryrun.spec_bytes(shapes, [dryrun._leaf(specs, k) for k, _
                                        in tree.flatten_with_keys(
                                            shapes)], logical)
    got_p = sum(x.numel() * x.element_size()
                for x in tree.leaves(params))
    got = serve_decode(model, params, serve_prompt(cfg, B, P, dev), mesh)
    total = P + DECODE_GEN
    whole = model.init_cache(B, total, "meta")
    cspec = cache_shardings(whole, logical)
    want_c = {k: local_shape(v.shape, cspec[k], logical)
              for k, v in whole.items()}
    got_c = {k: tuple(v.shape) for k, v in got["cache"].items()}
    if got_p != want_p or got_c != want_c:
        fail(f"{label} rank {mesh.cell()}: parameter bytes {got_p:,} "
             f"(the product rule {want_p:,}) or cache blocks {got_c} "
             f"(cache_shardings' {want_c})")
    cache_b = sum(x.numel() * x.element_size()
                  for x in got["cache"].values())
    if not coll.replicated([got["fed"].to(dev)], mesh.world):
        fail(f"{label}: the ranks drew different tokens")
    peak = coll.all_gather(torch.tensor(
        [torch.cuda.max_memory_allocated(dev)], device=dev), mesh.world,
        tiled=True).tolist()
    ms = got["ms"]
    say(f"{label}: {arch} f32 split over the {W} x {M} ranks, B "
        f"= {B}, prompt {P} ("
        + ("a split prefill" if cfg.family != "ssm" else "stepped")
        + f"), cache {total} rows: init of the share {init_s:.2f} s "
        + ("(each weight cut to the host as it is drawn, the shares moved "
           "to the card after the last draw)" if staged_ranks else
           "(each weight cut as it is drawn)")
        + f", prefill {got['prefill_ms']:.1f} ms, "
        f"decode step median {sorted(ms)[len(ms) // 2]:.1f} ms (min "
        f"{min(ms):.1f}, max {max(ms):.1f}; host clock, synchronised, "
        f"rank 0); a step's collectives " + "; ".join(
            f"{g}: " + ", ".join(
                f"{k} {v[1] // SERVE_GEN} calls {v[0] / SERVE_GEN / 1e3:.1f}"
                " kB" for k, v in sorted(kinds.items()))
            for g, kinds in sorted(got["by_group"].items()))
        + f"; parameters {got_p / 2**30:.3f} GiB a rank (the product "
        f"rule's, 1/{M} of every leaf param_shardings splits; whole "
        f"{4 * D_want / 2**30:.3f}), cache {cache_b / 2**20:.2f} MiB a "
        f"rank (cache_shardings' blocks: " + ", ".join(
            f"{k} {tuple(map(str, v))}" for k, v in cspec.items())
        + "); peak of the prefill and decode by rank (GiB) "
        + ", ".join(f"{v / 2**30:.2f}" for v in peak)
        + "; peak of the init by rank (GiB) "
        + ", ".join(f"{v / 2**30:.2f}" for v in init_peak)
        + (" (the weight being drawn and a block of its share)"
           if staged_ranks else " (the share and one whole weight)"))
    out = {k: got[k] for k in ("first", "fed", "logits")}
    if extra is not None:
        out.update(extra(model, params))
    del params
    out.update(init_s=init_s, init_peak=init_peak, peak=peak,
               param_bytes=got_p, cache_bytes=cache_b,
               prefill_ms=got["prefill_ms"], ms=ms)
    del got
    torch.cuda.empty_cache()
    return out


def serve_rank(dev, mesh, tmp, say) -> dict:
    """Phase 15a-15c on this rank (``serve_cell``); rank 0 writes the
    tokens and logits for the parent. Returns this rank's launch counts
    (K1-K7: none)."""
    from repro_torch.dist import collectives as coll
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import ZooMesh
    logical = ZooMesh(("data", "model"), (ZP_W, ZP_M))
    build.reset_launch_counts()
    t_phase = time.perf_counter()
    for cell in SERVE_CELLS:
        got = serve_cell(dev, mesh, logical, cell, say)
        if coll.axis_index(mesh.world) == 0:
            torch.save({k: got[k] for k in ("first", "fed", "logits")},
                       os.path.join(tmp, f"serve_{cell[0]}.pt"))
        del got
    counts = build.launch_counts()
    say(f"15: {time.perf_counter() - t_phase:.1f} s on rank 0")
    return counts


def check_serve(tmp, oracle10a, want) -> None:
    """15a's tokens and logits against 10a's one-process decode (its first
    ``SERVE_GEN`` steps), 15b's and 15c's against this process's whole
    decodes: tokens equal, logits within 1e-5 of their max, or within
    the whole decode's own spread where that is larger
    (``serve_oracles``). The spread is itself bounded: above
    ``SERVE_SPREAD_CAP`` the run fails, so the gate never passes
    ``SERVE_SPREAD_CAP``."""
    for label, arch, *_ in SERVE_CELLS:
        got = torch.load(os.path.join(tmp, f"serve_{label}.pt"))
        floor = 0.0
        if label == "15a":
            w_fed = oracle10a["fed"][:, :SERVE_GEN]
            w_log = oracle10a["logits"][:, :SERVE_GEN]
            if not torch.equal(got["first"], oracle10a["first"]):
                fail("15a: the split prefill's greedy token != 10a's")
        else:
            w_fed, w_log, floor = want[label]
            if floor > SERVE_SPREAD_CAP:
                fail(f"{label} {arch}: the whole decode's own spread "
                     f"{floor:.2e} passes its bound {SERVE_SPREAD_CAP:.1e}")
        gate = max(1e-5, floor)
        err = float((got["logits"] - w_log).abs().max()
                    / w_log.abs().max())
        if not torch.equal(got["fed"], w_fed) or err > gate:
            fail(f"{label} {arch}: the split decode's tokens differ from the "
                 f"whole decode's, or its logits by {err:.2e} of their max "
                 f"(gate {gate:.2e})")
        log(f"{label} {arch}: tokens equal the "
            + ("10a one-process" if label == "15a" else "whole")
            + f" decode's, logits within {err:.2e} of their max (gate "
            f"{gate:.2e}: 1e-05, or the whole decode's own spread with its "
            f"rows decoded apart, {floor:.2e}, where larger)")


# 15d: deepseek-v2-lite-16b (MLA, 64 routed experts top-6 + 2 shared) in
# f32, served split over a 1 x 2 model group at full width: 10b's config
# (capacity_factor 8) and prompt, held to 10b's one-process decode. Its
# own 2-rank launch, started with the script: the ranks sleep until the
# parent has freed 10b's weights after phase 10, and each stages its
# shares on the host during the init (tensor_parallel.draw_staged, then
# unstage), so the two draw at once in two whole expert leaves' room
# (18.56 GiB each)
MOE_CELL = ("15d", "deepseek-v2-lite-16b", 4, 32, 16_210_324_992)
MOE_M = 2
# 15d's router logits (the pinned decode's at every route call, the free
# decode's up to its first flip) may part from 10b's by at most this
# times 10b's own router-logit spread, its rows decoded in two blocks
# (``decode_spread``): f32 reordering, not a share gone wrong upstream
# of the router, whatever a flipped route's gap
ROUTE_NOISE_FACTOR = 4


def moe_serve_cfg():
    """10b's config: deepseek-v2-lite-16b in f32 at capacity_factor 8."""
    import dataclasses

    from repro_torch.configs import get_config, scaled
    cfg = scaled(get_config(MOE_CELL[1]), dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


@contextlib.contextmanager
def routes_recorded():
    """Within: every MoE route call's router logits (f32) and experts
    (``moe._route``'s idx), on the CPU, appended to the list it yields."""
    from repro_torch.models import moe as moe_lib
    rec, real = [], moe_lib._route

    def route(logits, top_k):
        w, idx, aux = real(logits, top_k)
        rec.append((logits.detach().float().cpu(), idx.cpu()))
        return w, idx, aux

    moe_lib._route = route
    try:
        yield rec
    finally:
        moe_lib._route = real


@contextlib.contextmanager
def routes_pinned(rec):
    """Within: the i-th MoE route call takes the experts ``rec`` recorded
    for its i-th call (``routes_recorded``), weighted by this call's own
    probabilities at them, normalised as ``moe._route`` does (bit for bit
    ``_route``'s weights where the experts are its own); the aux term,
    which serving never reads, 0."""
    from repro_torch.models import moe as moe_lib
    calls, real = iter(rec), moe_lib._route

    def route(logits, top_k):
        _, idx = next(calls)
        idx = idx.to(logits.device)
        w = torch.gather(torch.softmax(logits.to(torch.float32), dim=-1),
                         1, idx)
        w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
        return w, idx, torch.zeros((), device=logits.device)

    moe_lib._route = route
    try:
        yield
    finally:
        moe_lib._route = real


def first_route_flip(mine, theirs):
    """The first route call where ``mine``'s expert sets differ from
    ``theirs`` (``routes_recorded`` lists of one decode), or None:
    (call, [(token row, gap, noise)]): ``gap``, in ``theirs``' router
    logits, the largest logit of an expert they chose and ``mine`` did not
    less the smallest of one ``mine`` chose instead; ``noise``, the row's
    largest |difference| of the two router logits. A flip with gap ≤ 2 ·
    noise is a near tie that the measured f32 difference explains."""
    for i, ((lm, im), (lt, it)) in enumerate(zip(mine, theirs)):
        a, b = im.sort(-1).values, it.sort(-1).values
        rows = (a != b).any(-1).nonzero().flatten().tolist()
        if not rows:
            continue
        out = []
        for r in rows:
            lost = sorted(set(b[r].tolist()) - set(a[r].tolist()))
            gained = sorted(set(a[r].tolist()) - set(b[r].tolist()))
            gap = float(lt[r, lost].max() - lt[r, gained].min())
            out.append((r, gap, float((lm[r] - lt[r]).abs().max())))
        return i, out
    return None


def router_noise(mine, theirs) -> float:
    """The largest |difference| of two decodes' router logits
    (``routes_recorded`` lists of one decode each) over the route calls
    up to and including the first whose expert sets differ (after it the
    two decodes part for another cause than f32 noise), over all where
    none does."""
    flip = first_route_flip(mine, theirs)
    last = len(theirs) if flip is None else flip[0] + 1
    return max(float((lm - lt).abs().max())
               for (lm, _), (lt, _) in zip(mine[:last], theirs[:last]))


def serve_moe_rank() -> None:
    """15d in each rank that ``torchrun`` starts (``chip_smoke.py
    --serve-moe-rank DIR``): once the parent's go file is there, join a
    world of 1 x 2 ranks and run ``serve_cell`` with the init staged on
    the host, its MoE routes recorded, then the same decode again with
    the routes pinned to 10b's (``routes_pinned``; its router logits
    recorded too), the MoE's dropped routes counted in both; rank 0
    writes the tokens, logits and routes, each rank its launch counts and
    drops. Exits 1 on a mismatch."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.dist import collectives as coll
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import ZooMesh, join_world, leave_world
    from repro_torch.models import moe as moe_lib

    tmp = sys.argv[2]
    rank = int(os.environ["RANK"])
    _wait_for(os.path.join(tmp, "go_15d"), "15d's go", timeout=ZP_LIMIT)
    mesh, dev = join_world(model_parallel=MOE_M, init_method="file://"
                           + os.path.join(tmp, "store"))
    theirs = torch.load(os.path.join(tmp, "routes_10b.pt"))

    def say(msg):
        if rank == 0:
            log(msg)

    def pinned(model, params):
        t0 = time.perf_counter()
        with routes_pinned(theirs), routes_recorded() as seen:
            got = serve_decode(model, params, serve_prompt(
                model.cfg, *MOE_CELL[2:4], dev), mesh)
        say(f"15d: the decode again with 10b's routes pinned in "
            f"{time.perf_counter() - t0:.1f} s")
        return {"pinned": {**{k: got[k] for k in ("first", "fed",
                                                   "logits")},
                           "routes": seen}}

    drops = []
    dispatch = moe_lib._dispatch

    def counted(idx, E, capacity):
        flat, slot, keep = dispatch(idx, E, capacity)
        drops.append((~keep).sum())
        return flat, slot, keep

    moe_lib._dispatch = counted
    build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with routes_recorded() as routes:
            got = serve_cell(dev, mesh, ZooMesh(("data", "model"),
                                                (1, MOE_M)),
                             MOE_CELL, say, cfg=moe_serve_cfg(),
                             staged_ranks=MOE_M, extra=pinned)
    finally:
        moe_lib._dispatch = dispatch
    counts = build.launch_counts()
    n_drop = int(torch.stack(drops).sum()) if drops else 0
    if coll.axis_index(mesh.world) == 0:
        torch.save({**{k: got[k] for k in ("first", "fed", "logits",
                                            "pinned")}, "routes": routes},
                   os.path.join(tmp, "serve_15d.pt"))
    leave_world()
    with open(os.path.join(tmp, f"counts_15d_{rank}.json"), "w") as f:
        json.dump({"counts": counts, "drops": n_drop, "routes": len(drops),
                   **{k: got[k] for k in ("init_s", "init_peak", "peak",
                                          "param_bytes", "cache_bytes",
                                          "prefill_ms", "ms")}}, f)
    say(f"15d: {time.perf_counter() - t0:.1f} s on rank 0 from the go")


def start_serve_moe_procs() -> dict:
    """Start 15d's 2-rank launch (``serve_moe_rank``) with the script: the
    ranks start up while the kernels build and sleep, touching no card,
    until ``run_serve_moe_phase`` writes the go file."""
    import tempfile
    tmp = tempfile.TemporaryDirectory(dir=ROOT)
    h = start_torchrun("15d", MOE_M, [
        os.path.join(ROOT, "chip_smoke.py"), "--serve-moe-rank", tmp.name])
    return {"tmp": tmp, "launch": h}


def serve_moe_dry_run() -> dict:
    """The dry run's estimate of 15d's configuration: rank 0 of a
    "fake" 1 x 2 world on the meta device, the split prefill of the
    prompt and one split decode step at the cache's last position."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    _, _, B, P, _ = MOE_CELL
    return {kind: dryrun.measure(moe_serve_cfg(), InputShape(
        "15d", P if kind == "prefill" else P + DECODE_GEN, B, kind),
        (1, MOE_M), ("data", "model")) for kind in ("prefill", "decode")}


def run_serve_moe_phase(dev, card: str, started: dict) -> dict:
    """Phase 15d, after phase 10: free this process's weights (10b's),
    write the go file, compute the dry run's estimate while the ranks
    run, wait for the launch to end, then hold 15d to 10b's one-process
    decode: the first token and the ``SERVE_GEN`` fed tokens equal, the
    logits within 1e-5 of their max (or within the whole decode's own
    spread, ``ORACLES["10b"]["spread"]``, capped at ``SERVE_SPREAD_CAP``),
    the router logits within ``ROUTE_NOISE_FACTOR`` times 10b's own
    router-logit spread, no route dropped, no launch of K1-K7. Returns the
    ranks' summed launch counts."""
    import gc

    from repro_torch.models.tensor_parallel import host_available

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"15d: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"and {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved in "
        f"this process after phase 10; host MemAvailable "
        f"{host_available() / 2**30:.2f} GiB; the ranks go")
    h, oracle = started["launch"], ORACLES["10b"]
    with started["tmp"] as tmp:
        torch.save(oracle["routes"], os.path.join(tmp, "routes_10b.pt"))
        open(os.path.join(tmp, "go_15d"), "w").close()
        t0 = time.perf_counter()
        dry = serve_moe_dry_run()
        dry_s = time.perf_counter() - t0
        finish_cli(h, card, limit=ZP_LIMIT)
        ranks = [json.load(open(os.path.join(tmp, f"counts_15d_{r}.json")))
                 for r in range(MOE_M)]
        got = torch.load(os.path.join(tmp, "serve_15d.pt"))
    label, arch = MOE_CELL[:2]
    w_fed = oracle["fed"][:, :SERVE_GEN]
    w_log = oracle["logits"][:, :SERVE_GEN]
    spread = oracle["spread"]
    gate = max(1e-5, min(spread, SERVE_SPREAD_CAP))
    peak = float(w_log.abs().max())
    err = float((got["logits"] - w_log).abs().max()) / peak
    steps = ((got["logits"] - w_log).abs().amax(dim=(0, 2)) / peak).tolist()
    pin = got["pinned"]
    pin_err = float((pin["logits"] - oracle["whole"]).abs().max()
                    / oracle["whole"].abs().max())
    if not (torch.equal(got["first"], oracle["first"])
            and torch.equal(pin["first"], oracle["first"])):
        fail(f"{label}: the split prefill's greedy token != 10b's")
    if not (torch.equal(got["fed"], w_fed) and torch.equal(pin["fed"],
                                                           w_fed)):
        fail(f"{label} {arch}: the split decode's tokens differ from 10b's "
             f"one-process decode (free {got['fed'].tolist()}, routes pinned "
             f"{pin['fed'].tolist()}, 10b {w_fed.tolist()})")
    if pin_err > gate:
        fail(f"{label} {arch}: with 10b's routes pinned, the split decode's "
             f"logits part from 10b's by {pin_err:.2e} of their max (gate "
             f"{gate:.2e}: 1e-05, or 10b's own spread {spread:.2e} capped at "
             f"{SERVE_SPREAD_CAP:.1e}, where larger)")
    r_bound = ROUTE_NOISE_FACTOR * oracle["route_spread"]
    noise = {"pinned": router_noise(pin["routes"], oracle["routes"]),
             "free": router_noise(got["routes"], oracle["routes"])}
    r_line = (f"router logits from 10b's within {noise['pinned']:.3e} "
              f"(routes pinned, every call) and {noise['free']:.3e} (its "
              f"own routes, up to its first flip), the bound "
              f"{ROUTE_NOISE_FACTOR} x 10b's own router-logit spread "
              f"{oracle['route_spread']:.3e} = {r_bound:.3e}")
    if max(noise.values()) > r_bound:
        fail(f"{label} {arch}: the split's {r_line}: more than f32 "
             "reordering explains")
    flip = first_route_flip(got["routes"], oracle["routes"])
    why = "no route differs from 10b's"
    if flip is not None:
        call, rows = flip
        L = moe_serve_cfg().num_layers
        why = (f"its routes first differ from 10b's at route call {call} of "
               f"{len(oracle['routes'])} (layer {call % L}, "
               + ("the prefill" if call < L else f"step {call // L - 1}")
               + "): " + "; ".join(
                   f"token row {r}, 10b's router logits {gap:.3e} apart for "
                   f"the experts swapped, the two runs' router logits up to "
                   f"{noise:.3e} apart" for r, gap, noise in rows))
    if err > gate and (flip is None
                       or any(gap > 2 * noise for _, gap, noise in flip[1])):
        fail(f"{label} {arch}: the split decode's logits part from 10b's by "
             f"{err:.2e} of their max (by step {steps}; gate {gate:.2e}), and "
             f"no near tie of the routes explains it: {why}")
    drops = [r["drops"] for r in ranks]
    if any(drops):
        fail(f"{label}: routes dropped by rank {drops} at capacity_factor 8")
    counts = {k: sum(r["counts"][k] for r in ranks)
              for k in ranks[0]["counts"]}
    expect_counts(f"serve split ({label})", counts, {}, 0)
    log(f"{label} {arch}: the first token and the {SERVE_GEN} fed tokens "
        f"equal 10b's one-process decode, with its own routes and with "
        f"10b's pinned; with 10b's routes pinned the logits within "
        f"{pin_err:.2e} of their max (gate {gate:.2e}: 1e-05, or 10b's own "
        f"spread with its rows decoded apart, {spread:.2e}, capped at "
        f"{SERVE_SPREAD_CAP:.1e}, where larger); with its own routes "
        f"within {err:.2e} (by step: " + ", ".join(f"{v:.2e}" for v in steps)
        + f"): {why}"
        + (" (gap ≤ 2 x noise: a near tie that f32 reordering flips)"
           if err > gate else "")
        + f"; {r_line}; dropped routes by rank {drops} (of "
        f"{ranks[0]['routes']} "
        "dispatches each, both decodes, capacity_factor 8)")
    mem = {k: v["memory"] for k, v in dry.items()}
    calls = dry["decode"]["collectives"]["calls"]
    log(f"{label}: init " + ", ".join(f"{r['init_s']:.2f}" for r in ranks)
        + " s by rank (the draws, the shares staged on the host, then moved "
        f"to the card); device peak of the init by rank (GiB) "
        + ", ".join(f"{v / 2**30:.2f}" for v in ranks[0]["init_peak"])
        + f" (one whole expert leaf is {27 * 64 * 2048 * 1408 * 4 / 2**30:.2f}"
        f"); measured peak of the prefill and decode by rank (GiB) "
        + ", ".join(f"{v / 2**30:.2f}" for v in ranks[0]["peak"])
        + f" beside the dry run's estimate for the same configuration "
        f"(rank 0 of a fake 1 x {MOE_M} world on the meta device, "
        f"{dry_s:.1f} s): prefill total "
        f"{mem['prefill']['total'] / 2**30:.2f} GiB (params "
        f"{mem['prefill']['params'] / 2**30:.2f}, step_peak "
        f"{mem['prefill']['step_peak'] / 2**30:.3f}), decode step total "
        f"{mem['decode']['total'] / 2**30:.2f} GiB (params "
        f"{mem['decode']['params'] / 2**30:.2f}, cache "
        f"{mem['decode']['cache'] / 2**20:.2f} MiB, step_peak "
        f"{mem['decode']['step_peak'] / 2**30:.3f}); the dry run's decode "
        f"collectives a step " + ", ".join(
            f"{k} {v / 1e3:.1f} kB in {calls[k]} calls"
            for k, v in dry["decode"]["collectives"]["bytes"].items())
        + f"; parameters by rank (GiB) " + ", ".join(
            f"{r['param_bytes'] / 2**30:.3f}" for r in ranks)
        + f" (the product rule's: {mem['decode']['params'] / 2**30:.3f} on "
        f"rank 0), cache by rank (MiB) " + ", ".join(
            f"{r['cache_bytes'] / 2**20:.2f}" for r in ranks) + f"; {card}")
    log(f"{label}: phase 15d took {time.perf_counter() - t_phase:.1f} s "
        "from the go")
    return counts


def zoo_rank() -> None:
    """Phases 17, 13 and 14-16 in each rank that ``torchrun`` starts
    (``chip_smoke.py --zoo-rank DIR``): 17 in a world of its own, beside
    the parent's CLI groups; 13b and 13c through the trainer's CLI; then
    14a, 14c and 15 in a world of the 2 x 2 mesh, then 14b, 16a and 16b through the trainer's CLI
    (``main(argv)``, which joins and leaves its own world each time).
    Each rank writes its launch counts to DIR; rank 0 prints. Exits 1 on
    a mismatch."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.launch.mesh import join_world, leave_world

    tmp = sys.argv[2]
    rank = int(os.environ["RANK"])
    counts = {}
    # started with the script: phase 17 beside the CLI groups once the
    # parent's grid is on disk (its data loaded while we wait), phase
    # 13's runs on their goes, then wait for 14a's oracle
    sweep_procs_rank(tmp, rank, counts)
    federation_in_ranks(tmp, rank)
    _wait_for(os.path.join(tmp, "oracle_14a.pt"), "14a's oracle",
              timeout=ZP_LIMIT)
    mesh, dev = join_world(model_parallel=ZP_M, init_method="file://"
                           + os.path.join(tmp, "store_a"))

    def say(msg):
        if rank == 0:
            log(msg)

    counts["zoo_procs_surrogate"] = zoo_rank_surrogate(dev, mesh, tmp, say)
    t0 = time.perf_counter()
    zoo_rank_decode(dev, mesh, tmp, say)
    say(f"14c: {time.perf_counter() - t0:.1f} s")
    counts["serve_split"] = serve_rank(dev, mesh, tmp, say)
    leave_world()
    if rank == 0:
        open(os.path.join(tmp, "done_15"), "w").close()
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train.main(ZP_TRAIN_ARGV + ["--ckpt-dir", os.path.join(tmp, "ck"),
                                "--init-method", "file://" + os.path.join(
                                    tmp, "store_b")])
    counts["zoo_procs_train"] = build.launch_counts()
    if not all(counts["zoo_procs_train"][k] for k in (
            "topk_select", "cs_project", "cs_project_resid", "backproject")):
        fail(f"14b rank {rank}: K1-K4 did not all launch: "
             f"{counts['zoo_procs_train']}")
    used = {k: v for k, v in counts["zoo_procs_train"].items() if v}
    say(f"14b: the CLI in {time.perf_counter() - t0:.1f} s; launches on "
        f"rank 0 {used}; peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB on rank 0")
    counts["peak_14b"] = torch.cuda.max_memory_allocated(dev)
    split_train_rank(dev, tmp, rank, counts)
    with open(os.path.join(tmp, f"counts_{rank}.json"), "w") as f:
        json.dump(counts, f)


def zoo_train_oracle(dev):
    """14b's in-turn round on the logical 2 x 2 mesh, from the CLI's own
    configuration (``train_config``), init and batch."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_zoo_mesh
    from repro_torch.models.registry import build_model
    args = train.build_parser().parse_args(ZP_TRAIN_ARGV)
    tcfg = train.train_config(args)
    cfg = get_config(ZP_TRAIN_ARCH)
    model = build_model(cfg)
    zr = steps_lib.make_zoo_train_round(model, tcfg, make_zoo_mesh(ZP_W,
                                                                   ZP_M),
                                        device=dev, use_kernels=True)
    if zr.D != ZP_TRAIN_D:
        fail(f"14b: D = {zr.D:,}, want {ZP_TRAIN_D:,}")
    batch = train.make_zoo_batch(cfg, zr.U, args.batch, args.seq,
                                 device=dev)

    def rnd(state, t):
        return zr.round_train(state, batch, t, 1, tcfg.noise_var,
                              tcfg.p_max, args.lr)

    return zr, rnd


def start_zoo_procs() -> dict:
    """Start phase 14's 4-rank launch (``zoo_rank``) with the script:
    the ranks start up (imports, ~25 s of a launch) and load phase 17's
    data while the kernels build, then sleep until phase 17's go (after
    phase 12); they touch the card only then, run 17, then phase 13's
    trainer runs on their goes (``federation_in_ranks``), and sleep
    again until ``run_zoo_procs_phase`` writes 14a's oracle file."""
    import tempfile
    tmp = tempfile.TemporaryDirectory(dir=ROOT)
    h = start_torchrun("14", ZP_W * ZP_M, [
        os.path.join(ROOT, "chip_smoke.py"), "--zoo-rank", tmp.name])
    return {"tmp": tmp, "launch": h}


def zoo_procs_prepare(dev, tmp: str) -> dict:
    """What phase 14 holds its ranks against, made beforehand (beside
    13a, 13d and 13c's stopped and resumed runs): 15b's and 15c's one-process decodes
    (``serve_oracles``) and 14a's in-turn checksums, written where
    ``run_zoo_procs_phase`` moves them into the ranks' sight."""
    path = os.path.join(tmp, "oracle_14a.next.pt")
    out = {"serve": serve_oracles(dev), "oracle_14a": path}
    zoo_procs_oracle(dev, path)
    return out


def run_zoo_procs_phase(dev, card: str, started: dict,
                        prepared: dict) -> dict:
    """Phase 14 on the launch ``start_zoo_procs`` started, with the
    oracles ``zoo_procs_prepare`` made. The parent writes 10a's prompt
    state for 14c, moves 14a's in-turn checksums where the ranks wait
    for them (their signal to go), stays idle while the ranks run 14a
    and 14c (timed alone), runs 14b's in-turn rounds 0-2 beside the ranks'
    14b, then holds: 14c's tokens and logits against 10a's one-process
    decode, the ranks' 14b checkpoint against the in-turn carry after
    round 1 (bit for bit), and round 2 from that checkpoint against the
    uninterrupted in-turn round 2 (bit for bit). Phase 16: the parent's
    oracles (``split_train_oracles``) once its 14b rounds are done, which
    wake the ranks' 16a and 16b, then their gates (``check_split_train``)
    once the launch has ended. Returns the ranks' summed launch counts by
    path (phase 17's, run earlier in the launch, included)."""
    import gc

    from repro_torch import tree
    from repro_torch.engine.zoo_train import clone_state

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    h, oracle = started["launch"], ORACLES["10a"]
    with started["tmp"] as tmp:
        path = os.path.join(tmp, "seeds_14c.pt")
        torch.save({"first": oracle["first"], "seeds": oracle["seeds"]},
                   path + ".tmp")
        os.replace(path + ".tmp", path)
        serve_want = prepared["serve"]
        os.replace(prepared["oracle_14a"], os.path.join(tmp,
                                                        "oracle_14a.pt"))
        _wait_for(os.path.join(tmp, "done_15"),
                  "the ranks' 14a, 14c and 15", launch=h)
        t15 = time.perf_counter()
        check_serve(tmp, oracle, serve_want)
        log(f"15: held in {time.perf_counter() - t15:.1f} s")
        t0 = time.perf_counter()
        zr, rnd = zoo_train_oracle(dev)
        state = zr.init_state(zr.chunk_params(zr.model.init(0, device=dev)))
        for t in range(ZP_ROUNDS):
            state, st = rnd(state, t)
        after = clone_state(state)
        state, _ = rnd(state, ZP_ROUNDS)
        whole = state.master.cpu()
        del state
        torch.cuda.synchronize()
        log(f"14b in turn: rounds 0-{ZP_ROUNDS} in "
            f"{time.perf_counter() - t0:.1f} s beside the ranks' 14b (round "
            f"{ZP_ROUNDS - 1} loss {float(st.loss):.4f})")
        want16 = split_train_oracles(dev, tmp)
        t16 = time.perf_counter()
        check_split_16a(dev, tmp, want16, h)
        out = finish_cli(h, card, limit=ZP_LIMIT)
        log(f"16: the launch ended {time.perf_counter() - t16:.1f} s after "
            "the ranks' go")
        counts = [json.load(open(os.path.join(tmp, f"counts_{r}.json")))
                  for r in range(ZP_W * ZP_M)]
        fed, logits = torch.load(os.path.join(tmp, "decode_14c.pt"))
        want_fed, want = oracle["fed"], oracle["logits"]
        err = float((logits - want).abs().max() / want.abs().max())
        if not torch.equal(fed, want_fed) or err > 1e-5:
            fail(f"14c: the split decode's tokens differ from 10a's one-"
                 f"process decode, or its logits by {err:.2e} of their max "
                 "(gate 1e-5)")
        log(f"14c: tokens equal 10a's one-process decode, logits within "
            f"{err:.2e} of their max (gate 1e-5)")
        ck = os.path.join(tmp, "ck")
        got, t_next = zr.restore_state(ck)
        if t_next != ZP_ROUNDS or not all(
                torch.equal(a, b) for a, b in zip(tree.leaves(got),
                                                  tree.leaves(after))):
            fail("14b: the ranks' checkpoint != the in-turn carry after "
                 f"round {ZP_ROUNDS - 1}")
        del after
        got, _ = rnd(got, ZP_ROUNDS)
        if not torch.equal(got.master.cpu(), whole):
            fail(f"14b: round {ZP_ROUNDS} from the ranks' checkpoint != the "
                 f"uninterrupted in-turn round {ZP_ROUNDS}")
        log(f"14b: the ranks' checkpoint (step {ZP_ROUNDS}) ≡ the in-turn "
            f"carry bit for bit; round {ZP_ROUNDS} from it ≡ the "
            f"uninterrupted in-turn round {ZP_ROUNDS} bit for bit; peak "
            "by rank (GiB) " + ", ".join(
                f"{c['peak_14b'] / 2**30:.2f}" for c in counts))
        if "resumed" in out:
            fail("14b: the CLI resumed from a checkpoint it should not have")
        del got, whole, zr, rnd
        gc.collect()
        torch.cuda.empty_cache()
        check_split_train(dev, card, tmp, want16, counts)
    gc.collect()
    torch.cuda.empty_cache()
    paths = {p: {k: sum(c[p][k] for c in counts) for k in counts[0][p]}
             for p in ("zoo_procs_surrogate", "zoo_procs_train",
                       "serve_split", "split_16a", "split_16b",
                       "sweep_procs")}
    expect_counts("serve split (15)", paths["serve_split"], {}, 0)
    log(f"zoo over processes: phase 14 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return paths


# -- phase 16 -----------------------------------------------------------------

# the train step's model axis: the plain trainer's CLI under the same 2 x 2
# launch, after 14b, at internvl2-1b's full width with the CLI's defaults
# (bf16, SGD unless stated), one sequence of 128 a worker. 16a: mean with
# Adam, held bit for bit to the whole weights' steps with the workers in
# turn; 16b: obcsaa, each step held to make_train_step on make_zoo_mesh(2,
# 1) from the ranks' carry before it
P16_W, P16_M = 2, 2
P16_ARGV = ["--arch", FED_ARCH, "--model-parallel", str(P16_M), "--batch",
            str(P16_W), "--seq", "128", "--steps", "2", "--check-replicas"]
P16_RUNS = {"16a": ["--agg", "mean", "--optimizer", "adam"],
            "16b": ["--agg", "obcsaa", "--ckpt-every", "1"]}
P16_STEP = re.compile(r"step +(\d+) loss=(\S+) \(([\d.]+)s\) wire: (.*)$")


def split_train_args(label: str):
    """(args, TrainConfig) of phase 16's run ``label`` as the CLI parses
    them."""
    from repro_torch.launch import train
    args = train.build_parser().parse_args(P16_ARGV + P16_RUNS[label])
    return args, train.train_config(args)


def split_train_rank(dev, tmp, rank: int, counts: dict) -> None:
    """Phase 16 on this rank: 16a and 16b through the trainer's CLI
    (``main``, which joins and leaves a world of its own), once the
    parent's oracles are ready. Rank 0 writes the CLI's lines to
    ``out_16x.txt`` and prints them."""
    from repro_torch.kernels import build
    from repro_torch.launch import train
    _wait_for(os.path.join(tmp, "go_16"), "phase 16's oracles",
              timeout=ZP_LIMIT)
    for label, extra in P16_RUNS.items():
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train.main(P16_ARGV + extra + [
                "--ckpt-dir", os.path.join(tmp, f"ck_{label}"),
                "--init-method", "file://" + os.path.join(
                    tmp, f"store_{label}")])
        secs = time.perf_counter() - t0
        counts[f"split_{label}"] = build.launch_counts()
        counts[f"peak_{label}"] = torch.cuda.max_memory_allocated(dev)
        if rank == 0:
            with open(os.path.join(tmp, f"out_{label}.txt"), "w") as f:
                f.write(buf.getvalue())
            for line in buf.getvalue().splitlines():
                log(f"{label}: {line}")
            log(f"{label}: the CLI in {secs:.1f} s on rank 0 (its world's "
                "start, the init, the steps and the checkpoints)")


def split_train_alone() -> None:
    """Phase 16 alone (``chip_smoke.py --split-train``, ~200 s): its
    4-rank launch (``--split-train-rank DIR``), the oracles and the
    gates, as in phase 14's launch."""
    import tempfile
    if sys.argv[1] == "--split-train-rank":
        tmp, counts = sys.argv[2], {}
        rank = int(os.environ["RANK"])
        split_train_rank(torch.device("cuda", int(os.environ["LOCAL_RANK"])
                                      % torch.cuda.device_count()),
                         tmp, rank, counts)
        with open(os.path.join(tmp, f"counts_{rank}.json"), "w") as f:
            json.dump(counts, f)
        return
    card, dev = banner(), torch.device("cuda")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        h = start_torchrun("16", P16_W * P16_M, [
            os.path.join(ROOT, "chip_smoke.py"), "--split-train-rank", tmp])
        want = split_train_oracles(dev, tmp)
        check_split_16a(dev, tmp, want, h)
        finish_cli(h, card, limit=ZP_LIMIT)
        counts = [json.load(open(os.path.join(tmp, f"counts_{r}.json")))
                  for r in range(P16_W * P16_M)]
        check_split_train(dev, card, tmp, want, counts)
    log(f"phase 16 alone: {time.perf_counter() - t0:.1f} s; {card}")


def split_train_oracles(dev, tmp) -> dict:
    """Before phase 16 (the ranks wait for ``go_16``): the dry run of
    16a's configuration on the meta device (a "fake" world of 4 ranks in
    this process); 16a's two steps with the weights whole, the W workers
    in turn (each worker's gradient of its own rows, summed, over W,
    Adam); and 16b's step 0 from the init with ``make_train_step`` on
    ``make_zoo_mesh(2, 1)``. Returns them, on the card."""
    import gc

    from repro_torch import tree
    from repro_torch.configs import InputShape, get_config
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_zoo_mesh
    from repro_torch.launch.train import make_batch
    from repro_torch.models.registry import build_model

    t0 = time.perf_counter()
    args, tcfg = split_train_args("16a")
    cfg = get_config(FED_ARCH)
    # the VLM's sequence: the image embeddings, then the CLI's tokens
    dry = dryrun.measure(cfg, InputShape("16a", cfg.num_image_tokens
                                         + args.seq, args.batch, "train"),
                         (P16_W, P16_M), ("data", "model"), agg="mean",
                         tcfg=tcfg)
    if dry["model_axis"] != "split":
        fail(f"16a dry run: model_axis {dry['model_axis']}, want split")
    mem = dry["memory"]
    log(f"16a dry run (meta device, rank (0, 0) of a fake 2 x 2 world, "
        f"{time.perf_counter() - t0:.1f} s): params "
        f"{mem['params'] / 2**30:.3f} GiB, optimizer "
        f"{mem['optimizer'] / 2**30:.3f} GiB, step_peak "
        f"{mem['step_peak'] / 2**30:.3f} GiB, total "
        f"{mem['total'] / 2**30:.3f} GiB; collectives a step "
        + ", ".join(f"{k} {v / 1e6:.1f} MB in {dry['collectives']['calls'][k]}"
                    f" calls" for k, v in dry["collectives"]["bytes"].items()))
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(0, device=dev)
    opt = steps_lib.make_optimizer(tcfg)
    state = opt.init(params)
    batch = make_batch(cfg, args.batch, args.seq, device=dev)
    build.reset_launch_counts()
    losses = []
    for _ in range(args.steps):
        gs, ls = [], []
        for u in range(P16_W):
            loss, g = steps_lib.loss_and_grads(
                model, tcfg, params, steps_lib.shard_batch(batch, u, P16_W))
            gs.append(g)
            ls.append(float(loss))
        with torch.no_grad():
            grads = tree.tree_map(lambda a, b: (a + b).div_(P16_W), *gs)
            del gs
            params, state = opt.update(grads, state, params,
                                       tcfg.learning_rate)
        del grads
        losses.append(sum(ls) / len(ls))
    # kept on the card (6 GB) until the ranks' checkpoint is read
    want = {"leaves": tree.leaves(params) + tree.leaves(state),
            "losses": losses, "dry": dry}
    del params, state
    log(f"16a in turn: {args.steps} steps with the weights whole in "
        f"{time.perf_counter() - t0:.1f} s, losses "
        + ", ".join(f"{v:.4f}" for v in losses))
    t0 = time.perf_counter()
    _, tcfg = split_train_args("16b")
    mesh = make_zoo_mesh(P16_W, 1)
    params = model.init(0, device=dev)
    want["before0"] = _flat([p.float() for p in tree.leaves(params)])
    params, _, m = steps_lib.make_train_step(model, tcfg, mesh)(
        params, (), batch, steps_lib.default_round_ctx(seed=0, device=dev,
                                                       mesh=mesh))
    want["after0"] = _flat([p.float() for p in tree.leaves(params)])
    want["loss0"] = float(m["loss"])
    expect_counts("16a and 16b step 0 in turn", build.launch_counts(), {},
                  0)
    del params, batch, model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"16b in turn: step 0 from the init in "
        f"{time.perf_counter() - t0:.1f} s")
    open(os.path.join(tmp, "go_16"), "w").close()
    return want


def _split_lines(tmp, label: str, card: str) -> list:
    """16x's CLI lines on rank 0: the steps (s, loss finite, the
    collectives), the replicas' and the shares' lines; each step
    printed."""
    with open(os.path.join(tmp, f"out_{label}.txt")) as f:
        text = f.read()
    steps = [m for m in map(P16_STEP.search, text.splitlines()) if m]
    if len(steps) != 2 or not all(np.isfinite(float(m.group(2)))
                                  for m in steps):
        fail(f"{label}: want 2 steps with finite losses: {text}")
    for need in ("replicas: parameter shares bit-identical on the 2 ranks "
                 "of each worker group", "the product rule over "
                 "param_shardings", "peak memory by rank"):
        if need not in text:
            fail(f"{label}: the CLI printed no '{need}': {text}")
    for m in steps:
        log(f"{label}: step {m.group(1)}: {float(m.group(3)):.2f} s on rank "
            f"0, loss {m.group(2)}; collectives {m.group(4)}; {card}")
    return steps


def _chunks_parted(got, want, before, rel: float = 1e-4) -> tuple:
    """(1024-chunks of the movement ``want − before`` that ``got`` parts
    from by more than ``rel`` of their own norm, chunks)."""
    n = want.numel()
    pad = (-n) % 1024
    d = torch.nn.functional.pad(got - want, (0, pad)).reshape(-1, 1024)
    mv = torch.nn.functional.pad(want - before, (0, pad)).reshape(-1, 1024)
    apart = torch.linalg.vector_norm(d, dim=1) > rel * \
        torch.linalg.vector_norm(mv, dim=1)
    return int(apart.sum()), int(apart.numel())


def check_split_16a(dev, tmp, want: dict, launch) -> None:
    """16a's gate, while the ranks run 16b: the ranks' checkpoint after
    step 2 (on disk once rank 0 has written ``out_16a.txt``) against the
    whole weights' steps with the workers in turn, bit for bit, every
    parameter and Adam moment."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.registry import build_model

    _wait_for(os.path.join(tmp, "out_16a.txt"), "16a's checkpoint",
              timeout=ZP_LIMIT, launch=launch)
    t0 = time.perf_counter()
    args, tcfg = split_train_args("16a")
    got = steps_lib.restore_train_state(os.path.join(tmp, "ck_16a"),
                                        build_model(get_config(FED_ARCH)),
                                        tcfg, dev)
    if got is None or got[2] != args.steps:
        fail(f"16a: no checkpoint of step {args.steps}")
    mine = tree.leaves(got[0]) + tree.leaves(got[1])
    theirs = want.pop("leaves")
    differ = [i for i, (a, b) in enumerate(zip(mine, theirs))
              if not torch.equal(a, b)]
    if differ or len(mine) != len(theirs):
        i = differ[0] if differ else 0
        n, ulps = _ulps(mine[i].float().reshape(-1),
                        theirs[i].float().reshape(-1),
                        theirs[i].float().reshape(-1))
        fail(f"16a: {len(differ)} of {len(theirs)} leaves of the ranks' "
             f"checkpoint differ from the whole steps' (leaf {i}: {n:,} "
             f"elements, at most {ulps:.1f} ulp)")
    log(f"16a: the ranks' checkpoint after step {args.steps} ≡ the whole "
        f"weights' steps with the workers in turn, bit for bit in all "
        f"{len(theirs)} leaves (parameters and Adam's moments); losses in "
        f"turn " + ", ".join(f"{v:.4f}" for v in want["losses"])
        + f" (held in {time.perf_counter() - t0:.1f} s beside the ranks' "
        "16b)")
    del got, mine, theirs
    torch.cuda.empty_cache()


def _held_16b(t: int, before, ours, theirs, lr: float, loss: float) -> None:
    """16b's step t from the ranks' carry ``before``: this process's
    ``ours`` against the ranks' ``theirs`` (flat f32 on the card), bit
    for bit, or ĝ by NMSE and support and the parameters within 1e-4 of
    their movement (≤ 1% of its chunks parted), with the ulps."""
    if torch.equal(ours, theirs):
        log(f"16b: step {t} from the ranks' carry ≡ make_train_step on "
            f"make_zoo_mesh(2, 1) bit for bit (loss in turn {loss:.4f})")
        return
    nmse, overlap = _nmse_support((before - ours) / lr,
                                  (before - theirs) / lr)
    share = float(torch.linalg.vector_norm(ours - theirs)
                  / torch.linalg.vector_norm(theirs - before))
    parted, chunks = _chunks_parted(ours, theirs, before)
    n_diff, ulps = _ulps(ours, theirs, before)
    log(f"16b: step {t} from the ranks' carry against make_train_step on "
        f"make_zoo_mesh(2, 1): ĝ NMSE {nmse:.3e}, support overlap "
        f"{overlap:.6f}; parameters {share:.3e} of their movement apart, "
        f"{parted:,} of {chunks:,} chunks parted; the witness: {n_diff:,} "
        f"of {ours.numel():,} elements differ, by at most {ulps:.1f} ulp "
        f"(loss in turn {loss:.4f})")
    if not (nmse <= FED_GHAT_NMSE and overlap >= FED_SUPPORT):
        fail(f"16b step {t}: ĝ NMSE {nmse:.3e} (gate {FED_GHAT_NMSE}), "
             f"support overlap {overlap:.6f} (gate {FED_SUPPORT})")
    if share > FED_PARAM_TOL and parted > chunks // 100:
        fail(f"16b step {t}: parameters {share:.3e} of their movement "
             f"apart (gate {FED_PARAM_TOL}), {parted} of {chunks} chunks "
             "parted (gate 1%)")


def check_split_train(dev, card, tmp, want: dict, counts: list) -> None:
    """Phase 16's other gates once the launch has ended
    (``split_train_rank``): the CLI's lines, no launch of K1-K7 in any
    rank, the peaks beside the dry run's estimate; 16b's steps, each
    from the ranks' carry before it, against ``make_train_step`` on
    ``make_zoo_mesh(2, 1)`` (step 0's from ``split_train_oracles``)."""
    import gc

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_zoo_mesh
    from repro_torch.launch.train import make_batch
    from repro_torch.models.registry import build_model

    t0 = time.perf_counter()
    for label in P16_RUNS:
        _split_lines(tmp, label, card)
        summed = {k: sum(c[f"split_{label}"][k] for c in counts)
                  for k in counts[0][f"split_{label}"]}
        expect_counts(f"split train ({label})", summed, {}, 0)
        dry = want["dry"]["memory"]
        log(f"{label}: peak by rank (GiB) " + ", ".join(
            f"{c[f'peak_{label}'] / 2**30:.2f}" for c in counts)
            + f"; the dry run's 16a estimate: total "
            f"{dry['total'] / 2**30:.2f} GiB, step_peak "
            f"{dry['step_peak'] / 2**30:.2f} GiB (live storages, no "
            "allocator rounding; the CLI's init and checkpoints not in "
            "it)")
    args, tcfg = split_train_args("16b")
    cfg = get_config(FED_ARCH)
    model = build_model(cfg)
    ck = os.path.join(tmp, "ck_16b")
    lr = tcfg.learning_rate
    carry1 = _flat(_ckpt_params(ck, 1)).to(dev)
    _held_16b(0, want.pop("before0"), want.pop("after0"), carry1, lr,
              want["loss0"])
    mesh = make_zoo_mesh(P16_W, 1)
    leaves, treedef = tree.flatten(model.init(0, device="meta"))
    off = 0
    for i, p in enumerate(leaves):
        leaves[i] = carry1[off:off + p.numel()].reshape(p.shape).to(p.dtype)
        off += p.numel()
    build.reset_launch_counts()
    params, _, m = steps_lib.make_train_step(model, tcfg, mesh)(
        tree.unflatten(treedef, leaves), (), make_batch(
            cfg, args.batch, args.seq, device=dev),
        steps_lib.default_round_ctx(seed=1, device=dev, mesh=mesh))
    expect_counts("16b step 1 in turn", build.launch_counts(), {}, 0)
    ours = _flat([p.float() for p in tree.leaves(params)])
    del params, leaves
    _held_16b(1, carry1, ours, _flat(_ckpt_params(ck, 2)).to(dev), lr,
              float(m["loss"]))
    del carry1, ours
    gc.collect()
    torch.cuda.empty_cache()
    log(f"16: held in {time.perf_counter() - t0:.1f} s")
    split_rows_witness(dev, tcfg)


def split_rows_witness(dev, tcfg) -> None:
    """Why 16b may part from M = 1: Φ's product with a model shard's
    half of a leaf's chunk rows, against those rows of the product with
    all of them, for the largest leaves' chunk counts of internvl2-1b
    (N(0, 1) rows, the step's Φ)."""
    from repro_torch.launch.steps import _row_block, obcsaa_config
    ob = obcsaa_config(tcfg)
    phi = ob.phi(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for n in (132_699, 102_144, 18_816):
        x = torch.randn((n, ob.chunk), generator=gen, device=dev)
        whole = x @ phi.T
        for m in range(P16_M):
            a, b = _row_block(n, P16_M, m)
            part = x[a:b] @ phi.T
            out.append(f"n {n:,} rows [{a:,}, {b:,}): "
                       + ("equal" if torch.equal(part, whole[a:b]) else
                          f"{int((part != whole[a:b]).sum()):,} of "
                          f"{part.numel():,} differ, by at most "
                          f"{float((part - whole[a:b]).abs().max()):.2e}"))
    del x, whole, part
    torch.cuda.empty_cache()
    log("16b witness (cuBLAS, f32, TF32 off): a shard's rows of x Φᵀ "
        "alone against the whole product's: " + "; ".join(out))


# -- phase 17 -----------------------------------------------------------------

# the §V sweep's arm axis over processes: fig5's grid (benchmarks/
# fig5_noise.py:15-17: 4 σ² x seeds 0-2 = 12 arms, 100 rounds) with
# benchmarks/common.py:58-81's settings (U = 10 x K = 3000, scheduler
# ``all``, eval every 20, BIHT 25) in scan mode on phase 6's data and
# weights, in phase 14's launch before 13: (17a) over world_mesh(1), 3 arms
# a rank, (17b) over world_mesh(2), 6 arms a worker group replicated over
# its model group, (17c) resumed across world sizes, 1 -> 4 and 4 -> 1
P17_NV, P17_SEEDS = [1e-6, 1e-4, 1e-2, 1.0], [0, 1, 2]
P17_ROUNDS, P17_EVAL = 100, 20
P17_RANKS = 4
P17_RUNS = (("17a", 1, "ck17a", False), ("17b", 2, "ck17b", False),
            ("17c", 1, "ck17_from1", True))
P17_STREAMS = ("n_scheduled", "b_t", "rt_bound", "eval_rounds", "loss",
               "accuracy")
P17_KERNELS = ("topk_select", "cs_project", "cs_project_resid",
               "backproject")


def sweep17_engine(dev, task: Task):
    """(EngineRun, Arms) of phase 17's grid: arm i = (σ² of
    P17_NV[i // 3], seed i % 3), as fig5_noise.py lays them out."""
    from repro_torch.engine import EngineRun, FLConfig, make_arms
    cfg = FLConfig(aggregator="obcsaa", rounds=P17_ROUNDS,
                   eval_every=P17_EVAL, seed=0, mode="scan",
                   obcsaa=task.obcsaa(biht_iters=SWEEP_ITERS),
                   topk_dense=1000)
    run = EngineRun(cfg, task.loss_fn, task.params0, task.data,
                    task.k_weights(), eval_fn=task.eval_fn, device=dev)
    return run, make_arms(cfg, seeds=P17_SEEDS * len(P17_NV),
                          noise_var=[nv for nv in P17_NV
                                     for _ in P17_SEEDS])


def plain_sweep(res) -> dict:
    """A ``run_sweep`` result as tensors on the CPU, what the ranks and
    this process exchange through files: the streams, the budget's
    fields, ``t_start`` and every arm's carry leaves (the generator's
    state in the generator's place)."""
    from repro_torch import tree
    from repro_torch.engine.state import with_generator_state
    out = {k: torch.from_numpy(np.array(res[k])) for k in P17_STREAMS}
    out["budget"] = [torch.from_numpy(np.array(b)) for b in res["budget"]]
    out["t_start"] = res["t_start"]
    out["state"] = [[x.detach().cpu() for x in tree.leaves(
        with_generator_state(s))] for s in res["state"]]
    return out


def plain_diffs(got: dict, want: dict) -> list:
    """What differs, bit for bit, between two ``plain_sweep``s; a resumed
    ``got`` is held to the tail of the uninterrupted ``want``."""
    def tail(x, n):
        return x[..., x.shape[-1] - n:]

    n, e = got["n_scheduled"].shape[-1], got["eval_rounds"].shape[-1]
    bad = [k for k in P17_STREAMS if not torch.equal(
        got[k], tail(want[k], e if k in ("eval_rounds", "loss", "accuracy")
                     else n))]
    bad += [f"budget.{i}" for i, (g, w) in enumerate(zip(got["budget"],
                                                        want["budget"]))
            if not torch.equal(g, tail(w, n))]
    if len(got["state"]) != len(want["state"]):
        bad.append(f"{len(got['state'])} arms, not {len(want['state'])}")
    bad += [f"carry of arm {a}" for a, (g, w) in enumerate(
        zip(got["state"], want["state"]))
        if len(g) != len(w) or not all(torch.equal(x, y)
                                       for x, y in zip(g, w))]
    return bad


def _cut_after_middle(src: str, dst: str) -> tuple:
    """Copy the checkpoint ``src`` to ``dst`` and delete its steps past
    the middle boundary. Returns (the steps of ``src``, the kept one)."""
    import shutil
    from repro_torch import checkpoint
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(src))
    mid = steps[(len(steps) - 1) // 2]
    shutil.copytree(src, dst)
    for n in steps:
        if n > mid:
            shutil.rmtree(checkpoint.step_dir(dst, n))
    return steps, mid


def sweep_procs_rank(tmp, rank: int, counts: dict) -> None:
    """Phase 17 on this rank, once the parent's one-process grid is on
    disk (``go_17``): a world of 4 ranks (its own file store), then 17a
    over ``world_mesh(1)`` with a checkpoint at every boundary, 17b over
    ``world_mesh(2)`` (its saves check the model group's replicas), 17c
    the one-process checkpoint cut after its middle boundary resumed over
    ``world_mesh(1)``: each rank's whole result against the one-process
    grid, bit for bit, its launches against 27/1/25/26 an arm-round (the
    warm-up rounds counted), its seconds (host clock, from a barrier),
    the gathers' and the replica checks' MB, ms and calls, save ms; the
    peak memory. Written to ``sweep17_RANK.json``; the card's cache is
    emptied after. The data's host arrays load before the wait
    (``mnist_arrays``, ~7 s of host work)."""
    import gc

    from repro_torch.dist import collectives as coll
    from repro_torch.dist.sharding import batch_indices
    from repro_torch.engine import RoundGraph
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import join_world, leave_world, world_mesh
    mnist_arrays()
    _wait_for(os.path.join(tmp, "go_17"), "phase 17's one-process grid",
              timeout=ZP_LIMIT)
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                       % torch.cuda.device_count())
    with contextlib.redirect_stdout(io.StringIO()):
        task = Task(dev)
    mesh, dev = join_world(model_parallel=1, init_method="file://"
                           + os.path.join(tmp, "store_17"))
    meshes = {1: mesh, 2: world_mesh(2)}
    want = torch.load(os.path.join(tmp, "oracle_17.pt"))
    A = len(P17_NV) * len(P17_SEEDS)
    res = {}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated(dev)
    for label, M, ck, resume in P17_RUNS:
        run, arms = sweep17_engine(dev, task)
        coll.barrier(mesh.world)
        coll.reset_counters()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        out = run.run_sweep(arms, ckpt_dir=os.path.join(tmp, ck),
                            resume=resume, mesh=meshes[M])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = build.launch_counts()
        st = coll.stats()
        coll.barrier(mesh.world)
        wall = time.perf_counter() - t0
        got = plain_sweep(out)
        own = batch_indices(A, meshes[M])
        res[label] = {
            "diffs": plain_diffs(got, want), "t_start": out["t_start"],
            "own": list(own), "s": secs, "wall_s": wall,
            "launches": launches,
            "want": {k: SWEEP_PER_ROUND.get(k, 0) * len(own)
                     * (RoundGraph.WARMUP + P17_ROUNDS - out["t_start"])
                     for k in launches},
            "boundaries": len(run.save_s),
            "save_ms": [1e3 * x for x in run.save_s],
            "coll": {k: [st["bytes"].get(k, 0), st["ms"].get(k, 0.0),
                         st["calls"].get(k, 0)] for k in st["calls"]}}
        if label == "17a":
            counts["sweep_procs"] = launches
        del run, out, got
        torch.cuda.empty_cache()
        res[label]["held_after"] = torch.cuda.memory_allocated(dev)
    res["peak"] = torch.cuda.max_memory_allocated(dev) - base
    res["done"] = time.time()
    leave_world()
    del task, meshes, want
    gc.collect()                # what reference cycles still hold
    torch.cuda.empty_cache()
    res["base"] = base
    res["held_after"] = torch.cuda.memory_allocated(dev)
    path = os.path.join(tmp, f"sweep17_{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(res, f)
    os.replace(path + ".tmp", path)


def sweep_procs_oracle(dev, tmp, task: Task) -> dict:
    """Phase 17's grid in this process, before the ranks' go: 12 arms x
    100 rounds in scan mode with a checkpoint at every boundary, timed;
    its launches, its loss falling in the σ² ≤ 1e-2 arms and finite in
    all; the result to ``oracle_17.pt`` and the checkpoint cut after its
    middle boundary to ``ck17_from1`` (17c's 1 -> 4); then ``go_17``."""
    from repro_torch.engine import RoundGraph
    from repro_torch.kernels import build
    run, arms = sweep17_engine(dev, task)
    A = len(P17_NV) * len(P17_SEEDS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = run.run_sweep(arms, ckpt_dir=os.path.join(tmp, "ck17_one"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    expect_counts("17 one process", build.launch_counts(), SWEEP_PER_ROUND,
                  A * (RoundGraph.WARMUP + P17_ROUNDS))
    peak = torch.cuda.max_memory_allocated() - base
    loss = res["loss"]
    if not (np.isfinite(loss).all() and np.isfinite(res["rt_bound"]).all()):
        fail("17: a loss or rt_bound of the one-process grid is not finite")
    low = np.asarray(arms.noise_var) <= 1e-2
    if not (loss[low, -1] < task.loss0).all():
        fail(f"17: the loss did not fall in every σ² ≤ 1e-2 arm "
             f"({task.loss0} -> {loss[:, -1].tolist()})")
    want = plain_sweep(res)
    steps, mid = _cut_after_middle(os.path.join(tmp, "ck17_one"),
                                   os.path.join(tmp, "ck17_from1"))
    path = os.path.join(tmp, "oracle_17.pt")
    torch.save(want, path + ".tmp")
    os.replace(path + ".tmp", path)
    open(os.path.join(tmp, "go_17"), "w").close()
    t_go = time.time()
    log(f"17 one process: {A} arms x {P17_ROUNDS} rounds (fig5's grid, "
        f"scan) in {secs:.3f} s, captures and saves included = "
        f"{secs * 1e3 / (A * P17_ROUNDS):.3f} ms per arm-round; save ms "
        "per boundary " + ", ".join(f"{x * 1e3:.1f}" for x in run.save_s)
        + f"; peak {peak / 2**20:.1f} MiB over what this process held "
        "before; final loss by σ² "
        + "; ".join(f"{nv:g}: " + ", ".join(
            f"{v:.4f}" for v in loss[i * 3:(i + 1) * 3, -1])
            for i, nv in enumerate(P17_NV))
        + f"; steps saved {steps}, 17c cuts after {mid}")
    del run, res
    torch.cuda.empty_cache()
    return {"want": want, "steps": steps, "mid": mid, "secs": secs,
            "go": t_go}


def run_sweep_procs_phase(dev, card: str, tmp, task: Task, launch,
                          oracle: dict, beside: str = "") -> None:
    """Phase 17's parent once ``sweep_procs_oracle`` gave the ranks their
    go: each rank's verdicts and numbers (``sweep17_RANK.json``): 17a,
    17b and 17c's 1 -> 4 bit for bit, K1-K4 launched in every rank as
    counted; then 4 -> 1: 17a's checkpoint, which world rank 0 wrote at
    every boundary, cut after its middle boundary and resumed here, bit
    for bit the uninterrupted grid. ``beside``: what shared the card with
    the ranks' runs, for the log."""
    from repro_torch.engine import RoundGraph
    for r in range(P17_RANKS):
        _wait_for(os.path.join(tmp, f"sweep17_{r}.json"),
                  f"rank {r}'s phase 17", timeout=ZP_LIMIT, launch=launch)
    ranks = [json.load(open(os.path.join(tmp, f"sweep17_{r}.json")))
             for r in range(P17_RANKS)]
    for label, M, _, _ in P17_RUNS:
        for r, res in enumerate(ranks):
            got = res[label]
            if got["diffs"]:
                fail(f"{label} rank {r}: the sweep over processes differs "
                     f"from the one-process grid in {got['diffs']}")
            if got["launches"] != got["want"]:
                fail(f"{label} rank {r}: launches {got['launches']} != "
                     f"{got['want']}")
            if not all(got["launches"][k] for k in P17_KERNELS):
                fail(f"{label} rank {r}: K1-K4 did not all launch")
        r0 = ranks[0][label]
        gath = [res[label]["coll"].get("all_gather_arms", [0, 0.0, 0])
                for res in ranks]
        chk = [res[label]["coll"].get("broadcast", [0, 0.0, 0])
               for res in ranks]
        log(f"{label}: world_mesh({M}), arms by rank "
            + ", ".join(f"{res[label]['own'][0]}-{res[label]['own'][-1]}"
                        for res in ranks)
            + f", from round {r0['t_start']}: every rank's whole result ≡ "
            f"the one-process grid bit for bit (streams, budget, every arm's"
            f" carry, generator states included); s by rank (host clock, "
            f"from a barrier, captures and saves included"
            + (f", beside {beside}" if beside else "") + ") "
            + ", ".join(f"{res[label]['s']:.3f}" for res in ranks)
            + f", {max(res[label]['wall_s'] for res in ranks):.3f} to the "
            f"last rank's barrier; gathers ({gath[0][2]} calls: one a "
            f"boundary, then the final carries) "
            f"{gath[0][0] / max(gath[0][2], 1) / 2**20:.3f} MB a call, ms "
            "a call by rank "
            + ", ".join(f"{g[1] / max(g[2], 1):.2f}" for g in gath)
            + f"; replica checks (broadcast) "
            f"{chk[0][0] / 2**20:.3f} MB in {chk[0][2]} calls, "
            f"{chk[0][1]:.1f} ms on rank 0; save ms on rank 0 "
            + ", ".join(f"{x:.1f}" for x in r0["save_ms"])
            + f"; launches on rank 0 {r0['launches']} = {len(r0['own'])} "
            f"arms x ({RoundGraph.WARMUP} + {P17_ROUNDS - r0['t_start']}) "
            f"x {SWEEP_PER_ROUND}")
    log("17: peak by rank over what it held before 17a (MiB) " + ", ".join(
        f"{res['peak'] / 2**20:.1f}" for res in ranks)
        + "; allocated by rank (MiB) before 17a "
        + ", ".join(f"{res['base'] / 2**20:.1f}" for res in ranks)
        + ", after each run "
        + "; ".join(", ".join(f"{res[label]['held_after'] / 2**20:.1f}"
                              for res in ranks) for label, *_ in P17_RUNS)
        + ", after the phase "
        + ", ".join(f"{res['held_after'] / 2**20:.1f}" for res in ranks)
        + f"; {card}")
    # 4 -> 1: 17a's checkpoint, cut after its middle boundary, here
    run, arms = sweep17_engine(dev, task)
    steps, mid = _cut_after_middle(os.path.join(tmp, "ck17a"),
                                   os.path.join(tmp, "ck17_from4"))
    if steps != oracle["steps"]:
        fail(f"17a: world rank 0 saved steps {steps}, the one-process grid "
             f"{oracle['steps']}")
    t0 = time.perf_counter()
    out = run.run_sweep(arms, ckpt_dir=os.path.join(tmp, "ck17_from4"),
                        resume=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if out["t_start"] != mid:
        fail(f"17c 4 -> 1: resumed at {out['t_start']}, not {mid}")
    bad = plain_diffs(plain_sweep(out), oracle["want"])
    if bad:
        fail(f"17c 4 -> 1: the resumed sweep differs from the uninterrupted "
             f"grid in {bad}")
    log(f"17c: 1 -> 4 (the one-process checkpoint at step {mid} resumed by "
        f"the 4 ranks) and 4 -> 1 (17a's, resumed here in {secs:.3f} s) ≡ "
        f"the uninterrupted grid bit for bit; the ranks' 17 ended "
        f"{max(res['done'] for res in ranks) - oracle['go']:.1f} s after "
        "their go")
    del run, out
    torch.cuda.empty_cache()


def sweep_procs_alone() -> None:
    """Phase 17 alone (``chip_smoke.py --sweep-procs``): its own 4-rank
    launch (``--sweep-procs-rank DIR``), the parent's grid, the gates."""
    import tempfile
    if sys.argv[1] == "--sweep-procs-rank":
        sweep_procs_rank(sys.argv[2], int(os.environ["RANK"]), {})
        return
    card, dev = banner(), torch.device("cuda")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        h = start_torchrun("17", P17_RANKS, [
            os.path.join(ROOT, "chip_smoke.py"), "--sweep-procs-rank", tmp])
        build_kernels()
        task = Task(dev)
        run_sweep_procs_phase(dev, card, tmp, task, h,
                              sweep_procs_oracle(dev, tmp, task))
        finish_cli(h, card, limit=ZP_LIMIT)
    log(f"phase 17 alone: {time.perf_counter() - t0:.1f} s; {card}")


P17D_RUNS = (("17d", "ck17d", False), ("17d resumed", "ck17d_from1", True))


def start_nccl_rank(tmp: str) -> dict:
    """Start 13d's world of one (``nccl_rank`` under ``torchrun``)."""
    return start_torchrun("13d", 1, [os.path.join(ROOT, "chip_smoke.py"),
                                     "--nccl-rank", tmp])


def nccl_rank(tmp: str) -> None:
    """13d and 17d in the world of one that ``torchrun`` starts
    (``chip_smoke.py --nccl-rank DIR``): one rank on the card, so
    ``join_world`` picks NCCL. 13d: the trainer CLI's ``main`` at
    internvl2-1b's width, one step and its checkpoint (a world of its own,
    a file store), then ``done_13d``. 17d, once the parent's one-process
    grid is on disk (``go_17``), in a world of its own: fig5's grid over
    ``world_mesh(1)`` (W = 1: every boundary's records through NCCL's
    all-gather) with a checkpoint at every boundary, then the
    one-process checkpoint cut after its middle boundary resumed; each
    held to the grid bit for bit (``plain_diffs``). The backend, the
    wait for ``go_17``, each run's launches against 27/1/25/26 an
    arm-round (the warm-up rounds counted), its seconds, the gathers'
    MB, ms (CUDA events) and calls, save ms, the steps saved and the peak
    memory go to ``sweep17d.json``; the parent checks them. Nothing here
    catches a refused collective: the rank raises and ``torchrun``
    exits non-zero."""
    import gc

    import torch.distributed as dist

    from repro_torch.dist import collectives as coll
    from repro_torch.engine import RoundGraph
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.launch.mesh import join_world, leave_world
    code = train.main(FED_ARGV + [
        "--steps", "1", "--ckpt-dir", fed_ckpts(tmp)["d"], "--init-method",
        "file://" + os.path.join(tmp, "store_13d")])
    if code:
        fail(f"13d: the CLI returned {code}")
    gc.collect()
    torch.cuda.empty_cache()
    open(os.path.join(tmp, "done_13d"), "w").close()
    mnist_arrays()
    t0 = time.perf_counter()
    _wait_for(os.path.join(tmp, "go_17"), "phase 17's one-process grid",
              timeout=ZP_LIMIT)
    res = {"waited_s": time.perf_counter() - t0}
    mesh, dev = join_world(init_method="file://"
                           + os.path.join(tmp, "store_17d"))
    res["backend"] = dist.get_backend(mesh.world)
    with contextlib.redirect_stdout(io.StringIO()):
        task = Task(dev)
    want = torch.load(os.path.join(tmp, "oracle_17.pt"))
    res["steps_one"], res["mid"] = _cut_after_middle(
        os.path.join(tmp, "ck17_one"), os.path.join(tmp, P17D_RUNS[1][1]))
    A = len(P17_NV) * len(P17_SEEDS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated(dev)
    for label, ck, resume in P17D_RUNS:
        run, arms = sweep17_engine(dev, task)
        coll.barrier(mesh.world)        # NCCL's set-up before the clock
        coll.reset_counters()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        out = run.run_sweep(arms, ckpt_dir=os.path.join(tmp, ck),
                            resume=resume, mesh=mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = build.launch_counts()
        st = coll.stats()
        res[label] = {
            "diffs": plain_diffs(plain_sweep(out), want),
            "t_start": out["t_start"], "s": secs, "launches": launches,
            "want": {k: SWEEP_PER_ROUND.get(k, 0) * A
                     * (RoundGraph.WARMUP + P17_ROUNDS - out["t_start"])
                     for k in launches},
            "save_ms": [1e3 * x for x in run.save_s],
            "coll": {k: [st["bytes"].get(k, 0), st["ms"].get(k, 0.0),
                         st["calls"].get(k, 0)] for k in st["calls"]}}
        del run, out
        torch.cuda.empty_cache()
    res["steps"] = sorted(int(n.split("_")[1]) for n in os.listdir(
        os.path.join(tmp, P17D_RUNS[0][1])))
    res["peak"] = torch.cuda.max_memory_allocated(dev) - base
    leave_world()
    path = os.path.join(tmp, "sweep17d.json")
    with open(path + ".tmp", "w") as f:
        json.dump(res, f)
    os.replace(path + ".tmp", path)


def check_sweep_nccl(tmp: str, card: str, beside: str) -> None:
    """17d's verdicts and numbers (``sweep17d.json``, from ``nccl_rank``):
    the backend NCCL, both runs bit for bit the one-process grid, the
    resume from the cut's step, K1-K4 launched as counted, every
    boundary's records gathered through NCCL, the steps saved those of
    the one-process grid. ``beside``: what shared the card, for the
    log."""
    from repro_torch.engine import RoundGraph
    with open(os.path.join(tmp, "sweep17d.json")) as f:
        got = json.load(f)
    if got["backend"] != "nccl":
        fail(f"17d: the world of one joined over {got['backend']}, not "
             "NCCL")
    if got["steps"] != got["steps_one"]:
        fail(f"17d: saved steps {got['steps']}, the one-process grid "
             f"{got['steps_one']}")
    for label, _, resume in P17D_RUNS:
        r = got[label]
        if r["diffs"]:
            fail(f"{label}: the sweep in the NCCL world of one differs from "
                 f"the one-process grid in {r['diffs']}")
        if r["t_start"] != (got["mid"] if resume else 0):
            fail(f"{label}: started at round {r['t_start']}")
        if r["launches"] != r["want"] or not all(
                r["launches"][k] for k in P17_KERNELS):
            fail(f"{label}: launches {r['launches']} != {r['want']}")
        gath = r["coll"].get("all_gather_arms", [0, 0.0, 0])
        if not gath[2]:
            fail(f"{label}: no record went through NCCL's all-gather")
        log(f"{label}: world_mesh(1) of an NCCL world of one, from round "
            f"{r['t_start']}: ≡ the one-process grid bit for bit (streams, "
            f"budget, every arm's carry, generator states included); "
            f"{r['s']:.3f} s (host clock, captures and saves included, "
            f"beside {beside}); gathers on the card {gath[2]} calls, "
            f"{gath[0] / gath[2] / 2**20:.3f} MB and "
            f"{gath[1] / gath[2]:.2f} ms a call (CUDA events); save ms "
            + ", ".join(f"{x:.1f}" for x in r["save_ms"])
            + f"; launches {r['launches']} = "
            f"{len(P17_NV) * len(P17_SEEDS)} arms x ({RoundGraph.WARMUP} "
            f"+ {P17_ROUNDS - r['t_start']}) x {SWEEP_PER_ROUND}")
    log(f"17d: backend {got['backend']}; the rank waited "
        f"{got['waited_s']:.1f} s for the one-process grid after 13d's "
        f"step; steps saved {got['steps']}, resumed after {got['mid']}; "
        f"peak {got['peak'] / 2**20:.1f} MiB over what the rank held "
        f"before; {card}")


def check_nccl_world(dev, card: str, tmp: str, launch, beside: str) -> dict:
    """13d's and 17d's checks once 13d's world of one (``launch``, from
    ``start_nccl_rank``) has made its step: 13d against this process's
    step (``check_federation_nccl``) while the rank runs 17d, then the
    CLI's NCCL line and 17d (``check_sweep_nccl``). Returns the launch
    counts of this process's check, all 0."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    _wait_for(os.path.join(tmp, "done_13d"), "13d's step", timeout=ZP_LIMIT,
              launch=launch)
    t1 = time.perf_counter()
    build.reset_launch_counts()
    check_federation_nccl(dev, fed_ckpts(tmp)["d"])
    counts = build.launch_counts()
    t2 = time.perf_counter()
    if "world: 1 workers over nccl" not in finish_cli(launch, card):
        fail("13d: the world of one did not run over NCCL")
    log(f"13d: this process waited {t1 - t0:.1f} s for the rank's step, "
        f"checked it in {t2 - t1:.1f} s (17d beside it), then waited "
        f"{time.perf_counter() - t2:.1f} s for the rank's exit")
    check_sweep_nccl(tmp, card, beside)
    return counts


def nccl_world_alone() -> None:
    """13d and 17d alone (``chip_smoke.py --nccl-world``): 13d's world of
    one, started first (``--nccl-rank DIR``), the parent's one-process
    grid (phase 17's oracle), then 13d's and 17d's checks."""
    import tempfile
    if sys.argv[1] == "--nccl-rank":
        nccl_rank(sys.argv[2])
        return
    card, dev = banner(), torch.device("cuda")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        h = start_nccl_rank(tmp)
        build_kernels()
        task = Task(dev)
        sweep_procs_oracle(dev, tmp, task)
        expect_counts("13d's check", check_nccl_world(
            dev, card, tmp, h, beside="13d's check in this process"), {}, 0)
    log(f"13d and 17d alone: {time.perf_counter() - t0:.1f} s; {card}")


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
    if sys.argv[1:] == ["--federation-rank"]:
        federation_rank()
        return
    if sys.argv[1:2] == ["--zoo-rank"]:
        zoo_rank()
        return
    if sys.argv[1:2] == ["--serve-moe-rank"]:
        serve_moe_rank()
        return
    if sys.argv[1:2] in (["--split-train"], ["--split-train-rank"]):
        sys.path.insert(0, os.path.join(ROOT, "src"))
        split_train_alone()
        return
    if sys.argv[1:2] in (["--sweep-procs"], ["--sweep-procs-rank"]):
        sys.path.insert(0, os.path.join(ROOT, "src"))
        sweep_procs_alone()
        return
    if sys.argv[1:2] in (["--nccl-world"], ["--nccl-rank"]):
        sys.path.insert(0, os.path.join(ROOT, "src"))
        nccl_world_alone()
        return
    t_script = time.perf_counter()
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, src)
    dev = torch.device("cuda")
    card = banner()
    zoo_procs = start_zoo_procs()
    moe_procs = start_serve_moe_procs()
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
    paths["serve_moe_split"] = run_serve_moe_phase(dev, card, moe_procs)
    paths["families"] = run_families_phase(dev, card)
    paths.update(run_zoo_phase(dev, card, results))
    # phase 17: the grid here, then the zoo launch's ranks beside the CLIs
    grid17 = sweep_procs_oracle(dev, zoo_procs["tmp"].name, task)
    run_cli_groups(card)
    run_sweep_procs_phase(dev, card, zoo_procs["tmp"].name, task,
                          zoo_procs["launch"], grid17,
                          beside="the CLI groups of phases 9-12")
    paths["federation"], prepared = run_federation_phase(
        dev, card, zoo_procs, beside=lambda: zoo_procs_prepare(
            dev, zoo_procs["tmp"].name))
    paths.update(run_zoo_procs_phase(dev, card, zoo_procs, prepared))
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
            **{k: v for k, v in r.items() if k.endswith("_zoo")},
            **({"ms_compress_n130": r["ms_compress"],
                "cold_ms_compress_n130": r["cold_ms_compress"]}
               if "ms_compress" in r else {}),
            **({"cumsum_only_ms": r["cumsum_only_ms"],
                "ms_greedy_b1_u10": r["ms_greedy"],
                **{k: v for k, v in r.items() if k.startswith(
                    ("ms_serve_", "plain_ms_serve_", "bound_ms_serve_"))}}
               if name == "prefix_eval" else {})})
    log(f"the whole script: {time.perf_counter() - t_script:.1f} s of the "
        "1,200 it may take")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
