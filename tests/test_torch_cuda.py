"""The port's CUDA kernels against their plain PyTorch versions, on the
card. This file imports neither JAX nor ``repro`` and needs no conftest,
so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips (a CUDA kernel has no CPU mode).
The timings are ``chip_smoke.py``'s; these use the full-width shapes of
the compression (n = 130) and the decode (n = 13) and ragged ones around
each kernel body's tiles.

Tolerances: topk_select exact, on adversarial rows too (ties, zeros and
-0.0, +inf, subnormals; k = 0, 1, kappa, D, D + 3); signs may differ only where
|x·Φ_s| ≤ 2·D·2⁻²⁴·‖x‖·‖Φ_s‖ (two f32 sums of D products in different
orders, see tests/test_torch_kernels.py); float outputs rtol = atol = 1e-5.
Exact, kernel against kernel: the packed residual planes (K5) against K3's
sign residual, K6 on the planes against K4 on 2·(plus − minus), and the
packed BIHT decode against the f32 one (one accumulation order each).
prefix_eval (K7) is exact against its plain version where every prefix
sum is a whole number exact in f32 (K_i = 3000), and within rtol 1e-6 on
real K_i (the sums run in another order).

The round replayed from a CUDA graph (``engine/graph.py``) equals the
eager round bit for bit: the same kernels on the same inputs, the same
Philox draws. Under ``admm_batched`` the captured round is a program of
graphs cut at ADMM's loop and polish tests (``control.py``), and it too
equals the eager round (the reference's while loop) bit for bit, as the
captured solve equals the eager solve and the compacted fleet solver the
in-round one, lane by lane (multipliers compared by bit pattern).

At the zoo's geometry (D_c = 16,384, S_c = 32) K1-K4 hold the same
bounds, and a zoo round with the kernels holds the plain round (its
bisection run for K1's 32 steps): magnitude sums exact, MAC lane sums
equal but on borderline lanes, the parameters' movement chunk by chunk.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.decode import DecodeConfig, decode
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.backproject import packed_residual
from repro_torch.kernels.cs_project import project
from repro_torch.kernels.sign import pack_signs, unpack_signs
from repro_torch.sched import BatchedProblem, SchedConfig
from repro_torch.sched import greedy_solve_batched, pack_coefs
from repro_torch.theory import AnalysisConstants

SHAPES = [(13, 256, 1024, 32), (7, 96, 1000, 9), (130, 128, 512, 16),
          (40, 64, 4096, 80),
          # cs_project's register-blocked body (n > 16): the compression
          # shape, and row counts on both sides of its 144-row tile
          (130, 1024, 4096, 80), (17, 96, 1000, 20), (129, 96, 1000, 20),
          (131, 96, 1000, 20), (145, 96, 1000, 20),
          # the streamed bodies of backproject and cs_project (n <= 16):
          # the decode shape, one row, and 16 rows with S shorter than one
          # stage of backproject's ring
          (13, 1024, 4096, 320), (1, 96, 1000, 40), (16, 64, 1000, 40),
          # cs_project's streamed body: S of one and of 32 tiles at 1, 13
          # and 16 rows, D = 1000 not a multiple of its 128-deep stage
          (16, 1024, 1000, 40), (1, 1024, 4096, 40), (13, 96, 1000, 40)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (CUDA kernels have no "
                    "CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, s, d, k, dev):
    gen = torch.Generator(device=dev).manual_seed(n * s + d)
    phi = torch.randn(s, d, generator=gen, device=dev) / s ** 0.5
    x = ref.topk_select_ref(torch.randn(n, d, generator=gen, device=dev),
                            k)[0].contiguous()
    y = torch.where(torch.randn(n, s, generator=gen, device=dev) >= 0,
                    1.0, -1.0)
    return phi, x, y


def _hard_flips(phi, x, got, want):
    d = x.shape[1]
    acc = x.double() @ phi.double().T
    lim = 2 * d * 2.0 ** -24 * (torch.linalg.vector_norm(x.double(), dim=1)
                                [:, None]
                                * torch.linalg.vector_norm(phi.double(),
                                                           dim=1)[None])
    return int(((got != want) & (acc.abs() > lim)).sum())


def _close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def _adversarial_rows(d, k, dev, seed):
    """Gaussian, heavy ties, fewer than k nonzeros, zeros, -0.0, mixed
    signed zeros, a +inf entry, some subnormal entries, all subnormal."""
    gen = torch.Generator(device=dev).manual_seed(seed)
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


def _topk_equal(x, k):
    gv, gm = ops.topk_select(x, k)
    wv, wm = ref.topk_select_ref(x, k)
    return (torch.equal(gm, wm) and torch.equal(gv, wv)
            and torch.equal(gv.view(torch.int32), wv.view(torch.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,d,k", SHAPES)
def test_topk_select_exact(cuda, n, s, d, k):
    x = torch.randn(n, d, device=cuda)
    x[0, k // 2:] = 0.0          # fewer than k nonzeros: the lo fallback
    gv, gm = ops.topk_select(x, k)
    wv, wm = ref.topk_select_ref(x, k)
    assert torch.equal(gm, wm) and torch.equal(gv, wv)
    assert int(gm[0].sum()) == d
    adv = _adversarial_rows(d, k, cuda, n + d)
    for kk in (0, 1, k, d, d + 3):
        assert _topk_equal(adv, kk), kk


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(13, 1000, 320), (3, 16384, 1000),
                                   (2, 16384, 16384), (0, 4096, 80),
                                   (10, 1738, 80), (1, 1, 0), (4, 3, 1)])
def test_topk_select_row_lengths(cuda, n, d, k):
    """Ragged D, the largest D, no rows, and rows that do not start on a
    16-byte boundary (the scalar body), adversarial rows included."""
    x = torch.randn(n, d, device=cuda) * 1e-2
    assert _topk_equal(x, k)
    if n:
        adv = _adversarial_rows(d, min(k, d), cuda, d)
        for kk in (0, 1, k, d, d + 3):
            assert _topk_equal(adv, kk), kk
        off = torch.empty(n * d + 1, device=cuda)[1:].view(n, d)
        assert _topk_equal(off.copy_(x), k)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(13, 320), (130, 80)])
def test_topk_select_graph_replay_bitwise(cuda, n, k):
    """K1 at the decode and compression shapes: repeat launches, CUDA
    graph replays and a later eager launch give the same bits."""
    x = torch.randn(n, 4096, device=cuda) * 1e-2

    def run():
        v, m = ops.topk_select(x, k)
        return torch.cat([v.view(torch.int32).view(-1),
                          m.to(torch.int32).view(-1)])

    want = run()
    assert torch.equal(run(), want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = run()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(run(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,d,k", SHAPES)
def test_cs_project_epilogues(cuda, n, s, d, k):
    phi, x, y = _inputs(n, s, d, k, cuda)
    _close(ops.cs_project(phi, x), ref.cs_project_ref(phi, x))
    sg = ops.cs_project_sign(phi, x)
    assert _hard_flips(phi, x, sg, ref.cs_project_sign_ref(phi, x)) == 0
    assert torch.equal(unpack_signs(ops.cs_project_pack(phi, x)), sg)
    _close(project(phi, x, mode="residual", y=y),
           ref.cs_project_ref(phi, x, mode="residual", y=y))
    got = project(phi, x, mode="sign_residual", y=y)
    want = ref.cs_project_ref(phi, x, mode="sign_residual", y=y)
    assert _hard_flips(phi, x, y - got, y - want) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,d,k", SHAPES)
def test_backproject(cuda, n, s, d, k):
    phi, x, y = _inputs(n, s, d, k, cuda)
    r = ref.cs_project_ref(phi, x, mode="sign_residual", y=y)
    for tau in (1.0 / s, 1.0):
        _close(ops.backproject(x, r, phi, tau),
               ref.backproject_ref(x, r, phi, tau))


@pytest.mark.cuda
def test_kernels_count_and_refuse(cuda):
    """A CUDA tensor reaches the kernel (the counters move) or the wrapper
    raises; it never falls back to the plain version."""
    phi, x, y = _inputs(13, 256, 1024, 32, cuda)
    build.reset_launch_counts()
    ops.biht(ops.cs_project_sign(phi, x), phi, 32, 3, 1.0)
    assert build.launch_counts() == {"topk_select": 4, "cs_project": 1,
                                     "cs_project_resid": 3,
                                     "backproject": 4,
                                     "cs_project_pack_resid": 0,
                                     "backproject_packed": 0,
                                     "prefix_eval": 0}
    for bad in (x.double(), x.T.contiguous().T, x[:, :512]):
        with pytest.raises(ValueError, match="CUDA kernel takes"):
            ops.cs_project_sign(phi, bad)
    with pytest.raises(ValueError, match="CUDA kernel takes"):
        ops.backproject(x, y, phi.double(), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,d,k", SHAPES)
def test_pack_sign_residual(cuda, n, s, d, k):
    phi, x, y = _inputs(n, s, d, k, cuda)
    plus, minus = ops.cs_pack_sign_residual(phi, x, pack_signs(y))
    got = packed_residual(plus, minus)
    # exact against K3 on the card: the same accumulation gives the signs
    assert torch.equal(got, project(phi, x, mode="sign_residual", y=y))
    wp, wm = ref.cs_pack_sign_residual_ref(phi, x, pack_signs(y))
    assert _hard_flips(phi, x, y - got, y - packed_residual(wp, wm)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,d,k", SHAPES)
def test_backproject_packed(cuda, n, s, d, k):
    phi, x, y = _inputs(n, s, d, k, cuda)
    plus, minus = ref.cs_pack_sign_residual_ref(phi, x, pack_signs(y))
    r = packed_residual(plus, minus)
    for tau in (1.0 / s, 1.0):
        got = ops.backproject_packed(x, plus, minus, phi, tau)
        _close(got, ref.backproject_packed_ref(x, plus, minus, phi, tau))
        assert torch.equal(got, ops.backproject(x, r, phi, tau))


@pytest.mark.cuda
def test_redesigned_kernels_repeat_bitwise(cuda):
    """Two launches on the same inputs give the same bits: the split sums
    meet in a fixed order, with no float atomics."""
    phi, x, _ = _inputs(130, 1024, 4096, 80, cuda)
    for mode in ("none", "sign"):
        assert torch.equal(project(phi, x, mode=mode),
                           project(phi, x, mode=mode))
    phi, x, y = _inputs(13, 1024, 4096, 320, cuda)
    for mode in ("none", "sign_residual", "residual"):
        assert torch.equal(project(phi, x, mode=mode, y=y),
                           project(phi, x, mode=mode, y=y))
    yp = pack_signs(y)
    for got, want in zip(ops.cs_pack_sign_residual(phi, x, yp),
                         ops.cs_pack_sign_residual(phi, x, yp)):
        assert torch.equal(got, want)
    plus, minus = ref.cs_pack_sign_residual_ref(phi, x, pack_signs(y))
    r = packed_residual(plus, minus)
    assert torch.equal(ops.backproject(x, r, phi, 1.0 / 1024),
                       ops.backproject(x, r, phi, 1.0 / 1024))
    assert torch.equal(ops.backproject_packed(x, plus, minus, phi, 1.0),
                       ops.backproject_packed(x, plus, minus, phi, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sign_residual", "residual",
                                  "pack_sign_residual"])
def test_stream_projection_graph_replay_bitwise(cuda, mode):
    """K3 and K5 at the decode shape replayed from a CUDA graph give the
    eager launch's bits on every replay, and so does an eager launch after
    the replays: each launch of the n <= 16 body leaves its arrival
    tickets at 0."""
    phi, x, y = _inputs(13, 1024, 4096, 320, cuda)
    if mode == "pack_sign_residual":
        y = pack_signs(y)

    def run():
        out = project(phi, x, mode=mode, y=y)
        return torch.cat(out) if isinstance(out, tuple) else out

    want = run()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = run()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(run(), want)


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    out = torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


@pytest.mark.cuda
def test_vec4_bodies_refuse_other_rows(cuda):
    """cs_project (K2/K3/K5) at every n and K4/K6 at n <= 16 take
    D % 4 == 0 and aligned rows; the wrappers raise on anything else
    instead of taking another body."""
    runs = [(20, lambda phi, x, y: ops.cs_project_sign(phi, x)),
            (13, lambda phi, x, y: ops.cs_project_sign(phi, x)),
            (13, lambda phi, x, y: project(phi, x, mode="sign_residual",
                                           y=y)),
            (1, lambda phi, x, y: ops.cs_pack_sign_residual(
                phi, x, pack_signs(y))),
            (13, lambda phi, x, y: ops.backproject(x, y, phi, 1.0)),
            (13, lambda phi, x, y: ops.backproject_packed(
                x, pack_signs(y), pack_signs(-y), phi, 1.0))]
    for n, run in runs:
        phi, x, y = _inputs(n, 96, 1002, 20, cuda)
        with pytest.raises(ValueError, match="D % 4 == 0"):
            run(phi, x, y)
        phi, x, y = _inputs(n, 96, 1000, 20, cuda)
        with pytest.raises(ValueError, match="aligned"):
            run(phi, _misaligned(x), y)


def _sorted_prefix_inputs(b, u, dev, whole_k=True):
    gen = torch.Generator(device=dev).manual_seed(b * u)
    h = torch.randn(b, u, generator=gen, device=dev).abs() + 1e-3
    k = (torch.full((b, u), 3000.0, device=dev) if whole_k else
         1000.0 + 4000.0 * torch.rand(b, u, generator=gen, device=dev))
    bp = BatchedProblem.from_arrays(h, k, 10.0, 1e-4, D=50890, S=1000,
                                    kappa=1000,
                                    const=AnalysisConstants(rho1=200.0,
                                                            G=1.0))
    caps = bp.caps()
    order = torch.sort(-caps, dim=-1, stable=True).indices
    return (torch.gather(caps, -1, order),
            torch.gather(bp.k_weights, -1, order), pack_coefs(bp)), bp


@pytest.mark.cuda
@pytest.mark.parametrize("b,u", [(1, 10), (5, 1000), (3, 2049), (64, 8192),
                                 (2, 8193), (64, 100), (1, 3), (300, 3000)])
def test_prefix_eval(cuda, b, u):
    (caps_s, k_s, coefs), bp = _sorted_prefix_inputs(b, u, cuda)
    assert torch.equal(ops.prefix_eval(caps_s, k_s, coefs),
                       ref.prefix_eval_ref(caps_s, k_s, coefs))
    beta_k, bt_k, _ = greedy_solve_batched(bp, SchedConfig(use_kernel=True))
    beta_p, bt_p, _ = greedy_solve_batched(bp, SchedConfig(use_kernel=False))
    assert torch.equal(beta_k, beta_p) and torch.equal(bt_k, bt_p)
    (caps_s, k_s, coefs), _ = _sorted_prefix_inputs(b, u, cuda, False)
    np.testing.assert_allclose(
        ops.prefix_eval(caps_s, k_s, coefs).cpu().numpy(),
        ref.prefix_eval_ref(caps_s, k_s, coefs).cpu().numpy(), rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b,u", [(64, 8192), (1, 10)])
def test_prefix_eval_graph_replay_bitwise(cuda, b, u):
    """K7 on real K_i (its sums then depend on their order): repeat
    launches, CUDA graph replays and a later eager launch give the same
    bits, since every block sums its carry and its tiles in a fixed
    order."""
    (caps_s, k_s, coefs), _ = _sorted_prefix_inputs(b, u, cuda, False)
    want = ops.prefix_eval(caps_s, k_s, coefs)
    assert torch.equal(ops.prefix_eval(caps_s, k_s, coefs), want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ops.prefix_eval(caps_s, k_s, coefs)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(ops.prefix_eval(caps_s, k_s, coefs), want)


@pytest.mark.cuda
def test_packed_decode_equals_f32_decode(cuda):
    n, s, d, k = 13, 256, 1024, 32
    phi, x, _ = _inputs(n, s, d, k, cuda)
    y_packed = ops.cs_project_pack(phi, x)
    build.reset_launch_counts()
    got = decode(y_packed, phi, k, DecodeConfig(iters=5, packed=True,
                                                use_kernels=True))
    assert build.launch_counts() == {
        "topk_select": 6, "cs_project": 0, "cs_project_resid": 0,
        "backproject": 1, "cs_project_pack_resid": 5,
        "backproject_packed": 5, "prefix_eval": 0}
    want = decode(unpack_signs(y_packed), phi, k,
                  DecodeConfig(iters=5, use_kernels=True))
    assert torch.equal(got, want)


# --- the round as a CUDA graph ------------------------------------------------

def _sweep_task(dev, hidden=16, u=4, samples=200):
    from repro_torch.data.mnist import partition_workers
    from repro_torch.data.synthetic import synthetic_mnist
    from repro_torch.models import mlp_mnist as mm
    xtr, ytr, _, _ = synthetic_mnist(n_train=2000, n_test=10, seed=0)
    wx, wy = partition_workers(xtr, ytr, u, samples, seed=0)
    return dict(loss_fn=lambda p, d: mm.mlp_mnist_loss(p, d["x"], d["y"]),
                params=mm.init_mlp_mnist(seed=0, d_hidden=hidden, device=dev),
                data={"x": torch.from_numpy(wx), "y": torch.from_numpy(wy)},
                k_weights=np.full(u, float(samples)))


def _sweep_cfg(mode, scheduler="all", packed=False, **kw):
    from repro_torch.core.obcsaa import OBCSAAConfig
    from repro_torch.engine import FLConfig
    sched = ({"sched_cfg": SchedConfig(use_kernel=True)}
             if scheduler == "greedy_batched" else {})
    return FLConfig(mode=mode, scheduler=scheduler, rounds=5, eval_every=2,
                    probe_agg_error=True, const=AnalysisConstants(
                        rho1=200.0, G=1.0),
                    obcsaa=OBCSAAConfig(chunk=1024, measure=256, topk=32,
                                        biht_iters=5, use_kernels=True,
                                        packed=packed), **sched, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("scheduler,packed", [("all", False),
                                              ("greedy_batched", True)])
def test_graph_round_equals_eager_bitwise(cuda, scheduler, packed):
    """5 rounds of 2 arms replayed from their CUDA graphs against the eager
    loop: parameters, fade state, every stat, bit for bit; and each replay
    counts the launches its capture recorded, as many as an eager round
    makes."""
    from repro_torch.engine import EngineRun, make_arms
    t = _sweep_task(cuda)
    outs, counts, runs = {}, {}, {}
    for mode in ("scan", "host"):
        cfg = _sweep_cfg(mode, scheduler, packed)
        runs[mode] = EngineRun(cfg, t["loss_fn"], t["params"], t["data"],
                               t["k_weights"], device=cuda)
        build.reset_launch_counts()
        outs[mode] = runs[mode].run_sweep(
            make_arms(cfg, seeds=[0, 1], noise_var=[1e-4, 1e-2]))
        torch.cuda.synchronize()
        counts[mode] = build.launch_counts()
    s, h = outs["scan"], outs["host"]
    for key in ("n_scheduled", "b_t", "rt_bound", "agg_err"):
        np.testing.assert_array_equal(s[key], h[key])
    for a, b in zip(s["budget"], h["budget"]):
        np.testing.assert_array_equal(a, b)
    for k in s["params"]:
        assert torch.equal(s["params"][k], h["params"][k])
    for a in range(2):
        assert torch.equal(s["state"][a].fade, h["state"][a].fade)
    log = runs["scan"].capture_log
    assert len(log) == 2
    per_round = log[0]["captured"]
    assert per_round["topk_select"] == 7 and per_round["backproject"] == 6
    assert per_round["prefix_eval"] == (scheduler == "greedy_batched")
    for entry in log:
        assert entry["captured"] == per_round
        assert entry["warmup_launches"] == {
            k: 2 * v for k, v in per_round.items()}
    assert counts["host"] == {k: 2 * 5 * v for k, v in per_round.items()}
    assert counts["scan"] == {k: 2 * (2 + 5) * v
                              for k, v in per_round.items()}


@pytest.mark.cuda
def test_graph_capture_restores_generator_and_carry(cuda):
    """Warm-up and capture consume no draw and move no parameter: the
    generator state after the capture is the one before the warm-up."""
    from repro_torch.engine import EngineRun, RoundGraph
    t = _sweep_task(cuda)
    run = EngineRun(_sweep_cfg("scan"), t["loss_fn"], t["params"],
                    t["data"], t["k_weights"], device=cuda)
    state, arm = run.init()
    before = state.generator.get_state()
    graph = RoundGraph(run.fns.full_round, state, arm, run.worker_data,
                       run.k_weights)
    assert torch.equal(state.generator.get_state(), before)
    for k, v in state.params.items():
        assert torch.equal(graph.state().params[k], v)
    assert torch.equal(graph.state().fade, state.fade)
    graph.run(1)
    assert not torch.equal(state.generator.get_state(), before)


@pytest.mark.cuda
def test_graph_capture_failure_raises(cuda):
    """A round that reads a value back to the host cannot be captured: the
    scan run raises, and nothing runs the round eagerly in its place."""
    from repro_torch.fl import FederatedTrainer
    t = _sweep_task(cuda)

    def syncing_loss(p, d):
        loss = t["loss_fn"](p, d)
        if float(loss.sum()) < 0:       # a host read inside the round
            raise AssertionError
        return loss

    tr = FederatedTrainer(_sweep_cfg("scan"), syncing_loss, t["params"],
                          t["data"], t["k_weights"], device=cuda)
    params0 = {k: v.clone() for k, v in tr.params.items()}
    with pytest.raises(RuntimeError):
        tr.run(3)
    assert tr.sched_logs == []
    for k, v in params0.items():
        assert torch.equal(tr.params[k], v)


# --- Algorithm 2 on the card ----------------------------------------------------

def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm_duals"])
def test_admm_graph_round_equals_eager_bitwise(cuda, warm):
    """22 ``admm_batched`` rounds of 2 arms at U = 10 replayed from their
    captured programs against the eager loop, whose ADMM runs the
    reference's while loop with a host read per chunk: parameters, fade,
    multipliers and every stat bit for bit; the replays launch K1-K4 as
    an eager round does; the program is cut at the loop and the polish."""
    from repro_torch.engine import EngineRun, make_arms
    t = _sweep_task(cuda, u=10)
    outs, counts, runs = {}, {}, {}
    for mode in ("scan", "host"):
        cfg = _sweep_cfg(mode, "admm_batched", sched_warm_duals=warm)
        runs[mode] = EngineRun(cfg, t["loss_fn"], t["params"], t["data"],
                               t["k_weights"], device=cuda)
        build.reset_launch_counts()
        outs[mode] = runs[mode].run_sweep(
            make_arms(cfg, seeds=[0, 1], noise_var=[1e-4, 1e-2]),
            rounds=22, eval_every=0)
        torch.cuda.synchronize()
        counts[mode] = build.launch_counts()
    s, h = outs["scan"], outs["host"]
    for key in ("n_scheduled", "b_t", "rt_bound", "agg_err"):
        np.testing.assert_array_equal(s[key], h[key])
    for a, b in zip(s["budget"], h["budget"]):
        np.testing.assert_array_equal(a, b)
    for k in s["params"]:
        assert torch.equal(s["params"][k], h["params"][k])
    for a in range(2):
        assert torch.equal(s["state"][a].fade, h["state"][a].fade)
        if warm:
            for x, y in zip(s["state"][a].sched_duals,
                            h["state"][a].sched_duals):
                assert torch.equal(_bits(x), _bits(y))
        else:
            assert s["state"][a].sched_duals is None
    log = runs["scan"].capture_log
    per_round = log[0]["captured"]
    assert per_round["topk_select"] == 7 and per_round["backproject"] == 6
    assert per_round["cs_project"] == 1 and per_round["prefix_eval"] == 0
    for entry in log:
        assert entry["graphs"] == 5 and len(entry["trips"]) == 22
        assert entry["captured"] == per_round
    assert counts["host"] == {k: 2 * 22 * v for k, v in per_round.items()}
    assert counts["scan"] == {k: 2 * (2 + 22) * v
                              for k, v in per_round.items()}


def _three_chunk_problems(dev):
    """U = 10, K_i = 3000, ρ1 = 200, G = 1 instances whose ADMM needs 18
    to 21 outer iterations (3 chunks of 8) on an H100: numpy default_rng
    seeds 36, 130, 154 and 1551, h = |N(0, 1)| + 1e-3, picked by solving
    seeds 0-2999 on the card in one batch (the CPU's f32 arithmetic
    differs in its last bits and picks others); the test checks that they
    still need more than 16."""
    from repro_torch.sched import BatchedProblem
    h = np.concatenate([np.abs(np.random.default_rng(s).normal(size=(1, 10)))
                        + 1e-3 for s in (36, 130, 154, 1551)])
    return BatchedProblem.from_arrays(
        h, 3000.0, 10.0, 1e-4, D=50890, S=1000, kappa=1000,
        const=AnalysisConstants(rho1=200.0, G=1.0), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [4, 1])
def test_admm_captured_solve_runs_extra_chunks(cuda, lanes):
    """A solve whose lanes need 3 chunks, captured as a program and
    replayed, against the eager while loop: β, b_t, R_t, the iteration
    counts and the multipliers bit for bit, with the loop body replayed
    twice or more."""
    from repro_torch import control
    from repro_torch.sched import admm_solve_batched_jit, take
    bp = _three_chunk_problems(cuda)
    if lanes == 1:
        bp = take(bp, [2])          # seed 154: 20 iterations
    eager = admm_solve_batched_jit(bp, return_duals=True)
    assert int(eager[3].iters.max()) > 16
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    torch.cuda.synchronize()
    with control.SegmentedCapture(stream) as cap:
        out = admm_solve_batched_jit(bp, return_duals=True)
    assert [k for k, _, _ in cap.program] == ["run", "while", "run", "if",
                                              "run"]
    for _ in range(2):          # a replay rewrites the same buffers
        trips = control.replay(cap.program)
        torch.cuda.synchronize()
        assert trips[0] >= 2
        for a, b in ((out[0], eager[0]), (out[1], eager[1]),
                     (out[2], eager[2]), (out[3].iters, eager[3].iters),
                     *zip(out[3].duals, eager[3].duals)):
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_admm_compacted_equals_jit_fleet(cuda):
    """benchmarks/sched_bench.py's ADMM shape, B = 1024 and U = 64: the
    compacted fleet form against the in-round form, lane by lane, bit for
    bit (buckets of 8 to 1024 rows against the whole batch)."""
    from repro_torch.sched import (BatchedProblem, admm_solve_batched,
                                   admm_solve_batched_jit)
    rng = np.random.default_rng(0)
    bp = BatchedProblem.from_arrays(
        np.abs(rng.normal(size=(1024, 64))) + 1e-3, 3000.0, 10.0, 1e-4,
        D=50890, S=1000, kappa=1000,
        const=AnalysisConstants(rho1=200.0, G=1.0), device=cuda)
    a = admm_solve_batched(bp, return_duals=True)
    b = admm_solve_batched_jit(bp, return_duals=True)
    for x, y in ((a[0], b[0]), (a[1], b[1]), (a[2], b[2]),
                 (a[3].iters, b[3].iters), *zip(a[3].duals, b[3].duals)):
        assert torch.equal(_bits(x), _bits(y))
    assert int(b[3].iters.max()) > 8 and bool((a[1] > 0).all())


# --- error feedback, warm start, optimizer state, resume, the service ---------

def _carry_equal(a, b):
    from repro_torch import tree
    from repro_torch.engine.state import with_generator_state
    x, y = (tree.leaves(with_generator_state(s)) for s in (a, b))
    return len(x) == len(y) and all(torch.equal(p.cpu(), q.cpu())
                                    for p, q in zip(x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("scheduler,opt", [
    ("all", None), ("greedy_batched", "momentum"),
    ("greedy_batched", "adam"), ("admm_batched", "adam")])
def test_graph_round_ef_warm_optimizer_equals_eager(cuda, scheduler, opt):
    """Error feedback, warm-start IHT (τ = 0.25) and a stateful optimizer,
    8 rounds of 2 arms replayed from their graphs against the eager loop:
    every leaf of every arm's carry bit for bit — moments and Adam's step
    counter (incremented on the card by the graph), the EF residuals, the
    decoder's warm start, and the generator's state (a generator
    registered with the graphs reports the replays' Philox offset) — and
    every stat. The EF round compresses the split's top-κ as it is: K1
    runs only in the decode, once per IHT iteration."""
    from repro_torch import tree
    from repro_torch.engine import EngineRun, make_arms
    from repro_torch.optim import make
    t = _sweep_task(cuda)
    outs, runs = {}, {}
    for mode in ("scan", "host"):
        cfg = _sweep_cfg(mode, scheduler, error_feedback=True)
        cfg = dataclasses.replace(cfg, obcsaa=dataclasses.replace(
            cfg.obcsaa, recon_alg="iht", recon_tau=0.25, warm_start=True))
        runs[mode] = EngineRun(cfg, t["loss_fn"], t["params"], t["data"],
                               t["k_weights"], device=cuda,
                               optimizer=make(opt) if opt else None)
        outs[mode] = runs[mode].run_sweep(make_arms(cfg, seeds=[0, 1]),
                                          rounds=8, eval_every=3)
    s, h = outs["scan"], outs["host"]
    for key in ("n_scheduled", "b_t", "rt_bound", "agg_err"):
        np.testing.assert_array_equal(s[key], h[key])
    for a in range(2):
        assert _carry_equal(s["state"][a], h["state"][a])
    st = s["state"][0]
    assert float(st.residual.abs().sum()) > 0
    assert float(st.decode_x0.abs().sum()) > 0
    if opt:
        assert any(float(x.abs().sum()) > 0
                   for x in tree.leaves(st.opt_state))
    if opt == "adam":
        assert int(st.opt_state["t"]) == 8
    per_round = runs["scan"].capture_log[0]["captured"]
    assert per_round["topk_select"] == 5 and per_round["cs_project"] == 1
    assert per_round["cs_project_resid"] == 5
    assert per_round["backproject"] == 5
    assert per_round["prefix_eval"] == (scheduler == "greedy_batched")


@pytest.mark.cuda
def test_resume_in_scan_mode_equals_uninterrupted(cuda, tmp_path):
    """A scan-mode sweep with checkpoints, cut after its middle boundary
    and resumed in a fresh run (generators set back before their graphs
    are captured): the final carry and the stat tail equal the
    uninterrupted run's bit for bit."""
    import shutil
    from repro_torch import checkpoint
    from repro_torch.engine import EngineRun, make_arms
    from repro_torch.optim import make
    t = _sweep_task(cuda)
    cfg = _sweep_cfg("scan", "greedy_batched", error_feedback=True)
    arms = make_arms(cfg, seeds=[0, 1])

    def run():
        return EngineRun(cfg, t["loss_fn"], t["params"], t["data"],
                         t["k_weights"], device=cuda, optimizer=make("adam"))

    d = str(tmp_path / "ck")
    full = run().run_sweep(arms, rounds=8, eval_every=3, ckpt_dir=d)
    assert checkpoint.latest_step(d) == 8
    for n in (7, 8):
        shutil.rmtree(checkpoint.step_dir(d, n))
    res = run().run_sweep(arms, rounds=8, eval_every=3, ckpt_dir=d,
                          resume=True)
    assert res["t_start"] == 4
    for a in range(2):
        assert _carry_equal(res["state"][a], full["state"][a])
    for key in ("n_scheduled", "b_t", "rt_bound"):
        np.testing.assert_array_equal(res[key], full[key][:, 4:])


@pytest.mark.cuda
@pytest.mark.parametrize("scheduler", ["admm_batched", "greedy_batched"])
def test_serve_cache_parity_on_card(cuda, scheduler):
    """benchmarks/serve_bench.py's cache-parity gate on the card (greedy
    through K7): at threshold 0 the cache equals ``fresh_solve`` bit for
    bit; every greedy tick that solved launched K7 once."""
    from repro_torch.sched import ScenarioConfig
    from repro_torch.serve import (ServeConfig, fresh_solve, init_service,
                                   run_ticks)
    cfg = ServeConfig(scenario=ScenarioConfig(cells=384, workers=16,
                                              corr=0.999),
                      scheduler=scheduler, stale_threshold=0.0,
                      update_frac=0.35)
    build.reset_launch_counts()
    st, stats, _ = run_ticks(cfg, init_service(cfg, 1, device=cuda), 6)
    beta, b_t, rt = fresh_solve(cfg, st)
    assert torch.equal(beta, st.beta) and torch.equal(b_t, st.b_t)
    assert torch.equal(rt, st.rt)
    assert any(s.hit_rate > 0 for s in stats[1:])
    solved = sum(1 for s in stats if s.n_dirty)
    assert build.launch_counts()["prefix_eval"] == (
        solved + 1 if scheduler == "greedy_batched" else 0)


@pytest.mark.cuda
def test_prefix_eval_at_service_bucket(cuda):
    """K7 at the 100k-cell service's buckets, U = 16, K_i = 3000: the cold
    first tick's B = 131,072 (past grid y's 65,535 limit; B runs on grid
    x) and the steady ticks' B = 65,536. R equals the plain version
    exactly."""
    from repro_torch.sched import ScenarioConfig, init_fades, magnitudes
    from repro_torch.sched.problem import BatchedProblem
    gen = torch.Generator(device=cuda).manual_seed(5)
    for cells in (131072, 65536):
        h = magnitudes(init_fades(ScenarioConfig(cells=cells, workers=16),
                                  gen))
        bp = BatchedProblem.from_arrays(
            h, 3000.0, 10.0, 1e-4, D=50890, S=1000, kappa=1000,
            const=AnalysisConstants(rho1=200.0, G=1.0))
        caps = bp.caps()
        order = torch.sort(-caps, dim=-1, stable=True).indices
        caps_s = torch.gather(caps, -1, order)
        k_s = torch.gather(bp.k_weights, -1, order)
        coefs = pack_coefs(bp)
        got = ops.prefix_eval(caps_s, k_s, coefs)
        assert torch.equal(got, ref.prefix_eval_ref(caps_s, k_s, coefs))
        beta, b_t, r = greedy_solve_batched(bp, SchedConfig(use_kernel=True))
        want = greedy_solve_batched(bp, SchedConfig(use_kernel=False))
        for x, y in zip((beta, b_t, r), want):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_serve_cli_on_card_launches_prefix_eval(cuda, capsys):
    """``python -m repro_torch.serve --scheduler greedy_batched`` on the
    card (its default device) sweeps every tick's bucket through K7: at
    threshold 0 every cell moves, so each of the 3 ticks launches it
    once."""
    from repro_torch.serve.cli import main as cli_main
    build.reset_launch_counts()
    assert cli_main(["--cells", "4096", "--scheduler", "greedy_batched",
                     "--ticks", "3", "--threshold", "0.0"]) == 0
    assert build.launch_counts()["prefix_eval"] == 3
    assert "device=cuda" in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v2-lite-16b"])
def test_lm_decode_matches_forward_on_card(cuda, arch):
    """The LM decode path on the card at smoke size, f32: a seeded
    prefill of 64 tokens, then 16 decode steps fed the forward's own
    tokens (80 > gemma2's smoke window of 64, so the local mask bites),
    against the full forward at the reference test's gate (argmax equal,
    rtol = atol = 2e-2); none of K1-K7 is launched."""
    from repro_torch.configs import get_smoke_config, scaled
    from repro_torch.launch.steps import make_seeded_prefill
    from repro_torch.models.registry import build_model
    cfg = scaled(get_smoke_config(arch), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    model = build_model(cfg)
    build.reset_launch_counts()
    params = model.init(0, device=cuda)
    P, G = 64, 16
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, P + G), generator=gen,
                           dtype=torch.int32).to(cuda)
    with torch.no_grad():
        full = model.forward(params, {"tokens": tokens}, remat=False)
    _, cache, offset = make_seeded_prefill(model, P + G)(
        params, {"tokens": tokens[:, :P]})
    assert offset == P
    outs = []
    for pos in range(P, P + G):
        logits, cache = model.decode_step(params, cache,
                                          tokens[:, pos:pos + 1], pos)
        outs.append(logits[:, 0])
    dec, want = torch.stack(outs, dim=1), full[:, P:]
    assert torch.equal(dec.argmax(-1), want.argmax(-1))
    torch.testing.assert_close(dec, want, rtol=2e-2, atol=2e-2)
    assert not any(build.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 19])
def test_kernels_at_zoo_geometry(cuda, n):
    """K1-K4 at the zoo's chunk geometry (``benchmarks/zoo_bench.py``'s
    FULL_OB: D_c = 16,384 = K1's MAX_D, S_c = 32, narrower than K2's tile;
    κ = 8, decode k = 16), a full block of rows and a ragged one: K1
    exact, K2's packed signs only on borderline lanes, K3 and K4 to
    rtol = atol = 1e-5."""
    from repro_torch.kernels.cs_project import project_plain
    from repro_torch.kernels.sign import unpack_bits
    from repro_torch.kernels.topk_select import topk_select_plain
    d, s = 16384, 32
    gen = torch.Generator(device=cuda).manual_seed(n)
    phi = torch.randn(s, d, generator=gen, device=cuda) / s ** 0.5
    g = torch.randn(n, d, generator=gen, device=cuda) * 0.025
    for k in (8, 16):
        gv, gm = ops.topk_select(g, k)
        wv, wm = topk_select_plain(g, k)
        assert torch.equal(gm, wm) and torch.equal(gv, wv)
    sparse = ops.topk_select(g, 8)[0]
    got = unpack_bits(ops.cs_project_pack(phi, sparse), torch.float32)
    want = unpack_bits(project_plain(phi, sparse, mode="pack"),
                       torch.float32)
    assert _hard_flips(phi, sparse, got, want) == 0
    x = ops.topk_select(g, 16)[0]
    y = torch.randn(n, s, generator=gen, device=cuda)
    _close(project(phi, x, mode="residual", y=y),
           project_plain(phi, x, mode="residual", y=y))
    _close(ops.backproject(x, y, phi, 0.5),
           x + 0.5 * (y @ phi))


@pytest.mark.cuda
def test_zoo_round_kernels_against_plain(cuda):
    """One surrogate zoo round at D = 16,000 on the logical 4 x 2 mesh
    (``tests/test_zoo.py``'s ZOO_OB), K1-K4 and K7 on, against the plain
    path from the same parameters and draws (its bisection run for K1's
    32 steps, so both select the same top-κ): magnitude sums exact, MAC
    lane sums equal but where a worker's sign is borderline, the
    parameters' movement within 1e-4 of itself but for at most one of
    the 64 chunks."""
    from repro_torch.core.obcsaa import OBCSAAConfig
    from repro_torch.engine.zoo import build_zoo_round
    from repro_torch.kernels.topk_select import N_BISECT
    from repro_torch.launch.mesh import make_zoo_mesh
    ob = dict(chunk=256, measure=64, topk=16, biht_iters=3,
              recon_alg="iht", spmd_topk=True, packed=True)
    mesh = make_zoo_mesh(4, 2)
    kw = dict(scheduler="greedy_batched", device=cuda)
    zk = build_zoo_round(OBCSAAConfig(**ob, use_kernels=True), 16000, mesh,
                         sched_cfg=SchedConfig(use_kernel=True), **kw)
    zp = build_zoo_round(OBCSAAConfig(**ob, bisect_iters=N_BISECT), 16000,
                         mesh, sched_cfg=SchedConfig(), **kw)
    gen = torch.Generator(device=cuda).manual_seed(1)
    p0 = zk.chunk_params(torch.randn(16000, generator=gen, device=cuda))
    dr = zk.draws(7)(0)
    macs, outs = [], []
    for zr in (zk, zp):
        p = p0.clone()

        def hook(stage, **info):
            if stage == "mac":
                macs.append((info["y_sum"].clone(), info["mag_sum"].clone()))

        build.reset_launch_counts()
        zr.round_gen(p, 0, 7, 1e-4, 10.0, 0.1, draws=dr, hook=hook)
        counts = build.launch_counts()
        outs.append(p - p0)
        if zr is zk:
            assert all(counts[k] for k in ("topk_select", "cs_project",
                                           "cs_project_resid",
                                           "backproject", "prefix_eval"))
        else:
            assert not any(counts.values())
    (yk, mk), (yp, mp) = macs
    assert torch.equal(mk, mp)
    diff = yk != yp
    if bool(diff.any()):
        border = torch.zeros_like(diff)
        for u in range(4):
            g = zk._surrogate_grads(p0, 0, u, 0)
            border |= _hard_flips_mask(zk.phi, ops.topk_select(g, 16)[0])
        assert not bool((diff & ~border).any())
    dk, dp = outs
    err = torch.linalg.vector_norm(dk - dp, dim=1)
    parted = err > 1e-4 * torch.linalg.vector_norm(dp, dim=1)
    assert int(parted.sum()) <= 1
    assert float(torch.linalg.vector_norm(err[~parted])) <= \
        1e-4 * float(torch.linalg.vector_norm(dp))


def _hard_flips_mask(phi, x):
    """(n, S) bool: lanes whose projection is within the f32 reorder
    bound."""
    d = x.shape[1]
    acc = x.double() @ phi.double().T
    lim = 2 * d * 2.0 ** -24 * (torch.linalg.vector_norm(x.double(), dim=1)
                                [:, None]
                                * torch.linalg.vector_norm(phi.double(),
                                                           dim=1)[None])
    return acc.abs() <= lim


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [32, 64])
def test_moe_mean_step_over_ranks_remat_full(cuda, seq, tmp_path):
    """mixtral's smoke model in f32 under the ``mean`` step with remat
    "full", W = 2 workers of ``seq`` tokens each (T/W = 64: a dispatch a
    worker; 32: every token in one dispatch, gathered over the ranks): 2
    gloo ranks sharing the card against the 2 workers in turn in this
    process. On the card the backward pass, and in it each checkpointed
    layer's recompute, runs on the autograd engine's device thread; the
    recompute must dispatch as the forward did. Losses rtol 1e-5; each
    parameter leaf within 1e-4 of its movement (the gradients' sums run
    in other orders)."""
    from _torch_dist_child import run_world
    from repro_torch import configs, tree
    from repro_torch.data import token_stream
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_zoo_mesh
    from repro_torch.models.registry import build_model

    W = 2
    cs = dict(learning_rate=3e-2)
    cfg = configs.scaled(configs.get_smoke_config("mixtral-8x22b"),
                         dtype="float32")
    model = build_model(cfg)
    p0 = model.init(0, device="cpu")
    tok, tgt = token_stream(W, seq, cfg.vocab_size, seed=0)
    batch = {"tokens": torch.from_numpy(tok),
             "targets": torch.from_numpy(tgt)}
    outs = run_world("train", W, {"cases": {"moe": {
        "arch": "mixtral-8x22b", "agg": "mean", "ctxs": [{}],
        "params": p0, "batch": batch}}, "cs": cs}, tmp_path,
        device="cuda")
    tt = configs.TrainConfig(aggregation="mean", **cs)
    assert tt.remat_mode == "full"
    step = steps.make_train_step(model, tt, make_zoo_mesh(W, 1))
    params = tree.tree_map(lambda x: x.to(cuda), p0)
    params, _, m = step(params, steps.make_optimizer(tt).init(params),
                        tree.tree_map(lambda x: x.to(cuda), batch), {})
    for o in outs:
        assert o["moe"]["losses"][0] == pytest.approx(float(m["loss"]),
                                                      rel=1e-5)
        for got, want, start in zip(o["moe"]["params"], tree.leaves(params),
                                    tree.leaves(p0)):
            want = want.cpu()
            moved = torch.linalg.vector_norm(want - start)
            assert torch.linalg.vector_norm(got - want) <= 1e-4 * moved


@pytest.mark.cuda
def test_sweep_over_ranks_on_card(cuda, tmp_path):
    """tests/test_torch_sweep_procs.py's A = 4 sweep with the kernels, in
    scan mode (each arm's round replayed from a CUDA graph): 2 gloo ranks
    sharing the card, 2 arms a rank, a checkpoint at every boundary,
    against the one-process sweep on the card in this process, bit for
    bit; K1-K4 launch in both ranks."""
    from _torch_dist_child import run_world, sweep_engine, sweep_summary
    spec = dict(task="small", seeds=[0, 1, 2, 3],
                noise_var=[1e-4, 1e-3, 1e-2, 1e-1], kernels=True,
                ckpt=str(tmp_path / "ck"))
    outs = run_world("sweep", 2, {"runs": {"split4": spec}}, tmp_path,
                     device="cuda")
    run, arms = sweep_engine(spec, cuda)
    assert run.mode == "scan"
    want = sweep_summary(run.run_sweep(arms))
    for r, o in enumerate(outs):
        got = o["split4"]
        assert got["own"] == [2 * r, 2 * r + 1]
        for k in ("n_scheduled", "b_t", "rt_bound", "loss"):
            assert torch.equal(got[k], want[k]), k
        for ga, wa in zip(got["state"], want["state"]):
            assert all(torch.equal(x, y) for x, y in zip(ga, wa))
        assert all(got["launches"][k] for k in (
            "topk_select", "cs_project", "cs_project_resid", "backproject"))


@pytest.mark.cuda
def test_sweep_world_of_one_nccl_on_card(cuda, tmp_path):
    """The same sweep in a world of one on the card, which joins over
    NCCL: its arms split over W = 1 worker, each boundary's records
    gathered on the card (NCCL refuses CPU tensors), a checkpoint at
    every boundary; bit for bit the one-process sweep, and its
    checkpoint cut after round 4 resumes in this process bit for bit."""
    import os
    import shutil

    from _torch_dist_child import run_world, sweep_engine, sweep_summary
    ck = str(tmp_path / "ck")
    spec = dict(task="small", seeds=[0, 1, 2, 3],
                noise_var=[1e-4, 1e-3, 1e-2, 1e-1], kernels=True, ckpt=ck)
    (got,) = (o["split4"] for o in run_world(
        "sweep", 1, {"runs": {"split4": spec}}, tmp_path, device="cuda"))
    assert got["backend"] == "nccl"
    assert got["bytes"]["all_gather_arms"] > 0
    # over the group: the gathers, on the card; the save's replica check
    # has no group in a world of one, and its carries stay on the CPU
    over = [(fn, devices, w) for fn, devices, w, none in got["wire"]
            if not none]
    assert {fn for fn, _, _ in over} == {"gather_rows"}
    assert all(devices == [w] == ["cuda:0"] for _, devices, w in over)
    assert all(devices == ["cpu"] for fn, devices, _, none in got["wire"]
               if none)
    run, arms = sweep_engine(spec, cuda)
    want = sweep_summary(run.run_sweep(arms))
    for k in ("n_scheduled", "b_t", "rt_bound", "loss"):
        assert torch.equal(got[k], want[k]), k
    for ga, wa in zip(got["state"], want["state"]):
        assert all(torch.equal(x, y) for x, y in zip(ga, wa))
    for sub in os.listdir(ck):
        if int(sub.split("_")[1]) > 4:
            shutil.rmtree(os.path.join(ck, sub))
    run, arms = sweep_engine(spec, cuda)
    back = sweep_summary(run.run_sweep(arms, ckpt_dir=ck, resume=True))
    assert back["t_start"] == 4
    for k in ("n_scheduled", "b_t", "loss"):
        assert torch.equal(back[k], want[k][:, -back[k].shape[1]:]), k
    for ga, wa in zip(back["state"], want["state"]):
        assert all(torch.equal(x, y) for x, y in zip(ga, wa))
