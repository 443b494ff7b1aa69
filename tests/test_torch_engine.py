"""The port's sweep engine (``repro_torch.engine``: arms, chunks,
``run_sweep``, ``FederatedTrainer`` through ``EngineRun``) against
``repro.engine``, and the port's own scan ≡ host contract, on the CPU.

Tolerances:
- exact: ``chunk_spans``, ``eval_points``, ``budget_geometry``, the
  ``make_arms`` broadcast and its errors, the mode resolution, and the
  arm scalars given as 0-d tensors against the same values as floats.
- ``run_sweep`` in host mode against the reference's vmapped scan, with
  the reference's draws injected per arm (fade0 from
  ``fold_in(key, 0x7FADE)``, per round ``fold_in(fold_in(key, t), 0 | 1)``)
  at small width (MLP 784-4-10, D = 3,190, U = 4, 2 arms, 4 rounds):
  ``n_scheduled`` exact; ``b_t``, every ``budget`` field and ``rt_bound``
  rtol 1e-6 (|g| of the complex fade is computed by two libraries and may
  differ in its last bit, and b_t is the h of a scheduled worker); each
  final parameter within 1e-4 of how far the reference moved it (f32 sums
  in another order move it by ~1e-6 of that); eval losses rtol 1e-4.
- within the port on the CPU: scan mode ≡ host mode bit for bit; the
  ADMM dual warm start (``sched_warm_duals``) leaves every output bit for
  bit as the cold run's, in both modes.
- the host path (``FederatedTrainer`` with a NumPy oracle, ``enum``)
  against the reference's trainer with its draws injected: β exact, each
  parameter within 1e-4 of its movement.
- error feedback and warm-start IHT (τ = 0.25): ``run_sweep`` in host
  mode against the reference's with its draws injected, as above, and
  the EF residuals and the decoder's warm start each within 1e-4 of the
  reference's norm; the fused EF round (the split's top-κ compressed as
  it is) ≡ compressing the corrected gradient again, bit for bit; scan ≡
  host bit for bit with EF + warm start under ``greedy_batched`` and
  ``admm_batched``, and with momentum and Adam (every moment and the
  step counter), as tests/test_engine.py:113-167 hold the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jchan
from repro.core.obcsaa import OBCSAAConfig as JOB
from repro.data import synthetic as jsyn
from repro.data.mnist import partition_workers as jpartition
from repro.engine import FLConfig as JFL
from repro.engine import chunk_spans as jspans
from repro.engine import eval_points as jpoints
from repro.engine import make_arms as jmake_arms
from repro.engine import run_sweep as jrun_sweep
from repro.engine.core import budget_geometry as jgeom
from repro.fl import FederatedTrainer as JTrainer
from repro.models import mlp_mnist as jm
from repro.sched import SchedConfig as JSC
from repro.theory import AnalysisConstants as JAC
from repro_torch import convert
from repro_torch.core import channel as tchan
from repro_torch.core import power_control as tpc
from repro_torch.core.obcsaa import OBCSAAConfig as TOB
from repro_torch.engine import (Draws, EngineRun, budget_geometry,
                                chunk_spans, eval_points, make_arms, n_arms,
                                run_sweep, single_arm)
from repro_torch.engine import FLConfig as TFL
from repro_torch.core.obcsaa import simulate_round
from repro_torch.core.sparsify import topk_sparsify, topk_sparsify_bisect
from repro_torch.fl import FederatedTrainer, schedule_round
from repro_torch.engine.state import with_generator_state
from repro_torch.optim import make
from repro_torch import tree
from repro_torch.models import mlp_mnist as tm
from repro_torch.sched import AdmmDuals
from repro_torch.sched import SchedConfig as TSC
from repro_torch.theory import AnalysisConstants as TAC

U, SAMPLES, HIDDEN = 4, 60, 4       # D = 784*4 + 4 + 4*10 + 10 = 3190
D = 3190
CHUNK, MEASURE, KAPPA, ITERS = 1024, 256, 32, 5
ROUNDS, EVAL_EVERY = 4, 2
NOISE_VARS = [1e-4, 1e-2]
SEEDS = [0, 1]


@pytest.fixture(scope="module")
def task():
    xtr, ytr, xte, yte = jsyn.synthetic_mnist(n_train=600, n_test=100,
                                              seed=0)
    wx, wy = jpartition(xtr, ytr, U, SAMPLES, seed=0)
    p0 = {k: np.asarray(v) for k, v in jm.init_mlp_mnist(
        jax.random.PRNGKey(0), d_hidden=HIDDEN).items()}
    return dict(wx=wx, wy=wy, xte=xte, yte=yte, p0=p0)


def _port_task(task):
    xe, ye = torch.from_numpy(task["xte"]), torch.from_numpy(task["yte"])
    return dict(
        loss_fn=lambda p, d: tm.mlp_mnist_loss(p, d["x"], d["y"]),
        params=convert.params_from_reference(task["p0"], device="cpu"),
        data={"x": torch.from_numpy(task["wx"]),
              "y": torch.from_numpy(task["wy"])},
        eval_fn=lambda p: (tm.mlp_mnist_loss(p, xe, ye),
                           tm.mlp_mnist_accuracy(p, xe, ye)))


def _cfgs(aggregator, scheduler="all", packed=False, ob_kw=None, **kw):
    ob = dict(chunk=CHUNK, measure=MEASURE, topk=KAPPA, biht_iters=ITERS,
              use_kernels=True, packed=packed, **(ob_kw or {}))
    common = dict(aggregator=aggregator, scheduler=scheduler,
                  learning_rate=0.1, rounds=ROUNDS, eval_every=EVAL_EVERY,
                  topk_dense=96)
    common.update(kw)
    jsched, tsched = {}, {}
    if scheduler == "greedy_batched":
        jsched = dict(sched_cfg=JSC(use_kernel=True, interpret=True))
        tsched = dict(sched_cfg=TSC(use_kernel=True))
    return (JFL(obcsaa=JOB(**ob), const=JAC(rho1=200.0, G=1.0), **common,
                **jsched),
            TFL(obcsaa=TOB(**ob), const=TAC(rho1=200.0, G=1.0), **common,
                **tsched))


# --- exact pieces -------------------------------------------------------------

@pytest.mark.parametrize("rounds,every", [(1, 1), (7, 3), (20, 10),
                                          (10, 10), (5, None), (6, 0)])
def test_chunk_spans_and_eval_points_exact(rounds, every):
    assert chunk_spans(rounds, every) == jspans(rounds, every)
    if every:
        assert eval_points(rounds, every) == jpoints(rounds, every)


@pytest.mark.parametrize("d", [3190, 4096, 50890, 5])
def test_budget_geometry_exact(d):
    for ob in (dict(chunk=1024, measure=256, topk=32),
               dict(chunk=4096, measure=1024, topk=80)):
        assert budget_geometry(TOB(**ob), d) == jgeom(JOB(**ob), d)


@pytest.mark.parametrize("axes", [
    dict(noise_var=[1e-6, 1e-4, 1e-2], seeds=[0, 1, 2]),
    dict(seeds=[3, 4], lr=0.05), dict(p_max=[1.0], noise_var=[1e-3, 1e-2]),
    dict(lr=[0.1, 0.2, 0.3], seeds=[7])])
def test_make_arms_broadcast_exact(axes):
    want = jmake_arms(JFL(), **axes)
    got = make_arms(TFL(), **axes)
    assert n_arms(got) == want.noise_var.shape[0]
    for name in ("noise_var", "p_max", "lr"):
        assert getattr(got, name).dtype == torch.float32
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    keys = jax.vmap(jax.random.PRNGKey)(
        jnp.asarray(got.seed.numpy(), jnp.uint32))
    np.testing.assert_array_equal(np.asarray(keys), np.asarray(want.key))
    one = single_arm(TFL(seed=5))
    assert int(one.seed) == 5 and n_arms(one) == 1


@pytest.mark.parametrize("axes", [dict(), dict(seeds=3, lr=0.1),
                                  dict(seeds=[1, 2], noise_var=[1, 2, 3])])
def test_make_arms_errors_match(axes):
    with pytest.raises(ValueError) as want:
        jmake_arms(JFL(), **axes)
    with pytest.raises(ValueError) as got:
        make_arms(TFL(), **axes)
    assert str(got.value) == str(want.value)


def test_config_modes_and_refusals():
    scheds = ("all", "enum", "admm", "greedy", "admm_batched",
              "admm_batched_jit", "greedy_batched")
    for mode in ("auto", "scan", "host"):
        for agg in ("obcsaa", "perfect", "topk_aa"):
            for sched in scheds:
                for warm in (False, True):
                    kw = dict(aggregator=agg, scheduler=sched, mode=mode,
                              sched_warm_duals=warm)
                    j, t = JFL(**kw), TFL(**kw)
                    assert t.engine_capable() == j.engine_capable()
                    if j.engine_capable() or mode != "scan":
                        assert t.resolved_mode() == j.resolved_mode()
                    else:
                        with pytest.raises(ValueError, match="scan"):
                            j.resolved_mode()
                        with pytest.raises(ValueError, match="scan"):
                            t.resolved_mode()
    with pytest.raises(ValueError, match="mode='scan'"):
        TFL(scheduler="enum", mode="scan").resolved_mode()
    for kw in (dict(error_feedback=True), dict(ckpt_dir="x"),
               dict(ckpt_resume=True),
               dict(obcsaa=TOB(warm_start=True, recon_alg="iht"))):
        t = TFL(**kw)
        assert t.resolved_mode() == "scan" and t.engine_capable()
    with pytest.raises(ValueError, match="warm-capable"):
        TOB(warm_start=True).decode_cfg()
    with pytest.raises(ValueError, match="mode"):
        TFL(mode="jit")


def test_unknown_aggregator_refused():
    """An unknown aggregator is a ValueError naming it and the three
    aggregators, as the reference's round rejects one
    (``repro/engine/core.py:242``); the port refuses it at
    construction."""
    with pytest.raises(ValueError, match=r"unknown aggregator 'fedavg'; "
                       r"one of \('obcsaa', 'topk_aa', 'perfect'\)"):
        TFL(aggregator="fedavg")


def test_arm_scalars_as_tensors_leave_floats_unchanged():
    """σ² and P^Max as 0-d tensors (an arm's) give the float path's bits."""
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.rayleigh(size=6).astype(np.float32))
    k = torch.full((6,), 100.0)
    beta = torch.from_numpy((rng.random(6) > 0.3).astype(np.float32))
    for p in (10.0, 0.3):
        assert torch.equal(tpc.max_bt(beta, k, h, torch.tensor(p)),
                           tpc.max_bt(beta, k, h, p))
    for nv in (1e-4, 3e-2):
        a = tchan.draw_noise(torch.Generator().manual_seed(1), (3, 8), nv)
        b = tchan.draw_noise(torch.Generator().manual_seed(1), (3, 8),
                             torch.tensor(nv))
        assert torch.equal(a, b)


# --- run_sweep against the reference -----------------------------------------

def _reference_draws(keys, cfg, d):
    """The reference's per-arm draws as ``Draws``: fade0 from
    fold_in(key, 0x7FADE), per round fold_in(fold_in(key, t), 0 | 1)."""
    n_chunks = -(-d // CHUNK)
    shape = {"obcsaa": (n_chunks, MEASURE), "topk_aa": (d,)}.get(
        cfg.aggregator)
    fade0, fade_w, noise = [], [], []
    for key, nv in zip(keys, NOISE_VARS):
        fade0.append(np.asarray(jchan.draw_cn(
            jax.random.fold_in(key, 0x7FADE), (U,))))
        ks = [jax.random.fold_in(key, t) for t in range(ROUNDS)]
        fade_w.append([np.asarray(jchan.draw_cn(jax.random.fold_in(k, 0),
                                                (U,))) for k in ks])
        if shape is not None:
            noise.append([np.asarray(jchan.draw_noise(
                jax.random.fold_in(k, 1), shape, nv)) for k in ks])
    return Draws(fade0=torch.from_numpy(np.stack(fade0)),
                 fade_w=torch.from_numpy(np.stack(fade_w)),
                 noise=torch.from_numpy(np.stack(noise)) if noise else None)


@pytest.mark.parametrize("aggregator,scheduler,packed", [
    pytest.param("obcsaa", "all", False, id="obcsaa-all"),
    pytest.param("obcsaa", "greedy_batched", True,
                 id="obcsaa-greedy_batched-packed"),
    pytest.param("obcsaa", "admm_batched", False, id="obcsaa-admm_batched"),
    pytest.param("topk_aa", "all", False, id="topk_aa"),
    pytest.param("perfect", "all", False, id="perfect")])
def test_run_sweep_matches_reference(task, aggregator, scheduler, packed):
    jcfg, tcfg = _cfgs(aggregator, scheduler, packed, mode="host")
    xe, ye = jnp.asarray(task["xte"]), jnp.asarray(task["yte"])
    want = jrun_sweep(
        jcfg, lambda p, d: jm.mlp_mnist_loss(p, d["x"], d["y"]),
        {k: jnp.asarray(v) for k, v in task["p0"].items()},
        {"x": jnp.asarray(task["wx"]), "y": jnp.asarray(task["wy"])},
        np.full(U, float(SAMPLES)),
        eval_fn=lambda p: (jm.mlp_mnist_loss(p, xe, ye),
                           jm.mlp_mnist_accuracy(p, xe, ye)),
        seeds=SEEDS, noise_var=NOISE_VARS)
    pt = _port_task(task)
    phi = (torch.from_numpy(np.array(jcfg.obcsaa.phi()))
           if aggregator == "obcsaa" else None)
    got = run_sweep(tcfg, pt["loss_fn"], pt["params"], pt["data"],
                    np.full(U, float(SAMPLES)), eval_fn=pt["eval_fn"],
                    seeds=SEEDS, noise_var=NOISE_VARS, phi=phi,
                    device="cpu",
                    draws=_reference_draws(want["arms"].key, jcfg, D))
    assert sorted(got) == sorted(want)
    assert got["t_start"] == want["t_start"] == 0
    assert got["n_scheduled"].dtype == np.int32
    np.testing.assert_array_equal(got["n_scheduled"], want["n_scheduled"])
    if scheduler == "all":
        assert (got["n_scheduled"] == U).all()
    np.testing.assert_allclose(got["b_t"], want["b_t"], rtol=1e-6)
    if aggregator == "obcsaa":
        for g, w in zip(got["budget"], want["budget"]):
            assert g.shape == (2, ROUNDS)
            np.testing.assert_allclose(g, w, rtol=1e-6)
        np.testing.assert_allclose(got["rt_bound"], want["rt_bound"],
                                   rtol=1e-6)
    np.testing.assert_array_equal(got["eval_rounds"], want["eval_rounds"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for k, v in task["p0"].items():
        jp = np.asarray(want["params"][k])
        tp = got["params"][k].numpy()
        assert tp.shape == jp.shape == (2,) + v.shape
        for a in range(2):
            moved = np.linalg.norm(jp[a] - v)
            assert moved > 0
            assert np.linalg.norm(tp[a] - jp[a]) <= 1e-4 * moved, (k, a)


# --- the port's own contracts ---------------------------------------------------

@pytest.mark.parametrize("aggregator,scheduler,packed,probe", [
    ("obcsaa", "all", False, True), ("obcsaa", "greedy_batched", True, False),
    ("topk_aa", "all", False, True), ("obcsaa", "admm_batched", False, False),
    ("topk_aa", "admm_batched_jit", False, True)])
def test_scan_equals_host_bitwise(task, aggregator, scheduler, packed,
                                  probe):
    """The chunked runner and the per-round loop, generator draws: every
    output equal bit for bit (on the CPU both run eagerly; the card's
    graph is held to the same contract by tests/test_torch_cuda.py)."""
    pt = _port_task(task)
    outs = {}
    for mode in ("scan", "host"):
        _, cfg = _cfgs(aggregator, scheduler, packed, mode=mode,
                       probe_agg_error=probe)
        outs[mode] = run_sweep(cfg, pt["loss_fn"], pt["params"], pt["data"],
                               np.full(U, float(SAMPLES)),
                               eval_fn=pt["eval_fn"], seeds=SEEDS,
                               noise_var=NOISE_VARS, device="cpu")
    s, h = outs["scan"], outs["host"]
    assert sorted(s) == sorted(h)
    for key in ("n_scheduled", "b_t", "rt_bound", "agg_err", "loss",
                "accuracy", "eval_rounds"):
        if key in s:
            np.testing.assert_array_equal(s[key], h[key])
    assert ("agg_err" in s) == probe
    assert ("rt_bound" in s) == (aggregator == "obcsaa")
    for k in s["params"]:
        assert torch.equal(s["params"][k], h["params"][k])
    for a in range(2):
        assert torch.equal(s["state"][a].fade, h["state"][a].fade)


def test_trainer_scan_and_host_logs_identical(task):
    """``FederatedTrainer`` in both modes: the same parameters, eval logs
    and dense per-round trajectories, ``rt_bound`` filled every round."""
    pt = _port_task(task)
    trs = {}
    for mode in ("scan", "host"):
        _, cfg = _cfgs("obcsaa", mode=mode, probe_agg_error=True)
        tr = FederatedTrainer(cfg, pt["loss_fn"], pt["params"], pt["data"],
                              np.full(U, float(SAMPLES)),
                              eval_fn=pt["eval_fn"], device="cpu")
        tr.run()
        trs[mode] = tr
    s, h = trs["scan"], trs["host"]
    ts, th = s.sched_trajectory, h.sched_trajectory
    assert list(ts["round"]) == list(range(ROUNDS))
    for key in ts:
        np.testing.assert_array_equal(ts[key], th[key])
    assert np.isfinite(ts["rt_bound"]).all()
    assert np.isfinite(ts["agg_err"]).all()
    assert [(l.round, l.loss, l.accuracy) for l in s.logs] == \
        [(l.round, l.loss, l.accuracy) for l in h.logs] != []
    for k in s.params:
        assert torch.equal(s.params[k], h.params[k])


def test_probe_off_leaves_training_unchanged(task):
    pt = _port_task(task)
    outs = {}
    for probe in (False, True):
        _, cfg = _cfgs("obcsaa", probe_agg_error=probe)
        outs[probe] = run_sweep(cfg, pt["loss_fn"], pt["params"], pt["data"],
                                np.full(U, float(SAMPLES)), seeds=SEEDS,
                                device="cpu", rounds=3)
    for k in outs[False]["params"]:
        assert torch.equal(outs[False]["params"][k], outs[True]["params"][k])
    np.testing.assert_array_equal(outs[False]["rt_bound"],
                                  outs[True]["rt_bound"])
    assert "agg_err" not in outs[False]
    assert (outs[True]["agg_err"] > 0).all()
    assert (outs[True]["rt_bound"] >= outs[True]["agg_err"]).all()


def test_engine_resolves_validate_once(task):
    """``decode_validate`` is decided when the engine is built: a fixed
    step past the edge becomes niht under "fallback" and raises under
    "raise"; the round then decodes with the resolved decoder."""
    pt = _port_task(task)
    kw = dict(chunk=CHUNK, measure=MEASURE, topk=KAPPA, recon_alg="iht",
              recon_tau=1.0, biht_iters=3)
    with pytest.raises(ValueError, match="unstable"):
        EngineRun(TFL(obcsaa=TOB(decode_validate="raise", **kw)),
                  pt["loss_fn"], pt["params"], pt["data"],
                  np.full(U, float(SAMPLES)), device="cpu")
    outs = []
    for ob in (TOB(decode_validate="fallback", **kw),
               TOB(decoder="niht", **kw)):
        outs.append(run_sweep(TFL(obcsaa=ob), pt["loss_fn"], pt["params"],
                              pt["data"], np.full(U, float(SAMPLES)),
                              seeds=[0], device="cpu", rounds=2))
    for k in outs[0]["params"]:
        assert torch.equal(outs[0]["params"][k], outs[1]["params"][k])


def test_sweep_needs_cuda_by_default(monkeypatch, task):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pt = _port_task(task)
    _, cfg = _cfgs("perfect")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sweep(cfg, pt["loss_fn"], pt["params"], pt["data"],
                  np.full(U, float(SAMPLES)), seeds=SEEDS)
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineRun(cfg, pt["loss_fn"], pt["params"], pt["data"],
                  np.full(U, float(SAMPLES)))
    with pytest.raises(ValueError, match="host"):
        run_sweep(cfg, pt["loss_fn"], pt["params"], pt["data"],
                  np.full(U, float(SAMPLES)), seeds=SEEDS, device="cpu",
                  draws=Draws(torch.zeros(2, U), torch.zeros(2, 1, U)))
    with pytest.raises(ValueError, match="ckpt_dir"):
        run_sweep(cfg, pt["loss_fn"], pt["params"], pt["data"],
                  np.full(U, float(SAMPLES)), seeds=SEEDS, device="cpu",
                  resume=True)


# --- ADMM in the round: the dual warm start -----------------------------------

def test_warm_duals_bitwise_neutral_and_scan_equals_host(task):
    """tests/test_serve.py:278's property: carrying the multipliers from
    round to round leaves the trajectory bit for bit; and scan ≡ host
    holds under the carry, duals included."""
    pt = _port_task(task)
    outs = {}
    for warm in (False, True):
        for mode in ("scan", "host"):
            _, cfg = _cfgs("obcsaa", "admm_batched", mode=mode,
                           sched_warm_duals=warm)
            outs[warm, mode] = run_sweep(
                cfg, pt["loss_fn"], pt["params"], pt["data"],
                np.full(U, float(SAMPLES)), eval_fn=pt["eval_fn"],
                seeds=SEEDS, noise_var=NOISE_VARS, device="cpu")
    cold = outs[False, "scan"]
    assert cold["state"][0].sched_duals is None
    for key in outs:
        o = outs[key]
        for k in cold["params"]:
            assert torch.equal(o["params"][k], cold["params"][k]), (key, k)
        for name in ("n_scheduled", "b_t", "rt_bound", "loss"):
            np.testing.assert_array_equal(o[name], cold[name])
    for a in range(2):
        ds, dh = (outs[True, m]["state"][a].sched_duals
                  for m in ("scan", "host"))
        assert isinstance(ds, AdmmDuals) and ds.nu.shape == (U,)
        for x, y in zip(ds, dh):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


# --- the host path: a NumPy oracle between the fade draw and the round ---------

def test_enum_scheduler_runs_on_host_path(task):
    """The reference's tests/test_engine.py:317 case on the port, and the
    same three rounds against the reference's trainer with its draws
    injected: each round's β is ``schedule_round``'s for that round's h,
    and the parameters follow the reference's."""
    jcfg, tcfg = _cfgs("obcsaa", "enum", rounds=3, eval_every=2)
    pt = _port_task(task)
    tr = FederatedTrainer(tcfg, pt["loss_fn"], pt["params"], pt["data"],
                          np.full(U, float(SAMPLES)), eval_fn=pt["eval_fn"],
                          phi=torch.from_numpy(np.array(jcfg.obcsaa.phi())),
                          device="cpu")
    assert tr.engine.mode == "host"
    logs = tr.run()
    assert np.isfinite(logs[-1].loss) and len(tr.sched_logs) == 3
    with pytest.raises(ValueError, match="host"):
        run_sweep(tcfg, pt["loss_fn"], pt["params"], pt["data"],
                  np.full(U, float(SAMPLES)), seeds=SEEDS, device="cpu")

    xe, ye = jnp.asarray(task["xte"]), jnp.asarray(task["yte"])
    jtr = JTrainer(jcfg, lambda p, d: jm.mlp_mnist_loss(p, d["x"], d["y"]),
                   {k: jnp.asarray(v) for k, v in task["p0"].items()},
                   {"x": jnp.asarray(task["wx"]),
                    "y": jnp.asarray(task["wy"])},
                   np.full(U, float(SAMPLES)),
                   eval_fn=lambda p: (jm.mlp_mnist_loss(p, xe, ye),
                                      jm.mlp_mnist_accuracy(p, xe, ye)))
    key = jtr._arm.key
    draws = _reference_draws([key, key], jcfg, D)
    tr = FederatedTrainer(tcfg, pt["loss_fn"], pt["params"], pt["data"],
                          np.full(U, float(SAMPLES)),
                          phi=torch.from_numpy(np.array(jcfg.obcsaa.phi())),
                          device="cpu")
    tr.state, tr.arm = tr.engine.init(fade0_w=draws.fade0[0])
    for t in range(3):
        want = jtr.run_round(t)
        got = tr.run_round(t, fade_w=draws.fade_w[0, t],
                           noise=draws.noise[0, t])
        np.testing.assert_array_equal(got["beta"].numpy(), want["beta"])
        beta_np, bt = schedule_round(
            "enum", got["h"].numpy().astype(np.float64),
            np.full(U, float(SAMPLES)), tcfg.obcsaa, tcfg.const, D)
        np.testing.assert_array_equal(got["beta"].numpy(), beta_np)
        assert float(got["b_t"]) == np.float32(bt)
    for k, v in task["p0"].items():
        moved = np.linalg.norm(np.asarray(jtr.params[k]) - v)
        assert moved > 0
        assert np.linalg.norm(tr.params[k].numpy()
                              - np.asarray(jtr.params[k])) <= 1e-4 * moved


# --- error feedback, warm-start decoding, stateful optimizers -----------------

EF_WARM = dict(recon_alg="iht", recon_tau=0.25, warm_start=True)


@pytest.mark.parametrize("scheduler", ["all", "greedy_batched"])
def test_run_sweep_ef_warm_matches_reference(task, scheduler):
    jcfg, tcfg = _cfgs("obcsaa", scheduler, ob_kw=EF_WARM, mode="host",
                       error_feedback=True)
    xe, ye = jnp.asarray(task["xte"]), jnp.asarray(task["yte"])
    want = jrun_sweep(
        jcfg, lambda p, d: jm.mlp_mnist_loss(p, d["x"], d["y"]),
        {k: jnp.asarray(v) for k, v in task["p0"].items()},
        {"x": jnp.asarray(task["wx"]), "y": jnp.asarray(task["wy"])},
        np.full(U, float(SAMPLES)),
        eval_fn=lambda p: (jm.mlp_mnist_loss(p, xe, ye),
                           jm.mlp_mnist_accuracy(p, xe, ye)),
        seeds=SEEDS, noise_var=NOISE_VARS)
    pt = _port_task(task)
    got = run_sweep(tcfg, pt["loss_fn"], pt["params"], pt["data"],
                    np.full(U, float(SAMPLES)), eval_fn=pt["eval_fn"],
                    seeds=SEEDS, noise_var=NOISE_VARS,
                    phi=torch.from_numpy(np.array(jcfg.obcsaa.phi())),
                    device="cpu",
                    draws=_reference_draws(want["arms"].key, jcfg, D))
    np.testing.assert_array_equal(got["n_scheduled"], want["n_scheduled"])
    np.testing.assert_allclose(got["b_t"], want["b_t"], rtol=1e-6)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for k, v in task["p0"].items():
        jp = np.asarray(want["params"][k])
        for a in range(2):
            moved = np.linalg.norm(jp[a] - v)
            assert moved > 0
            assert np.linalg.norm(got["params"][k][a].numpy() - jp[a]) \
                <= 1e-4 * moved, (k, a)
    for name in ("residual", "decode_x0"):
        ref = np.asarray(getattr(want["state"], name))
        for a in range(2):
            port = getattr(got["state"][a], name).numpy()
            assert port.shape == ref[a].shape
            assert np.linalg.norm(ref[a]) > 0
            assert np.linalg.norm(port - ref[a]) <= \
                1e-4 * np.linalg.norm(ref[a]), (name, a)


@pytest.mark.parametrize("use_kernels,spmd", [(True, False), (False, False),
                                              (False, True)])
def test_fused_ef_compression_matches_double_selection(use_kernels, spmd):
    """tests/test_engine.py:194 on the port: the split's sparse_κ fed to
    the compression presparsified is bit for bit compressing (selecting
    again from) the sparse vector."""
    ob = TOB(chunk=64, measure=32, topk=8, biht_iters=3,
             use_kernels=use_kernels, spmd_topk=spmd)
    gen = torch.Generator().manual_seed(3)
    grads = torch.randn(U, 192, generator=gen)
    kw, beta, h = torch.full((U,), 16.0), torch.ones(U), torch.ones(U)
    noise = 1e-2 * torch.randn(3, 32, generator=gen)
    phi = ob.phi("cpu")
    gc = grads.reshape(U, -1, ob.chunk)
    sp = (topk_sparsify_bisect(gc, ob.topk, iters=ob.bisect_iters)[0]
          if spmd else topk_sparsify(gc, ob.topk)[0]).reshape(U, -1)
    a, _ = simulate_round(ob, grads, kw, beta, 1.0, h, phi=phi, noise=noise)
    b, _ = simulate_round(ob, sp, kw, beta, 1.0, h, phi=phi, noise=noise,
                          presparsified=True)
    assert torch.equal(a, b)


def _trainers_both_modes(task, scheduler, rounds, optimizer=None):
    pt = _port_task(task)
    out = {}
    for mode in ("scan", "host"):
        _, cfg = _cfgs("obcsaa", scheduler, ob_kw=EF_WARM, mode=mode,
                       error_feedback=True, rounds=rounds, eval_every=5)
        tr = FederatedTrainer(cfg, pt["loss_fn"], pt["params"], pt["data"],
                              np.full(U, float(SAMPLES)),
                              optimizer=None if optimizer is None
                              else make(*optimizer[:1], **optimizer[1]),
                              device="cpu")
        tr.run()
        out[mode] = tr
    return out["scan"], out["host"]


def _carry_equal(a, b):
    fa, fb = (tree.leaves(with_generator_state(s)) for s in (a, b))
    return len(fa) == len(fb) and all(torch.equal(x, y)
                                      for x, y in zip(fa, fb))


@pytest.mark.parametrize("scheduler", ["greedy_batched", "admm_batched"])
def test_scan_equals_host_bitwise_warm_ef(task, scheduler):
    s, h = _trainers_both_modes(task, scheduler, 12)
    assert s.engine.mode == "scan" and h.engine.mode == "host"
    assert _carry_equal(s.state, h.state)
    assert s.state.residual.shape == (U, D)
    assert s.state.residual.abs().sum() > 0
    assert s.state.decode_x0.abs().sum() > 0
    ts, th = s.sched_trajectory, h.sched_trajectory
    for key in ts:
        np.testing.assert_array_equal(ts[key], th[key])


@pytest.mark.parametrize("opt", [("momentum", {"beta": 0.9}), ("adam", {})])
def test_scan_equals_host_bitwise_optimizer_moments(task, opt):
    s, h = _trainers_both_modes(task, "greedy_batched", 8, opt)
    assert _carry_equal(s.state, h.state)
    for x, y in zip(tree.leaves(s.opt_state), tree.leaves(h.opt_state)):
        assert torch.equal(x, y)
    assert any(float(x.abs().sum()) > 0 for x in tree.leaves(s.opt_state))
    if opt[0] == "adam":
        assert int(s.opt_state["t"]) == 8
