"""The port's scheduling service (``repro_torch.serve``) against
``repro.serve``, and its own invariants, on the CPU.

Tolerances:
- the service's ticks against the reference's with the reference's draws
  injected (initial fades from split(split(key)[0])[0], tick t's
  innovation from fold_in(kw, t), its report mask from
  fold_in(fold_in(kw, 0x5EED), t)): per-tick reported/dirty/solved counts
  and hit rates exact; the fades rtol 1e-6 (atol 1e-7: XLA fuses the
  recursion into FMAs) and h_seen rtol 1e-6; greedy β exact, b_t and R_t rtol 1e-6;
  ADMM at most one lane's β differing per 64 lanes and b_t/R_t rtol 1e-4
  on the lanes whose β agrees (tests/test_torch_admm.py's allowance: the
  two run Algorithm 2's f32 ops in different orders); the cells whose
  warm-start multipliers have exploded past |ν| = 1e6 (lanes where b
  collapsed to its floor) number the same within 25% in both packages.
- within the port, bit for bit: at threshold 0 the cache equals
  ``fresh_solve`` for both solvers; the report mask and the innovation
  from the generator equal the same draws passed in.
- exact: hit-rate accounting, the threshold freeze, ``ingest``, the
  config's validation messages (the reference's), the CLI.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.channel import draw_cn as jdraw_cn
from repro.sched import ScenarioConfig as JScen
from repro.serve import ServeConfig as JServe
from repro.serve import init_service as jinit
from repro.serve import tick as jtick
from repro_torch.core.channel import draw_cn
from repro_torch.sched import SchedConfig, ScenarioConfig
from repro_torch.serve import (ServeConfig, TickStats, fresh_solve, ingest,
                               init_service, movement, run_ticks,
                               slo_summary, tick)
from repro_torch.serve.cli import main as cli_main

U = 16


def _serve_cfg(cells=96, cls=ServeConfig, scen=ScenarioConfig, **kw):
    base = dict(scenario=scen(cells=cells, workers=U, corr=0.99),
                stale_threshold=0.0, update_frac=0.35)
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("scheduler", ["admm_batched", "greedy_batched"])
def test_serve_cache_parity_at_threshold_zero(scheduler):
    """At threshold 0 with partial reporting the cache, a patchwork of
    solves from different ticks and bucket sizes, equals a cold
    full-fleet solve bit for bit."""
    cfg = _serve_cfg(scheduler=scheduler)
    st = init_service(cfg, 0, device="cpu")
    st, stats, _ = run_ticks(cfg, st, 5)
    assert any(s.hit_rate > 0 for s in stats[1:])
    beta, b_t, rt = fresh_solve(cfg, st)
    assert torch.equal(beta, st.beta)
    assert torch.equal(b_t, st.b_t)
    assert torch.equal(rt, st.rt)


def test_serve_hit_rate_accounting():
    cfg = _serve_cfg(cells=64, stale_threshold=0.05)
    st = init_service(cfg, 4, device="cpu")
    st, stats, _ = run_ticks(cfg, st, 4)
    assert stats[0].n_dirty == 64 and stats[0].hit_rate == 0.0
    for s in stats[1:]:
        assert s.n_dirty <= s.n_reported
        assert s.hit_rate == 1.0 - s.n_dirty / 64
        assert s.n_solved >= s.n_dirty       # pow2 pad lanes included
        assert isinstance(s, TickStats)
    assert [s.tick for s in stats] == [0, 1, 2, 3] and st.tick == 4


def test_serve_threshold_freezes_cache():
    cfg = _serve_cfg(cells=32, stale_threshold=1e9, update_frac=1.0)
    st = init_service(cfg, 0, device="cpu")
    st, _, _ = run_ticks(cfg, st, 1)
    beta0 = st.beta.clone()
    st, stats, _ = run_ticks(cfg, st, 3)
    assert all(s.n_dirty == 0 and s.n_solved == 0 for s in stats)
    assert torch.equal(st.beta, beta0)


def test_serve_ingest_marks_dirty():
    cfg = _serve_cfg(cells=32, update_frac=0.0)
    st = init_service(cfg, 1, device="cpu")
    st, _, _ = run_ticks(cfg, st, 2)                # cold solve, then idle
    h_new = st.h_seen[[3, 7]] * 1.5
    st = ingest(st, [3, 7], h_new)
    assert set(np.flatnonzero(movement(cfg, st) > 0)) == {3, 7}
    st, stats = tick(cfg, st)
    assert stats.n_dirty == 2 and stats.n_reported == 0
    assert torch.equal(st.h_solved[[3, 7]], h_new)


@pytest.mark.parametrize("kw", [dict(scheduler="enum"),
                                dict(update_frac=1.5),
                                dict(stale_threshold=-0.1)])
def test_serve_config_validation(kw):
    with pytest.raises(ValueError) as want:
        JServe(**kw)
    with pytest.raises(ValueError) as got:
        ServeConfig(**kw)
    assert str(got.value) == str(want.value)
    assert ServeConfig(scheduler="greedy_batched").warm is False
    assert ServeConfig(warm_duals=False).warm is False
    assert ServeConfig().warm is True


def test_generator_draws_equal_injected_draws():
    """The generator's order: the initial fade, then per tick the
    innovation and the report mask; the same numbers passed in give the
    same bits."""
    cfg = _serve_cfg(cells=40, scheduler="greedy_batched",
                     stale_threshold=0.05, update_frac=0.5)
    a = init_service(cfg, 9, device="cpu")
    g0 = draw_cn(torch.Generator().manual_seed(9), (40, U), "cpu")
    assert torch.equal(a.fades.g, g0)
    b = init_service(cfg, torch.Generator().manual_seed(123), g0=g0)
    for _ in range(3):
        replay = torch.Generator()
        replay.set_state(a.fades.generator.get_state())
        w = draw_cn(replay, (40, U), "cpu")
        report = torch.rand(40, generator=replay) < 0.5
        a, sa = tick(cfg, a)
        b, sb = tick(cfg, b, w=w, report=report)
        assert sa[:5] == sb[:5]       # mean_iters is NaN for greedy
        for x, y in ((a.fades.g, b.fades.g), (a.h_seen, b.h_seen),
                     (a.beta, b.beta), (a.b_t, b.b_t), (a.rt, b.rt)):
            assert torch.equal(x, y)
        assert torch.equal(a.fades.generator.get_state(),
                           replay.get_state())


def _reference_draws(cfg_j, key, ticks):
    """The reference's initial fades, innovations and report masks."""
    kf, _ = jax.random.split(key)
    k0, kw = jax.random.split(kf)
    shape = (cfg_j.scenario.cells, cfg_j.scenario.workers)
    g0 = np.asarray(jdraw_cn(k0, shape).astype(jnp.complex64))
    w = [np.asarray(jdraw_cn(jax.random.fold_in(kw, t), shape))
         for t in range(ticks)]
    rep = [np.asarray(jax.random.uniform(jax.random.fold_in(
        jax.random.fold_in(kw, 0x5EED), t), (shape[0],))
        < cfg_j.update_frac) for t in range(ticks)]
    return g0, w, rep


@pytest.mark.parametrize("scheduler", ["greedy_batched", "admm_batched"])
def test_ticks_match_reference(scheduler):
    cells, ticks = 128, 4
    kw = dict(scheduler=scheduler, stale_threshold=0.05, update_frac=0.5)
    jcfg = _serve_cfg(cells, JServe, JScen, **kw)
    tcfg = _serve_cfg(cells, **kw)
    key = jax.random.PRNGKey(3)
    g0, w, rep = _reference_draws(jcfg, key, ticks)
    js = jinit(jcfg, key)
    ts = init_service(tcfg, device="cpu", g0=torch.from_numpy(g0.copy()))
    np.testing.assert_array_equal(ts.fades.g.numpy(),
                                  np.asarray(js.fades.g))
    for t in range(ticks):
        js, jst = jtick(jcfg, js)
        ts, tst = tick(tcfg, ts, w=torch.from_numpy(w[t]),
                       report=torch.from_numpy(rep[t]))
        np.testing.assert_allclose(ts.fades.g.numpy(),
                                   np.asarray(js.fades.g), rtol=1e-6,
                                   atol=1e-7)
        assert (tst.tick, tst.n_reported, tst.n_dirty, tst.n_solved,
                tst.hit_rate) == (jst.tick, jst.n_reported, jst.n_dirty,
                                  jst.n_solved, jst.hit_rate)
        np.testing.assert_allclose(ts.h_seen.numpy(),
                                   np.asarray(js.h_seen), rtol=1e-6)
        beta, jbeta = ts.beta.numpy(), np.asarray(js.beta)
        if scheduler == "greedy_batched":
            np.testing.assert_array_equal(beta, jbeta)
            np.testing.assert_allclose(ts.b_t.numpy(), np.asarray(js.b_t),
                                       rtol=1e-6)
            np.testing.assert_allclose(ts.rt.numpy(), np.asarray(js.rt),
                                       rtol=1e-6)
        else:
            same = (beta == jbeta).all(-1)
            assert (~same).sum() <= cells // 64
            np.testing.assert_allclose(ts.b_t.numpy()[same],
                                       np.asarray(js.b_t)[same], rtol=1e-4)
            np.testing.assert_allclose(ts.rt.numpy()[same],
                                       np.asarray(js.rt)[same], rtol=1e-4)
    assert tst.n_reported < cells and tst.hit_rate > 0
    if scheduler == "admm_batched":
        # both packages carry degenerate lanes' exploded multipliers into
        # the next tick's warm start, on a like share of the cells
        big_ref = int((np.abs(np.asarray(js.duals.nu)) > 1e6).any(-1).sum())
        big_port = int((ts.duals.nu.abs() > 1e6).any(-1).sum())
        assert big_ref > 0 and abs(big_port - big_ref) <= 0.25 * big_ref


def test_slo_summary_accounting():
    stats = [TickStats(0, 10, 10, 16, 0.0, float("nan")),
             TickStats(1, 5, 2, 8, 0.8, float("nan"))]
    slo = slo_summary(stats, [0.002, 0.004], 10)
    assert slo["mean_ms"] == pytest.approx(3.0)
    assert slo["hit_rate"] == pytest.approx(0.4)
    assert slo["solved_per_s"] == pytest.approx(12 / 0.006)
    assert slo["served_per_s"] == pytest.approx(20 / 0.006)


def test_serve_cli_smoke(capsys):
    rc = cli_main(["--cells", "32", "--workers", "8", "--ticks", "2",
                   "--threshold", "0.0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "SLO:" in out and "hit_rate" in out
    assert "device=cpu" in out


@pytest.mark.parametrize("sched_cfg", [None, SchedConfig(use_kernel=False)])
def test_serve_greedy_goes_through_prefix_eval(monkeypatch, sched_cfg):
    """The service sweeps greedy prefixes through the K7 wrapper whatever
    ``sched_cfg.use_kernel`` says (on CPU tensors the wrapper takes its
    plain version): one call a tick that solved, none outside it."""
    import repro_torch.sched.greedy as greedy
    calls = []
    wrapped = greedy.prefix_eval

    def counting(*a):
        calls.append(a[0].shape)
        return wrapped(*a)

    monkeypatch.setattr(greedy, "prefix_eval", counting)
    cfg = _serve_cfg(cells=40, scheduler="greedy_batched",
                     stale_threshold=0.0, update_frac=1.0,
                     sched_cfg=sched_cfg)
    assert cfg.solver.use_kernel
    _, stats, _ = run_ticks(cfg, init_service(cfg, 0, device="cpu"), 3)
    assert len(calls) == sum(1 for s in stats if s.n_dirty) == 3
    assert all(shape == (64, 16) for shape in calls)


def test_serve_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["--cells", "8", "--ticks", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        init_service(ServeConfig(), 0)
