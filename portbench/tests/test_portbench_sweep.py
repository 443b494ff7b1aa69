"""The §V sweep cell's path at a CPU's size, through the reference
comparison: sound, and with the timed path broken underneath."""
import pytest
import torch

from portbench import harness
from portbench.drivers import sweep
from portbench.tests._cells import run, tiny

CELL = "sec5-fig5-obcsaa"


def test_sound_run_is_correct():
    ctx, checks = run(CELL)
    assert checks.correct, checks.report()
    assert ctx.units and ctx.window_s > 0
    assert set(checks.items) == {"first_round_gap", "stretch_gap", "b_t_gap"}
    assert ctx.counters["failed"] == 0


def test_a_perturbed_answer_fails_the_comparison():
    """One sweep's parameters after its first round nudged by a fifth of the
    round's change: the comparison the run makes reads it."""
    cell = tiny(CELL)
    sw = sweep.Sweeps(cell.config, cell.traffic, 7, "cpu")
    sw.sweep(0)
    ok = harness.Checks()
    sweep.check(sw, ok, 7)
    assert ok.correct, ok.report()
    for snap in sw.done[0]["snaps"]:
        p = snap[2]
        p["w1"] += 0.2 * (p["w1"] - sw.params0["w1"].cpu())
    bad = harness.Checks()
    assert sweep.check(sw, bad, 7) > 0
    assert not bad.correct


def _state_unchanged(monkeypatch):
    from repro_torch.engine import runner
    from repro_torch.optim.optimizers import Optimizer

    monkeypatch.setattr(runner, "sgd", lambda: Optimizer(
        lambda p: (), lambda g, s, p, lr: (p, s)))


def _half_the_batch(monkeypatch):
    from repro_torch.engine import core
    full = core.stacked_grads

    def half(loss_fn, params, data):
        g = full(loss_fn, params, data)
        u = g.shape[0] // 2 or 1
        idx = torch.arange(g.shape[0]) % u
        return g[idx]
    monkeypatch.setattr(core, "stacked_grads", half)


def _stale_draws(monkeypatch):
    from repro_torch.core import channel
    draw = channel.draw_fades

    def stale(generator=None, shape=None, *, rho=0.0, prev=None, w=None,
              device=None, clamp=True):
        if prev is not None:
            draw(generator, shape, rho=rho, prev=prev, w=w, device=device,
                 clamp=clamp)
            g = prev.to(torch.complex64)
            return torch.clamp(g.abs().float(), min=channel.H_MIN), g
        return draw(generator, shape, rho=rho, prev=prev, w=w,
                    device=device, clamp=clamp)
    monkeypatch.setattr(channel, "draw_fades", stale)


def _stale_carry(monkeypatch):
    """Every round of a stretch run from the stretch's first parameters:
    round 0 and every b_t as they should be, the carry not advanced."""
    from repro_torch.engine import runner

    def chunk(self, state, arm, t0, n, draws=None, a=0):
        start, stats = state.params, []
        for _ in range(n):
            state, st, _ = self.fns.full_round(
                state._replace(params=start), arm, self.worker_data,
                self.k_weights)
            stats.append(st)
        return state, runner._join(stats)
    monkeypatch.setattr(runner.EngineRun, "_eager_chunk", chunk)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch,
                                   _stale_draws, _stale_carry])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    _, checks = run(CELL)
    assert not checks.correct, checks.report()
