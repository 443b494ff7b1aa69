"""The zoo cell's path at a CPU's size, through the reference comparison:
sound, and with the timed path broken underneath."""
import pytest

from portbench.tests._cells import run

CELL = "zoo-internvl2-1b-train"


def test_sound_run_is_correct():
    ctx, checks = run(CELL)
    assert checks.correct, checks.report()
    assert set(checks.items) == {"mac_lane_share", "grad_gap", "change_gap"}
    assert ctx.units >= 1 and ctx.counters["failed"] == 0


def _state_unchanged(monkeypatch):
    from repro_torch.engine.zoo_train import ZooTrainRound
    monkeypatch.setattr(ZooTrainRound, "_opt_update_blocks",
                        lambda self, ghat, opt, master, a, b, lr: [])


def _half_the_batch(monkeypatch):
    from repro_torch.engine.zoo_train import ZooTrainRound
    full = ZooTrainRound._worker_grads

    def half(self, p_full, batch, u):
        n = batch["tokens"].shape[1] // 2
        return full(self, p_full, {k: v[:, :n] for k, v in batch.items()},
                    u)
    monkeypatch.setattr(ZooTrainRound, "_worker_grads", half)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    _, checks = run(CELL)
    assert not checks.correct, checks.report()


def test_a_perturbed_answer_fails_the_comparison():
    """The carry after the first round with its change from the start
    made half as large again: the comparison the run makes reads it."""
    import torch

    from portbench import harness
    from portbench.drivers import zoo_train
    from portbench.tests._cells import tiny

    cell = tiny(CELL)
    torch.set_num_threads(1)
    inp = zoo_train.Inputs(cell.config, cell.traffic, 11, "cpu")
    run = zoo_train.setup_rounds(zoo_train.Program(cell.config, inp),
                                 int(cell.traffic["setup_rounds"]))
    ok = harness.Checks()
    zoo_train.compare(inp, run, ok, cell.traffic["limits"])
    assert ok.correct, ok.report()
    p0 = inp.layout.to_master(inp.params())
    run["p1"] = p0 + 1.5 * (run["p1"] - p0)
    bad = harness.Checks()
    assert zoo_train.compare(inp, run, bad, cell.traffic["limits"]) > 0
    assert not bad.correct
