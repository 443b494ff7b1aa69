"""The zoo over processes: ``ZooRound`` and ``ZooTrainRound`` with one
gloo rank per (worker, model-shard) cell of a 2 x 2 mesh
(``launch.mesh.world_mesh``) on the CPU, and the trainer's
``--zoo-train --model-parallel 2`` CLI under a file store, against the
port's in-turn rounds on the same logical mesh and the reference's
single-device oracles on ``AbstractMesh((2, 2))``, the reference's Φ and
``fold_in(key, t)`` draws injected. The ranks import no JAX
(``_torch_dist_child``).

Tolerances:
- exact (bit for bit): every rank's rows of the master (and of the
  moments and EF residuals), after each of two chained rounds, against
  the port's in-turn round's; the MAC's int32 lane sums and magnitude
  sums of each rank's half against the in-turn round's (two workers: a
  sum of two f32 terms does not depend on their order); the loss; the
  carry the ranks save against the in-turn carry, and restored by them;
  the CLI's run stopped at round 2 and resumed to 3 against its
  uninterrupted run.
- exact: the sweep of 3 arms x 2 rounds on the ranks, every carry leaf
  and stat, against the in-turn ``reference_sweep``; its checkpoint
  both ways; the CLI's ``--arms 3`` per-arm losses against the in-turn
  sweep of the CLI's own configuration, and its resume.
- ‖ĝ‖ rtol 1e-6 (a statistic: the world's all-reduce adds the ranks'
  parts in its own order).
- against the reference, from the same carry: the surrogate rounds as
  ``tests/test_torch_zoo.py`` holds them (MAC lane sums equal but on
  borderline lanes; the movement chunk by chunk, ≤ 1% of the chunks
  parted); the real-backward round 0 as ``tests/test_torch_zoo_train.py``
  holds it (each carry leaf chunk by chunk, ≤ 1% parted).
"""
import contextlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from _torch_dist_child import run_world
from repro.core import obcsaa as job
from repro.engine import zoo as jzoo
from repro_torch import tree
from repro_torch.core import obcsaa as tob
from repro_torch.engine import zoo as tzoo
from repro_torch.engine import zoo_train as tzt
from repro_torch.launch.mesh import make_zoo_mesh
from test_torch_zoo import ZOO_OB, check_mac, held, ref_draws, ref_mac
from test_torch_zoo_train import PARITY_OB, Case, held_state, held_stats

D = 16000                       # 64 chunks of 256: 16 a cell at 2 x 2
NV, PMAX, LR = 1e-4, 10.0, 0.1
KEY = 7


def _np(a):
    return np.array(a, copy=True)


@contextlib.contextmanager
def one_thread():
    """One torch thread, as each rank runs: the CPU's reductions may
    round by their thread count, and the in-turn rounds are held against
    the ranks bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _rows(zr, cell):
    d, m = cell
    r0 = m * zr.n_half + d * zr.n_local
    return slice(r0, r0 + zr.n_local)


# --- the surrogate round ---------------------------------------------------

@pytest.fixture(scope="module")
def surrogate(tmp_path_factory):
    jz = jzoo.build_zoo_round(job.OBCSAAConfig(**ZOO_OB), D,
                              AbstractMesh((2, 2), ("data", "model")),
                              scheduler="greedy_batched")
    tz = tzoo.build_zoo_round(tob.OBCSAAConfig(**ZOO_OB), D,
                              make_zoo_mesh(2, 2), device="cpu",
                              phi=_np(job.OBCSAAConfig(**ZOO_OB).phi()),
                              scheduler="greedy_batched")
    key = jax.random.PRNGKey(KEY)
    chunked = jz.chunk_params(jax.random.normal(jax.random.PRNGKey(1), (D,),
                                                jnp.float32))
    draws = [ref_draws(jz, key, t) for t in range(2)]
    outs = run_world("zoo", 4, {
        "ob": ZOO_OB, "D": D, "phi": tz.phi, "scheduler": "greedy_batched",
        "params": torch.from_numpy(_np(chunked)), "draws": [tuple(d) for d
                                                           in draws],
        "grads": _grads(tz), "args": (NV, PMAX, LR)},
        tmp_path_factory.mktemp("zoo"), model_parallel=2)
    return jz, tz, key, chunked, draws, outs


def _grads(tz):
    g = torch.randn((tz.U, D), generator=torch.Generator().manual_seed(4))
    return tz.chunk_worker_grads(0.05 * g)


def test_surrogate_ranks_match_in_turn_bitwise(surrogate):
    """Each rank's rows and its half's MAC sums after each of two
    chained rounds, bit for bit the in-turn round's on the same logical
    2 x 2 mesh, and after a third on handed-in gradients; the stats
    alike (‖ĝ‖ rtol 1e-6); the surrogate rounds' collective bytes those
    of a blockwise gather of the half and the half's MAC."""
    _, tz, _, chunked, draws, outs = surrogate
    assert sorted(o["cell"] for o in outs) == [(0, 0), (0, 1), (1, 0),
                                               (1, 1)]
    p = torch.from_numpy(_np(chunked))
    for t in range(2):
        seen = {}
        with one_thread():
            _, st = tz.round_gen(p, t, 0, NV, PMAX, LR, draws=draws[t],
                                 hook=lambda stage, **i: seen.update(i)
                                 if stage == "mac" else None)
        for o in outs:
            d, m = o["cell"]
            half = slice(m * tz.n_half, (m + 1) * tz.n_half)
            assert torch.equal(o["rows"][t], p[_rows(tz, o["cell"])])
            assert torch.equal(o["mac"][t][0], seen["y_sum"][half])
            assert torch.equal(o["mac"][t][1], seen["mag_sum"][half])
            got = o["stats"][t]
            assert got["n_scheduled"] == int(st.n_scheduled)
            assert got["b_t"] == float(st.b_t)
            np.testing.assert_allclose(got["ghat_norm"],
                                       float(st.ghat_norm), rtol=1e-6)
    with one_thread():
        tz.round_from_grads(p, _grads(tz), 2, 0, NV, PMAX, LR,
                            draws=draws[0])
    for o in outs:                  # a round on handed-in gradients
        assert torch.equal(o["from_grads"], p[_rows(tz, o["cell"])])
    half_bytes = tz.n_local * tz.ob.chunk * 4          # a rank's rows
    for o in outs:
        assert o["bytes"]["all_gather"] == 2 * half_bytes
        assert o["bytes"]["all_reduce"] == 2 * (
            tz.n_half * tz.ob.measure * 4 + tz.n_half * 4 + 4 + 4)


def test_surrogate_ranks_match_reference(surrogate):
    """The ranks' rounds against the reference's ``reference_round`` on
    AbstractMesh((2, 2)), each from the same parameters: MAC sums equal
    but on borderline lanes, the movement held chunk by chunk."""
    jz, tz, key, chunked, _, outs = surrogate
    r = chunked
    for t in range(2):
        _, beta, _, _ = jz._prologue(jnp.int32(t), key, NV, PMAX)
        want_mac, sparse = ref_mac(jz, r, t, _np(beta))
        r0 = _np(r)
        r, _ = jz.reference_round(r, t, key, NV, PMAX, LR)
        got = np.zeros_like(r0)
        mac = torch.zeros((tz.n_chunks, tz.ob.measure), dtype=torch.int32)
        for o in outs:
            got[_rows(tz, o["cell"])] = o["rows"][t].numpy()
            m = o["cell"][1]
            mac[m * tz.n_half:(m + 1) * tz.n_half] = o["mac"][t][0]
        check_mac(tz.phi, want_mac, mac, sparse, _np(beta))
        held(r0, got, _np(r))
        r = jnp.asarray(got)          # round 1 from the ranks' carry


# --- the real-backward round ------------------------------------------------

TRAIN_CASES = {"gemma2-sgd": ("gemma2-2b", "sgd", False),
               "gemma2-adam-ef": ("gemma2-2b", "adam", True),
               "internvl2-sgd": ("internvl2-1b", "sgd", False),
               "internvl2-adam-ef": ("internvl2-1b", "adam", True)}


def _case(arch, opt, ef):
    c = Case(arch, opt, ef, w=2, m=2)
    if c.tz.model.cfg.family == "vlm":
        cfg = c.tz.model.cfg
        img = 0.1 * np.ones((2, 2, cfg.num_image_tokens, cfg.d_model),
                            np.float32)
        c.raw = dict(c.raw, image_embeds=jnp.asarray(img))
        c.batch = dict(c.batch, image_embeds=torch.from_numpy(img))
    return c


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    cases = {name: _case(*spec) for name, spec in TRAIN_CASES.items()}
    tmp = tmp_path_factory.mktemp("zoo_train")
    inp = {"cases": {}, "args": (NV, PMAX, LR), "dir": str(tmp)}
    for name, c in cases.items():
        arch, opt, ef = TRAIN_CASES[name]
        state = c.tz.init_state(torch.from_numpy(_np(c.chunked)))
        inp["cases"][name] = {
            "arch": arch, "ob": PARITY_OB, "phi": c.tz.phi, "opt": opt,
            "ef": ef, "state": tuple(state), "batch": c.batch,
            "draws": [tuple(c.draws(t)) for t in range(2)]}
    outs = run_world("zoo_train", 4, inp, tmp, model_parallel=2)
    return cases, inp, outs


def _local(tz, state, cell):
    """The rows of a whole carry that rank ``cell`` holds."""
    d, m = cell
    rows = _rows(tz, cell)
    res = state.residual
    return (state.master[rows],
            tree.tree_map(lambda x: x[rows] if x.ndim == 2 else x,
                          state.opt),
            None if res is None else res[d, m * tz.n_half:
                                         (m + 1) * tz.n_half])


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_train_ranks_match_in_turn_bitwise(trained, name):
    """Each rank's gradient block of its worker's half and its loss
    (``grads_in_layout``), and after two chained rounds every rank's
    rows of the master, the moments (Adam's counter) and the EF
    residuals, bit for bit the in-turn round's; the loss equal, ‖ĝ‖ rtol 1e-6. The carry the ranks saved
    (rank 0 gathering a block of rows at a time) equals the in-turn
    carry leaf for leaf and restores into the in-turn round, and the
    ranks restored their own rows of it."""
    cases, inp, outs = trained
    c, spec = cases[name], inp["cases"][name]
    state = tzt.clone_state(c.tz.init_state(torch.from_numpy(
        _np(c.chunked))))
    with one_thread():
        grads, losses = c.tz.grads_in_layout(state, c.batch)
    for r, o in enumerate(outs):    # before the rounds: the backward
        d, m = r // 2, r % 2
        g, loss = o[name]["grads"]
        assert torch.equal(g, grads[d, m * c.tz.n_half:
                                    (m + 1) * c.tz.n_half])
        assert torch.equal(loss, losses[d])
    for t in range(2):
        with one_thread():
            state, st = c.tz.round_train(
                state, c.batch, t, 0, NV, PMAX, LR,
                draws=tzoo.ZooDraws(*spec["draws"][t]))
        for r, o in enumerate(outs):
            cell = (r // 2, r % 2)
            got = o[name]["states"][t]
            want = _local(c.tz, state, cell)
            assert torch.equal(got[0], want[0])
            for a, b in zip(tree.leaves(got[1]), tree.leaves(want[1])):
                assert torch.equal(a, b)
            assert (got[2] is None) == (want[2] is None)
            if want[2] is not None:
                assert torch.equal(got[2], want[2])
                assert float(got[2].abs().sum()) > 0
            s = o[name]["stats"][t]
            assert s["loss"] == float(st.loss)
            assert s["b_t"] == float(st.b_t)
            np.testing.assert_allclose(s["ghat_norm"], float(st.ghat_norm),
                                       rtol=1e-6)
    for o in outs:
        assert o[name]["restored_equal"]
    saved, t_next = c.tz.restore_state(os.path.join(inp["dir"], name))
    assert t_next == 2
    for a, b in zip(tree.leaves(saved), tree.leaves(state)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_train_ranks_match_reference(trained, name):
    """Round 0 of the ranks, from the reference's carry, against the
    reference's ``reference_round_train`` on AbstractMesh((2, 2)): each
    carry leaf chunk by chunk, ≤ 1% of the chunks parted; the stats."""
    cases, inp, outs = trained
    c = cases[name]
    js = c.jz.init_state(c.chunked)
    js, rst = c.jz.reference_round_train(js, c.raw, 0,
                                         jax.random.PRNGKey(KEY), NV, PMAX,
                                         LR)
    held_state(_whole(c.tz, [o[name]["states"][0] for o in outs]), js,
               _np(c.chunked).astype(np.float64))
    held_stats(types.SimpleNamespace(**outs[0][name]["stats"][0]), rst)


def _whole(tz, parts):
    """The whole carry from the ranks' rows (rank r = cell (r // 2,
    r % 2)); scalar moments from rank 0."""
    master = torch.zeros((tz.n_chunks, tz.ob.chunk))
    for r, p in enumerate(parts):
        master[_rows(tz, (r // 2, r % 2))] = p[0]
    shapes, td = tree.flatten(tz._opt_shapes)
    opt = []
    for i, shape in enumerate(shapes):
        if shape.ndim != 2:
            opt.append(tree.leaves(parts[0][1])[i])
            continue
        full = torch.zeros(tuple(shape.shape))
        for r, p in enumerate(parts):
            full[_rows(tz, (r // 2, r % 2))] = tree.leaves(p[1])[i]
        opt.append(full)
    res = None
    if parts[0][2] is not None:
        res = torch.zeros((tz.U, tz.n_chunks, tz.ob.chunk))
        for r, p in enumerate(parts):
            d, m = r // 2, r % 2
            res[d, m * tz.n_half:(m + 1) * tz.n_half] = p[2]
    return tzt.ZooTrainState(master, tree.unflatten(td, opt), res)


# --- the sweep ----------------------------------------------------------------

SWEEP_ARMS = {"noise_var": torch.tensor([1e-4, 1e-3, 1e-2]),
              "p_max": torch.tensor([10.0, 10.0, 10.0]),
              "lr": torch.tensor([0.1, 0.05, 0.02])}


def test_sweep_ranks_match_in_turn_bitwise(tmp_path):
    """``run_sweep`` over 3 arms x 2 rounds (gemma2, Adam and EF) on the
    2 x 2 ranks, each rank every arm on its rows of the arm-stacked
    carry, each round's draws shared by its arms: every carry leaf of
    every rank (master, moments, Adam's per-arm counter, residual) bit
    for bit the in-turn ``reference_sweep``'s on the logical 2 x 2 mesh,
    every stat on every rank (‖ĝ‖ rtol 1e-6); the carry the ranks saved
    with ``save_state`` equals the in-turn carry, and each rank's
    ``restore_state(arms=3)`` its own rows; a carry a row short in its
    master or its residual is refused with a ValueError naming it."""
    c = _case("gemma2-2b", "adam", True)
    masters = torch.from_numpy(_np(c.chunked))[None].expand(
        (3,) + tuple(c.chunked.shape)).clone()
    masters[1:] += 0.01 * torch.randn(masters[1:].shape,
                                      generator=torch.Generator()
                                      .manual_seed(5))
    draws = [tuple(c.draws(t)) for t in range(2)]
    outs = run_world("zoo_sweep", 4, {
        "case": {"arch": "gemma2-2b", "ob": PARITY_OB, "phi": c.tz.phi,
                 "opt": "adam", "ef": True, "batch": c.batch,
                 "draws": draws},
        "masters": masters, "arms": SWEEP_ARMS, "dir": str(tmp_path)},
        tmp_path, model_parallel=2)
    with one_thread():
        states, st = c.tz.reference_sweep(
            c.tz.init_sweep_state(masters), c.batch, SWEEP_ARMS, 2, key=0,
            draws=lambda t: tzoo.ZooDraws(*draws[t]))
    for r, o in enumerate(outs):
        d, m = r // 2, r % 2
        rows = _rows(c.tz, (d, m))
        got = o["state"]
        assert torch.equal(got[0], states.master[:, rows])
        for a, b in zip(tree.leaves(got[1]), tree.leaves(states.opt)):
            assert torch.equal(a, b[:, rows] if b.ndim == 3 else b)
        assert torch.equal(got[2], states.residual[
            :, d, m * c.tz.n_half:(m + 1) * c.tz.n_half])
        assert float(got[2].abs().sum()) > 0
        for k in ("loss", "b_t", "n_scheduled"):
            assert o["stats"][k] == np.asarray(getattr(st, k)).tolist(), k
        np.testing.assert_allclose(o["stats"]["ghat_norm"], st.ghat_norm,
                                   rtol=1e-6)
        assert o["restored_equal"]
        assert "master" in o["refused"][0], o["refused"]
        assert "EF residual" in o["refused"][1], o["refused"]
    assert np.asarray(st.loss).shape == (2, 3)
    saved, t_next = c.tz.restore_state(str(tmp_path), arms=3)
    assert t_next == 2
    for a, b in zip(tree.leaves(saved), tree.leaves(states)):
        assert torch.equal(a, b)


def test_zoo_train_cli_arms(tmp_path):
    """``--zoo-train --model-parallel 2 --arms 3`` on 4 ranks prints each
    arm's losses as the in-turn sweep on the logical 2 x 2 mesh computes
    them from the CLI's own configuration, init and batch; 1 round then
    ``--resume`` to 2 leaves the uninterrupted run's checkpoint, leaf for
    leaf."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as ttrain
    from repro_torch.models.registry import build_model
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    base = ["--zoo-train", "--model-parallel", "2", "--arms", "3",
            "--device", "cpu", "--smoke", "--arch", "gemma2-2b",
            "--optimizer", "adam", "--batch", "1", "--seq", "16",
            "--cs-chunk", "256", "--cs-measure", "64", "--cs-topk", "16"]
    outs = run_world("zoo_cli", 4, {"argvs": [
        base + ["--steps", "2", "--ckpt-dir", a],
        base + ["--steps", "1", "--ckpt-dir", b],
        base + ["--steps", "2", "--ckpt-dir", b, "--resume"]]}, tmp_path)
    logs = outs[0]["logs"]
    assert "resumed sweep at round 1" in logs[2]
    args = ttrain.build_parser().parse_args(base + ["--steps", "2"])
    tc = ttrain.train_config(args)
    cfg = get_smoke_config("gemma2-2b")
    model = build_model(cfg)
    zr = tsteps.make_zoo_train_round(model, tc, make_zoo_mesh(2, 2),
                                     device="cpu")
    master = zr.chunk_params(model.init(0, device="cpu"))
    arms = ttrain.sweep_arms(tc, args.lr, 3)
    with one_thread():
        _, st = zr.reference_sweep(
            zr.init_sweep_state(master[None].expand(
                (3,) + tuple(master.shape)).clone()),
            ttrain.make_zoo_batch(cfg, zr.U, args.batch, args.seq,
                                  device="cpu"), arms, 2, key=1)
    want = [f"arm {i}: noise_var={arms['noise_var'][i]:.2e} "
            f"lr={arms['lr'][i]:.3f} loss {st.loss[0, i]:.4f} -> "
            f"{st.loss[-1, i]:.4f}" for i in range(3)]
    assert [ln for ln in logs[0].splitlines()
            if ln.startswith("arm ")] == want
    x, y = (np.load(os.path.join(p, "step_00000002", "arrays.npz"))
            for p in (a, b))
    assert sorted(x.files) == sorted(y.files)
    for k in x.files:
        np.testing.assert_array_equal(x[k], y[k])


# --- the CLI ---------------------------------------------------------------

def test_zoo_train_cli_resume(tmp_path):
    """``--zoo-train --model-parallel 2`` with Adam and EF on 4 ranks:
    rounds 0-2 uninterrupted, and 0-1 then ``--resume`` to 3; the
    checkpoints of round 3 equal leaf for leaf."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    base = ["--zoo-train", "--model-parallel", "2", "--device", "cpu",
            "--smoke", "--arch", "gemma2-2b", "--optimizer", "adam",
            "--error-feedback", "--batch", "1", "--seq", "16",
            "--cs-chunk", "256", "--cs-measure", "64", "--cs-topk", "16"]
    outs = run_world("zoo_cli", 4, {"argvs": [
        base + ["--steps", "3", "--ckpt-dir", a],
        base + ["--steps", "2", "--ckpt-dir", b],
        base + ["--steps", "3", "--ckpt-dir", b, "--resume"]]}, tmp_path)
    logs = outs[0]["logs"]
    assert "world: 2 x 2 ranks over gloo" in logs[0]
    assert "resumed zoo-train at round 2" in logs[2]
    assert sum(ln.startswith("round ") for ln in logs[0].splitlines()) == 3
    assert all(o["logs"] == ["", "", ""] for o in outs[1:])
    x, y = (np.load(os.path.join(p, "step_00000003", "arrays.npz"))
            for p in (a, b))
    # master, Adam's m, v and step counter, EF residual, t_next
    assert sorted(x.files) == sorted(y.files) and len(x.files) == 6
    for k in x.files:
        np.testing.assert_array_equal(x[k], y[k])
