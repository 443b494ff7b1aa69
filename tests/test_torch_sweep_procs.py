"""The §V sweep's arm axis over processes: ``run_sweep(mesh=world_mesh(M))``
with gloo ranks on the CPU (``_torch_dist_child``'s ``sweep`` case),
against the one-process ``run_sweep`` of the port and the reference's
single-placement ``run_sweep``; ``dist.sharding.infer_batch_sharding``
against the reference's specs.

Tolerances:
- exact: the specs of ``infer_batch_sharding`` against the reference's
  on ``AbstractMesh`` meshes; the arms each rank holds.
- exact (bit for bit): every stream (``n_scheduled``, ``b_t``, the
  budget, ``rt_bound``, the eval streams), every arm's carry leaf
  (parameters, Adam's moments and step, fade, β, the decoder's warm
  start, the EF residuals, the generator's state) and the stacked
  parameters, on every rank, against the one-process sweep: 2 ranks
  with A = 4 (split, 2 arms a rank) and A = 3 (replicated); a 2 x 2
  world (2 arms a worker group, replicated over its model group); resume
  1 -> 2 and 2 -> 1 against the uninterrupted sweep, as
  tests/test_checkpoint.py:214-233 holds the reference's mesh resume;
  ``mesh=make_zoo_mesh(4, 2)`` in one process against ``mesh=None``; a
  world of one (its arms split over W = 1 worker, its records through
  the group's all-gather) against the one-process sweep. Arms share
  nothing, so a split changes no bit.
- exact: ``collectives.wire_device``'s rule (gloo: the CPU; NCCL: the
  run's device; no group: the run's device); every leaf that a sweep
  over ranks hands to ``gather_rows`` and ``replicated`` lies on
  ``wire_device`` of their group (the CPU under gloo).
- against the reference's single-placement ``run_sweep`` (its draws
  injected, host mode, the 2-rank A = 4 split of the §V MLP at small
  width): tests/test_torch_engine.py's gates, ``n_scheduled`` exact,
  ``b_t`` and ``rt_bound`` rtol 1e-6, eval losses rtol 1e-4, each final
  parameter within 1e-4 of how far the reference moved it.
"""
import contextlib
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from _torch_dist_child import run_world, sweep_engine, sweep_summary
from repro.core import channel as jchan
from repro.dist.sharding import infer_batch_sharding as j_infer
from repro.engine import run_sweep as jrun_sweep
from repro.models import mlp_mnist as jm
from repro_torch import convert
from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import batch_indices, infer_batch_sharding
from repro_torch.engine import Draws
from repro_torch.launch.mesh import ZooMesh, make_zoo_mesh
from test_torch_engine import (CHUNK, D, EVAL_EVERY, ITERS, KAPPA, MEASURE,
                               ROUNDS, SAMPLES, U, _cfgs, task)  # noqa: F401

SEEDS4, NV4 = [0, 1, 2, 3], [1e-4, 1e-3, 1e-2, 1e-1]


@contextlib.contextmanager
def one_thread():
    """One torch thread, as each rank runs: the CPU's reductions may
    round by their thread count, and the ranks are held bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def small(a, **kw):
    return dict(task="small", seeds=SEEDS4[:a], noise_var=NV4[:a], **kw)


def one_process(spec, mesh=None, **kw):
    with one_thread():
        run, arms = sweep_engine(spec)
        return sweep_summary(run.run_sweep(arms, mesh=mesh, **kw))


def _trim(ckpt_dir, keep_to):
    for sub in os.listdir(ckpt_dir):
        if int(sub.split("_")[1]) > keep_to:
            shutil.rmtree(os.path.join(ckpt_dir, sub))


def assert_same(got, want, tail=None):
    """Two ``sweep_summary``s bit for bit; ``tail``: ``want`` is the
    uninterrupted sweep and ``got`` resumed at round ``tail``."""
    assert got["t_start"] == (tail or 0)
    for k in ("n_scheduled", "b_t", "rt_bound", "loss", "accuracy"):
        w = want[k][:, -got[k].shape[1]:] if tail else want[k]
        assert torch.equal(got[k], w), k
    for g, w in zip(got["budget"], want["budget"]):
        assert torch.equal(g, w[:, -g.shape[1]:] if tail else w)
    assert len(got["state"]) == len(want["state"])
    for a, (ga, wa) in enumerate(zip(got["state"], want["state"])):
        assert len(ga) == len(wa)
        assert all(torch.equal(x, y) for x, y in zip(ga, wa)), a
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k


# --- the layout ------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [((4, 2), ("data", "model")),
                                        ((8, 1), ("data", "model")),
                                        ((1, 8), ("data", "model")),
                                        ((2, 4, 2), ("pod", "data",
                                                     "model"))])
def test_batch_specs_match_reference(shape, axes):
    jmesh, tmesh = AbstractMesh(shape, axes), ZooMesh(axes, shape)
    for a in range(1, 17):
        t = {"x": np.zeros((a, 5), np.float32), "s": np.float32(0),
             "y": np.zeros((a,), np.int32)}
        want = j_infer(t, jmesh)
        got = infer_batch_sharding({k: torch.as_tensor(v)
                                    for k, v in t.items()}, tmesh)
        for k in t:
            assert tuple(got[k]) == tuple(want[k].spec), (a, k)


def test_batch_indices_without_world():
    """A mesh without a world (one process) holds every arm, as None."""
    for a in (1, 3, 4, 12):
        assert batch_indices(a, None) == range(a)
        assert batch_indices(a, make_zoo_mesh(4, 2)) == range(a)


def test_zoo_mesh_in_one_process_equals_none():
    spec = small(4)
    assert_same(one_process(spec, mesh=make_zoo_mesh(4, 2)),
                one_process(spec))


# --- the wire device ------------------------------------------------------------

@pytest.mark.parametrize("backend,want", [("gloo", "cpu"), ("nccl", "cuda:0"),
                                          (None, "cuda:0")])
def test_wire_device_rule(monkeypatch, backend, want):
    """gloo takes a sweep's records on the CPU, NCCL on the run's card;
    without a group they stay on the run's device. The backend is read
    from ``dist.get_backend`` of the group passed."""
    seen = []

    def get_backend(group):
        seen.append(group)
        return backend

    monkeypatch.setattr(coll.dist, "get_backend", get_backend)
    group = None if backend is None else object()
    assert coll.wire_device(group, torch.device("cuda", 0)) \
        == torch.device(want)
    assert coll.wire_device(group, "cpu") == torch.device("cpu")
    assert seen == ([] if group is None else [group, group])


# --- over processes ------------------------------------------------------------------

def _reference_draws(keys, noise_vars):
    """The reference's per-arm draws as ``Draws`` (tests/test_torch_engine
    .py's, for any arms): fade0 from fold_in(key, 0x7FADE), per round
    fold_in(fold_in(key, t), 0 | 1)."""
    shape = (-(-D // CHUNK), MEASURE)
    fade0, fade_w, noise = [], [], []
    for key, nv in zip(keys, noise_vars):
        fade0.append(np.asarray(jchan.draw_cn(
            jax.random.fold_in(key, 0x7FADE), (U,))))
        ks = [jax.random.fold_in(key, t) for t in range(ROUNDS)]
        fade_w.append([np.asarray(jchan.draw_cn(jax.random.fold_in(k, 0),
                                                (U,))) for k in ks])
        noise.append([np.asarray(jchan.draw_noise(jax.random.fold_in(k, 1),
                                                  shape, nv)) for k in ks])
    return tuple(torch.from_numpy(np.stack(x)) for x in (fade0, fade_w,
                                                         noise))


@pytest.fixture(scope="module")
def mlp(task):
    """The 2-rank A = 4 sweep of the §V MLP in host mode against the
    reference: the reference's result, and the port's spec with its draws
    and Φ."""
    jcfg, _ = _cfgs("obcsaa", mode="host")
    xe, ye = jnp.asarray(task["xte"]), jnp.asarray(task["yte"])
    want = jrun_sweep(
        jcfg, lambda p, d: jm.mlp_mnist_loss(p, d["x"], d["y"]),
        {k: jnp.asarray(v) for k, v in task["p0"].items()},
        {"x": jnp.asarray(task["wx"]), "y": jnp.asarray(task["wy"])},
        np.full(U, float(SAMPLES)),
        eval_fn=lambda p: (jm.mlp_mnist_loss(p, xe, ye),
                           jm.mlp_mnist_accuracy(p, xe, ye)),
        seeds=SEEDS4, noise_var=NV4)
    spec = dict(
        task="mlp", seeds=SEEDS4, noise_var=NV4,
        ob=dict(chunk=CHUNK, measure=MEASURE, topk=KAPPA, biht_iters=ITERS,
                use_kernels=True), const=dict(rho1=200.0, G=1.0),
        fl=dict(aggregator="obcsaa", scheduler="all", learning_rate=0.1,
                rounds=ROUNDS, eval_every=EVAL_EVERY, topk_dense=96,
                mode="host"),
        params=convert.params_from_reference(task["p0"], device="cpu"),
        wx=torch.from_numpy(task["wx"]), wy=torch.from_numpy(task["wy"]),
        xte=torch.from_numpy(task["xte"]), yte=torch.from_numpy(task["yte"]),
        k_weights=torch.full((U,), float(SAMPLES)),
        phi=torch.from_numpy(np.array(jcfg.obcsaa.phi())),
        draws=_reference_draws(want["arms"].key, NV4))
    return want, spec


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, mlp):
    """One launch of 2 ranks (M = 1) running, in turn: the A = 4 small
    sweep with a checkpoint at every boundary (split, 2 arms a rank); the
    A = 3 one (replicated); the one-process A = 4 checkpoint cut after
    round 4 and resumed; the same resumed under other arms, without a
    directory, and at another cadence; the MLP's A = 4 with the
    reference's draws. Then the ranks' A = 4 checkpoint
    cut after round 4 and resumed in this process."""
    tmp = tmp_path_factory.mktemp("sweep2")
    d1, d2 = str(tmp / "from1"), str(tmp / "from2")
    want4 = one_process(small(4), ckpt_dir=d1)
    _trim(d1, 4)
    shutil.copytree(d1, str(tmp / "cut"))
    other = dict(small(4), seeds=[0, 1, 2, 5])
    outs = run_world("sweep", 2, {"runs": {
        "split4": small(4, ckpt=d2), "rep3": small(3),
        "resume12": small(4, ckpt=d1, resume=True),
        "other_arms": dict(other, ckpt=d1, resume=True),
        "no_ckpt": small(4, resume=True),
        "off_cadence": small(4, ckpt=str(tmp / "cut"), resume=True,
                             every=2),
        "mlp": mlp[1]}}, tmp, timeout=300)
    steps2 = sorted(os.listdir(d2))
    _trim(d2, 4)
    return {"outs": outs, "want4": want4, "want3": one_process(small(3)),
            "resume21": one_process(small(4), ckpt_dir=d2, resume=True),
            "steps2": steps2}


def test_split_sweep_bitwise(two_ranks):
    for r, o in enumerate(two_ranks["outs"]):
        got = o["split4"]
        assert got["own"] == [2 * r, 2 * r + 1]
        assert_same(got, two_ranks["want4"])
        # each boundary gathers the chunk's stats, evals and carries
        assert got["bytes"]["all_gather_arms"] > 0
    # the carry's leaves: w, Adam's m, t and v, ...: the moments moved
    carry = two_ranks["want4"]["state"][0]
    assert float(carry[1].abs().sum()) > 0 and float(carry[3].sum()) > 0


def test_replicated_sweep_bitwise(two_ranks):
    for o in two_ranks["outs"]:
        got = o["rep3"]
        assert got["own"] == [0, 1, 2]
        assert_same(got, two_ranks["want3"])
        assert "all_gather_arms" not in got["bytes"]


def test_resume_one_to_two(two_ranks):
    for o in two_ranks["outs"]:
        assert_same(o["resume12"], two_ranks["want4"], tail=4)


def test_resume_two_to_one(two_ranks):
    """The checkpoint world rank 0 wrote holds every arm, at every
    boundary, and one process finishes it."""
    assert two_ranks["steps2"] == [f"step_{s:08d}" for s in (1, 4, 7, 8)]
    assert_same(two_ranks["resume21"], two_ranks["want4"], tail=4)


def test_resume_checks_on_every_rank(two_ranks):
    """Every rank refuses a checkpoint written under other arms, a resume
    without a checkpoint directory, and a step off the cadence."""
    for o in two_ranks["outs"]:
        assert "different arms" in o["other_arms"]["refused"]
        assert "needs ckpt_dir" in o["no_ckpt"]["refused"]
        assert "chunk boundary" in o["off_cadence"]["refused"]


def test_records_on_the_wire_device(two_ranks):
    """Every leaf that the split and resumed sweeps hand to
    ``gather_rows`` and ``replicated`` lies on ``wire_device`` of the
    group they pass, the CPU under gloo; the replicated sweep, which
    saves nothing, hands them nothing."""
    for o in two_ranks["outs"]:
        for name in ("split4", "resume12", "mlp"):
            calls = o[name]["wire"]
            assert calls, name
            for fn, devices, want, _ in calls:
                assert devices == [want] == ["cpu"], (name, fn)
            assert {fn for fn, _, _, none in calls if not none} \
                == {"gather_rows"}, name
        assert o["rep3"]["wire"] == []
        assert o["split4"]["backend"] == "gloo"


def test_world_of_one_gathers(tmp_path):
    """A world of one splits its arms over W = 1 worker: each boundary's
    records go through the group's all-gather, on ``wire_device``'s CPU
    under gloo; the result is the one-process sweep bit for bit, and the
    checkpoint it wrote resumes in one process."""
    d = str(tmp_path / "ck")
    (o,) = run_world("sweep", 1, {"runs": {"split4": small(4, ckpt=d)}},
                     tmp_path, timeout=300)
    got, want = o["split4"], one_process(small(4))
    assert got["own"] == [0, 1, 2, 3]
    assert_same(got, want)
    assert got["bytes"]["all_gather_arms"] > 0
    assert {fn for fn, _, _, none in got["wire"] if not none} \
        == {"gather_rows"}
    assert all(devices == [w] == ["cpu"] for _, devices, w, _ in got["wire"])
    _trim(d, 4)
    assert_same(one_process(small(4), ckpt_dir=d, resume=True), want,
                tail=4)


def test_split_sweep_matches_reference(two_ranks, mlp, task):
    want, spec = mlp
    ours = one_process(spec, draws=Draws(*spec["draws"]))
    for o in two_ranks["outs"]:
        got = o["mlp"]
        assert_same(got, ours)
        np.testing.assert_array_equal(got["n_scheduled"].numpy(),
                                      want["n_scheduled"])
        np.testing.assert_allclose(got["b_t"].numpy(), want["b_t"],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["rt_bound"].numpy(),
                                   want["rt_bound"], rtol=1e-6)
        np.testing.assert_allclose(got["loss"].numpy(), want["loss"],
                                   rtol=1e-4)
        for k, v in task["p0"].items():
            jp = np.asarray(want["params"][k])
            for a in range(len(SEEDS4)):
                moved = np.linalg.norm(jp[a] - v)
                assert moved > 0
                assert np.linalg.norm(got["params"][k][a].numpy() - jp[a]) \
                    <= 1e-4 * moved, (k, a)


def test_two_by_two_replicas_equal(tmp_path):
    """A 2 x 2 world: worker group d runs arms [2d, 2d + 2), the two ranks
    of its model group the same ones, checked equal at every save; every
    rank returns the one-process sweep, and world rank 0's checkpoint
    resumes in one process."""
    d = str(tmp_path / "ck")
    outs = run_world("sweep", 4, {"runs": {"split4": small(4, M=2, ckpt=d)}},
                     tmp_path, timeout=300, model_parallel=2)
    want = one_process(small(4))
    for r, o in enumerate(outs):
        got = o["split4"]
        assert got["own"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert_same(got, want)
        # gathers over the worker group, replica checks over the model
        # group, every leaf on the CPU
        assert {fn for fn, _, _, none in got["wire"] if not none} \
            == {"gather_rows", "replicated"}
        assert all(devices == [w] == ["cpu"]
                   for _, devices, w, _ in got["wire"])
    _trim(d, 4)
    assert_same(one_process(small(4), ckpt_dir=d, resume=True), want,
                tail=4)
