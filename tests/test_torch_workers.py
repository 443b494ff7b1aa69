"""The federation over processes: ``shardmap_aggregate`` and
``launch.steps.make_train_step`` at U = 4 gloo ranks on the CPU, the
U workers in turn in one process, the P2-scheduled round contexts, the
multi-round step and the CLI (``--scan-rounds``, ``torchrun``), against
single-device oracles built from the reference's own functions
(``simulate_round``, ``compress_chunks``, gradients of ``loss_fn``) with
the reference's Φ and AWGN injected. The ranks import no JAX
(``_torch_dist_child``).

Tolerances:
- exact: every rank's result against every other's (the PS decodes and
  broadcasts ĝ); ``shardmap_aggregate`` at 4 ranks against the port's
  own ``simulate_round`` (b_t = 1.5 and two workers scheduled: every
  partial sum of the MAC is exact in f32, so the sum order cannot show);
  the scheduled contexts' β and the generator seeds against the
  reference's; the multi-round step against the same rounds stepped one
  at a time; the ``--scan-rounds`` resume against the uninterrupted run.
- b_t within 1 ulp of the reference's (XLA fuses the last step of R_t
  into an FMA; ROADMAP Queue 3).
- decoded gradients against the reference's per-leaf ``simulate_round``
  of the reference's per-worker gradients, chunk by chunk: at most 1% of
  a leaf's 1024-chunks (and at least one) may part, farther than 1e-4
  of their own norm; the rest NMSE ≤ 1e-6, the leaf's support overlap ≥
  0.99. The packages' f32 gradients differ by ~2e-6 of their max, enough
  to move a near tie of a worker's top-κ or flip a borderline sign, and
  one such lane changes every later BIHT iterate of its chunk: with 4
  workers of mixtral's smoke model 1 and 2 of the 1,024 chunks of its
  ``ew1`` and ``ew3`` leaves parted (ROADMAP Queue 3 records the same
  for one worker, and the zoo's ≤ 1%). The same bounds hold the process
  group against the in-turn path.
- parameters after the step within 1e-4 of their movement ‖p₁ − p₀‖
  (the reference's, or the in-turn path's), or with at most 1% of the
  movement's chunks parted as above; losses rtol 1e-5.

The CS geometry is the CLI's (chunks of 1024, S_c = 256, κ_c = 64) with
BIHT 3, not 10, to keep the file near a minute and a half.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_child import run_world
from repro import configs as jcfg
from repro.core import channel as jchan
from repro.core import obcsaa as job
from repro.launch import steps as jsteps
from repro.models.registry import build_model as jbuild
from repro.sched.scenario import ScenarioConfig as JScenario
from repro.sched.scenario import generate as jgenerate
from repro_torch import configs as tcfg
from repro_torch import tree
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import obcsaa as tob
from repro_torch.data import token_stream
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_zoo_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import build_model as tbuild

ROOT = os.path.join(os.path.dirname(__file__), "..")
U = 4
CS = dict(cs_chunk=1024, cs_measure=256, cs_topk=64, biht_iters=3,
          learning_rate=3e-2)


def _np(a):
    return np.array(a, copy=True)


def _t(a):
    return torch.from_numpy(_np(a))


# --- shardmap_aggregate at 4 ranks -----------------------------------------

AGG = dict(chunk=1024, measure=256, topk=32, biht_iters=10)
AGG_D = 3000                              # 3 chunks, the last padded
AGG_BETA = np.array([0, 1, 1, 0], np.float32)    # the PS unscheduled
AGG_BT = 1.5


@pytest.fixture(scope="module")
def aggregated(tmp_path_factory):
    rng = np.random.default_rng(0)
    grads = rng.standard_normal((U, AGG_D)).astype(np.float32)
    gpad = np.pad(grads, ((0, 0), (0, (-AGG_D) % 1024)))
    jo = job.OBCSAAConfig(**AGG)
    nkey = jax.random.PRNGKey(7)
    noise = _np(jchan.draw_noise(nkey, (3, 256), jo.noise_var))
    cfgs = {"f32": dict(AGG), "packed": dict(AGG, packed=True)}
    outs = run_world("aggregate", U, {
        "cfgs": cfgs, "grads": _t(gpad), "beta": _t(AGG_BETA),
        "b_t": torch.tensor(AGG_BT), "phi": _t(jo.phi()), "noise":
        _t(noise)}, tmp_path_factory.mktemp("agg"))
    return grads, jo, nkey, noise, cfgs, outs


@pytest.mark.parametrize("codec", ["f32", "packed"])
def test_shardmap_aggregate_4_ranks(aggregated, codec):
    """Every rank decodes the same ĝ: bit for bit the port's centralized
    ``simulate_round`` on the same Φ and AWGN, and within the decode's
    bounds of the reference's ``simulate_round``."""
    grads, jo, nkey, noise, cfgs, outs = aggregated
    got = [o[codec] for o in outs]
    for g in got[1:]:
        assert torch.equal(g, got[0])
    ones = np.ones(U, np.float32)
    cfg = tob.OBCSAAConfig(**cfgs[codec])
    own, _ = tob.simulate_round(cfg, _t(grads), _t(ones), _t(AGG_BETA),
                                torch.tensor(AGG_BT), _t(ones),
                                phi=_t(jo.phi()), noise=_t(noise))
    assert torch.equal(got[0][:AGG_D], own)
    want, _ = job.simulate_round(
        job.OBCSAAConfig(**cfgs[codec]), jnp.asarray(grads),
        jnp.asarray(ones), jnp.asarray(AGG_BETA), jnp.float32(AGG_BT),
        jnp.asarray(ones), nkey)
    _gate(got[0][:AGG_D].numpy(), _np(want), codec)


def _parted(n_chunks: int) -> int:
    """Chunks of a leaf that may part: 1%, at least one."""
    return max(1, n_chunks // 100)


def _gate(g, w, what, parted: bool = False):
    """ĝ against the oracle's: NMSE ≤ 1e-6 and support overlap ≥ 0.99;
    with ``parted``, ``_parted`` of the 1024-chunks may be apart (and are
    left out of the NMSE)."""
    assert np.isfinite(g).all(), what
    apart = _apart(w, g)
    assert apart.sum() <= (_parted(apart.size) if parted else 0), \
        (what, int(apart.sum()))
    keep = np.repeat(~apart, 1024)[:w.size]
    nmse = np.sum((g - w)[keep] ** 2) / max(np.sum(w[keep] ** 2), 1e-30)
    overlap = np.sum((g != 0) & (w != 0)) / max(np.sum(w != 0), 1)
    assert nmse <= 1e-6 and overlap >= 0.99, (what, nmse, overlap)


def _apart(want, got, chunk=1024, rel=1e-4):
    """Which chunks of a flat vector are farther apart than ``rel`` of
    their own norm."""
    pad = (-want.size) % chunk
    w = np.pad(np.ravel(want), (0, pad)).reshape(-1, chunk)
    g = np.pad(np.ravel(got), (0, pad)).reshape(-1, chunk)
    return np.linalg.norm(g - w, axis=1) > rel * np.linalg.norm(w, axis=1)


# --- make_train_step at 4 ranks ------------------------------------------

# (arch, agg, seq, per-step (β, b_t)); T/W = seq tokens a worker: the
# MoE cases at 64 dispatch per worker, at 32 every token together
CASES = {
    "gemma2_obcsaa": ("gemma2-2b", "obcsaa", 32, [((0, 1, 0, 1), 2.5)]),
    "gemma2_mean": ("gemma2-2b", "mean", 32, [None]),
    "mixtral_obcsaa": ("mixtral-8x22b", "obcsaa", 32, [((1, 0, 1, 1), 1.25)]),
    "mixtral_mean_shard": ("mixtral-8x22b", "mean", 64, [None]),
    "mixtral_mean_global": ("mixtral-8x22b", "mean", 32, [None]),
}


def _ref_model(arch):
    jc = jcfg.scaled(jcfg.get_smoke_config(arch), dtype="float32")
    jm = jbuild(jc)
    return jc, jm, jm.init(jax.random.PRNGKey(0))


def _ctxs(case, jp, jo):
    """Per step: β, b_t, the reference's Φ and leaf i's AWGN
    ``fold_in(PRNGKey(10 + t), i)``."""
    out = []
    leaves = jax.tree_util.tree_leaves(jp)
    for t, sched in enumerate(CASES[case][3]):
        if sched is None:
            out.append({})
            continue
        beta, b_t = sched
        key = jax.random.PRNGKey(10 + t)
        out.append({"beta": torch.tensor(beta, dtype=torch.float32),
                    "b_t": torch.tensor(b_t), "phi": _t(jo.phi()),
                    "noise": [_t(jchan.draw_noise(
                        jax.random.fold_in(key, i),
                        (-(-leaf.size // 1024), 256), jo.noise_var))
                        for i, leaf in enumerate(leaves)]})
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    jo = jsteps.obcsaa_config(jcfg.TrainConfig(aggregation="obcsaa", **CS))
    cases, refs = {}, {}
    for name, (arch, agg, seq, _) in CASES.items():
        jc, jm, jp = _ref_model(arch)
        tok, tgt = token_stream(U, seq, jc.vocab_size, seed=0)
        cases[name] = {
            "arch": arch, "agg": agg, "ctxs": _ctxs(name, jp, jo),
            "params": lm_params_from_reference(
                jax.tree_util.tree_map(np.asarray, jp), device="cpu"),
            "batch": {"tokens": torch.from_numpy(tok),
                      "targets": torch.from_numpy(tgt)}}
        refs[name] = (jm, jp, {"tokens": jnp.asarray(tok),
                               "targets": jnp.asarray(tgt)})
    outs = run_world("train", U, {"cases": cases, "cs": CS},
                     tmp_path_factory.mktemp("train"))
    return jo, cases, refs, outs


def _ref_step(jo, jm, jp, jb, agg, ctx, per_shard):
    """The reference's step from its own functions: per-worker
    gradients, then per leaf ``simulate_round`` (``obcsaa``) or the
    gradient of the global mean loss (``mean``; per-shard MoE dispatch
    is the mean of the shards' gradients), and SGD."""
    def loss(p, b):
        return jm.loss_fn(p, b, remat=False)[0]

    vg = jax.jit(jax.value_and_grad(loss))
    shards = [{k: v[u:u + 1] for k, v in jb.items()} for u in range(U)]
    if agg == "mean" and not per_shard:
        lval, g = vg(jp, jb)
        ghat = None
    else:
        lg = [vg(jp, s) for s in shards]
        lval = np.mean([float(v) for v, _ in lg])
        g = jax.tree_util.tree_map(lambda *x: sum(x) / U,
                                   *[g for _, g in lg])
        ghat = None
        if agg == "obcsaa":
            leaves = [jax.tree_util.tree_leaves(g) for _, g in lg]
            ones = jnp.ones((U,), jnp.float32)
            ghat = []
            for i, leaf in enumerate(leaves[0]):
                flat = jnp.stack([lv[i].reshape(-1) for lv in leaves])
                noise = jnp.asarray(ctx["noise"][i].numpy())
                gh = _simulate_injected(jo, flat, ones,
                                        jnp.asarray(ctx["beta"].numpy()),
                                        jnp.float32(ctx["b_t"]), noise)
                ghat.append(gh.reshape(leaf.shape))
            g = jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(g), ghat)
    new = jax.tree_util.tree_map(lambda p, d: p - CS["learning_rate"] * d,
                                 jp, g)
    return float(lval), new, ghat


@functools.partial(jax.jit, static_argnums=0)
def _simulate_injected(jo, flat, k, beta, b_t, noise):
    """``simulate_round``'s body (``repro/core/obcsaa.py``) with the AWGN
    given: the reference's ``compress_chunks``, the MAC's einsum plus
    ``noise`` (eq. 12), post-processing (eq. 13) and
    ``reconstruct_chunks``."""
    U_, D = flat.shape
    pad = (-D) % jo.chunk
    gpad = jnp.pad(flat, ((0, 0), (0, pad)))
    phi = jo.phi()
    signs, mags = jax.vmap(lambda g: job.compress_chunks(jo, g, phi))(gpad)
    w = k * beta * b_t
    y = jnp.einsum("u,ucs->cs", w, signs) + noise
    denom = jnp.maximum(jnp.sum(k * beta) * b_t, 1e-12)
    mbar = jnp.einsum("u,uc->c", k * beta, mags) / jnp.maximum(
        jnp.sum(k * beta), 1e-12)
    return job.reconstruct_chunks(jo, y / denom, mbar, phi)[:D]


def _movement_gate(got, want, start, rel, what):
    """Each leaf within ``rel`` of its movement, or with ``_parted`` of
    the movement's 1024-chunks apart."""
    for i, (g, w, s) in enumerate(zip(got, want, start)):
        g, w, s = (np.asarray(a, np.float64) for a in (g, w, s))
        moved = np.linalg.norm(w - s)
        if np.linalg.norm(g - w) <= rel * max(moved, 1e-30):
            continue
        apart = _apart(w - s, g - s)
        assert 0 < apart.sum() <= _parted(apart.size), (what, i)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_ranks_identical(trained, case):
    """Every rank holds the same parameters, bit for bit."""
    _, _, _, outs = trained
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in
                   zip(o[case]["params"], outs[0][case]["params"]))
        assert o[case]["losses"] == outs[0][case]["losses"]


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference(trained, case):
    """Step 0 of each case against the reference's own functions."""
    jo, cases, refs, outs = trained
    arch, agg, seq, _ = CASES[case]
    jm, jp, jb = refs[case]
    ctx = cases[case]["ctxs"][0]
    lval, new, ghat = _ref_step(jo, jm, jp, jb, agg, ctx,
                                per_shard=seq >= tmoe.MIN_SHARD_TOKENS)
    got = outs[0][case]
    assert got["losses"][0] == pytest.approx(lval, rel=1e-5)
    if ghat is not None:
        for i, (g, w) in enumerate(zip(got["decoded"][0], ghat)):
            _gate(g.numpy()[:w.size], _np(w).ravel(), (case, i), parted=True)
    _movement_gate(got["params"], jax.tree_util.tree_leaves(new),
                   jax.tree_util.tree_leaves(jp), 1e-4, case)


@pytest.mark.parametrize("case", list(CASES))
def test_process_group_matches_in_turn(trained, case):
    """The same steps with the U workers in turn in one process."""
    _, cases, _, outs = trained
    arch, agg, _, _ = CASES[case]
    c = cases[case]
    model = tbuild(tcfg.scaled(tcfg.get_smoke_config(arch),
                               dtype="float32"))
    tt = tcfg.TrainConfig(aggregation=agg, **CS)
    step = tsteps.make_train_step(model, tt, make_zoo_mesh(U, 1))
    params = c["params"]
    opt_state = tsteps.make_optimizer(tt).init(params)
    for t, ctx in enumerate(c["ctxs"]):
        got = {}
        hook = (lambda stage, i, grad, dec:
                got.__setitem__(i, dec.clone()) if stage == "decode"
                else None)
        params, opt_state, m = step(params, opt_state, c["batch"],
                                    dict(ctx, hook=hook))
        assert float(m["loss"]) == pytest.approx(
            outs[0][case]["losses"][t], rel=1e-5)
        for i in got:
            _gate(outs[0][case]["decoded"][t][i].numpy(), got[i].numpy(),
                  (case, t, i), parted=True)
    _movement_gate(outs[0][case]["params"], tree.leaves(params),
                   tree.leaves(c["params"]), 1e-4, case)


def test_process_group_wire_bytes(trained):
    """The uplink is one f32 all-reduce of (n_chunks, S_c) a leaf plus
    ksum and mag_sum; the downlink the PS's broadcast of the decoded
    chunks."""
    _, cases, _, outs = trained
    leaves = tree.leaves(cases["gemma2_obcsaa"]["params"])
    chunks = sum(-(-x.numel() // 1024) for x in leaves)
    steps = len(CASES["gemma2_obcsaa"][3])
    want_up = steps * (chunks * 256 * 4 + len(leaves) * 4 + chunks * 4 + 4)
    for o in outs:
        got = o["gemma2_obcsaa"]["bytes"]
        assert got["all_reduce"] == want_up
        assert got["broadcast"] == steps * chunks * 1024 * 4


def test_batch_must_split_over_workers():
    with pytest.raises(ValueError, match="does not split over 4 workers"):
        tsteps.shard_batch({"tokens": torch.zeros(6, 3)}, 0, 4)


# --- the P2-scheduled round contexts ---------------------------------------

def _amesh():
    return jax.sharding.AbstractMesh((U, 1), ("data", "model"))


@pytest.mark.parametrize("D", [1_312_000, 493_982_720])
def test_scheduled_round_ctx_matches_reference(D):
    jt = jcfg.TrainConfig(aggregation="obcsaa")
    tt = tcfg.TrainConfig(aggregation="obcsaa")
    ref = jsteps.make_scheduled_round_ctx(_amesh(), jt, D, seed=3)
    traj = _np(jgenerate(JScenario(rounds=256, cells=1, workers=U),
                         jax.random.PRNGKey(3)))
    got = tsteps.make_scheduled_round_ctx(make_zoo_mesh(U, 1), tt, D,
                                          seed=3, trajectory=traj,
                                          device="cpu")
    for t in (0, 1, 5, 257):
        r, g = ref(t), got(t)
        np.testing.assert_array_equal(g["h"].numpy(), _np(r["h"]))
        np.testing.assert_array_equal(g["beta"].numpy(), _np(r["beta"]))
        b = _np(r["b_t"])
        assert abs(float(g["b_t"]) - float(b)) <= np.spacing(b)
        assert g["generator"].initial_seed() == 3 * 100003 + t


@pytest.mark.parametrize("D", [1_312_000, 493_982_720])
def test_scheduled_round_span_matches_reference(D):
    jt = jcfg.TrainConfig(aggregation="obcsaa")
    tt = tcfg.TrainConfig(aggregation="obcsaa")
    n = 6
    ref = jsteps.make_scheduled_round_span(_amesh(), jt, D, n, seed=2)
    traj = _np(jgenerate(JScenario(rounds=n, cells=1, workers=U),
                         jax.random.PRNGKey(2)))
    got = tsteps.make_scheduled_round_span(make_zoo_mesh(U, 1), tt, D, n,
                                           seed=2, trajectory=traj,
                                           device="cpu")
    np.testing.assert_array_equal(got["h"].numpy(), _np(ref["h"]))
    np.testing.assert_array_equal(got["beta"].numpy(), _np(ref["beta"]))
    b = _np(ref["b_t"])
    assert np.all(np.abs(got["b_t"].numpy() - b) <= np.spacing(b))
    assert got["seed"].tolist() == [2 * 100003 + t for t in range(n)]


# --- the multi-round step ------------------------------------------------

def _mlp():
    cfg = tcfg.get_config("mnist-mlp")
    tt = tcfg.TrainConfig(aggregation="obcsaa", cs_chunk=512,
                          cs_measure=64, cs_topk=16, biht_iters=2)
    return cfg, tbuild(cfg), tt


def test_scan_step_equals_stepped_rounds():
    """``make_scan_train_step`` over a scheduled span of U = 4 workers in
    turn ≡ the same rounds stepped one at a time, bit for bit."""
    cfg, model, tt = _mlp()
    mesh = make_zoo_mesh(U, 1)
    params = model.init(0, device="cpu")
    opt = tsteps.make_optimizer(tt)
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.standard_normal((8, 784))
                                   .astype(np.float32)),
             "y": torch.from_numpy(rng.integers(0, 10, 8))}
    n = 3
    span = tsteps.make_scheduled_round_span(mesh, tt, 50890, n,
                                            device="cpu")
    scan = tsteps.make_scan_train_step(model, tt, mesh, n)
    p1, o1, m1 = scan(params, opt.init(params), batch, span)
    step = tsteps.make_train_step(model, tt, mesh)
    p2, o2 = params, opt.init(params)
    losses = []
    for t in range(n):
        p2, o2, m = step(p2, o2, batch, {k: v[t] for k, v in span.items()})
        losses.append(m["loss"])
    assert m1["loss"].shape == (n,)
    assert torch.equal(m1["loss"], torch.stack(losses))
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(p1), tree.leaves(p2)))


def test_scan_step_matches_reference():
    """U = 1 (``tests/test_engine.py``'s geometry): the reference's
    ``make_scan_train_step`` over its own span against the port's over
    the same β, b_t, Φ and per-round AWGN."""
    from jax.sharding import Mesh
    jc = jcfg.get_config("mnist-mlp")
    jt = jcfg.TrainConfig(aggregation="obcsaa", cs_chunk=512,
                          cs_measure=64, cs_topk=16, biht_iters=2)
    jm = jbuild(jc)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    n = 3
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 784)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    with jax.set_mesh(mesh):
        jp = jm.init(jax.random.PRNGKey(0))
        D = sum(int(np.prod(leaf.shape))
                for leaf in jax.tree_util.tree_leaves(jp))
        span = jsteps.make_scheduled_round_span(mesh, jt, D, n)
        step = jax.jit(jsteps.make_scan_train_step(jm, jt, mesh, n))
        jp2, _, jmet = step(jp, jsteps.make_optimizer(jt).init(jp),
                            {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                            span)
    _, model, tt = _mlp()
    jo = jsteps.obcsaa_config(jt)
    leaves = jax.tree_util.tree_leaves(jp)
    noise = [[_t(jchan.draw_noise(jax.random.fold_in(span["key"][t], i),
                                  (-(-leaf.size // 512), 64), jo.noise_var))
              for i, leaf in enumerate(leaves)] for t in range(n)]
    ctxs = {"beta": _t(span["beta"]), "b_t": _t(span["b_t"]),
            "h": _t(span["h"]), "seed": torch.arange(n), "noise": noise,
            "phi": _t(jo.phi())}
    tp = {k: _t(v) for k, v in jp.items()}
    scan = tsteps.make_scan_train_step(model, tt, make_zoo_mesh(1, 1), n)
    tp2, _, met = scan(tp, tsteps.make_optimizer(tt).init(tp),
                       {"x": _t(x), "y": _t(y)}, ctxs)
    np.testing.assert_allclose(met["loss"].numpy(), _np(jmet["loss"]),
                               rtol=1e-5)
    _movement_gate([tp2[k] for k in sorted(tp2)],
                   [_np(jp2[k]) for k in sorted(jp2)],
                   [_np(jp[k]) for k in sorted(jp)], 1e-4, "mnist-mlp")


# --- the CLI ---------------------------------------------------------------

def _ckpt(path, steps):
    model = tbuild(tcfg.get_smoke_config("gemma2-2b"))
    got = tsteps.restore_train_state(path, model, tcfg.TrainConfig(), "cpu")
    assert got[2] == steps
    return tree.leaves(got[0])


def test_cli_scan_rounds_resume(tmp_path, capsys):
    """``--scan-rounds``: a checkpoint at each chunk boundary; 1 round
    then ``--resume`` to 2 ≡ 2 uninterrupted, bit for bit; a resume off
    a boundary exits non-zero with the reference's message."""
    base = ["--device", "cpu", "--smoke", "--seq", "16", "--batch", "1",
            "--cs-measure", "64", "--cs-topk", "16"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert ttrain.main(base + ["--steps", "2", "--scan-rounds", "1",
                               "--ckpt-dir", a]) == 0
    out = capsys.readouterr().out
    assert "rounds    0..0" in out and "rounds    1..1" in out
    assert sorted(os.listdir(a)) == ["step_00000001", "step_00000002"]
    assert ttrain.main(base + ["--steps", "1", "--scan-rounds", "1",
                               "--ckpt-dir", b]) == 0
    with pytest.raises(SystemExit) as e:
        ttrain.main(base + ["--steps", "2", "--scan-rounds", "2",
                            "--ckpt-dir", b, "--resume"])
    assert "does not land on a --scan-rounds 2 chunk boundary" in \
        str(e.value.code)
    assert ttrain.main(base + ["--steps", "2", "--scan-rounds", "1",
                               "--ckpt-dir", b, "--resume"]) == 0
    assert "resumed from step 1" in capsys.readouterr().out
    assert all(torch.equal(x, y) for x, y in zip(_ckpt(a, 2), _ckpt(b, 2)))


def test_cli_torchrun_two_ranks_cpu(tmp_path):
    """``torchrun --nproc-per-node 2`` on the CPU: two workers over gloo,
    the global batch split, rank 0 prints and checkpoints, the replicas
    equal (``--check-replicas``); the checkpoint holds the in-turn path's
    parameters (within the decode's bounds)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    ck = str(tmp_path / "ck")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--smoke", "--steps", "1", "--batch", "2",
         "--seq", "32", "--cs-measure", "64", "--cs-topk", "16",
         "--ckpt-dir", ck, "--check-replicas"], capture_output=True,
        text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert "world: 2 workers over gloo, batch 2 = 2 x 1" in out
    assert sum(ln.startswith("step") for ln in out.splitlines()) == 1
    assert "wire: all_reduce" in out
    assert "replicas: parameters bit-identical on all 2 ranks" in out
    got = _ckpt(ck, 1)
    cfg = tcfg.get_smoke_config("gemma2-2b")
    model = tbuild(cfg)
    tt = tcfg.TrainConfig(aggregation="obcsaa", optimizer="sgd",
                          learning_rate=3e-2, cs_chunk=1024, cs_measure=64,
                          cs_topk=16, biht_iters=10)
    mesh = make_zoo_mesh(2, 1)
    step = tsteps.make_train_step(model, tt, mesh)
    p0 = model.init(0, device="cpu")
    p, o = p0, tsteps.make_optimizer(tt).init(p0)
    batch = ttrain.make_batch(cfg, 2, 32, device="cpu")
    p, o, _ = step(p, o, batch, tsteps.default_round_ctx(
        seed=0, device="cpu", mesh=mesh))
    _movement_gate(got, tree.leaves(p), tree.leaves(p0), 1e-4, "torchrun")
