"""The port's real-backward zoo round (``repro_torch.engine.zoo_train``)
against ``repro.engine.zoo_train``'s single-device oracles
(``reference_round_train``, ``reference_grads``, ``reference_sweep``),
built on a 4 x 2 ``jax.sharding.AbstractMesh``, on the CPU, in f32
compute. The reference's weights (through ``repro_torch.convert``), Φ
and ``fold_in(key, t)`` draws are injected.

Tolerances:
- exact: ``chunk_params`` against the reference's, ``params_from_master``
  against the reference's on the NumPy master, the checkpoint's leaves
  both ways, Adam's step counter, the carry validation messages.
- ``grads_in_layout``: within 1e-5 of the gradient's norm, losses rtol
  1e-5 (f32 forward and backward in two packages).
- ``round_train`` over 2 rounds, each from the reference's carry, every
  carry leaf, chunk by chunk
  (the master through its movement, moments and EF residuals as they
  are): each chunk within 1e-4 of its own norm but for at most 1% of the
  chunks (at least one) per leaf, which may part: the packages' f32
  gradients differ by ~1e-6 of their size, so a near tie of a chunk's
  top-κ or a borderline sign can fall the other way, and the decode
  then parts on that chunk. The held chunks together within 1e-4 of the
  leaf's norm (the master's: of its movement). Loss rtol 1e-5, ‖ĝ‖ and
  b_t rtol 1e-3 / 1e-5. The EF residual is non-zero after a round.
- ``run_sweep`` against ``reference_sweep`` at 2 arms x 2 rounds: the
  same bounds per arm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import checkpoint as jck
from repro.configs import get_smoke_config as jsmoke
from repro.configs.base import scaled as jscaled
from repro.core import channel as jchan
from repro.core import obcsaa as job
from repro.engine import zoo_train as jzt
from repro.models.registry import build_model as jbuild
from repro_torch import tree
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.configs.base import scaled as tscaled
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import obcsaa as tob
from repro_torch.engine import zoo as tzoo
from repro_torch.engine import zoo_train as tzt
from repro_torch.launch.mesh import make_zoo_mesh
from repro_torch.models.registry import build_model as tbuild

PARITY_OB = dict(chunk=256, measure=64, topk=16, biht_iters=3,
                 recon_alg="iht", spmd_topk=True, packed=True,
                 bisect_iters=16)
NV, PMAX, LR = 1e-4, 10.0, 0.05
KEY = 7


def _np(a):
    return np.array(a, copy=True)


class Case:
    """Both packages' rounds for one (arch, optimizer, EF), the weights and
    a (U, ...) batch."""

    def __init__(self, arch, optimizer="sgd", ef=False, w=4, m=2):
        # f32 activations too: in bf16 the two packages' roundings move
        # borderline top-κ entries and signs in most chunks
        jm = jbuild(jscaled(jsmoke(arch), dtype="float32"))
        tm = tbuild(tscaled(tsmoke(arch), dtype="float32"))
        kw = dict(optimizer=optimizer, error_feedback=ef)
        self.jz = jzt.build_zoo_train_round(
            jm, AbstractMesh((w, m), ("data", "model")),
            job.OBCSAAConfig(**PARITY_OB), compute_dtype=jnp.float32, **kw)
        self.tz = tzt.build_zoo_train_round(
            tm, make_zoo_mesh(w, m), tob.OBCSAAConfig(**PARITY_OB),
            compute_dtype=torch.float32, device="cpu",
            phi=_np(job.OBCSAAConfig(**PARITY_OB).phi()), **kw)
        jp = jm.init(jax.random.PRNGKey(0))
        self.jparams = jp
        self.tparams = lm_params_from_reference(
            jax.tree_util.tree_map(_np, jp), device="cpu")
        self.chunked = self.jz.chunk_params(jp)
        U = self.jz.U
        if arch == "mnist-mlp":
            kx, ky = jax.random.split(jax.random.PRNGKey(3))
            raw = {"x": 0.1 * jax.random.normal(kx, (U, 2, 784)),
                   "y": jax.random.randint(ky, (U, 2), 0, 10, jnp.int32)}
        else:
            tok = jax.random.randint(jax.random.PRNGKey(1), (U, 2, 32), 0,
                                     jm.cfg.vocab_size, jnp.int32)
            raw = {"tokens": tok, "targets": jnp.roll(tok, -1, axis=-1)}
        self.raw = raw
        self.batch = self.tz.shard_batch(
            {k: _np(v) for k, v in raw.items()})

    def draws(self, t):
        k_t = jax.random.fold_in(jax.random.PRNGKey(KEY), t)
        h, _ = jchan.draw_fades(jax.random.fold_in(k_t, 0), (self.jz.U,))
        z = jax.random.normal(jax.random.fold_in(k_t, 1),
                              (self.jz.n_chunks, self.jz.ob.measure))
        return tzoo.ZooDraws(torch.from_numpy(_np(h)),
                             torch.from_numpy(_np(z)))


def held_rows(got, want, base=None, share=1e-4):
    """Chunk by chunk (the last axis is D_c): every chunk within ``share``
    of its own norm but for at most 1% of the chunks (at least one); the
    held chunks within ``share`` of the whole. With ``base`` both sides
    are taken as movements from it."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if base is not None:
        got, want = got - base, want - base
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(-1,
                                                             got.shape[-1])
    err = np.linalg.norm(got - want, axis=1)
    parted = err > share * np.linalg.norm(want, axis=1)
    assert parted.sum() <= max(1, got.shape[0] // 100), parted.sum()
    assert np.linalg.norm(err[~parted]) <= share * np.linalg.norm(want)


def held_state(ts, js, base):
    held_rows(ts.master.numpy(), _np(js.master), base=base)
    tl, jl = tree.leaves(ts.opt), jax.tree_util.tree_leaves(js.opt)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        if a.ndim:
            held_rows(a.numpy(), _np(b))
        else:
            assert int(a) == int(b)
    if js.residual is None:
        assert ts.residual is None
    else:
        held_rows(ts.residual.numpy(), _np(js.residual))
        assert float(ts.residual.abs().sum()) > 0


def held_stats(st, rst):
    np.testing.assert_allclose(float(st.loss), float(rst.loss), rtol=1e-5)
    np.testing.assert_allclose(float(st.ghat_norm), float(rst.ghat_norm),
                               rtol=1e-3)
    np.testing.assert_allclose(float(st.b_t), float(rst.b_t), rtol=1e-5)
    assert int(st.n_scheduled) == int(rst.n_scheduled)
    for a, b in zip(st.budget, rst.budget):
        np.testing.assert_allclose(np.asarray(a), _np(b), rtol=1e-3)


@pytest.fixture(scope="module")
def mlp_adam_ef():
    return Case("mnist-mlp", "adam", True)


@pytest.mark.parametrize("arch,opt,ef", [
    ("mnist-mlp", "sgd", False), ("mnist-mlp", "sgd", True),
    ("mnist-mlp", "momentum", False), ("mnist-mlp", "momentum", True),
    ("mnist-mlp", "adam", False), ("mnist-mlp", "adam", True),
    ("gemma2-2b", "sgd", False), ("gemma2-2b", "adam", True)])
def test_round_train_chain_matches_reference(arch, opt, ef):
    """Two rounds (the second with Adam's counter at 2 and a live
    residual): every carry leaf (master, moments, Adam's counter, EF
    residuals) and the stats. Each round starts the port from the
    reference's carry: under Adam a chunk that parted in round 0 moves
    its parameters by ~lr, which moves every gradient of round 1 by
    ~1e-4 of its size and with it many chunks' top-κ (gemma2 smoke: 1,396
    of 5,632 master chunks part in a chained round 1)."""
    c = Case(arch, opt, ef)
    key = jax.random.PRNGKey(KEY)
    js = c.jz.init_state(c.chunked)
    for t in range(2):
        ts = tree.tree_map(lambda x: torch.from_numpy(_np(x)), js)
        ts = tzt.ZooTrainState(ts.master, ts.opt, ts.residual)
        base = _np(js.master).astype(np.float64)
        ts, st = c.tz.round_train(ts, c.batch, t, 0, NV, PMAX, LR,
                                  draws=c.draws(t))
        js, rst = c.jz.reference_round_train(js, c.raw, t, key, NV, PMAX,
                                             LR)
        held_state(ts, js, base)
        held_stats(st, rst)


def test_grads_in_layout_and_params(mlp_adam_ef):
    for c in (mlp_adam_ef, Case("gemma2-2b")):
        np.testing.assert_array_equal(c.tz.chunk_params(c.tparams).numpy(),
                                      _np(c.chunked))
        back = c.tz.params_from_master(torch.from_numpy(_np(c.chunked)))
        want = c.jz.layout.master_to_tree(_np(c.chunked))
        for a, b in zip(tree.leaves(back), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a.numpy(), _np(b))
        np.testing.assert_array_equal(
            c.tz.unchunk(torch.from_numpy(_np(c.chunked))).numpy(),
            _np(c.jz.unchunk(_np(c.chunked))))
        g, losses = c.tz.grads_in_layout(torch.from_numpy(_np(c.chunked)),
                                         c.batch)
        gr, lref = c.jz.reference_grads(c.chunked, c.raw)
        assert np.linalg.norm(g.numpy() - _np(gr)) <= \
            1e-5 * np.linalg.norm(_np(gr))
        np.testing.assert_allclose(losses.numpy(), _np(lref), rtol=1e-5)


def test_sweep_matches_reference():
    """2 arms x 2 rounds, momentum with EF: each arm's carry and the
    (rounds, A) stats against ``reference_sweep`` (every arm of a round
    shares the round's draws)."""
    c = Case("mnist-mlp", "momentum", True)
    A = 2
    jarms = {"noise_var": jnp.array([1e-4, 1e-3], jnp.float32),
             "p_max": jnp.full((A,), 10.0, jnp.float32),
             "lr": jnp.array([0.05, 0.02], jnp.float32)}
    stacked = np.broadcast_to(_np(c.chunked), (A,) + c.chunked.shape)
    js, jst = c.jz.reference_sweep(c.jz.init_sweep_state(
        jnp.asarray(stacked)), c.raw, jarms, 2, key=jax.random.PRNGKey(KEY))
    ts, tst = c.tz.run_sweep(c.tz.init_sweep_state(torch.from_numpy(
        stacked.copy())), c.batch, {k: _np(v) for k, v in jarms.items()}, 2,
        key=0, draws=c.draws)
    for a in range(A):
        held_rows(ts.master[a].numpy(), _np(js.master[a]), base=stacked[a])
        held_rows(ts.opt[a].numpy(), _np(js.opt[a]))
        held_rows(ts.residual[a].numpy(), _np(js.residual[a]))
    assert tst.loss.shape == (2, A)
    np.testing.assert_allclose(tst.loss, _np(jst.loss), rtol=1e-5)
    np.testing.assert_allclose(tst.ghat_norm, _np(jst.ghat_norm), rtol=1e-3)


def test_checkpoints_both_ways(tmp_path, mlp_adam_ef):
    """Adam + EF carry: the reference's ``save_state`` restores in the
    port and continues like the reference; the port's restores in the
    reference's ``checkpoint.restore`` leaf for leaf."""
    c = mlp_adam_ef
    key = jax.random.PRNGKey(KEY)
    js, _ = c.jz.reference_round_train(c.jz.init_state(c.chunked), c.raw,
                                       0, key, NV, PMAX, LR)
    c.jz.save_state(str(tmp_path / "ref"), 1, js, t_next=1)
    ts, t_next = c.tz.restore_state(str(tmp_path / "ref"))
    assert t_next == 1
    for a, b in zip(tree.leaves(ts), jax.tree_util.tree_leaves(js)):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    base = ts.master.numpy().copy()
    ts, _ = c.tz.round_train(ts, c.batch, 1, 0, NV, PMAX, LR,
                             draws=c.draws(1))
    js2, _ = c.jz.reference_round_train(js, c.raw, 1, key, NV, PMAX, LR)
    held_state(ts, js2, base)
    # port -> reference
    path = c.tz.save_state(str(tmp_path / "port"), 2, ts, t_next=2)
    assert path.endswith("step_00000002")
    like = {"state": c.jz.state_template(),
            "t_next": jax.ShapeDtypeStruct((), jnp.int32)}
    got = jck.restore(str(tmp_path / "port"), 2, like)
    assert int(got["t_next"]) == 2
    for a, b in zip(tree.leaves(ts), jax.tree_util.tree_leaves(
            got["state"])):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    assert c.tz.restore_state(str(tmp_path / "none")) is None


def test_state_messages_match_reference(mlp_adam_ef):
    c = mlp_adam_ef
    jz, tz = c.jz, c.tz
    jm, tm = c.chunked, torch.from_numpy(_np(c.chunked))

    def same(fj, ft, kind):
        with pytest.raises(kind) as je:
            fj()
        with pytest.raises(kind) as te:
            ft()
        assert str(te.value) == str(je.value)

    same(lambda: jz.as_state(jm), lambda: tz.as_state(tm), TypeError)
    same(lambda: jz.as_state("x"), lambda: tz.as_state("x"), TypeError)
    jb = jzt.ZooTrainState(jm, jz.optimizer.init(jm), None)
    tb = tzt.ZooTrainState(tm, tz.optimizer.init(tm), None)
    same(lambda: jz._check_state(jb), lambda: tz._check_state(tb),
         ValueError)
    same(lambda: jz._check_state(jb._replace(
        residual=jnp.zeros((1, 2, 3)))),
        lambda: tz._check_state(tb._replace(residual=torch.zeros(1, 2, 3))),
        ValueError)
    c2 = Case("mnist-mlp")
    want = (c2.jz.U, c2.jz.n_chunks, 256)
    same(lambda: c2.jz._check_state(jzt.ZooTrainState(
        jm, (), jnp.zeros(want))),
        lambda: c2.tz._check_state(tzt.ZooTrainState(
            tm, (), torch.zeros(want))), ValueError)
    st = c2.tz.as_state(tm)
    assert st.opt == () and st.residual is None and st.master is tm
    for name in ("n_chunks", "n_half", "n_local", "block", "block_dec",
                 "D", "D_pad"):
        assert getattr(tz, name) == getattr(jz, name), name
    assert tree.leaves(tz.state_template())[0].shape == (jz.n_chunks, 256)
    assert [tuple(x.shape) for x in tree.leaves(tz.state_template(3))] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(
            jz.state_template(3))]
