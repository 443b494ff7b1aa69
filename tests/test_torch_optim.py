"""The port's optimizers, schedules, error-feedback step and worker
transmit (``repro_torch.optim``, ``repro_torch.fl.worker.transmit``)
against ``repro.optim`` and ``repro.fl.worker``, on the CPU, from the same
numpy-seeded inputs.

Tolerances:
- ``sgd``, ``momentum`` (plain and Nesterov) and ``adam`` over 5 steps of
  the same gradients, on a parameter dict and on one chunked array:
  parameters and every moment rtol 1e-5 (atol 1e-7 for entries near 0),
  Adam's step counter exact; the registry's names and errors exact.
- ``constant``, ``cosine_decay``, ``warmup_cosine`` at every step of their
  range and past it: rtol 1e-5.
- ``ef_step``/``with_error_feedback`` with a top-κ compressor: the kept
  masks exact, values rtol 1e-6.
- ``transmit``: the sign pattern exact where |x·Φ_s| is clear of f32
  rounding (two libraries sum D products in different orders), the
  weighted symbols and the chunk norms rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jopt
from repro.core.obcsaa import OBCSAAConfig as JOB
from repro.core.sparsify import topk_sparsify as jtopk
from repro.fl.worker import transmit as jtransmit
import repro_torch.optim as topt
from repro_torch.core.obcsaa import OBCSAAConfig as TOB
from repro_torch.core.sparsify import topk_sparsify as ttopk
from repro_torch.fl import transmit as ttransmit
from repro_torch.tree import leaves

RTOL, ATOL = 1e-5, 1e-7


def _params(rng):
    return {"w1": rng.normal(size=(6, 5)).astype(np.float32),
            "b1": rng.normal(size=(5,)).astype(np.float32),
            "w2": rng.normal(size=(5, 3)).astype(np.float32)}


def _both(tree_np):
    jt = jax.tree_util.tree_map(jnp.asarray, tree_np)
    tt = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                tree_np)
    return jt, tt


def _close(got, want):
    for g, w in zip(leaves(got), jax.tree_util.tree_leaves(want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


OPTS = [("sgd", {}), ("momentum", {"beta": 0.9}),
        ("momentum", {"beta": 0.8, "nesterov": True}),
        ("adam", {}), ("adam", {"b1": 0.5, "b2": 0.9, "eps": 1e-6})]


@pytest.mark.parametrize("name,kw", OPTS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(OPTS)])
@pytest.mark.parametrize("layout", ["dict", "chunked"])
def test_optimizer_matches_reference(name, kw, layout):
    rng = np.random.default_rng(5)
    p_np = (_params(rng) if layout == "dict"
            else rng.normal(size=(3, 64)).astype(np.float32))
    jp, tp = _both(p_np)
    jo, to = jopt.make(name, **kw), topt.make(name, **kw)
    js, ts = jo.init(jp), to.init(tp)
    _close(ts, js)
    for step in range(5):
        g_np = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), p_np)
        jg, tg = _both(g_np)
        lr = 0.05 * (step + 1)
        jp, js = jo.update(jg, js, jp, lr)
        tp, ts = to.update(tg, ts, tp, torch.tensor(lr))
        _close(tp, jp)
        _close(ts, js)
    if name == "adam":
        assert ts["t"].dtype == torch.int32 and ts["t"].ndim == 0
        assert int(ts["t"]) == 5
    if name != "sgd":
        assert any(float(x.abs().sum()) > 0 for x in leaves(ts))


def test_moments_are_f32_and_registry_matches():
    p = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    st = topt.make("adam").init(p)
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.float32
    assert topt.momentum().init(p)["w"].dtype == torch.float32
    assert sorted(topt.OPTIMIZERS) == sorted(jopt.OPTIMIZERS)
    assert topt.__all__ == jopt.__all__
    with pytest.raises(ValueError) as want:
        jopt.make("lion")
    with pytest.raises(ValueError) as got:
        topt.make("lion")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("sched,args", [
    ("constant", (0.3,)), ("cosine_decay", (0.1, 20)),
    ("cosine_decay", (0.2, 7, 0.0)), ("warmup_cosine", (0.1, 5, 30)),
    ("warmup_cosine", (0.5, 1, 4, 0.3))])
def test_schedules_match_reference(sched, args):
    jf, tf = getattr(jopt, sched)(*args), getattr(topt, sched)(*args)
    steps = np.arange(0, 40, dtype=np.int32)
    want = np.asarray(jax.vmap(jf)(jnp.asarray(steps)))
    got = tf(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(want,
                                                            steps.shape),
                               rtol=RTOL)
    for s in (0, 3, 25):
        np.testing.assert_allclose(float(tf(s)), float(jf(s)), rtol=RTOL)


@pytest.mark.parametrize("k", [1, 7, 32])
def test_ef_step_and_wrapper_match_reference(k):
    rng = np.random.default_rng(k)
    g = rng.normal(size=(4, 96)).astype(np.float32)
    e = 0.1 * rng.normal(size=(4, 96)).astype(np.float32)

    def japprox(x):
        sp, mask = jtopk(x, k)
        return mask, sp

    def tapprox(x):
        sp, mask = ttopk(x, k)
        return mask, sp

    jout, jres, jcorr = jopt.ef_step(jnp.asarray(g), jnp.asarray(e), japprox)
    tout, tres, tcorr = topt.ef_step(torch.from_numpy(g),
                                     torch.from_numpy(e), tapprox)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert int(tout.sum()) == 4 * k
    np.testing.assert_allclose(tres.numpy(), np.asarray(jres), rtol=1e-6)
    np.testing.assert_allclose(tcorr.numpy(), np.asarray(jcorr), rtol=1e-6)
    # the residual keeps exactly what the top-κ dropped
    assert not (tres.numpy() * tout.numpy()).any()

    jw, jr = jopt.with_error_feedback(japprox)(jnp.asarray(g),
                                                jnp.asarray(e))
    tw, tr = topt.with_error_feedback(tapprox)(torch.from_numpy(g),
                                               torch.from_numpy(e))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)


@pytest.mark.parametrize("d,beta_i", [(1000, 1.0), (2500, 1.0), (700, 0.0)])
def test_transmit_matches_reference(d, beta_i):
    kw = dict(chunk=512, measure=128, topk=24)
    job, tob = JOB(**kw), TOB(**kw)
    rng = np.random.default_rng(d)
    g = rng.normal(size=d).astype(np.float32)
    phi = np.array(job.phi())
    jsym, jmags = jtransmit(job, jnp.asarray(g),
                            k_weight=jnp.float32(300),
                            beta_i=jnp.float32(beta_i),
                            b_t=jnp.float32(0.02))
    tsym, tmags = ttransmit(tob, torch.from_numpy(g),
                            k_weight=torch.tensor(300.0),
                            beta_i=torch.tensor(beta_i),
                            b_t=torch.tensor(0.02),
                            phi=torch.from_numpy(phi))
    n = -(-d // 512)
    assert tuple(tsym.shape) == (n, 128) and tuple(tmags.shape) == (n,)
    np.testing.assert_allclose(tmags.numpy(), np.asarray(jmags), rtol=1e-6)
    gpad = np.pad(g, (0, n * 512 - d)).reshape(n, 512)
    sp = np.asarray(jtopk(jnp.asarray(gpad), 24)[0])
    proj = sp.astype(np.float64) @ phi.T.astype(np.float64)
    clear = np.abs(proj) > 2 * 512 * 2.0 ** -24 * np.linalg.norm(
        sp, axis=1, keepdims=True) * np.linalg.norm(phi, axis=1)[None]
    got, want = tsym.numpy(), np.asarray(jsym)
    np.testing.assert_allclose(got[clear], want[clear], rtol=1e-6)
    if beta_i == 0.0:
        assert not got.any()
