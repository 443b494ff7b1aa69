"""The port's Theorem-1 budget (``repro_torch.theory.bounds``) and
``sched.problem.rt_from_stats`` against the reference, on the CPU.

Tolerances:
- exact within the port: ``lemma1_error_bound`` equals
  ``ErrorBudget.total_error()`` bit for bit (it is the field-order sum),
  and ``rt()`` is ``scheduling + total_error()``.
- rtol 1e-6 against the reference: every ``ErrorBudget`` field,
  ``rt_objective``, ``bt_term``, ``theorem1_rate``,
  ``theorem1_trajectory``, ``error_floor_asymptote``, ``rt_from_stats``
  and ``reconstruction_constant_traced`` (+inf where δ ≥ √2 − 1). Both
  round the same f32 operations; XLA may fuse a product and a sum into
  one FMA, which moves the last bit.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sched.problem import rt_from_stats as jrt_from_stats
from repro.theory import AnalysisConstants as JAC
from repro.theory import bounds as jb
from repro_torch.core import error_floor
from repro_torch.sched.problem import rt_from_stats
from repro_torch.theory import AnalysisConstants as TAC
from repro_torch.theory import bounds as tb

CONSTS = [dict(), dict(rho1=200.0, G=1.0, delta=0.1, L=4.0, rho2=0.3)]


def _case(shape, seed):
    """β, K, b_t, σ² of ``shape`` rounds/arms over U = 6 workers."""
    rng = np.random.default_rng(seed)
    beta = (rng.random(shape + (6,)) > 0.4).astype(np.float32)
    beta[..., 0] = 1.0
    k = rng.integers(50, 500, shape + (6,)).astype(np.float32)
    b_t = (rng.random(shape) * 1e-2 + 1e-4).astype(np.float32)
    nv = (10.0 ** rng.uniform(-6, -2, shape)).astype(np.float32)
    return beta, k, b_t, nv


def _kw(beta, k, b_t, nv, to):
    return dict(D=50890, S=13 * 1024, kappa=1040, beta=to(beta),
                k_weights=to(k), b_t=to(b_t), noise_var=to(nv))


@pytest.mark.parametrize("const", CONSTS)
@pytest.mark.parametrize("shape", [(), (5,), (3, 4)])
def test_error_budget_matches_reference(const, shape):
    tc, jc = TAC(**const), JAC(**const)
    args = _case(shape, len(shape))
    got = tb.error_budget(tc, **_kw(*args, torch.from_numpy
                                    if shape else torch.tensor))
    want = jb.error_budget(jc, **_kw(*args, jnp.asarray))
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    kw_t = _kw(*args, torch.as_tensor)
    assert torch.equal(tb.lemma1_error_bound(tc, **kw_t), got.total_error())
    assert torch.equal(got.rt(), got.scheduling + got.total_error())
    for fn in ("rt_objective", "bt_term", "lemma1_error_bound"):
        np.testing.assert_allclose(
            getattr(tb, fn)(tc, **kw_t).numpy(),
            np.asarray(getattr(jb, fn)(jc, **_kw(*args, jnp.asarray))),
            rtol=1e-6)


def test_error_budget_traced_delta():
    args = _case((4,), 7)
    delta = np.asarray([0.05, 0.2, 0.3, 0.5], np.float32)
    got = tb.error_budget(TAC(), delta=torch.from_numpy(delta),
                          **_kw(*args, torch.from_numpy))
    want = jb.error_budget(JAC(), delta=jnp.asarray(delta),
                           **_kw(*args, jnp.asarray))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert math.isinf(float(got.reconstruction[-1]))


def test_reconstruction_constant_traced():
    d = np.asarray([0.0, 0.05, 0.2, 0.4, tb.DELTA_MAX, 0.5, 0.99],
                   np.float32)
    got = tb.reconstruction_constant_traced(torch.from_numpy(d)).numpy()
    want = np.asarray(jb.reconstruction_constant_traced(jnp.asarray(d)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isinf(got[d >= tb.DELTA_MAX]).all()
    assert np.isfinite(got[d < tb.DELTA_MAX]).all()
    assert got[2] == pytest.approx(TAC().C, rel=1e-6)


@pytest.mark.parametrize("const", CONSTS)
def test_theorem1_rate_trajectory_and_floor(const):
    tc, jc = TAC(**const), JAC(**const)
    assert tb.theorem1_rate(tc, T=300, f0_minus_fstar=2.3, bt_sum=41.0) == \
        pytest.approx(jb.theorem1_rate(jc, T=300, f0_minus_fstar=2.3,
                                       bt_sum=41.0), rel=1e-12)
    bt = np.random.default_rng(3).random((3, 25)).astype(np.float32)
    got = tb.theorem1_trajectory(tc, 2.0, torch.from_numpy(bt))
    want = jb.theorem1_trajectory(jc, 2.0, jnp.asarray(bt))
    assert tuple(got.shape) == want.shape == (3, 25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    floor = tb.error_floor_asymptote(tc, torch.tensor(0.7))
    np.testing.assert_allclose(float(floor), float(
        jb.error_floor_asymptote(jc, 0.7)), rtol=1e-6)
    flat = tb.theorem1_trajectory(tc, 5.0, torch.full((400,), 0.7))
    assert float(flat[-1]) == pytest.approx(float(floor), rel=1e-5)


def test_rt_from_stats_matches_reference():
    rng = np.random.default_rng(9)
    s1 = np.arange(1, 11, dtype=np.float32)
    s2 = np.cumsum(rng.integers(100, 400, 10)).astype(np.float32)
    b = np.sort(rng.random(10).astype(np.float32))[::-1] * 1e-2 + 1e-4
    coef = dict(ktot=float(s2[-1]), rho1=200.0, A=3.5, E=0.02, N=2e-3)
    got = rt_from_stats(torch.from_numpy(s1), torch.from_numpy(s2),
                        torch.from_numpy(b.copy()), **coef)
    want = jrt_from_stats(jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(b),
                          **coef)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_error_floor_reexports_theory():
    for name in error_floor.__all__:
        assert getattr(error_floor, name) is getattr(tb, name)
