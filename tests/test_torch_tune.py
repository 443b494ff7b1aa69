"""The port's design tuner (``repro_torch.theory.tune``) against
``repro.theory.tune`` on the cases of tests/test_theory.py.

Tolerances:
- exact: ``pareto_mask``, the candidate axes, ``symbols``, ``flops``, the
  frontier mask, ``best`` and the infeasible-budget error.
- δ(κ, S) and R_t: rtol 1e-6 (the same f32 formulas; log, sqrt and the
  eq. 19 sums in another library).
- ``calibrate_delta`` with the reference's Φ and RIP draws injected:
  rtol 1e-5 (the Monte-Carlo maximum over f32 sums of squares).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.measurement import make_phi
from repro.theory import AnalysisConstants as JConst
from repro.theory import tune as jtune
from repro_torch.theory import AnalysisConstants as TConst
from repro_torch.theory import tune as ttune

U = 4
GRID = dict(D=50890, d_chunk=4096, kappas=[20, 80, 320, 1280],
            measures=[256, 1024], noise_var=1e-4, b_t=0.001, calib=0.3)


def test_delta_model_matches():
    k = np.array([20, 80, 320, 1280], np.float32)
    s = np.array([256, 1024, 256, 1024], np.float32)
    np.testing.assert_allclose(
        ttune.delta_model(k, s, 4096, calib=0.3).numpy(),
        np.asarray(jtune.delta_model(k, s, 4096, calib=0.3)), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_mask_exact(seed):
    rng = np.random.default_rng(seed)
    obj = rng.integers(0, 6, (40, 3)).astype(np.float64)   # many ties
    obj[rng.integers(0, 40, 3), rng.integers(0, 3, 3)] = np.inf
    np.testing.assert_array_equal(ttune.pareto_mask(obj),
                                  jtune.pareto_mask(obj))
    basic = np.array([[1.0, 1.0], [2.0, 2.0], [0.5, 3.0], [np.inf, 0.0]])
    assert list(ttune.pareto_mask(basic)) == [True, False, True, False]


@pytest.mark.parametrize("case", ["loop", "budget"])
def test_tune_design_matches(case):
    """test_theory.py's two grids: decode_iters [10] unbudgeted, and
    [5, 25] with the 13·1025-symbol budget."""
    kw = dict(GRID, k_weights=np.full(U, 3000.0))
    if case == "budget":
        kw.update(decode_iters=[5, 25], max_symbols=13 * 1025)
    else:
        kw.update(decode_iters=[10])
    j = jtune.tune_design(JConst(G=2.0), **kw)
    t = ttune.tune_design(TConst(G=2.0), **kw)
    for name in ("kappa", "measure", "iters", "symbols", "flops",
                 "pareto"):
        np.testing.assert_array_equal(t[name], np.asarray(j[name]), name)
    np.testing.assert_allclose(t["delta"], np.asarray(j["delta"]),
                               rtol=1e-6)
    finite = np.isfinite(j["rt"])
    np.testing.assert_array_equal(np.isfinite(t["rt"]), finite)
    np.testing.assert_allclose(t["rt"][finite], j["rt"][finite], rtol=1e-6)
    assert t["best"] == j["best"] and t["calib"] == j["calib"]
    assert t["pareto"].any()


def test_tune_design_raises_when_infeasible():
    kw = dict(GRID, kappas=[20, 80], k_weights=np.full(U, 3000.0),
              max_symbols=10)
    for mod, const in ((jtune, JConst), (ttune, TConst)):
        with pytest.raises(ValueError, match="RIP-feasible"):
            mod.tune_design(const(G=2.0), **kw)


def _reference_rip_draws(seed, n_trials, d, k):
    """The supports and values ``repro``'s ``rip_constant_estimate``
    draws from ``PRNGKey(seed)``."""
    sup, val = [], []
    for key in jax.random.split(jax.random.PRNGKey(seed), n_trials):
        k1, k2 = jax.random.split(key)
        sup.append(np.asarray(jax.random.choice(k1, d, (k,), replace=False)))
        val.append(np.asarray(jax.random.normal(k2, (k,))))
    return torch.from_numpy(np.stack(sup)), torch.from_numpy(np.stack(val))


def test_calibrate_delta_injected():
    """One-point calibration at (κ, S, D_c) = (20, 256, 1024), 32 trials,
    with the reference's Φ (seed 0) and RIP draws; then a tuned grid
    without ``calib`` runs the port's own calibration."""
    d, k, s = 1024, 20, 256
    phi = torch.from_numpy(np.array(make_phi(0, s, d)))
    sup, val = _reference_rip_draws(1, 32, d, k)
    got = ttune.calibrate_delta(d, kappa_ref=k, s_ref=s, phi=phi,
                                supports=sup, values=val)
    want = jtune.calibrate_delta(d, kappa_ref=k, s_ref=s)
    assert got == pytest.approx(want, rel=1e-5)
    own = ttune.tune_design(TConst(G=2.0), D=50890, d_chunk=d,
                            kappas=[k, 80], measures=[128, s],
                            k_weights=np.full(U, 3000.0), noise_var=1e-4,
                            b_t=0.001)
    assert 0.0 < own["calib"] < 10.0 and np.isfinite(own["rt"]).any()
