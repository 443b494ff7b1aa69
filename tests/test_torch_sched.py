"""The port's P2 scheduling (``repro_torch.sched``) and the prefix_eval
kernel's plain version against ``repro.sched`` on the same NumPy inputs.
JAX runs its Pallas prefix kernel in interpret mode, as tests/test_sched.py
does; the port runs on the CPU, i.e. through the kernel's plain version.

Tolerances:
- ``pack_coefs`` / ``rt_coefs``: exact (ρ1, A and E are float64 rounded to
  f32 once in both packages, N = f32(C²)·σ²), and Ktot, an f32 sum, exact
  on whole-number K_i; on real K_i the two packages sum in another order
  and Ktot is held to 1 ulp.
- prefix R with whole-number K_i (every prefix sum exact in f32): exact
  against the reference's formula evaluated op by op. Under ``jax.jit``
  (``prefix_sweep`` jitted, ``prefix_eval(interpret=True)``,
  ``greedy_solve_batched``) XLA on the CPU contracts the last ``+ s1·E``
  into a fused multiply-add, which the port, like the formula, rounds
  twice; there R is held to 1 ulp.
- prefix R with real K_i: rtol 1e-6 (cumsums in another order).
- β and b_t: exact (picks from the same f32 cap array; the argmins agree
  on every row of these inputs, which has no two R within 1 ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.prefix_eval import prefix_eval as j_prefix_eval
from repro.sched import BatchedProblem as JBP
from repro.sched import SchedConfig as JSC
from repro.sched import greedy_solve_batched as j_greedy
from repro.sched import schedule as j_schedule
from repro.sched.greedy import pack_coefs as j_pack_coefs
from repro.sched.greedy import prefix_sweep as j_prefix_sweep
from repro.theory import AnalysisConstants as JAC
from repro_torch.core.measurement import reconstruction_constant
from repro_torch.engine import FLConfig
from repro_torch.kernels import ops
from repro_torch.sched import (BatchedProblem, SchedConfig,
                               greedy_solve_batched, list_schedulers,
                               pack_coefs, prefix_sweep, schedule)
from repro_torch.theory import AnalysisConstants

KW = dict(D=50890, S=1000, kappa=1000)


def _instances(B, U, seed, whole_k=True, tied=False):
    """tests/test_sched.py's recipe: h = |N(0, 1)| + 1e-3, K_i = 3000 or
    U(1000, 5000), P^Max = 10, σ² = 1e-4, ρ1 = 200, G = 1. ``tied``: h = 1
    everywhere under the default constants (ρ1 = 1, G = 10), where the
    optimum schedules fewer than U workers, so which of the tied workers
    come first decides β."""
    rng = np.random.default_rng(seed)
    h = np.ones((B, U)) if tied else np.abs(rng.normal(size=(B, U))) + 1e-3
    k = (np.full((B, U), 3000.0) if whole_k
         else rng.uniform(1000.0, 5000.0, size=(B, U)))
    const = {} if tied else dict(rho1=200.0, G=1.0)
    jbp = JBP.from_arrays(h, k, 10.0, 1e-4, const=JAC(**const), **KW)
    tbp = BatchedProblem.from_arrays(
        h, k, 10.0, 1e-4, const=AnalysisConstants(**const), device="cpu",
        **KW)
    return jbp, tbp


def _sorted(jbp):
    caps = jbp.caps()
    order = jnp.argsort(-caps, axis=-1)
    return (jnp.take_along_axis(caps, order, -1),
            jnp.take_along_axis(jbp.k_weights, order, -1), j_pack_coefs(jbp))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _within_ulp(got, want, ulps=1):
    want = np.asarray(want)
    assert np.all(np.abs(got - want) <= ulps * np.spacing(np.abs(want))), \
        np.max(np.abs(got - want) / np.spacing(np.abs(want)))


def test_analysis_constants_match():
    for delta in (0.0, 0.2, 0.4):
        assert AnalysisConstants(delta=delta).C == JAC(delta=delta).C
    with pytest.raises(ValueError, match="RIP"):
        reconstruction_constant(0.5)
    assert SchedConfig().__dict__ == {
        k: v for k, v in JSC().__dict__.items()
        if k not in ("interpret", "kernel_tiles")}


@pytest.mark.parametrize("whole_k", [True, False])
def test_pack_coefs_exact(whole_k):
    jbp, tbp = _instances(6, 24, 2, whole_k)
    got, want = pack_coefs(tbp).numpy(), np.asarray(j_pack_coefs(jbp))
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    if whole_k:
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
    else:
        _within_ulp(got[:, 0], want[:, 0])
    for g, w in zip(tbp.rt_coefs()[1:], jbp.rt_coefs()[1:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    np.testing.assert_array_equal(tbp.caps().numpy(), np.asarray(jbp.caps()))


@pytest.mark.parametrize("whole_k", [True, False], ids=["K3000", "Kreal"])
@pytest.mark.parametrize("B,U", [(1, 10), (3, 1000), (8, 1024)])
def test_prefix_sweep_matches_reference(B, U, whole_k):
    jbp, _ = _instances(B, U, B * U, whole_k)
    caps_s, k_s, coefs = _sorted(jbp)
    args = [_t(a) for a in (caps_s, k_s, coefs)]
    got = prefix_sweep(*args).numpy()
    assert torch.equal(ops.prefix_eval(*args), prefix_sweep(*args))
    eager = np.asarray(j_prefix_sweep(caps_s, k_s, coefs))
    jitted = np.asarray(jax.jit(j_prefix_sweep)(caps_s, k_s, coefs))
    kernel = np.asarray(j_prefix_eval(caps_s, k_s, coefs, interpret=True))
    if whole_k:
        np.testing.assert_array_equal(got, eager)
        _within_ulp(got, jitted)
        _within_ulp(got, kernel)
    else:
        for want in (eager, jitted, kernel):
            np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(np.argmin(got, -1), np.argmin(kernel, -1))


@pytest.mark.parametrize("case", ["K3000", "Kreal", "tied_caps"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_greedy_solve_batched(case, use_kernel):
    """Tied caps (h = 1 everywhere) keep index order only through a stable
    sort: ``torch.sort`` without ``stable=True`` reorders ties at U = 24."""
    jbp, tbp = _instances(8, 24, 5, whole_k=case != "Kreal",
                          tied=case == "tied_caps")
    beta, b_t, r = greedy_solve_batched(tbp,
                                        SchedConfig(use_kernel=use_kernel))
    jbeta, jb_t, jr = j_greedy(jbp, JSC(use_kernel=use_kernel,
                                        interpret=True))
    np.testing.assert_array_equal(beta.numpy(), np.asarray(jbeta))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(jb_t))
    if case == "Kreal":
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6)
    else:
        _within_ulp(r.numpy(), jr)
    if case == "tied_caps":
        n = beta.sum(-1).to(torch.int64)
        assert bool((n < 24).all())
        assert torch.equal(beta, (torch.arange(24)[None] < n[:, None])
                           .to(beta.dtype))
    # the prefix form of R_t against the direct eq. (24) form
    np.testing.assert_allclose(r.numpy(), tbp.rt(beta, b_t).numpy(),
                               rtol=1e-5)


def test_registry_schedule():
    jbp, tbp = _instances(4, 12, 9)
    assert list_schedulers() == ["all", "greedy_batched"]
    beta, b_t, r = schedule(tbp, "all")
    jbeta, jb_t, jr = j_schedule(jbp, "all")    # per-instance float64 oracle
    np.testing.assert_array_equal(beta.numpy(), jbeta)
    np.testing.assert_allclose(b_t.numpy(), jb_t, rtol=1e-6)
    np.testing.assert_allclose(r.numpy(), jr, rtol=1e-5)
    # the engine's closed form
    assert torch.equal(b_t, tbp.optimal_bt(torch.ones_like(tbp.h)))
    beta, b_t, r = schedule(tbp, "greedy_batched", SchedConfig(True))
    jbeta, jb_t, jr = j_schedule(jbp, "greedy_batched")
    np.testing.assert_array_equal(beta.numpy(), np.asarray(jbeta))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(jb_t))
    _within_ulp(r.numpy(), jr)
    for name in ("enum", "admm", "greedy", "admm_batched",
                 "admm_batched_jit"):
        with pytest.raises(NotImplementedError, match="greedy_batched"):
            schedule(tbp, name)
    with pytest.raises(ValueError, match="unknown scheduling method"):
        schedule(tbp, "nope")


def test_engine_schedulers():
    assert FLConfig(scheduler="greedy_batched").sched_cfg is None
    with pytest.raises(NotImplementedError, match="not ported"):
        FLConfig(scheduler="admm_batched")
