"""The port's batched Algorithm 2 (``repro_torch.sched.admm``) against
``repro.sched.admm`` and against its own float64 oracle, on the CPU.

Tolerances:
- port against the reference's ``admm_solve_batched`` (B = 64, equal and
  unequal K_i, tests/test_sched.py:89-102's instances): at most one lane's
  β differs; b_t and R_t within rtol 1e-4 (the reference's own tolerance
  between its f32 batch and its float64 oracle). The two run f32 ops in
  different orders (the reference under XLA's fusion), so bits may differ.
- port against the port's float64 ``admm_solve``: the same bound.
- within the port, bit for bit: the compacted fleet form ≡ the in-round
  form per lane (β, b_t, R_t, exit duals and iteration counts);
  ``inner_iters`` 16 ≡ 50 on β and b_t; a warm start from another solve's
  duals ≡ the cold solve on β, b_t and R_t.
"""
import jax
import numpy as np
import pytest
import torch

from repro.sched import BatchedProblem as JBP
from repro.sched import SchedConfig as JSC
from repro.sched import admm_solve_batched as j_admm
from repro.sched import admm_solve_batched_jit as j_admm_jit
from repro.sched.reference import Problem as JProblem
from repro.theory import AnalysisConstants as JAC
from repro_torch.sched import (AdmmDuals, BatchedProblem, Problem,
                               SchedConfig, admm_solve, admm_solve_batched,
                               admm_solve_batched_jit)
from repro_torch.sched import admm as tadmm
from repro_torch.theory import AnalysisConstants

KW = dict(D=50890, S=1000, kappa=1000)


def _problems(n, U, seed, equal_k=True, p_max=10.0):
    """tests/test_sched.py's ``random_problems``, as (reference, port)
    float64 instances."""
    rng = np.random.default_rng(seed)
    jps, tps = [], []
    for _ in range(n):
        k = (np.full(U, 3000.0) if equal_k
             else rng.uniform(1000.0, 5000.0, size=U))
        kw = dict(h=np.abs(rng.normal(size=U)) + 1e-3, k_weights=k,
                  p_max=p_max, noise_var=1e-4, **KW)
        jps.append(JProblem(const=JAC(rho1=200.0, G=1.0), **kw))
        tps.append(Problem(const=AnalysisConstants(rho1=200.0, G=1.0), **kw))
    return (JBP.from_problems(jps),
            BatchedProblem.from_problems(tps, device="cpu"), tps)


def _bits(t):
    """Bit patterns, so that equal NaNs compare equal: an ill-conditioned
    lane (a tiny h_i) can drive ν past f32 range and ξ to NaN, in both
    forms alike."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_lanes_equal(x, y):
    (b1, t1, r1, i1), (b2, t2, r2, i2) = x, y
    for a, b in ((b1, b2), (t1, t2), (r1, r2), (i1.iters, i2.iters),
                 *zip(i1.duals, i2.duals)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("equal_k", [True, False], ids=["K3000", "Kreal"])
@pytest.mark.parametrize("solver", ["compacted", "jit"])
def test_batched_admm_matches_reference(solver, equal_k):
    jbp, tbp, tps = _problems(64, 8, 11, equal_k)
    fn = admm_solve_batched if solver == "compacted" else \
        admm_solve_batched_jit
    beta, b_t, r = fn(tbp)
    jbeta, jb_t, jr = (j_admm if solver == "compacted" else j_admm_jit)(jbp)
    assert beta.shape == (64, 8) and b_t.shape == r.shape == (64,)
    assert beta.dtype == b_t.dtype == r.dtype == torch.float32
    flips = int((beta.numpy() != np.asarray(jbeta)).any(-1).sum())
    assert flips <= 1
    np.testing.assert_allclose(b_t.numpy(), np.asarray(jb_t), rtol=1e-4)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-4)
    # and against the port's own float64 oracle, instance by instance
    flips = 0
    for i, p in enumerate(tps):
        beta_n, bt_n, r_n = admm_solve(p)
        flips += not np.array_equal(beta[i].numpy(), beta_n)
        assert abs(float(r[i]) - r_n) / r_n < 1e-4, i
        assert abs(float(b_t[i]) - bt_n) / max(bt_n, 1e-12) < 1e-4, i
    assert flips <= 1


@pytest.mark.parametrize("equal_k", [True, False], ids=["K3000", "Kreal"])
@pytest.mark.parametrize("B,U,max_iters", [(64, 16, 200), (48, 10, 200),
                                           (40, 12, 13), (3, 6, 200)])
def test_compacted_equals_jit_per_lane(B, U, max_iters, equal_k):
    """β, b_t, R_t, the exit duals and the iteration counts, lane by lane:
    buckets of 8..64 rows against the whole batch (``max_iters`` = 13 cuts
    lanes at a bound that is not a chunk's end)."""
    _, tbp, _ = _problems(B, U, 31 + B, equal_k)
    cfg = SchedConfig(max_iters=max_iters)
    full = admm_solve_batched_jit(tbp, cfg, return_duals=True)
    _assert_lanes_equal(admm_solve_batched(tbp, cfg, return_duals=True),
                        full)
    assert int(full[3].iters.max()) <= max_iters
    # a lane's result does not depend on which lanes share its batch
    lanes = [B - 1, 0]
    sub = admm_solve_batched_jit(tadmm.take(tbp, lanes), cfg,
                                 return_duals=True)
    for a, b in zip(sub[:3], full[:3]):
        assert torch.equal(a, b[lanes])


def test_compacted_matches_reference_iterations_and_duals():
    """The reference pins its compacted form to its jit form on iterations
    and duals; the port's iteration counts agree with the reference's on
    all but marginal lanes, and the duals are finite prices (ν ≥ 0)."""
    jbp, tbp, _ = _problems(64, 16, 7)
    *_, info = admm_solve_batched(tbp, return_duals=True)
    *_, jinfo = j_admm(jbp, return_duals=True)
    assert info.iters.dtype == torch.int32
    agree = (info.iters.numpy() == np.asarray(jinfo.iters)).mean()
    assert agree >= 0.9, agree
    assert bool((info.duals.nu >= 0).all())
    for d in info.duals:
        assert d.shape == (64, 16) and bool(torch.isfinite(d).all())


@pytest.mark.parametrize("equal_k", [True, False], ids=["K3000", "Kreal"])
def test_inner_iters_16_equals_50(equal_k):
    _, tbp, _ = _problems(48, 16, 31, equal_k)
    out16 = admm_solve_batched(tbp, SchedConfig(inner_iters=16))
    out50 = admm_solve_batched(tbp, SchedConfig(inner_iters=50))
    assert torch.equal(out16[0], out50[0])
    assert torch.equal(out16[1], out50[1])


@pytest.mark.parametrize("solver", ["compacted", "jit"])
def test_duals_returned_and_fed_back(solver):
    """tests/test_serve.py's warm-start property: seeding the multipliers
    from a correlated earlier solve leaves β, b_t and R_t bit for bit."""
    fn = admm_solve_batched if solver == "compacted" else \
        admm_solve_batched_jit
    rng = np.random.default_rng(2)
    h0 = np.abs(rng.normal(size=(64, 10))) + 1e-3
    h1 = np.abs(0.99 * h0 + 0.1 * rng.normal(size=(64, 10))) + 1e-3
    const = AnalysisConstants(rho1=200.0, G=1.0)

    def prob(h):
        return BatchedProblem.from_arrays(h, 3000.0, 10.0, 1e-4, const=const,
                                          device="cpu", **KW)

    *_, info = fn(prob(h0), return_duals=True)
    assert isinstance(info.duals, AdmmDuals)
    assert info.duals.nu.shape == (64, 10) and bool((info.duals.nu >= 0).all())
    cold = fn(prob(h1), return_duals=True)
    warm = fn(prob(h1), duals=info.duals, return_duals=True)
    for a, b in zip(cold[:3], warm[:3]):
        assert torch.equal(a, b)
    # a warm start changes the multipliers it leaves, not the schedule
    assert not all(torch.equal(a, b)
                   for a, b in zip(cold[3].duals, warm[3].duals))
    # the reference, with the same duals fed back, gives the same β
    jp1 = JBP.from_arrays(h1, 3000.0, 10.0, 1e-4, const=JAC(rho1=200.0,
                                                            G=1.0), **KW)
    jd = type(j_admm(jp1, return_duals=True)[3].duals)(
        *(np.asarray(d.numpy()) for d in info.duals))
    jwarm = (j_admm if solver == "compacted" else j_admm_jit)(jp1, duals=jd)
    flips = int((warm[0].numpy() != np.asarray(jwarm[0])).any(-1).sum())
    assert flips <= 1


def test_warm_beta_projects_to_feasible_start():
    """``warm_beta`` seeds the primal: binarised, empty lanes all-on; the
    solve still ends on a feasible schedule, as in the reference."""
    jbp, tbp, _ = _problems(8, 6, 3)
    wb = np.zeros((8, 6), np.float32)
    wb[:4, :3] = 0.9
    st = tadmm._init_state(tbp, warm_beta=torch.from_numpy(wb))
    want = (wb > 0.5).astype(np.float32)
    want[4:] = 1.0
    np.testing.assert_array_equal(st[1].numpy(), want)
    for fn, jfn in ((admm_solve_batched, j_admm),
                    (admm_solve_batched_jit, j_admm_jit)):
        beta, b_t, r = fn(tbp, warm_beta=torch.from_numpy(wb))
        jbeta, jb_t, jr = jfn(jbp, warm_beta=jax.numpy.asarray(wb))
        assert int((beta.numpy() != np.asarray(jbeta)).any(-1).sum()) <= 1
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-4)
        p = (tbp.k_weights * beta * b_t[:, None] / tbp.h) ** 2
        assert bool((p <= tbp.p_max * (1 + 1e-5)).all())


def test_admm_at_large_u_is_feasible():
    """tests/test_sched.py's large-U case: U = 64, both forms."""
    _, tbp, _ = _problems(4, 64, 5)
    for fn in (admm_solve_batched, admm_solve_batched_jit):
        beta, b_t, r = fn(tbp)
        assert beta.shape == (4, 64) and bool(torch.isfinite(r).all())
        p = (tbp.k_weights * beta * b_t[:, None] / tbp.h) ** 2
        assert bool((p <= tbp.p_max * (1 + 1e-5)).all())


def test_project_and_polish_pieces_match_reference():
    """The empty-schedule fallback, the greedy-prefix bound and the
    polish-active test against the reference's on the same β."""
    from repro.sched import admm as jadmm
    jbp, tbp, _ = _problems(16, 8, 9, equal_k=False)
    rng = np.random.default_rng(0)
    beta = (rng.random((16, 8)) > 0.6).astype(np.float32)
    beta[:3] = 0.0                                   # empty lanes
    got = tadmm._project_batched(tbp, torch.from_numpy(beta))
    want = jadmm._project_batched(jbp, jax.numpy.asarray(beta))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    bound = tadmm._greedy_prefix_bound(tbp, tbp.caps())
    np.testing.assert_allclose(
        bound.numpy(), np.asarray(jadmm._greedy_prefix_bound(
            jbp, jbp.caps())), rtol=1e-5)
    polished = tadmm._polish(tbp, SchedConfig(), got[0], got[1])
    jpol = jax.vmap(lambda p, b, r: jadmm._polish_one(p, JSC(), b, r))(
        jbp, want[0], want[1])
    assert int((polished.numpy() != np.asarray(jpol)).any(-1).sum()) <= 1
