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
- the NumPy float64 oracles (``sched/reference.py``: ``enum``, ``admm``,
  ``greedy``, the prefix bound and the flip-polish): bit for bit, and
  ``Problem`` ↔ ``BatchedProblem`` exact.
- the registry's batched ADMM entries against the reference's on one
  small batch: β exact, b_t and R_t rtol 1e-4 (the tolerance of
  tests/test_sched.py; tests/test_torch_admm.py holds the solvers).
- ``scenario``: ``bessel_j0`` to 1e-12 (the same float64 polynomial);
  with the reference's draws injected, fades and gains rtol 1e-6 (the
  innovation weight √(1−ρ²) is rounded once in float64 here, in f32
  there); a stepped trajectory equals the whole draw bit for bit.
- compaction: exact.
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
from repro.engine import ENGINE_SCHEDULERS as J_ENGINE_SCHEDULERS
from repro.sched import get_scheduler as j_get_scheduler
from repro.sched import list_schedulers as j_list_schedulers
from repro.sched import schedule as j_schedule
from repro.sched.greedy import pack_coefs as j_pack_coefs
from repro.sched.greedy import prefix_sweep as j_prefix_sweep
from repro.core.channel import draw_cn as j_draw_cn
from repro.sched import Problem as JProblem
from repro.sched import compaction as jcomp
from repro.sched import reference as jref
from repro.sched import scenario as jscen
from repro.theory import AnalysisConstants as JAC
from repro_torch.core.measurement import reconstruction_constant
from repro_torch.engine import ENGINE_SCHEDULERS, FLConfig
from repro_torch.engine.config import SCHEDULERS
from repro_torch.kernels import ops
from repro_torch.sched import (BatchedProblem, SchedConfig, get_scheduler,
                               greedy_solve_batched, list_schedulers,
                               pack_coefs, prefix_sweep, schedule)
from repro_torch.sched import Problem, compaction, scenario
from repro_torch.sched import reference as tref
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
    """All seven names, dispatched on a ``BatchedProblem`` as the reference
    does: the NumPy entries instance by instance (float64 out, equal to the
    reference's bit for bit), the batched ones on the tensors."""
    jbp, tbp = _instances(4, 12, 9)
    assert list_schedulers() == j_list_schedulers() == [
        "admm", "admm_batched", "admm_batched_jit", "all", "enum", "greedy",
        "greedy_batched"]
    assert [get_scheduler(n).batched for n in list_schedulers()] == [
        j_get_scheduler(n).batched for n in j_list_schedulers()]
    for name in ("all", "enum", "admm", "greedy"):
        got, want = schedule(tbp, name), j_schedule(jbp, name)
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray)
            np.testing.assert_array_equal(g, w)
    beta, b_t, _ = schedule(tbp, "all")
    # the engine's closed form, on the tensors
    np.testing.assert_allclose(
        b_t, tbp.optimal_bt(torch.ones_like(tbp.h)).numpy(), rtol=1e-6)
    beta, b_t, r = schedule(tbp, "greedy_batched", SchedConfig(True))
    jbeta, jb_t, jr = j_schedule(jbp, "greedy_batched")
    np.testing.assert_array_equal(beta.numpy(), np.asarray(jbeta))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(jb_t))
    _within_ulp(r.numpy(), jr)
    for name in ("admm_batched", "admm_batched_jit"):
        beta, b_t, r = schedule(tbp, name)
        jbeta, jb_t, jr = j_schedule(jbp, name)
        assert isinstance(beta, torch.Tensor)
        np.testing.assert_array_equal(beta.numpy(), np.asarray(jbeta))
        np.testing.assert_allclose(b_t.numpy(), jb_t, rtol=1e-4)
        np.testing.assert_allclose(r.numpy(), jr, rtol=1e-4)
    with pytest.raises(ValueError, match="unknown scheduling method"):
        schedule(tbp, "nope")


def test_engine_schedulers():
    assert FLConfig(scheduler="greedy_batched").sched_cfg is None
    assert FLConfig(scheduler="admm_batched").scheduler == "admm_batched"
    assert ENGINE_SCHEDULERS == J_ENGINE_SCHEDULERS
    assert set(SCHEDULERS) == set(list_schedulers())
    with pytest.raises(ValueError, match="unknown scheduler"):
        FLConfig(scheduler="nope")


# --- the NumPy float64 oracles (sched/reference.py) ---------------------------

def _problems(U, seed, *, equal_k=True, p_max=10.0):
    """tests/test_sched.py's ``make_problem``/``random_problems`` recipe, as
    a (reference, port) pair of float64 ``Problem``s."""
    rng = np.random.default_rng(seed)
    h = np.abs(rng.normal(size=U)) + 1e-3
    k = (np.full(U, 3000.0) if equal_k
         else rng.uniform(1000.0, 5000.0, size=U))
    p = p_max(rng, U) if callable(p_max) else p_max
    kw = dict(h=h, k_weights=k, p_max=p, noise_var=1e-4, **KW)
    return (JProblem(const=JAC(rho1=200.0, G=1.0), **kw),
            Problem(const=AnalysisConstants(rho1=200.0, G=1.0), **kw))


ORACLE_CASES = {
    "equal_k": dict(U=8, equal_k=True),
    "real_k": dict(U=8, equal_k=False),
    "pmax_vector": dict(U=8, p_max=lambda rng, U: rng.uniform(0.5, 20.0, U)),
    "pmax_tiny": dict(U=4, p_max=lambda rng, U: np.array([10.0, 10.0, 1e-6,
                                                          10.0])),
    "u16": dict(U=16, equal_k=False,
                p_max=lambda rng, U: rng.uniform(0.5, 20.0, U)),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
@pytest.mark.parametrize("solver", ["enumerate_solve", "admm_solve",
                                    "greedy_solve"])
def test_reference_oracles_bitwise(solver, case):
    """tests/test_scheduling.py's and tests/test_sched.py:57-86's instances:
    β, b_t and R_t of the port's float64 oracle equal the reference's."""
    kw = dict(ORACLE_CASES[case])
    if solver == "enumerate_solve" and kw["U"] > 10:
        kw["U"] = 10
    for seed in range(3):
        jp, tp = _problems(seed=seed, **kw)
        want, got = getattr(jref, solver)(jp), getattr(tref, solver)(tp)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and got[2] == want[2]
        assert isinstance(got[0], np.ndarray)
        assert tref.greedy_prefix_bound(tp) == jref.greedy_prefix_bound(jp)
        beta = (np.arange(tp.U) % 3 == 0).astype(np.float64)
        np.testing.assert_array_equal(tref._flip_polish(tp, beta.copy()),
                                      jref._flip_polish(jp, beta.copy()))
        assert tref._rt(tp, beta, tref.optimal_bt(tp, beta)) == \
            jref._rt(jp, beta, jref.optimal_bt(jp, beta))
        np.testing.assert_array_equal(tp.caps(), jp.caps())


def test_reference_admm_knobs_and_constants():
    assert (tref.STALL_RTOL, tref.STALL_PATIENCE) == (jref.STALL_RTOL,
                                                      jref.STALL_PATIENCE)
    jp, tp = _problems(U=10, seed=4, equal_k=False)
    for kw in (dict(c_step=0.5), dict(max_iters=7), dict(abs_tol=1e-2),
               dict(rel_tol=1e-3)):
        got, want = tref.admm_solve(tp, **kw), jref.admm_solve(jp, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_problem_conversions_exact():
    pairs = [_problems(U=6, seed=s, equal_k=False,
                       p_max=lambda rng, U: rng.uniform(1.0, 9.0, U))
             for s in range(3)]
    tbp = BatchedProblem.from_problems([t for _, t in pairs], device="cpu")
    jbp = JBP.from_problems([j for j, _ in pairs])
    for name in ("h", "k_weights", "p_max", "noise_var"):
        np.testing.assert_array_equal(getattr(tbp, name).numpy(),
                                      np.asarray(getattr(jbp, name)))
    for b in range(3):
        got, want = tbp.instance(b), jbp.instance(b)
        for name in ("h", "k_weights", "p_max"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
            assert getattr(got, name).dtype == np.float64
        assert got.noise_var == want.noise_var
    one = BatchedProblem.single(pairs[0][1], device="cpu")
    assert one.B == 1 and torch.equal(one.h[0], tbp.h[0])
    other = Problem(**{**pairs[1][1].__dict__, "D": 1000})
    with pytest.raises(ValueError, match="shared"):
        BatchedProblem.from_problems([pairs[0][1], other], device="cpu")


def test_single_problem_dispatch_and_lift():
    """A NumPy ``Problem`` gets NumPy out of every entry; the batched ones
    run it lifted to B = 1 (``device``), as in tests/test_sched.py."""
    jp, tp = _problems(U=6, seed=4)
    for name in list_schedulers():
        got, want = schedule(tp, name, device="cpu"), j_schedule(jp, name)
        assert isinstance(got[0], np.ndarray) and isinstance(got[1], float)
        assert isinstance(got[2], float)
        np.testing.assert_array_equal(got[0], want[0])
        if get_scheduler(name).batched:
            np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4)
            lifted = schedule(BatchedProblem.single(tp, device="cpu"), name)
            np.testing.assert_array_equal(got[0], lifted[0][0].numpy())
            assert got[1] == float(lifted[1][0])
        else:
            assert got[1:] == want[1:]


# --- compaction ----------------------------------------------------------------

def test_compaction_exact():
    for n, mb in ((1, 8), (8, 8), (9, 8), (1000, 8), (3, 2)):
        assert compaction.bucket(n, mb) == jcomp.bucket(n, mb)
    with pytest.raises(ValueError):
        compaction.bucket(0)
    for idx in (np.array([5, 9, 11]), np.arange(17)):
        for a, b in zip(compaction.pad_to_bucket(idx),
                        jcomp.pad_to_bucket(idx)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        compaction.pad_to_bucket(np.array([], np.int64))
    _, tbp = _instances(5, 3, 1)
    sub = compaction.take(tbp, np.array([4, 0, 4]))
    assert isinstance(sub, BatchedProblem) and sub.D == tbp.D
    assert torch.equal(sub.h, tbp.h[[4, 0, 4]])
    assert torch.equal(sub.noise_var, tbp.noise_var[[4, 0, 4]])
    st = (torch.arange(5), None, torch.ones(5, 2))
    got = compaction.take(st, torch.tensor([1, 1]))
    assert got[1] is None and torch.equal(got[0], torch.tensor([1, 1]))


# --- scenario ------------------------------------------------------------------

@pytest.mark.parametrize("x", [0.0, 0.3, 1.0, 2.999, 3.0, 3.5, 5.0, 12.0,
                               -1.7])
def test_bessel_j0_matches(x):
    assert abs(scenario.bessel_j0(x) - jscen.bessel_j0(x)) <= 1e-12
    for model in ("gauss_markov", "jakes", "iid"):
        kw = dict(model=model, doppler_hz=abs(x) * 10.0)
        assert scenario.ScenarioConfig(**kw).rho == \
            jscen.ScenarioConfig(**kw).rho
    with pytest.raises(ValueError):
        _ = scenario.ScenarioConfig(model="nope").rho


def _reference_fade_draws(jcfg, key):
    """The reference's draws for ``init_fades`` and each ``step_fades``:
    g0 from split(key)[0], step t's innovation from fold_in(kw, t)."""
    k0, kw = jax.random.split(key)
    shape = (jcfg.cells, jcfg.workers)
    g0 = np.asarray(j_draw_cn(k0, shape).astype(jnp.complex64))
    w = np.stack([np.asarray(j_draw_cn(jax.random.fold_in(kw, t), shape))
                  for t in range(jcfg.rounds - 1)])
    return _t(g0), _t(w)


@pytest.mark.parametrize("model", ["gauss_markov", "jakes", "iid"])
def test_scenario_fades_match_reference(model):
    kw = dict(rounds=6, cells=3, workers=8, model=model, corr=0.8)
    jcfg, tcfg = jscen.ScenarioConfig(**kw), scenario.ScenarioConfig(**kw)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jscen.generate_fades(jcfg, key))
    g0, w = _reference_fade_draws(jcfg, key)
    got = scenario.generate_fades(tcfg, g0=g0, w=w)
    assert got.dtype == torch.complex64 and got.shape == (6, 3, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # stepped by hand, round by round: the whole draw, bit for bit
    st = scenario.init_fades(tcfg, g0=g0)
    for t in range(tcfg.rounds):
        assert st.t == t and torch.equal(st.g, got[t])
        np.testing.assert_array_equal(
            scenario.magnitudes(st, h_min=0.3).numpy(),
            scenario.magnitudes(got[t], h_min=0.3).numpy())
        if t + 1 < tcfg.rounds:
            st = scenario.step_fades(tcfg, st, w[t])
    # and with the generator's own draws: stepped ≡ whole trajectory
    whole = scenario.generate_fades(
        tcfg, torch.Generator().manual_seed(3), device="cpu")
    st = scenario.init_fades(tcfg, torch.Generator().manual_seed(3),
                             device="cpu")
    for t in range(tcfg.rounds):
        assert torch.equal(st.g, whole[t])
        st = scenario.step_fades(tcfg, st)


def test_scenario_gain_and_problems_match_reference():
    kw = dict(rounds=4, cells=2, workers=16, shadowing_db=8.0,
              cell_radius=1.0, corr=0.5)
    jcfg, tcfg = jscen.ScenarioConfig(**kw), scenario.ScenarioConfig(**kw)
    key = jax.random.PRNGKey(3)
    kf, kg = jax.random.split(key)
    ks, kp = jax.random.split(kg)
    shape = (2, 16)
    shadow = _t(jax.random.normal(ks, shape))
    radius_u = _t(jax.random.uniform(kp, shape))
    gain = scenario.large_scale_gain(tcfg, shadow=shadow, radius_u=radius_u)
    np.testing.assert_allclose(
        gain.numpy(), np.asarray(jscen.large_scale_gain(jcfg, kg)),
        rtol=1e-6)
    g0, w = _reference_fade_draws(jcfg, kf)
    h = scenario.generate(tcfg, g0=g0, w=w, shadow=shadow,
                          radius_u=radius_u)
    want = np.asarray(jscen.generate(jcfg, key))
    assert h.dtype == torch.float32 and float(h.min()) >= tcfg.h_min
    np.testing.assert_allclose(h.numpy(), want, rtol=1e-5)
    ones = scenario.large_scale_gain(scenario.ScenarioConfig(cells=2,
                                                             workers=3),
                                     device="cpu")
    assert torch.equal(ones, torch.ones(2, 3))
    tbp = scenario.round_problems(h, 2, k_weights=3000.0, p_max=10.0,
                                  noise_var=1e-4, const=AnalysisConstants(),
                                  **KW)
    jbp = jscen.round_problems(jnp.asarray(h.numpy()), 2, k_weights=3000.0,
                               p_max=10.0, noise_var=1e-4, const=JAC(), **KW)
    assert tbp.B == 2 and tbp.U == 16
    np.testing.assert_array_equal(tbp.caps().numpy(), np.asarray(jbp.caps()))
