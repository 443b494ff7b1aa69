"""The port's aggregation pipeline (core/, decode/, sched/problem.py)
against ``repro`` on the same NumPy inputs, with the reference's draws
(Φ, fades, AWGN) injected.

Tolerances:
- exact: sort top-κ (ties to the lowest index), bisection top-κ, chunk
  padding, ``comm_stats``, ``optimal_bt`` on identical channels.
- compressed signs: a lane may differ only where the projection is
  borderline (|x·Φ_s| ≤ 2·D·2⁻²⁴·‖x‖·‖Φ_s‖, see test_torch_kernels.py);
  chunk norms rtol 1e-6 (f32 sums of squares in another order).
- fades: |h| and g within 1e-6 relative (complex magnitude in another
  library); ``gauss_markov_step`` with the innovation injected, and
  ``rayleigh_cdf``, ``mac_aggregate`` and ``post_process``, rtol/atol
  1e-6; the uint8 codec ``pack_bits`` / ``unpack_bits`` exact, with its
  round trip.
- a decoded round: cosine ≥ 0.999 and ‖Δ‖/‖ĝ‖ ≤ 1e-3, because one flipped
  borderline lane changes every later BIHT iterate.
- fixed-step IHT: rtol = atol = 1e-5 (no sign step; the selection is the
  same, only the f32 sums run in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jchan
from repro.core import obcsaa as job
from repro.core import quantize as jq
from repro.core import sparsify as jsp
from repro.sched.problem import BatchedProblem
from repro.theory.bounds import AnalysisConstants
from repro_torch.core import channel as tchan
from repro_torch.core import obcsaa as tob
from repro_torch.core import quantize as tq
from repro_torch.core import sparsify as tsp
from repro_torch.sched import problem as tprob


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(a):
    return np.asarray(a)


def _grads(u, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((u, d)) * 1e-2).astype(np.float32)


@pytest.mark.parametrize("k", [1, 7, 32])
def test_topk_sparsify_tie_rule(k):
    rng = np.random.default_rng(k)
    g = rng.integers(-4, 5, (6, 64)).astype(np.float32)   # many ties
    sv, sm = tsp.topk_sparsify(_t(g), k)
    jv, jm = jsp.topk_sparsify(jnp.asarray(g), k)
    np.testing.assert_array_equal(sm.numpy(), _np(jm))
    np.testing.assert_array_equal(sv.numpy(), _np(jv))
    assert (sm.sum(-1) == k).all()


@pytest.mark.parametrize("iters", [20, 40])
def test_topk_sparsify_bisect_exact(iters):
    g = _grads(5, 512, iters)
    sv, sm = tsp.topk_sparsify_bisect(_t(g), 17, iters=iters)
    jv, jm = jsp.topk_sparsify_bisect(jnp.asarray(g), 17, iters=iters)
    np.testing.assert_array_equal(sm.numpy(), _np(jm))
    np.testing.assert_array_equal(sv.numpy(), _np(jv))


def test_pad_to_chunks_exact():
    g = _grads(1, 6370, 0)[0]
    tp, td = tsp.pad_to_chunks(_t(g), 1024)
    jp, jd = jsp.pad_to_chunks(jnp.asarray(g), 1024)
    assert td == jd == 6370
    np.testing.assert_array_equal(tp.numpy(), _np(jp))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("measure,chunk", [(1024, 4096), (256, 1024),
                                           (100, 1000)])
def test_comm_stats_exact(measure, chunk, packed):
    if packed and measure % 32:
        with pytest.raises(ValueError):
            tob.OBCSAAConfig(chunk=chunk, measure=measure, packed=True)
        return
    kw = dict(chunk=chunk, measure=measure, topk=80, packed=packed)
    assert tob.comm_stats(tob.OBCSAAConfig(**kw), 50890) == \
        job.comm_stats(job.OBCSAAConfig(**kw), 50890)


def test_config_defaults_match():
    import dataclasses
    t = {f.name: f.default for f in dataclasses.fields(tob.OBCSAAConfig)}
    j = {f.name: f.default for f in dataclasses.fields(job.OBCSAAConfig)}
    assert t == j
    cfg = tob.OBCSAAConfig(topk=80)
    assert cfg.decode_k == job.OBCSAAConfig(topk=80).decode_k == 320


def test_optimal_bt_exact():
    rng = np.random.default_rng(0)
    h = rng.rayleigh(size=(3, 10)).astype(np.float32)
    k = rng.uniform(100, 3000, (3, 10)).astype(np.float32)
    beta = (rng.uniform(size=(3, 10)) > 0.3).astype(np.float32)
    beta[2] = 0.0                           # nothing scheduled -> b_t = 0
    bp = BatchedProblem.from_arrays(h, k, 10.0, 1e-4, D=50890, S=1024,
                                    kappa=80, const=AnalysisConstants())
    p = torch.full((3, 10), 10.0)
    np.testing.assert_array_equal(tprob.caps(_t(h), _t(k), p).numpy(),
                                  _np(bp.caps()))
    np.testing.assert_array_equal(
        tprob.optimal_bt(_t(h), _t(k), p, _t(beta)).numpy(),
        _np(bp.optimal_bt(jnp.asarray(beta))))


@pytest.mark.parametrize("rho", [0.0, 0.9])
def test_draw_fades_injected(rho):
    """The port steps the Gauss-Markov recursion on the reference's CN
    draw: same |h|, same g, same H_MIN clamp."""
    key = jax.random.PRNGKey(3)
    k0, k1 = jax.random.split(key)
    jh0, jg0 = jchan.draw_fades(k0, (6,))
    jh, jg = jchan.draw_fades(k1, rho=rho, prev=jg0)
    w = _np(jchan.draw_cn(k1, (6,)))
    th, tg = tchan.draw_fades(rho=rho, prev=_t(_np(jg0)), w=_t(w))
    np.testing.assert_allclose(tg.numpy(), _np(jg), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(th.numpy(), _np(jh), rtol=1e-6)
    tiny = torch.tensor([1e-5 + 0j], dtype=torch.complex64)
    assert tchan.draw_fades(w=tiny)[0].item() == pytest.approx(tchan.H_MIN)


@pytest.mark.parametrize("rho", [0.0, 0.5, 0.99])
def test_gauss_markov_step_injected(rho):
    key = jax.random.PRNGKey(11)
    g = _np(jchan.draw_cn(jax.random.PRNGKey(12), (7,)))
    w = _np(jchan.draw_cn(key, (7,)))
    want = _np(jchan.gauss_markov_step(jnp.asarray(g), key, rho))
    got = tchan.gauss_markov_step(_t(g), rho=rho, w=_t(w))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # draw_fades steps the same recursion
    h, g1 = tchan.draw_fades(rho=rho, prev=_t(g), w=_t(w))
    assert torch.equal(g1, got)
    # drawn from a generator: draw_fades's draw, and draw_channels its |h|
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    assert torch.equal(tchan.gauss_markov_step(_t(g), gen(), rho),
                       tchan.draw_fades(gen(), rho=rho, prev=_t(g))[1])
    assert torch.equal(tchan.draw_channels(gen(), 7, device="cpu"),
                       tchan.draw_fades(gen(), (7,), device="cpu")[0])


def test_rayleigh_cdf():
    x = np.linspace(0.0, 4.0, 101).astype(np.float32)
    np.testing.assert_allclose(tchan.rayleigh_cdf(_t(x)).numpy(),
                               _np(jchan.rayleigh_cdf(x)), rtol=1e-6,
                               atol=1e-6)
    assert float(tchan.rayleigh_cdf(0.5)) == pytest.approx(
        float(jchan.rayleigh_cdf(0.5)), rel=1e-6)


def test_mac_aggregate_and_post_process():
    rng = np.random.default_rng(21)
    U, S = 6, 128
    sym = np.where(rng.standard_normal((U, S)) >= 0, 1.0, -1.0).astype(
        np.float32)
    h = rng.rayleigh(size=U).astype(np.float32)
    p = rng.uniform(0.5, 10.0, U).astype(np.float32)
    z = (rng.standard_normal(S) * 1e-2).astype(np.float32)
    y = tchan.mac_aggregate(_t(sym), _t(h), _t(p), _t(z))
    jy = _np(jchan.mac_aggregate(*map(jnp.asarray, (sym, h, p, z))))
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-6, atol=1e-6)
    k = rng.uniform(100, 3000, U).astype(np.float32)
    for beta in ((rng.uniform(size=U) > 0.4).astype(np.float32),
                 np.zeros(U, np.float32)):      # nothing scheduled
        for b_t in (np.float32(0.37), np.float32(0.0)):
            got = tchan.post_process(y, _t(k), _t(beta), torch.tensor(b_t))
            want = _np(jchan.post_process(jnp.asarray(jy), jnp.asarray(k),
                                          jnp.asarray(beta), b_t))
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("n", [8, 64, 1024])
def test_uint8_codec_exact(n):
    rng = np.random.default_rng(n)
    signs = np.where(rng.standard_normal(n) >= 0, 1.0, -1.0).astype(
        np.float32)
    signs[::7] = 0.0                         # 0 packs as a 0 bit, like -1
    got = tq.pack_bits(_t(signs))
    want = _np(jq.pack_bits(jnp.asarray(signs)))
    assert got.dtype == torch.uint8 and got.shape == (n // 8,)
    np.testing.assert_array_equal(got.numpy(), want)
    for m in (n, n - 3):
        back = tq.unpack_bits(got, m)
        np.testing.assert_array_equal(
            back.numpy(), _np(jq.unpack_bits(jnp.asarray(want), m)))
        np.testing.assert_array_equal(back.numpy(),
                                      np.where(signs > 0, 1.0, -1.0)[:m])


def _jphi(cfg):
    return _np(cfg.phi())


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_compress_chunks(use_kernels, packed):
    kw = dict(chunk=1024, measure=256, topk=32, use_kernels=use_kernels,
              packed=packed)
    jc, tc = job.OBCSAAConfig(**kw), tob.OBCSAAConfig(**kw)
    phi = _jphi(jc)
    g = _grads(1, 7 * 1024, 1)[0]
    g[6 * 1024 + 226:] = 0.0                 # the zero-padded tail chunk
    js, jm = job.compress_chunks(jc, jnp.asarray(g), jnp.asarray(phi))
    ts, tm = tob.compress_chunks(tc, _t(g), _t(phi))
    np.testing.assert_allclose(tm.numpy(), _np(jm), rtol=1e-6)
    if packed:
        from repro.kernels.sign import unpack_signs
        js = unpack_signs(js)
        ts = _t(_np(unpack_signs(jnp.asarray(
            ts.numpy().view(np.uint32)))))
    sparse = _np(jsp.topk_sparsify(jnp.asarray(g.reshape(7, 1024)), 32)[0])
    d = 1024
    acc = sparse.astype(np.float64) @ phi.astype(np.float64).T
    lim = 2 * d * 2.0 ** -24 * np.outer(np.linalg.norm(sparse, axis=1),
                                        np.linalg.norm(phi, axis=1))
    hard = (ts.numpy() != _np(js)) & (np.abs(acc) > lim)
    assert not hard.any()


@pytest.mark.parametrize("use_kernels", [False, True])
def test_simulate_round_injected(use_kernels):
    """One §V round at small width: U=4 workers, D=6370 (the d_hidden=8
    MLP), chunk 1024, S=256, κ=32, 5 BIHT iterations."""
    kw = dict(chunk=1024, measure=256, topk=32, biht_iters=5,
              use_kernels=use_kernels)
    jc, tc = job.OBCSAAConfig(**kw), tob.OBCSAAConfig(**kw)
    u, d = 4, 6370
    g = _grads(u, d, 2)
    k_w = np.full(u, 100.0, np.float32)
    beta = np.ones(u, np.float32)
    h = np.array([0.5, 1.2, 0.8, 2.0], np.float32)
    b_t = np.float32(np.min(h * np.sqrt(np.float32(10.0)) / k_w))
    key = jax.random.PRNGKey(7)
    noise = _np(jchan.draw_noise(key, (7, 256), 1e-4))
    jg, jd = job.simulate_round(jc, jnp.asarray(g), jnp.asarray(k_w),
                                jnp.asarray(beta), b_t, jnp.asarray(h), key)
    tg, td = tob.simulate_round(tc, _t(g), _t(k_w), _t(beta),
                                torch.tensor(b_t), _t(h),
                                phi=_t(_jphi(jc)), noise=_t(noise))
    jg, tg = _np(jg), tg.numpy()
    assert tg.shape == (d,) and np.isfinite(tg).all()
    cos = float(jg @ tg / (np.linalg.norm(jg) * np.linalg.norm(tg)))
    assert cos >= 0.999, cos
    assert np.linalg.norm(tg - jg) / np.linalg.norm(jg) <= 1e-3
    np.testing.assert_allclose(float(td["denom"]), float(jd["denom"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(td["mbar_mean"]),
                               float(jd["mbar_mean"]), rtol=1e-5)


def test_power_control_and_bounds():
    """Eq. 10-11 and the eq. 42 bound on the same inputs; the f32 power
    terms within rtol 1e-6 (division order is the same, sqrt is correctly
    rounded in both)."""
    from repro.core import power_control as jpc
    from repro.core import quantize as jq
    from repro_torch.core import power_control as tpc
    from repro_torch.core import quantize as tq
    rng = np.random.default_rng(4)
    h = rng.rayleigh(size=8).astype(np.float32)
    k = rng.uniform(100, 3000, 8).astype(np.float32)
    beta = (rng.uniform(size=8) > 0.4).astype(np.float32)
    b_t = float(np.min(np.where(beta > 0, h * np.sqrt(10.0) / k, np.inf)))
    j = (jnp.asarray(beta), jnp.asarray(k), b_t, jnp.asarray(h))
    t = (_t(beta), _t(k), b_t, _t(h))
    np.testing.assert_allclose(tpc.power_factors(*t).numpy(),
                               _np(jpc.power_factors(*j)), rtol=1e-6)
    np.testing.assert_allclose(tpc.tx_power(*t).numpy(),
                               _np(jpc.tx_power(*j)), rtol=1e-6)
    np.testing.assert_allclose(
        float(tpc.max_bt(_t(beta), _t(k), _t(h), 10.0)),
        float(jpc.max_bt(jnp.asarray(beta), jnp.asarray(k), jnp.asarray(h),
                         10.0)), rtol=1e-6)
    assert bool(tpc.feasible(*t, 10.0)) == bool(jpc.feasible(*j, 10.0))
    assert not bool(tpc.feasible(_t(beta), _t(k), 2 * b_t, _t(h), 10.0))
    assert tq.quantization_error_bound(1024, 50890, 1040, 1.0, 0.1) == \
        jq.quantization_error_bound(1024, 50890, 1040, 1.0, 0.1)


def test_measurement():
    """``make_phi`` draws N(0, 1/S) from its seed (not JAX's bits, so only
    the law is checked: std within 2% of 1/√S over 256×1024 draws, same
    seed same Φ); ``project_chunked`` against the reference at 1e-5."""
    from repro.core.measurement import project_chunked as jproj
    from repro_torch.core.measurement import make_phi, project_chunked
    phi = make_phi(42, 256, 1024, device="cpu")
    assert phi.shape == (256, 1024) and phi.dtype == torch.float32
    assert torch.equal(phi, make_phi(42, 256, 1024, device="cpu"))
    assert not torch.equal(phi, make_phi(43, 256, 1024, device="cpu"))
    assert abs(float(phi.std()) * 16.0 - 1.0) < 0.02
    assert abs(float(phi.mean())) < 1e-3
    g = _grads(5, 1024, 3)
    np.testing.assert_allclose(
        project_chunked(phi, _t(g)).numpy(),
        _np(jproj(jnp.asarray(phi.numpy()), jnp.asarray(g))),
        rtol=1e-5, atol=1e-5)


def test_decoders_registered():
    from repro.decode import list_decoders as jlist
    from repro_torch.decode import DecodeConfig, decode, list_decoders
    assert list_decoders() == jlist() == ["biht", "iht", "iht_fused",
                                          "iht_warm", "niht"]
    # validate guards the fixed-step family only: biht decodes as unguarded
    rng = np.random.default_rng(2)
    y = _t(np.sign(rng.standard_normal((2, 32))).astype(np.float32))
    phi = _t(rng.standard_normal((32, 64)).astype(np.float32))
    assert torch.equal(decode(y, phi, 4, DecodeConfig(validate="raise")),
                       decode(y, phi, 4, DecodeConfig()))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_iht_matches_reference(use_kernels):
    """Fixed-step IHT (τ = 0.25) on a real aggregate: the plain decoder
    against ``repro.decode.iht``, the kernel loop against ``fused_iht``."""
    from repro.decode import DecodeConfig as JDC, decode as jdecode
    from repro_torch.decode import DecodeConfig as TDC, decode as tdecode
    s, d, k = 256, 1024, 64
    rng = np.random.default_rng(5)
    phi = (rng.standard_normal((s, d)) / np.sqrt(s)).astype(np.float32)
    y = rng.standard_normal((5, s)).astype(np.float32)
    kw = dict(algorithm="iht", iters=6, tau=0.25, use_kernels=use_kernels,
              ht="bisect")
    want = _np(jdecode(jnp.asarray(y), jnp.asarray(phi), k, JDC(**kw)))
    got = tdecode(_t(y), _t(phi), k, TDC(**kw)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
