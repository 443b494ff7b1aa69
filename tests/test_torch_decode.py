"""The rest of the port's ``decode/`` and ``core/`` against the reference,
on the CPU: ``niht``, ``fused_iht``, the ``iht_fused`` registry entry, the
restricted spectral estimate behind ``validate``, chunked top-κ, eq. (40)
and the RIP estimate of eq. (41).

Tolerances:
- exact: the ``validate="raise"`` / ``"fallback"`` decisions at τ·λ̂ =
  1.75 and 2.005 (``tests/test_decode.py``'s two sides of the edge), the
  ``topk_sparsify_chunked`` masks, ``sparsification_error_bound``.
- rtol = atol = 1e-5, as ``tests/test_torch_obcsaa.py`` holds fixed-step
  IHT: ``niht``, ``fused_iht`` and ``iht_fused`` (f32 products summed in
  another order); λ̂ to rtol 1e-5.
- ``rip_constant_estimate`` with the reference's supports and values
  injected: rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.measurement import rip_constant_estimate as jrip
from repro.core.sparsify import sparsification_error_bound as jseb
from repro.core.sparsify import topk_sparsify_chunked as jchunked
from repro.decode import DecodeConfig as JDC
from repro.decode import decode as jdecode
from repro.decode import fused_iht as jfused
from repro.decode import niht as jniht
from repro.decode.iht import iht_step_stable as jstable
from repro.decode.iht import restricted_spectral_estimate as jlam
from repro_torch.core.measurement import rip_constant_estimate
from repro_torch.core.sparsify import (sparsification_error_bound,
                                       topk_sparsify_chunked)
from repro_torch.decode import (IHT_STABILITY_BOUND, DecodeConfig, decode,
                                fused_iht, iht_step_stable, niht,
                                resolve_validate,
                                restricted_spectral_estimate)


def _measurements(n=8, s=512, d=1024, k_true=60, noise=0.01, seed=0):
    rng = np.random.default_rng(seed)
    phi = (rng.standard_normal((s, d)) / np.sqrt(s)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    keep = np.argsort(-np.abs(x), axis=1)[:, :k_true]
    x_true = np.zeros_like(x)
    np.put_along_axis(x_true, keep, np.take_along_axis(x, keep, 1), 1)
    y = (x_true @ phi.T + noise * rng.standard_normal((n, s))).astype(
        np.float32)
    return y, phi, x_true


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("ht", ["sort", "bisect"])
def test_niht_matches_reference(ht):
    y, phi, _ = _measurements()
    cfg = dict(algorithm="niht", iters=8, ht=ht)
    _close(decode(torch.from_numpy(y), torch.from_numpy(phi), 64,
                  DecodeConfig(**cfg)),
           jdecode(jnp.asarray(y), jnp.asarray(phi), 64, JDC(**cfg)))
    x0 = np.asarray(_measurements(seed=3)[2])
    _close(niht(torch.from_numpy(y), torch.from_numpy(phi), 64, iters=3,
                x0=torch.from_numpy(x0)),
           jniht(jnp.asarray(y), jnp.asarray(phi), 64, iters=3,
                 x0=jnp.asarray(x0)))


@pytest.mark.parametrize("n,warm", [(13, False), (8, True)])
def test_fused_iht_matches_reference(n, warm):
    """The kernel loop (K3 residual, K4, K1; their plain versions here)
    against the reference's Pallas loop in interpret mode."""
    y, phi, x_true = _measurements(n=n)
    x0 = x_true if warm else None
    got = fused_iht(torch.from_numpy(y), torch.from_numpy(phi), 64, iters=6,
                    tau=0.25,
                    x0=None if x0 is None else torch.from_numpy(x0))
    want = jfused(jnp.asarray(y), jnp.asarray(phi), 64, iters=6, tau=0.25,
                  x0=None if x0 is None else jnp.asarray(x0),
                  interpret=True)
    _close(got, want)


def test_iht_fused_registry_entry_matches_reference():
    y, phi, x_true = _measurements()
    cfg = dict(algorithm="iht_fused", iters=5, tau=0.25)
    _close(decode(torch.from_numpy(y), torch.from_numpy(phi), 64,
                  DecodeConfig(**cfg), x0=torch.from_numpy(x_true)),
           jdecode(jnp.asarray(y), jnp.asarray(phi), 64, JDC(**cfg),
                   x0=jnp.asarray(x_true)))


def test_restricted_spectral_estimate_matches_reference():
    _, phi, _ = _measurements()
    for k in (64, 256):
        lam = float(restricted_spectral_estimate(torch.from_numpy(phi), k))
        want = float(jlam(jnp.asarray(phi), k))
        assert lam == pytest.approx(want, rel=1e-5)
        assert 1.0 < lam < 6.0
    lam = float(jlam(jnp.asarray(phi), 256))
    for tau in (0.5 / lam, 2.5 / lam):
        assert bool(iht_step_stable(torch.from_numpy(phi), 256, tau)) == \
            bool(jstable(jnp.asarray(phi), 256, tau))


@pytest.mark.parametrize("edge", [1.75, 2.005])
def test_validate_decisions_match_reference(edge):
    """τ with τ·λ̂ = 1.75 (stable) and 2.005 (past the edge): "raise"
    raises exactly where the reference does, and "fallback" decodes with
    niht exactly where the reference does."""
    y, phi, _ = _measurements()
    lam = float(jlam(jnp.asarray(phi), 256))
    tau = edge / lam
    ty, tphi = torch.from_numpy(y), torch.from_numpy(phi)
    unstable = edge >= IHT_STABILITY_BOUND
    kw = dict(algorithm="iht", iters=4, tau=tau)
    for mode in ("raise", "fallback"):
        ref_raised = port_raised = False
        try:
            jdecode(jnp.asarray(y), jnp.asarray(phi), 256,
                    JDC(validate=mode, **kw))
        except ValueError:
            ref_raised = True
        try:
            resolved = resolve_validate(DecodeConfig(validate=mode, **kw),
                                        tphi, 256)
        except ValueError as e:
            port_raised = True
            assert "unstable" in str(e)
        assert port_raised == ref_raised == (unstable and mode == "raise")
        if not port_raised:
            assert resolved.validate == "off"
            assert resolved.algorithm == ("niht" if unstable else "iht")
    fb = decode(ty, tphi, 256, DecodeConfig(validate="fallback", **kw))
    alt = decode(ty, tphi, 256, DecodeConfig(
        algorithm="niht" if unstable else "iht", iters=4, tau=tau))
    assert torch.equal(fb, alt)
    with pytest.raises(ValueError, match="validate"):
        decode(ty, tphi, 64, DecodeConfig(algorithm="iht", validate="maybe"))


@pytest.mark.parametrize("shape,k,chunk", [((4096,), 40, 1024),
                                           ((3, 512), 17, 512)])
def test_topk_sparsify_chunked_masks_exact(shape, k, chunk):
    g = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    sg, mask = topk_sparsify_chunked(torch.from_numpy(g), k, chunk)
    jsg, jmask = jchunked(jnp.asarray(g), k, chunk)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(sg.numpy(), np.asarray(jsg))
    with pytest.raises(ValueError, match="chunks"):
        topk_sparsify_chunked(torch.zeros(1000), 4, 512)


@pytest.mark.parametrize("D,kappa,G,delta", [(50890, 1040, 10.0, 0.2),
                                             (3190, 128, 1.0, 0.05)])
def test_sparsification_error_bound_exact(D, kappa, G, delta):
    assert sparsification_error_bound(D, kappa, G, delta) == \
        jseb(D, kappa, G, delta)


@pytest.mark.parametrize("s,d,k", [(128, 512, 16), (256, 1024, 64)])
def test_rip_constant_estimate_injected_draws(s, d, k):
    """The reference draws supports and values from ``seed``; the same
    draws, made with JAX as it makes them, go into the port."""
    phi = (np.random.default_rng(2).standard_normal((s, d))
           / np.sqrt(s)).astype(np.float32)
    n_trials, seed = 16, 1
    sup, val = [], []
    for key in jax.random.split(jax.random.PRNGKey(seed), n_trials):
        k1, k2 = jax.random.split(key)
        sup.append(np.asarray(jax.random.choice(k1, d, (k,),
                                                replace=False)))
        val.append(np.asarray(jax.random.normal(k2, (k,))))
    got = rip_constant_estimate(torch.from_numpy(phi), k, n_trials, seed,
                                supports=torch.from_numpy(np.stack(sup)),
                                values=torch.from_numpy(np.stack(val)))
    want = jrip(jnp.asarray(phi), k, n_trials, seed)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    own = rip_constant_estimate(torch.from_numpy(phi), k, n_trials, seed)
    assert 0.0 < float(own) < 1.0
    assert torch.equal(own, rip_constant_estimate(torch.from_numpy(phi), k,
                                                  n_trials, seed))
