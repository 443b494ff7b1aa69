"""The port's packed 1-bit BIHT path (K5 ``pack_sign_residual``, K6
``backproject_packed``, ``decode/fused.py`` and the registry's packed
route) against ``repro`` on the same NumPy inputs. JAX runs its Pallas
kernels in interpret mode (``repro.kernels.ops``), as tests/test_packed.py
does; the port runs on the CPU, i.e. through each kernel's plain version.
Packed words are int32 in the port and uint32 in JAX: they are compared
through ``view(np.uint32)``.

Tolerances:
- K5 planes: exact, except that the fresh sign of a lane may differ where
  |x·Φ_s| ≤ 2·D·2⁻²⁴·‖x‖·‖Φ_s‖ (two f32 sums in different orders, see
  tests/test_torch_kernels.py); 2·(plus − minus) equals the port's own
  ``sign_residual`` exactly (one sign predicate on the same product).
- K6: rtol = atol = 1e-5 against JAX; exactly the port's ``backproject``
  on the equivalent f32 residual.
- packed decode: exactly the unpacked decode in the port (with and
  without kernels, as tests/test_packed.py holds the reference); against
  JAX the ``biht`` parity of tests/test_torch_kernels.py (cosine ≥ 0.999
  per row, support overlap ≥ 95%).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.decode import DecodeConfig as JDC
from repro.decode import decode as j_decode
from repro.kernels import ops as jops
from repro_torch.decode import DecodeConfig, decode, fused_biht_packed
from repro_torch.kernels import build, ops
from repro_torch.kernels.backproject import packed_residual
from repro_torch.kernels.cs_project import project
from repro_torch.kernels.sign import pack_signs, unpack_signs


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _inputs(n, s, d, k, seed):
    """Φ (S, D) N(0, 1/S), k-sparse rows x (n, D), ±1 measurements y of
    other sparse rows, packed as int32 words."""
    rng = np.random.default_rng(seed)
    phi = (rng.standard_normal((s, d)) / np.sqrt(s)).astype(np.float32)
    rows = rng.standard_normal((2, n, d)).astype(np.float32)
    drop = np.argsort(-np.abs(rows), axis=-1)[..., k:]
    np.put_along_axis(rows, drop, 0.0, axis=-1)
    x, xt = rows
    y = np.where(xt @ phi.T >= 0, 1.0, -1.0).astype(np.float32)
    return phi, x, y, pack_signs(_t(y))


def _hard_flips(phi, x, got, want):
    d = x.shape[1]
    acc = x.astype(np.float64) @ phi.astype(np.float64).T
    lim = 2 * d * 2.0 ** -24 * (np.linalg.norm(x.astype(np.float64), axis=1)
                                [:, None]
                                * np.linalg.norm(phi.astype(np.float64),
                                                 axis=1)[None])
    return int(np.sum((got != want) & (np.abs(acc) > lim)))


def _u32(words):
    return jnp.asarray(words.numpy().view(np.uint32))


def _resid_of(plus, minus):
    return packed_residual(_t(np.asarray(plus).view(np.int32)),
                           _t(np.asarray(minus).view(np.int32))).numpy()


SHAPES = [(8, 128, 512, 16), (13, 256, 1024, 64), (130, 128, 512, 32)]


@pytest.mark.parametrize("n,s,d,k", SHAPES)
def test_pack_sign_residual(n, s, d, k):
    phi, x, y, yp = _inputs(n, s, d, k, n + s)
    plus, minus = ops.cs_pack_sign_residual(_t(phi), _t(x), yp)
    assert plus.dtype == minus.dtype == torch.int32
    assert plus.shape == minus.shape == (n, s // 32)
    assert not bool((plus & minus).any())
    jplus, jminus = jops.cs_pack_sign_residual(jnp.asarray(phi),
                                               jnp.asarray(x), _u32(yp))
    got = packed_residual(plus, minus).numpy()
    want = _resid_of(jplus, jminus)
    # the planes encode the residual lane for lane: equal outside the
    # borderline lanes, and word for word on rows without a flip
    assert _hard_flips(phi, x, y - got, y - want) == 0
    flipped = np.any(got != want, axis=1)
    np.testing.assert_array_equal(plus.numpy()[~flipped].view(np.uint32),
                                  np.asarray(jplus)[~flipped])
    np.testing.assert_array_equal(minus.numpy()[~flipped].view(np.uint32),
                                  np.asarray(jminus)[~flipped])
    # one sign predicate: the planes are the f32 sign residual
    np.testing.assert_array_equal(
        got, project(_t(phi), _t(x), mode="sign_residual", y=_t(y)).numpy())


@pytest.mark.parametrize("n,s,d,k", SHAPES[:2])
@pytest.mark.parametrize("tau", [1.0, 1.0 / 256])
def test_backproject_packed(n, s, d, k, tau):
    phi, x, y, yp = _inputs(n, s, d, k, 7 * n + s)
    plus, minus = ops.cs_pack_sign_residual(_t(phi), _t(x), yp)
    got = ops.backproject_packed(_t(x), plus, minus, _t(phi), tau)
    want = jops.backproject_packed(jnp.asarray(x), _u32(plus), _u32(minus),
                                   jnp.asarray(phi), tau)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, ops.backproject(
        _t(x), packed_residual(plus, minus), _t(phi), tau))


def test_packed_shape_errors():
    phi, x = torch.zeros(48, 64), torch.zeros(2, 64)
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.cs_pack_sign_residual(phi, x,
                                  torch.zeros(2, 1, dtype=torch.int32))
    phi = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="int32"):
        ops.cs_pack_sign_residual(phi, x, torch.zeros(2, 2))
    words = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="bit-planes"):
        ops.backproject_packed(x, words, words.float(), phi, 1.0)


def test_fused_biht_packed_equals_biht():
    """tests/test_packed.py's exactness of the packed loop, in the port."""
    phi, x, _, _ = _inputs(4, 128, 512, 50, 3)
    y = ops.cs_project_sign(_t(phi), ops.topk_select(_t(x), 50)[0])
    got = fused_biht_packed(pack_signs(y), _t(phi), 50, iters=12, tau=1.0)
    assert torch.equal(got, ops.biht(y, _t(phi), 50, iters=12, tau=1.0))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_decode_packed(use_kernels):
    """Through the registry: packed y decodes exactly as its unpacked ±1
    values do, and like JAX's packed decode within the biht parity."""
    n, s, d, k = 5, 128, 512, 40
    phi, _, y, yp = _inputs(n, s, d, k, 11)
    cfg = DecodeConfig(algorithm="biht", iters=8, packed=True,
                       use_kernels=use_kernels)
    got = decode(yp, _t(phi), k, cfg)
    want = decode(unpack_signs(yp), _t(phi), k,
                  DecodeConfig(algorithm="biht", iters=8,
                               use_kernels=use_kernels))
    assert torch.equal(got, want)
    assert torch.equal(unpack_signs(yp), _t(y))
    ref = np.asarray(j_decode(_u32(yp), jnp.asarray(phi), k,
                              JDC(algorithm="biht", iters=8, packed=True,
                                  use_kernels=use_kernels)))
    got = got.numpy()
    cos = np.sum(got * ref, axis=1) / (np.linalg.norm(got, axis=1)
                                      * np.linalg.norm(ref, axis=1))
    assert cos.min() >= 0.999, cos
    overlap = np.sum((got != 0) & (ref != 0), axis=1) / np.maximum(
        np.sum(ref != 0, axis=1), 1)
    assert overlap.min() >= 0.95, overlap


def test_plain_packed_path_builds_nothing(monkeypatch):
    """CPU tensors never reach the kernel library or its counters."""
    def no_lib():
        raise AssertionError("a CPU tensor reached the CUDA kernel library")

    monkeypatch.setattr(build, "lib", no_lib)
    build.reset_launch_counts()
    phi, _, _, yp = _inputs(3, 64, 256, 8, 5)
    decode(yp, _t(phi), 8, DecodeConfig(iters=2, packed=True,
                                        use_kernels=True))
    ops.prefix_eval(torch.ones(2, 5), torch.ones(2, 5), torch.ones(2, 8))
    assert set(build.launch_counts().values()) == {0}
