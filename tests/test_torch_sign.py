"""The port's sign predicate and packed codec, bit-exact against
``repro.kernels.sign`` on the same NumPy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sign as jsign
from repro_torch.kernels import sign as tsign


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = 0.0          # sign(0) = +1
    flat[3::11] = -0.0       # and so is sign(-0.0): x >= 0 holds
    return x


def _words(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("shape", [(64,), (3, 96), (2, 5, 128)])
def test_sign_pm1_exact(shape):
    x = _inputs(shape, 0)
    got = tsign.sign_pm1(torch.from_numpy(x)).numpy()
    want = np.asarray(jsign.sign_pm1(jnp.asarray(x)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {-1.0, 1.0}


@pytest.mark.parametrize("shape", [(32,), (4, 256), (2, 3, 1024)])
def test_pack_signs_exact(shape):
    x = _inputs(shape, 1)
    got = tsign.pack_signs(torch.from_numpy(x))
    assert got.dtype == torch.int32
    want = np.asarray(jsign.pack_signs(jnp.asarray(x)))
    np.testing.assert_array_equal(_words(got), want)
    bits = x >= 0
    np.testing.assert_array_equal(
        _words(tsign.pack_bool(torch.from_numpy(bits))),
        np.asarray(jsign.pack_bool(jnp.asarray(bits))))


def test_pack_is_lsb_first():
    x = -np.ones((1, 64), np.float32)
    x[0, 0] = 1.0     # bit 0 of word 0
    x[0, 31] = 1.0    # bit 31 of word 0 (the int32 sign bit)
    x[0, 33] = 1.0    # bit 1 of word 1
    got = _words(tsign.pack_signs(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, [[1 | (1 << 31), 2]])


@pytest.mark.parametrize("seed", [0, 1])
def test_unpack_exact_and_round_trip(seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, (3, 8), dtype=np.uint64).astype(
        np.uint32)
    tw = torch.from_numpy(words.view(np.int32))
    np.testing.assert_array_equal(
        tsign.unpack_bits(tw).numpy(),
        np.asarray(jsign.unpack_bits(jnp.asarray(words))))
    signs = tsign.unpack_signs(tw)
    np.testing.assert_array_equal(
        signs.numpy(), np.asarray(jsign.unpack_signs(jnp.asarray(words))))
    np.testing.assert_array_equal(_words(tsign.pack_signs(signs)), words)


def test_packed_width_errors():
    assert tsign.packed_width(1024) == jsign.packed_width(1024) == 32
    for n in (31, 100):
        with pytest.raises(ValueError):
            tsign.packed_width(n)
    with pytest.raises(ValueError):
        tsign.pack_signs(torch.zeros(2, 48))
