"""The port's worker-group collectives (``repro_torch.dist.collectives``)
in a gloo world of 8 ranks on the CPU, against the reference's
``repro.dist.collectives`` with no worker axes (its single-device form)
and NumPy sums.

One world runs every case (``_torch_dist_child.collectives``); the ranks
import no JAX. Tolerances:
- exact: ``psum_bits_mac`` (the int32 lane sums, and scaled by a power of
  two against the reference's f32 einsum of the unpacked symbols, as
  ``tests/test_distributed.py``'s packed-MAC test holds the reference),
  the gathers, ``shard_slice``, the replicated gather's backward, the
  broadcast, the byte counter, and every rank's copy of each result.
- f32 sums of 8 values (``psum``, ``pmean``, the gather's summed
  backward): rtol 1e-6 against NumPy's float64 sum (the ranks add in
  another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_child import run_world
from repro.dist import collectives as jcoll
from repro.kernels.sign import pack_signs, unpack_signs
from repro_torch.dist import collectives as coll

W = 8
ROWS, S = 4096, 32          # the zoo's geometry: a block of rows, S_c = 32
SCALE = 0.5                 # K·b_t, a power of two


def _inputs():
    rng = np.random.default_rng(0)
    proj = rng.standard_normal((W, ROWS, S)).astype(np.float32)
    packed = np.asarray(pack_signs(jnp.asarray(proj)))   # (W, ROWS, 1) u32
    beta = np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32)
    return {
        "proj": proj, "packed": packed, "beta_np": beta,
        "words": torch.from_numpy(packed.view(np.int32).copy()),
        "beta": torch.from_numpy(beta),
        "x": torch.from_numpy(rng.standard_normal((W, 3, 5))
                              .astype(np.float32)),
        "rows": torch.arange(W * 6, dtype=torch.float32).reshape(W * 6, 1),
        "w": torch.from_numpy(rng.standard_normal((W, 3, 5 * W))
                              .astype(np.float32)),
        "shard": torch.from_numpy(rng.standard_normal((W, 2, 4))
                                  .astype(np.float32)),
        "cot": torch.from_numpy(rng.standard_normal((2 * W, 4))
                                .astype(np.float32)),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inp = _inputs()
    sent = {k: v for k, v in inp.items() if isinstance(v, torch.Tensor)}
    outs = run_world("collectives", W, sent, tmp_path_factory.mktemp("c8"))
    return inp, outs


def _same_on_all(outs, key):
    for o in outs[1:]:
        assert torch.equal(o[key], outs[0][key]), key


def test_axis_index_and_size(world):
    _, outs = world
    assert [o["index"] for o in outs] == list(range(W))
    assert all(o["size"] == W for o in outs)


def test_psum_bits_mac_bitwise(world):
    """The int32 lane sums of 8 ranks equal the reference's per-worker
    ``psum_bits_mac`` (no axes) summed, and scaled by K·b_t they equal
    the f32 einsum of the unpacked symbols bit for bit."""
    inp, outs = world
    _same_on_all(outs, "bits")
    want = sum(np.asarray(jcoll.psum_bits_mac(
        jnp.asarray(inp["packed"][u]), (), beta_i=jnp.float32(b)))
        for u, b in enumerate(inp["beta_np"]))
    got = outs[0]["bits"]
    assert got.dtype == torch.int32 and got.shape == (ROWS, S)
    np.testing.assert_array_equal(got.numpy(), want)
    y_ref = np.asarray(jnp.einsum(
        "u,uns->ns", jnp.asarray(inp["beta_np"] * SCALE),
        unpack_signs(jnp.asarray(inp["packed"]))))
    np.testing.assert_array_equal(
        (got.to(torch.float32) * SCALE).numpy(), y_ref)


def test_psum_and_pmean(world):
    inp, outs = world
    _same_on_all(outs, "psum")
    _same_on_all(outs, "pmean")
    x = inp["x"].numpy().astype(np.float64)
    np.testing.assert_allclose(outs[0]["psum"].numpy(), x.sum(0), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(outs[0]["pmean"].numpy(), x.mean(0),
                               rtol=1e-6, atol=1e-6)
    for r, o in enumerate(outs):     # psum leaves its input as it was
        assert torch.equal(o["x_after"], inp["x"][r])


def test_all_gather(world):
    inp, outs = world
    x = inp["x"]
    for o in outs:
        assert torch.equal(o["stacked"], x)
        assert torch.equal(o["tiled"], torch.cat(list(x), dim=1))


def test_all_gather_backward_sums_cotangents(world):
    """d/dx_r of Σ_s w_s ⊙ gather(x) is the sum over the ranks s of w_s's
    block r: every rank's loss reaches every rank's input."""
    inp, outs = world
    w = inp["w"].numpy().astype(np.float64).sum(0)      # (3, 5·W)
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["gather_grad"].numpy(),
                                   w[:, 5 * r:5 * (r + 1)], rtol=1e-6,
                                   atol=1e-6)


def test_replicated_gather_backward_is_local_slice(world):
    inp, outs = world
    full = torch.cat(list(inp["shard"]))
    for r, o in enumerate(outs):
        assert torch.equal(o["rep_full"], full)
        assert torch.equal(o["rep_grad"], inp["cot"][2 * r:2 * (r + 1)])


def test_shard_slice_and_broadcast(world):
    inp, outs = world
    for r, o in enumerate(outs):
        assert torch.equal(o["slice"], inp["rows"][6 * r:6 * (r + 1)])
        assert torch.equal(o["bcast"], inp["x"][W - 1])


def test_replicated_check(world):
    _, outs = world
    assert all(o["replicated_same"] for o in outs)
    assert not any(o["replicated_differ"] for o in outs)


def test_byte_counter(world):
    """Bytes by kind: what each rank handed to the collectives."""
    inp, outs = world
    xb, sb = inp["x"][0].numel() * 4, inp["shard"][0].numel() * 4
    for o in outs:
        st = o["stats"]
        assert st["bytes"] == {"all_reduce": ROWS * S * 4 + 2 * xb + W * xb,
                               "all_gather": 3 * xb + sb}
        assert st["calls"] == {"all_reduce": 4, "all_gather": 4}
        assert set(st["ms"]) == {"all_reduce", "all_gather"}


def test_no_group_is_one_worker():
    """``group=None`` is the reference's "no worker axes": the identity,
    rank 0 of 1, and nothing counted."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    proj = rng.standard_normal((5, 64)).astype(np.float32)
    packed = np.asarray(pack_signs(jnp.asarray(proj)))
    coll.reset_counters()
    assert coll.psum(x, None) is x and coll.pmean(x, None) is x
    assert coll.axis_index(None) == 0 and coll.axis_size(None) == 1
    assert coll.shard_slice(x, None) is x
    assert coll.all_gather(x, None, tiled=True) is x
    np.testing.assert_array_equal(
        coll.all_gather(x, None, axis=1).numpy(),
        np.asarray(jcoll.all_gather(jnp.asarray(x.numpy()), (), axis=1)))
    assert coll.replicated_gather(None, 1)(x) is x
    assert coll.broadcast(x, None) is x and coll.replicated([x], None)
    words = torch.from_numpy(packed.view(np.int32).copy())
    got = coll.psum_bits_mac(words, None, beta_i=torch.tensor(1.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jcoll.psum_bits_mac(jnp.asarray(packed), (),
                            beta_i=jnp.float32(1.0))))
    assert coll.stats() == {"bytes": {}, "calls": {}, "ms": {}}
