"""The port's kernel wrappers against ``repro.kernels`` on the same NumPy
inputs. JAX runs its Pallas kernels as ``tests/test_kernels.py`` does
(``repro.kernels.ops``, interpret mode on the CPU); the port runs on the
CPU, i.e. through each kernel's plain PyTorch version.

Tolerances:
- topk_select masks and values: exact. Both run the same 32-round f32
  bisection, op for op. The CUDA kernel finds the same threshold from two
  order statistics and a replay of the 32 steps on scalars; a model of
  that (below) is held bit for bit to the plain version and to the
  Pallas kernel in interpret mode. XLA on the CPU flushes subnormal
  floats to zero, so the row whose threshold falls among subnormals is
  held to the plain version only.
- signs (sign / pack / sign_residual): a lane may differ only where
  |x·Φ_s| ≤ 2·D·2⁻²⁴·‖x‖·‖Φ_s‖ — each f32 sum of D products is within
  D·2⁻²⁴·‖x‖‖Φ_s‖ of the exact value, and the two packages sum in
  different orders.
- float projections and back-projections: rtol = atol = 1e-5 (f32 sums in
  another order).
- BIHT: cosine ≥ 0.999 per row and ≥ 95% support overlap, because one
  flipped borderline lane changes every later iterate; the oracles of
  ``kernels/ref.py``: ``biht_ref`` by NMSE ≤ 1e-6 and ≥ 95% support
  overlap, ``sign_residual_planes_ref`` exact apart from borderline
  lanes (as tests/test_torch_packed.py holds K5).

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cs_project as jcs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import topk_select as jtopk
from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.sign import pack_signs, unpack_bits
from repro_torch.kernels.cs_project import project
from repro_torch.kernels.topk_select import N_BISECT, topk_select_plain


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _phi(s, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((s, d)) / np.sqrt(s)).astype(np.float32)


def _rows(n, d, seed, k=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if k is not None:   # k-sparse rows, like the top-κ output the path feeds
        drop = np.argsort(-np.abs(x), axis=1)[:, k:]
        np.put_along_axis(x, drop, 0.0, axis=1)
    return x


def _hard_flips(phi, x, got, want):
    """Lanes where two ±1 arrays differ although the projection is not
    borderline (see the module docstring)."""
    d = x.shape[1]
    acc = x.astype(np.float64) @ phi.astype(np.float64).T
    lim = 2 * d * 2.0 ** -24 * (np.linalg.norm(x.astype(np.float64), axis=1)
                                [:, None]
                                * np.linalg.norm(phi.astype(np.float64),
                                                 axis=1)[None])
    return int(np.sum((got != want) & (np.abs(acc) > lim)))


@pytest.mark.parametrize("n,d,k", [(8, 256, 5), (13, 1024, 64),
                                   (3, 512, 1), (7, 1000, 33)])
def test_topk_select_exact(n, d, k):
    x = _rows(n, d, n * d + k)
    x[0, k // 2:] = 0.0      # a row with fewer than k nonzeros
    x[1, 5] = -x[1, 6]       # a magnitude tie
    gv, gm = ops.topk_select(_t(x), k)
    wv, wm = jops.topk_select(jnp.asarray(x), k)
    assert gm.dtype == torch.int8 and gv.dtype == torch.float32
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gm[0].sum() == d  # the lo fallback selects the whole row


def test_topk_select_tail_chunk():
    """The zero-padded last chunk of the MLP gradient: 1738 live entries
    of 4096 at the paper's geometry, here 6370 - 6*1024 = 226 of 1024."""
    x = np.zeros((4, 1024), np.float32)
    x[:, :226] = _rows(4, 226, 3)
    x[2, 20:] = 0.0
    gv, gm = ops.topk_select(_t(x), 32)
    wv, wm = jops.topk_select(jnp.asarray(x), 32)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def _threshold_by_order_stats(row: torch.Tensor, k: int) -> torch.Tensor:
    """The CUDA kernel's threshold, modelled with a sort: v(j), the j-th
    largest |x| (+inf for j <= 0, -inf for j > D), decides every step of
    the bisection, since cnt(t) = #{|x| >= t} > k exactly when
    t <= v(k+1), and cnt(t) >= k exactly when t <= v(k). The 32 steps are
    then replayed on f32 scalars in the Pallas kernel's op order."""
    a = row.abs()
    desc = torch.sort(a, descending=True).values
    inf = torch.tensor(float("inf"))

    def v(j):
        return inf if j <= 0 else -inf if j > a.numel() else desc[j - 1]

    amax, vk1, vk = desc[0], v(k + 1), v(k)
    lo, hi = torch.tensor(0.0), amax
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        if mid <= vk1:
            lo = mid
        else:
            hi = mid
    sel_hi = torch.minimum(hi, amax)
    return sel_hi if sel_hi <= vk else lo


def _adversarial_rows(d: int, kappa: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    rows = {"gaussian": rng.standard_normal(d) * 1e-2,
            "ties": np.round(rng.standard_normal(d) * 3),
            "few_nonzeros": np.where(np.arange(d) < kappa // 2,
                                     rng.standard_normal(d), 0.0),
            "zeros": np.zeros(d), "negative_zeros": -np.zeros(d)}
    r = rng.standard_normal(d)
    r[::2] = -0.0
    rows["mixed_zeros"] = r
    r = rng.standard_normal(d)
    r[d // 3] = np.inf
    rows["inf"] = r
    r = rng.standard_normal(d)
    r[::3] *= 1e-40            # subnormal entries below a normal threshold
    rows["some_subnormals"] = r
    rows["subnormals"] = rng.standard_normal(d) * 1e-39
    return {name: r.astype(np.float32) for name, r in rows.items()}


def _bits(t):
    return np.asarray(t).view(np.int32)


@pytest.mark.parametrize("d,kappa", [(64, 16), (1000, 33)])
@pytest.mark.parametrize("which", ["0", "1", "kappa", "D", "D+3"])
def test_topk_order_statistics_replay(d, kappa, which):
    """The order-statistic threshold gives the plain version's masks and
    values bit for bit, and the Pallas kernel's (interpret mode) masks and
    values (the JAX package writes +0.0 where an unselected entry is
    negative), except where XLA on the CPU flushes the threshold's
    subnormals to zero."""
    k = {"0": 0, "1": 1, "kappa": kappa, "D": d, "D+3": d + 3}[which]
    rows = _adversarial_rows(d, kappa, d + k)
    x = np.stack(list(rows.values()))
    pv, pm = topk_select_plain(_t(x), k)
    jv, jm = jtopk.topk_select(jnp.asarray(x), k, interpret=True)
    for i, (name, row) in enumerate(rows.items()):
        r = _t(row)
        mask = r.abs() >= _threshold_by_order_stats(r, k)
        val = r * mask.to(r.dtype)
        np.testing.assert_array_equal(mask.to(torch.int8).numpy(),
                                      pm[i].numpy(), err_msg=name)
        np.testing.assert_array_equal(_bits(val), _bits(pv[i]), err_msg=name)
        if name != "subnormals":
            np.testing.assert_array_equal(mask.to(torch.int8).numpy(),
                                          np.asarray(jm)[i], err_msg=name)
            # values equal; the sign of an unselected zero may differ
            np.testing.assert_array_equal(val.numpy(), np.asarray(jv)[i],
                                          err_msg=name)


@pytest.mark.parametrize("n,s,d", [(8, 128, 512), (28, 256, 1024),
                                   (130, 128, 512)])
def test_cs_project_epilogues(n, s, d):
    phi, x = _phi(s, d, 0), _rows(n, d, 1, k=d // 16)
    jp, jx = jnp.asarray(phi), jnp.asarray(x)
    raw = ops.cs_project(_t(phi), _t(x)).numpy()
    np.testing.assert_allclose(raw, np.asarray(jops.cs_project(jp, jx)),
                               rtol=1e-5, atol=1e-5)
    sg = ops.cs_project_sign(_t(phi), _t(x)).numpy()
    assert _hard_flips(phi, x, sg,
                       np.asarray(jops.cs_project_sign(jp, jx))) == 0
    words = ops.cs_project_pack(_t(phi), _t(x))
    assert words.dtype == torch.int32 and words.shape == (n, s // 32)
    from repro.kernels.sign import unpack_signs as j_unpack
    unpacked = np.asarray(j_unpack(jnp.asarray(words.numpy().view(
        np.uint32))))
    np.testing.assert_array_equal(unpacked, sg)   # pack ≡ sign, one rule
    assert _hard_flips(phi, x, unpacked, np.asarray(j_unpack(
        jops.cs_project_pack(jp, jx)))) == 0


@pytest.mark.parametrize("mode", ["sign_residual", "residual"])
def test_cs_project_residual_epilogues(mode):
    n, s, d = 13, 256, 1024
    phi, x = _phi(s, d, 2), _rows(n, d, 3, k=64)
    y = np.where(_rows(n, s, 4) >= 0, 1.0, -1.0).astype(np.float32)
    got = project(_t(phi), _t(x), mode=mode, y=_t(y)).numpy()
    want = np.asarray(jcs.project(jnp.asarray(phi), jnp.asarray(x),
                                  mode=mode, y=jnp.asarray(y),
                                  interpret=True))
    if mode == "residual":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert set(np.unique(got)) <= {-2.0, 0.0, 2.0}
        assert _hard_flips(phi, x, y - got, y - want) == 0


@pytest.mark.parametrize("n,s,d", [(8, 128, 512), (13, 256, 1024)])
@pytest.mark.parametrize("tau", [1.0, 1.0 / 256])
def test_backproject(n, s, d, tau):
    phi, x, r = _phi(s, d, 5), _rows(n, d, 6), _rows(n, s, 7)
    got = ops.backproject(_t(x), _t(r), _t(phi), tau).numpy()
    want = np.asarray(jops.backproject(jnp.asarray(x), jnp.asarray(r),
                                       jnp.asarray(phi), tau))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("iters", [0, 5])
def test_biht_composition(iters):
    n, s, d, k = 7, 256, 1024, 32
    phi, xt = _phi(s, d, 8), _rows(n, d, 9, k=k)
    y = np.where(xt @ phi.T >= 0, 1.0, -1.0).astype(np.float32)
    got = ops.biht(_t(y), _t(phi), k, iters, 1.0).numpy()
    want = np.asarray(jops.biht(jnp.asarray(y), jnp.asarray(phi), k, iters,
                                1.0))
    cos = np.sum(got * want, axis=1) / (np.linalg.norm(got, axis=1)
                                       * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.999, cos
    overlap = np.sum((got != 0) & (want != 0), axis=1) / np.maximum(
        np.sum(want != 0, axis=1), 1)
    assert overlap.min() >= 0.95, overlap
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("iters", [0, 5])
def test_biht_ref_matches_reference(iters):
    n, s, d, k = 7, 256, 1024, 32
    phi, xt = _phi(s, d, 18), _rows(n, d, 19, k=k)
    y = np.where(xt @ phi.T >= 0, 1.0, -1.0).astype(np.float32)
    got = tref.biht_ref(_t(y), _t(phi), k, iters, 1.0).numpy()
    want = np.asarray(jref.biht_ref(jnp.asarray(y), jnp.asarray(phi), k,
                                    iters, 1.0))
    nmse = np.sum((got - want) ** 2, axis=1) / np.sum(want ** 2, axis=1)
    assert nmse.max() <= 1e-6, nmse
    overlap = np.sum((got != 0) & (want != 0), axis=1) / np.maximum(
        np.sum(want != 0, axis=1), 1)
    assert overlap.min() >= 0.95, overlap
    # the oracle is the plain composition of the kernels' loop
    np.testing.assert_allclose(got, ops.biht(_t(y), _t(phi), k, iters,
                                             1.0).numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n,s,d", [(8, 128, 512), (13, 256, 1024)])
def test_sign_residual_planes_ref(n, s, d):
    phi, x, xt = _phi(s, d, 20), _rows(n, d, 21, k=d // 16), _rows(n, d, 22)
    y = np.where(xt @ phi.T >= 0, 1.0, -1.0).astype(np.float32)
    yp = pack_signs(_t(y))
    plus, minus = tref.sign_residual_planes_ref(_t(phi), _t(x), yp)
    jplus, jminus = jref.sign_residual_planes_ref(
        jnp.asarray(phi), jnp.asarray(x),
        jnp.asarray(yp.numpy().view(np.uint32)))

    def resid(p, m):
        return 2.0 * (unpack_bits(_t(np.asarray(p).view(np.int32)),
                                  torch.float32)
                      - unpack_bits(_t(np.asarray(m).view(np.int32)),
                                    torch.float32)).numpy()

    got, want = resid(plus, minus), resid(jplus, jminus)
    assert _hard_flips(phi, x, y - got, y - want) == 0
    same = ~np.any(got != want, axis=1)
    np.testing.assert_array_equal(plus.numpy()[same].view(np.uint32),
                                  np.asarray(jplus)[same])
    np.testing.assert_array_equal(minus.numpy()[same].view(np.uint32),
                                  np.asarray(jminus)[same])
    np.testing.assert_array_equal(got, y - ops.cs_project_sign(
        _t(phi), _t(x)).numpy())


def test_plain_path_builds_nothing(monkeypatch):
    """A CPU tensor never reaches the kernel library or its counters."""
    def no_lib():
        raise AssertionError("a CPU tensor reached the CUDA kernel library")

    monkeypatch.setattr(build, "lib", no_lib)
    build.reset_launch_counts()
    x = _t(_rows(4, 256, 10))
    phi = _t(_phi(64, 256, 11))
    ops.topk_select(x, 8)
    ops.cs_project_sign(phi, x)
    ops.backproject(x, ops.cs_project(phi, x), phi, 0.5)
    ops.biht(ops.cs_project_sign(phi, x), phi, 8, 2, 1.0)
    assert set(build.launch_counts().values()) == {0}


@pytest.mark.parametrize("bad", ["cpu", "dtype", "shape", "layout"])
def test_kernel_input_checks(bad):
    """What a CUDA wrapper refuses before it reaches the kernel (checked
    here on CPU tensors: the check refuses them first of all)."""
    t = {"cpu": torch.zeros(4, 8),
         "dtype": torch.zeros(4, 8, dtype=torch.int32),
         "shape": torch.zeros(8, 4), "layout": torch.zeros(8, 4).T}[bad]
    with pytest.raises(ValueError, match="CUDA kernel takes"):
        build.require(t, "x", (4, 8))


def test_unported_modes_raise():
    """Every mode of the reference is ported; an unknown one raises."""
    with pytest.raises(ValueError, match="unknown mode 'bogus'"):
        project(torch.zeros(32, 8), torch.zeros(2, 8), mode="bogus")

