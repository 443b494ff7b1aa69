"""The port's zoo round (``repro_torch.engine.zoo``) against
``repro.engine.zoo``'s single-device oracle, built on a 4 x 2
``jax.sharding.AbstractMesh``, on the CPU. The reference's Φ and its
``fold_in(key, t)`` draws (fades, AWGN) are injected.

Tolerances:
- exact: ``_hash_u01`` (indices up to 2³² − 1), ``_surrogate_grads``
  (also where the uint32 element index wraps), the geometry and its
  error messages, ``chunk_params`` / ``chunk_worker_grads`` /
  ``unchunk``, the partition specs, β and |M_t|.
- the packed MAC's int32 lane sums: equal except on lanes where some
  scheduled worker's projection is borderline
  (|x·Φ_s| ≤ 2·D_c·2⁻²⁴·‖x‖·‖Φ_s‖, where two f32 sums of one product
  set in different orders may disagree on the sign); magnitude sums rtol
  1e-6 (norms summed in another order).
- over a 2-round chain at D = 16,000 (``ZOO_OB``, ``tests/test_zoo.py``):
  ĝ through the movement Δ = p − p₀ = −lr·ĝ, chunk by chunk: each chunk
  within 1e-4 of its own norm but for at most 1% of the chunks, which may
  part (a borderline sign, or the decode's bisection threshold on a near
  tie that the GEMMs round apart: one chunk of 199 seen, with equal MAC
  sums); the held chunks within 1e-4 of the whole movement; support
  overlap ≥ 0.99; ‖ĝ‖, b_t and the budget terms rtol 1e-5 (1e-3 for ‖ĝ‖
  where a chunk parted).
- ``round_from_grads`` on the reference's own gradient of every config's
  smoke model (one worker, 1 x 1): the same decode and parameter bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_MODULES, InputShape
from repro.configs import get_smoke_config as jsmoke
from repro.core import channel as jchan
from repro.core import obcsaa as job
from repro.core.sparsify import flatten_pytree as jflatten
from repro.core.sparsify import topk_sparsify_bisect as jbisect
from repro.engine import zoo as jzoo
from repro.kernels.sign import unpack_bits as junpack
from repro.models.registry import build_model as jbuild
from repro_torch.core import obcsaa as tob
from repro_torch.engine import zoo as tzoo
from repro_torch.launch.mesh import make_zoo_mesh

ZOO_OB = dict(chunk=256, measure=64, topk=16, biht_iters=3,
              recon_alg="iht", spmd_topk=True, packed=True,
              bisect_iters=16)
D = 16000                       # pads to 64 chunks, 8 per cell at 4 x 2
KEY, NV, PMAX, LR = 7, 1e-4, 10.0, 0.1


def _np(a):
    return np.array(a, copy=True)


def _pair(D_, w=4, m=2, **kw):
    jz = jzoo.build_zoo_round(job.OBCSAAConfig(**ZOO_OB), D_,
                              AbstractMesh((w, m), ("data", "model")), **kw)
    tz = tzoo.build_zoo_round(tob.OBCSAAConfig(**ZOO_OB), D_,
                              make_zoo_mesh(w, m), device="cpu",
                              phi=_np(job.OBCSAAConfig(**ZOO_OB).phi()),
                              **kw)
    return jz, tz


@pytest.fixture(scope="module")
def rounds():
    return {s: _pair(D, scheduler=s) for s in ("all", "greedy_batched")}


def ref_draws(jz, key, t):
    """The reference prologue's draws of round t (``zoo.py:340-348``)."""
    k_t = jax.random.fold_in(key, t)
    h, _ = jchan.draw_fades(jax.random.fold_in(k_t, 0), (jz.U,))
    z = jax.random.normal(jax.random.fold_in(k_t, 1),
                          (jz.n_chunks, jz.ob.measure))
    return tzoo.ZooDraws(torch.from_numpy(_np(h)), torch.from_numpy(_np(z)))


def borderline(phi, x):
    """(rows, S) bool: |x·Φ_s| within the f32 reorder bound."""
    x = x.double()
    phi = torch.as_tensor(phi).double()
    acc = x @ phi.T
    lim = 2 * x.shape[1] * 2.0 ** -24 * (
        torch.linalg.vector_norm(x, dim=1)[:, None]
        * torch.linalg.vector_norm(phi, dim=1)[None])
    return acc.abs() <= lim


def ref_mac(jz, chunked, t, beta, grads=None):
    """The reference oracle's packed MAC sums of round t and every
    worker's transmitted sparse chunks (its own compression, eq. 12)."""
    sums, sparse = 0, []
    for u in range(jz.U):
        g = grads[u] if grads is not None else jz._surrogate_grads(
            chunked, jnp.zeros((), jnp.int32), jnp.int32(u), jnp.int32(t))
        sp = _np(jbisect(g, jz.ob.topk, iters=jz.ob.bisect_iters)[0])
        signs, _ = job.compress_chunks(jz.ob, g, None)
        sums = sums + (2 * _np(junpack(signs, jnp.int32)) - 1) \
            * int(beta[u])
        sparse.append(torch.from_numpy(sp))
    return sums, sparse


def check_mac(phi, want, got, sparse, beta):
    """Lane sums equal but where a scheduled worker is borderline."""
    diff = torch.from_numpy(want) != got
    if bool(diff.any()):
        border = torch.zeros_like(diff)
        for u, sp in enumerate(sparse):
            if beta[u]:
                border |= borderline(phi, sp)
        assert not bool((diff & ~border).any())


def held(c0, got, want, share=1e-4, overlap=0.99):
    """ĝ through Δ = p − p₀ = −lr·ĝ, chunk by chunk: every chunk's Δ
    within ``share`` of its norm, but for at most 1% of the chunks (at
    least one), and the support overlap of Δ over all chunks. A chunk
    parts where a worker's borderline sign reaches the MAC or where the
    decode's bisection threshold meets a near tie that the two GEMMs round
    apart (seen: one chunk of 199, 13.7% of its norm, with equal MAC
    sums)."""
    dg, dw = got - c0, want - c0
    err = np.linalg.norm(dg - dw, axis=1)
    parted = err > share * np.linalg.norm(dw, axis=1)
    assert parted.sum() <= max(1, dg.shape[0] // 100), parted.sum()
    sup = dw != 0
    assert np.sum(sup & (dg != 0)) >= overlap * np.sum(sup)
    assert np.linalg.norm(err[~parted]) <= share * np.linalg.norm(dw)


def _make_batch(model, B=2, S=24, seed=0):
    """Small concrete inputs from the model's input_specs (as
    ``tests/test_zoo.py`` makes them)."""
    cfg = model.cfg
    if cfg.family == "vlm":
        S = cfg.num_image_tokens + 8
    specs = model.input_specs(InputShape("zoo_smoke", S, B, "train"))
    key = jax.random.PRNGKey(seed)
    batch = {}
    for name in sorted(specs):
        sd = specs[name]
        key, k = jax.random.split(key)
        if jnp.issubdtype(sd.dtype, jnp.integer):
            batch[name] = jax.random.randint(k, sd.shape, 0,
                                             cfg.vocab_size, sd.dtype)
        else:
            batch[name] = (0.05 * jax.random.normal(k, sd.shape)
                           ).astype(sd.dtype)
    return batch


def held_stats(st, rst):
    assert int(st.n_scheduled) == int(rst.n_scheduled)
    np.testing.assert_allclose(float(st.b_t), float(rst.b_t), rtol=1e-5)
    np.testing.assert_allclose(float(st.ghat_norm), float(rst.ghat_norm),
                               rtol=1e-3)
    for a, b in zip(st.budget, rst.budget):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5)


# --- exact pieces ----------------------------------------------------------------

def test_hash_u01_exact():
    idx = np.array([0, 1, 2, 255, 16000, 123456789, 2 ** 31 - 1, 2 ** 31,
                    2 ** 32 - 3, 2 ** 32 - 2, 2 ** 32 - 1], np.uint32)
    for w, t in [(0, 0), (3, 7), (1023, 2 ** 20), (2 ** 31, 5)]:
        want = _np(jzoo._hash_u01(jnp.asarray(idx), jnp.uint32(w),
                                  jnp.uint32(t)))
        got = tzoo._hash_u01(torch.from_numpy(idx.astype(np.int64)), w, t)
        np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        tzoo._hash_u01(torch.from_numpy(idx.astype(np.int64)), 2, 9).numpy(),
        _np(jzoo._hash_u01(jnp.asarray(idx), jnp.int32(2), jnp.int32(9))))


@pytest.mark.parametrize("D_,off", [(D, 0), (D, 40), (2 ** 32 - 5, None)])
def test_surrogate_grads_exact(D_, off):
    """At D = 2³² − 5 the last chunks' element indices pass 2³² and wrap
    (uint32), and the indices at or above D get zero gradients."""
    jz, tz = _pair(D_, 1, 1)
    if off is None:
        off = jz.n_chunks - 3
    rng = np.random.default_rng(1)
    p = rng.standard_normal((3, 256)).astype(np.float32)
    for u, t in [(0, 0), (1, 5)]:
        want = _np(jz._surrogate_grads(jnp.asarray(p), jnp.int32(off),
                                       jnp.int32(u), jnp.int32(t)))
        got = tz._surrogate_grads(torch.from_numpy(p), off, u, t).numpy()
        np.testing.assert_array_equal(got, want)
    if D_ > 2 ** 31:
        assert (want == 0).any() and (want != 0).any()


def test_geometry_and_messages(rounds):
    jz, tz = rounds["all"]
    for name in ("U", "n_model", "n_chunks", "D_pad", "n_half", "n_local",
                 "block", "block_dec", "_s_eff", "_kappa_eff"):
        assert getattr(tz, name) == getattr(jz, name), name
    assert tz.spec == tuple(jz.spec) and tz.grads_spec == tuple(
        jz.grads_spec)
    for kw in ({"n_chunks": 60}, {"n_chunks": 8}):
        with pytest.raises(ValueError) as je:
            _pair(D, **kw)
        with pytest.raises(ValueError) as te:
            tzoo.build_zoo_round(tob.OBCSAAConfig(**ZOO_OB), D,
                                 make_zoo_mesh(4, 2), device="cpu", **kw)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="below 2\\*\\*32"):
        tzoo.build_zoo_round(tob.OBCSAAConfig(**ZOO_OB), 2 ** 32,
                             make_zoo_mesh(1, 1), device="cpu")
    rng = np.random.default_rng(2)
    flat = rng.standard_normal(D).astype(np.float32)
    c = tz.chunk_params(torch.from_numpy(flat))
    np.testing.assert_array_equal(c.numpy(), _np(jz.chunk_params(
        jnp.asarray(flat))))
    np.testing.assert_array_equal(tz.unchunk(c).numpy(), flat)
    g = rng.standard_normal((4, D)).astype(np.float32)
    want = np.pad(g, ((0, 0), (0, jz.D_pad - D))).reshape(4, -1, 256)
    np.testing.assert_array_equal(tz.chunk_worker_grads(g).numpy(), want)


def test_default_draws_keyed_by_round():
    tz = tzoo.build_zoo_round(tob.OBCSAAConfig(**ZOO_OB), D,
                              make_zoo_mesh(4, 2), device="cpu")
    a, b = tz.draws(3)(5), tz.draws(3)(5)
    assert torch.equal(a.h, b.h) and torch.equal(a.z, b.z)
    assert a.h.shape == (4,) and a.z.shape == (tz.n_chunks, 64)
    assert not torch.equal(a.z, tz.draws(3)(6).z)
    assert not torch.equal(a.z, tz.draws(4)(5).z)
    p = torch.zeros((tz.n_chunks, 256))
    q = p.clone()
    tz.round_gen(p, 5, 3, NV, PMAX, LR)
    tz.round_gen(q, 5, 3, NV, PMAX, LR, draws=a)
    assert torch.equal(p, q)


# --- rounds against the oracle -------------------------------------------------

@pytest.mark.parametrize("scheduler", ["all", "greedy_batched"])
def test_surrogate_chain_matches_reference(rounds, scheduler):
    """Two chained rounds from the same parameters, each package on its
    own carry: the MAC sums, ĝ, the parameters and the stats held."""
    jz, tz = rounds[scheduler]
    key = jax.random.PRNGKey(KEY)
    flat = jax.random.normal(jax.random.PRNGKey(1), (D,), jnp.float32)
    r = jz.chunk_params(flat)
    p = torch.from_numpy(_np(r))
    for t in range(2):
        dr = ref_draws(jz, key, t)
        _, beta, _, _ = jz._prologue(jnp.int32(t), key, NV, PMAX)
        r0, p0 = _np(r), p.clone()
        want_mac, sparse = ref_mac(jz, r, t, _np(beta))
        seen = {}

        def hook(stage, **info):
            if stage == "mac":
                seen.update(info)

        _, st = tz.round_gen(p, t, 0, NV, PMAX, LR, draws=dr, hook=hook)
        r, rst = jz.reference_round(r, t, key, NV, PMAX, LR)
        check_mac(tz.phi, want_mac, seen["y_sum"], sparse, _np(beta))
        held(r0, p.numpy(), _np(r))
        held_stats(st, rst)
        assert p0.shape == p.shape


@pytest.mark.parametrize("arch", sorted(ARCH_MODULES))
def test_round_from_grads_matches_reference(arch):
    """The reference's own gradient of each config's smoke model (one
    worker, 1 x 1) through both rounds."""
    model = jbuild(jsmoke(arch))
    params = model.init(jax.random.PRNGKey(0))
    batch = _make_batch(model)
    grads = jax.jit(jax.grad(lambda p: model.loss_fn(p, batch)[0]))(params)
    gflat, _ = jflatten(grads)
    jz, tz = _pair(int(gflat.shape[0]), 1, 1)
    key = jax.random.PRNGKey(1)
    c = jz.chunk_params(params)
    gref = jnp.pad(gflat[None], ((0, 0), (0, jz.D_pad - jz.D))).reshape(
        1, jz.n_chunks, 256)
    r, rst = jz.reference_round(c, 0, key, NV, PMAX, LR, grads=gref)
    p = torch.from_numpy(_np(c))
    g = tz.chunk_worker_grads(_np(gflat)[None])
    _, st = tz.round_from_grads(p, g, 0, 0, NV, PMAX, LR,
                                draws=ref_draws(jz, key, 0))
    held(_np(c), p.numpy(), _np(r))
    held_stats(st, rst)
    assert np.isfinite(p.numpy()).all()


def test_blocks_change_no_round(monkeypatch, rounds):
    """Blocks of 3 chunk rows (a cell compresses its half's 32 rows in 12
    blocks, 3 of each owner's 8 rows, and decodes its 8 in 3, the last
    ragged) against one block of each owner's rows: the same round, each
    chunk's
    movement within 1e-5 of its norm (the CPU's GEMMs round some rows by
    the rows in a call)."""
    _, tz = rounds["greedy_batched"]
    monkeypatch.setattr(tzoo, "BLOCK_BYTES", 3 * 4 * 256)
    small = tzoo.build_zoo_round(tob.OBCSAAConfig(**ZOO_OB), D,
                                 make_zoo_mesh(4, 2), device="cpu",
                                 scheduler="greedy_batched", phi=tz.phi)
    assert small.block_rows == 3 and tz.block_rows >= tz.n_half
    p0 = tz.chunk_params(torch.randn(D, generator=torch.Generator()
                                     .manual_seed(3)))
    dr = small.draws(5)(1)
    pieces = []
    outs = []
    for zr in (tz, small):
        p = p0.clone()
        zr.round_gen(p, 1, 5, NV, PMAX, LR, draws=dr,
                     hook=lambda stage, **i: pieces.append(stage))
        outs.append((p - p0).numpy())
    assert pieces.count("decode") == 8 + 8 * 3
    assert pieces.count("compress") == 8 * 4 + 8 * 12
    err = np.linalg.norm(outs[0] - outs[1], axis=1)
    assert (err <= 1e-5 * np.linalg.norm(outs[0], axis=1)).all()
