"""The port's encoder-decoder (``repro_torch.models.encdec``) and the
cross-attention and no-RoPE paths of ``repro_torch.models.attention``
against ``repro`` on the same NumPy inputs, at whisper-base's smoke size
(2 + 2 layers, d_model 256, 64 frames); the reference's weights come in
through ``repro_torch.convert``.

Tolerances, each against the max |value| of the reference's output:
- f32 (``scaled(cfg, dtype="float32")``): 1e-5 for the attention paths,
  ``encode``, ``decode_full``, the cross K/V and every decode step's
  logits and cache leaves (sums in another order).
- bf16 (the config's own dtype): 3e-2 for the decode logits (one bf16
  rounding is 4e-3 relative and compounds over the layers).
- exact: the cross cache is read, never written, by a decode step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import attention as jattn
from repro.models import encdec as jenc
from repro.models.registry import build_model as jbuild
from repro_torch import configs as tcfg
from repro_torch.convert import lm_params_from_reference, lm_params_to_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tenc
from repro_torch.models.registry import build_model as tbuild

ARCH = "whisper-base"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach().float().numpy() if torch.is_tensor(got)
                     else got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


def _gqa(seed, d=32, H=4, KV=2, hd=16):
    rng = _rng(seed)
    p = {"wq": rng.standard_normal((d, H, hd)) / np.sqrt(d),
         "wk": rng.standard_normal((d, KV, hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, KV, hd)) / np.sqrt(d),
         "wo": rng.standard_normal((H, hd, d)) / np.sqrt(H * hd)}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("use_rope", [False, True])
@pytest.mark.parametrize("cross,causal", [(False, False), (True, False),
                                          (True, True)])
def test_gqa_forward_kv_and_causal(cross, causal, use_rope):
    """Self-attention without a mask, and cross-attention to a longer
    ``kv`` (RoPE then rotates q only); the k/v it returns are the
    projections of ``kv``."""
    p = _gqa(1)
    rng = _rng(2)
    x = rng.standard_normal((2, 24, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 40, 32)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32)
    kv_pos = np.arange(40, dtype=np.int32)
    a = tcfg.AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16,
                             logit_softcap=5.0)
    ja = jcfg.AttentionConfig(**dataclasses.asdict(a))
    jkw = dict(kv=jnp.asarray(kv), kv_positions=jnp.asarray(kv_pos)) \
        if cross else {}
    tkw = dict(kv=_t(kv), kv_positions=_t(kv_pos)) if cross else {}
    jo, (jk, jv) = jattn.gqa_forward(p, jnp.asarray(x), ja,
                                     positions=jnp.asarray(pos),
                                     causal=causal, use_rope=use_rope, **jkw)
    to, (tk, tv) = tattn.gqa_forward({k: _t(v) for k, v in p.items()},
                                     _t(x), a, positions=_t(pos),
                                     causal=causal, use_rope=use_rope, **tkw)
    for got, want, what in ((to, jo, "out"), (tk, jk, "k"), (tv, jv, "v")):
        _close(got, want, 1e-5, what)


@pytest.mark.parametrize("use_rope", [False, True])
def test_gqa_decode_cross(use_rope):
    """``cross=True`` attends over the whole given cache without a mask
    and writes nothing into it; ``use_rope=False`` leaves q and the new
    self-attention row unrotated."""
    p = _gqa(3)
    rng = _rng(4)
    a = tcfg.AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16)
    ja = jcfg.AttentionConfig(**dataclasses.asdict(a))
    x = rng.standard_normal((2, 1, 32)).astype(np.float32)
    ck = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    for cross in (True, False):
        for pos in (0, 17, 39):
            jo, jk, jv = jattn.gqa_decode(
                p, jnp.asarray(x), ja, cache_k=jnp.asarray(ck),
                cache_v=jnp.asarray(cv), pos=jnp.int32(pos),
                use_rope=use_rope, cross=cross)
            tk, tv = _t(ck), _t(cv)
            to, tk2, tv2 = tattn.gqa_decode(tp, _t(x), a, cache_k=tk,
                                            cache_v=tv, pos=pos,
                                            use_rope=use_rope, cross=cross)
            assert tk2 is tk and tv2 is tv
            _close(to, jo, 1e-5, f"out cross={cross} pos={pos}")
            _close(tk, jk, 1e-5, "k")
            _close(tv, jv, 1e-5, "v")
            if cross:
                assert torch.equal(tk, _t(ck)) and torch.equal(tv, _t(cv))


def _pair(dtype="float32"):
    jc = jcfg.scaled(jcfg.get_smoke_config(ARCH), dtype=dtype)
    tc = tcfg.scaled(tcfg.get_smoke_config(ARCH), dtype=dtype)
    jp = jbuild(jc).init(jax.random.PRNGKey(0))
    tp = lm_params_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    frames = (_rng(5).standard_normal((2, jc.encoder_seq_len, jc.d_model))
              * 0.5).astype(np.float32)
    return jc, tc, jp, tp, frames


def test_encode_and_decode_full():
    jc, tc, jp, tp, frames = _pair()
    tok = _rng(6).integers(0, jc.vocab_size, (2, 12)).astype(np.int32)
    jenc_out = jax.jit(lambda p, f: jenc.encode(p, jc, f))(jp, frames)
    with torch.no_grad():
        tenc_out = tenc.encode(tp, tc, _t(frames))
    _close(tenc_out, jenc_out, 1e-5, "encode")
    jl = jax.jit(lambda p, t, e: jenc.decode_full(p, jc, t, e,
                                                  remat=False))(
        jp, tok, jenc_out)
    jh = jenc.decode_full(jp, jc, tok, jenc_out, remat=True,
                          return_hidden=True)
    with torch.no_grad():
        tl = tenc.decode_full(tp, tc, _t(tok), tenc_out, remat=False)
        th = tenc.decode_full(tp, tc, _t(tok), tenc_out, remat="full",
                              return_hidden=True)
    _close(tl, jl, 1e-5, "logits")
    _close(th, jh, 1e-5, "hidden")


def test_positions_wrap_the_table():
    """The decoder's learned positions are read at position % 4096."""
    _, tc, _, tp, _ = _pair()
    got = tenc._dec_positions(tp, torch.tensor([0, 4095, 4096, 9000]),
                              torch.float32)
    table = tp["pos_embedding"]
    assert torch.equal(got, table[[0, 4095, 0, 9000 % 4096]])


def test_seed_cross_cache():
    jc, tc, jp, tp, frames = _pair()
    jenc_out = jenc.encode(jp, jc, frames)
    jcache = jenc.seed_cross_cache(jp, jc, jenc.init_encdec_cache(jc, 2, 8),
                                   jenc_out)
    tcache = tenc.seed_cross_cache(
        tp, tc, tenc.init_encdec_cache(tc, 2, 8, "cpu"),
        _t(np.asarray(jenc_out)))
    assert list(tcache) == ["k", "v", "cross_k", "cross_v"]
    for name in ("cross_k", "cross_v"):
        _close(tcache[name], jcache[name], 1e-5, name)
    for name in ("k", "v"):
        assert not tcache[name].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_decode_steps(dtype):
    """Both packages seed the cross K/V from the same encoder output,
    then decode 6 tokens from position 0 step by step; f32: logits and
    every cache leaf within 1e-5 of their max; bf16: logits within 3e-2."""
    jc, tc, jp, tp, frames = _pair(dtype)
    jm = jbuild(jc)
    tok = _rng(7).integers(0, jc.vocab_size, (2, 6)).astype(np.int32)
    _, jcache = jax.jit(jm.prefill)(jp, {"frames": jnp.asarray(frames),
                                         "tokens": jnp.asarray(tok)})
    tcache = lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, jcache), device="cpu")
    cross = {k: tcache[k].clone() for k in ("cross_k", "cross_v")}
    jdec = jax.jit(jm.decode_step)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for pos in range(6):
        t = tok[:, pos:pos + 1]
        jlogits, jcache = jdec(jp, jcache, jnp.asarray(t), jnp.int32(pos))
        tlogits, tcache = tenc.encdec_decode_step(tp, tc, tcache, _t(t), pos)
        assert tlogits.shape == (2, 1, tc.vocab_size)
        _close(tlogits, jlogits, tol, f"logits at {pos}")
        if dtype == "float32":
            for name, want in jcache.items():
                _close(tcache[name], want, tol, f"{name} at {pos}")
    for k, v in cross.items():
        assert torch.equal(tcache[k], v)


def test_prefill_matches_reference():
    """``Model.prefill``: the teacher-forced logits and the cache (self
    k/v zero, cross k/v seeded), f32."""
    jc, tc, jp, tp, frames = _pair()
    tok = _rng(8).integers(0, jc.vocab_size, (2, 10)).astype(np.int32)
    batch = {"frames": frames, "tokens": tok}
    jl, jcache = jax.jit(jbuild(jc).prefill)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tcache = tbuild(tc).prefill(tp, {k: _t(v) for k, v in batch.items()})
    _close(tl, jl, 1e-5, "logits")
    got = lm_params_to_numpy(tcache)
    assert sorted(got) == sorted(jcache)
    for name, want in jcache.items():
        _close(got[name], want, 1e-5, name)


def test_decode_matches_decode_full():
    """Within the port, the reference test's gate
    (``tests/test_decode_consistency.py``): 16 tokens stepped from the
    seeded cross K/V against ``decode_full``: argmax equal, rtol = atol =
    2e-2 (f32)."""
    _, tc, _, tp, frames = _pair()
    m = tbuild(tc)
    tok = _t(_rng(9).integers(0, tc.vocab_size, (2, 16)).astype(np.int32))
    with torch.no_grad():
        enc = tenc.encode(tp, tc, _t(frames))
        full = tenc.decode_full(tp, tc, tok, enc, remat=False)
    cache = tenc.seed_cross_cache(tp, tc, m.init_cache(2, 16, "cpu"), enc)
    outs = []
    for pos in range(16):
        logits, cache = m.decode_step(tp, cache, tok[:, pos:pos + 1], pos)
        outs.append(logits[:, 0])
    a, d = full.numpy(), torch.stack(outs, dim=1).numpy()
    np.testing.assert_array_equal(a.argmax(-1), d.argmax(-1))
    np.testing.assert_allclose(a, d, rtol=2e-2, atol=2e-2)
