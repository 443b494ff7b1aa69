"""The port's LM decode path (``repro_torch.models``: GQA decode, the
flash-decoding split, MLA, MoE, the KV cache, the SSM and hybrid caches,
the VLM's image prefix, the encoder-decoder's cross cache, prefill and
``decode_step``; ``repro_torch.launch.decode_demo``) against ``repro`` on
the same NumPy inputs; the reference's weights and caches go in through
``repro_torch.convert``. The SSM, hybrid and audio families have no
prefill seeding in either package: their reference caches are built by
stepping the prompt through ``decode_step`` (audio: after
``seed_cross_cache``).

Tolerances:
- exact: ``_route``'s expert indices against ``jax.lax.top_k`` (bf16
  logits, ties included: both take the lower index first); the MoE
  dispatch's slots, keeps and drop count against a NumPy count of earlier
  routes; the cache's leaf names, shapes, dtypes and order; the seeded
  prefill's offset; greedy tokens of the demo's loop in f32.
- f32 functions (attention decode, MLA, ``_moe_tokens``, route weights
  and aux): rtol = atol = 1e-5 (sums in another order).
- the model in f32: prefill logits, every cache leaf and decode logits
  within 1e-5 of the leaf's max |value|.
- the model in bf16: decode logits within 3e-2 of their max |value| (one
  bf16 rounding is 4e-3 relative, and it compounds over the layers).
- decode ≡ forward within the port: the reference test's gate
  (``tests/test_decode_consistency.py``): argmax equal, rtol = atol =
  2e-2, in f32 with ``capacity_factor = 8`` so no route is dropped in
  either; the hybrid's decoded k/v rows against its prefill seeds within
  1e-5 of their max, and exactly zero on the layers without attention.
"""
import dataclasses
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch.steps import make_seeded_prefill as jseeded_prefill
from repro.models import attention as jattn
from repro.models import encdec as jenc
from repro.models import moe as jmoe
from repro.models.registry import build_model as jbuild
from repro_torch import configs as tcfg
from repro_torch import tree
from repro_torch.convert import lm_params_from_reference, lm_params_to_numpy
from repro_torch.launch.decode_demo import generate
from repro_torch.launch.steps import make_seeded_prefill
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tenc
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import build_model as tbuild

LM_ARCHS = ["starcoder2-15b", "gemma2-2b", "gemma3-27b", "minicpm3-4b",
            "mixtral-8x22b", "deepseek-v2-lite-16b"]
RECURRENT = ["mamba2-2.7b", "zamba2-7b"]
RECURRENT_FAMILIES = ("ssm", "hybrid")
NEW_ARCHS = RECURRENT + ["internvl2-1b", "whisper-base"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rng(seed):
    return np.random.default_rng(seed)


def _bf16_values(a):
    """a rounded to bf16, as f32 NumPy: both packages get the same bf16."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _close_to_max(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


# --- MoE ---------------------------------------------------------------------

def _route_logits(kind, T, E, seed):
    rng = _rng(seed)
    if kind == "random":
        x = rng.standard_normal((T, E)).astype(np.float32) * 2
    elif kind == "few_levels":      # heavy ties: 3 distinct values a row
        x = rng.integers(-1, 2, (T, E)).astype(np.float32) * 0.5
    elif kind == "all_equal":
        x = np.full((T, E), 0.75, np.float32)
    else:                           # near-ties that bf16 rounds together
        x = (1.0 + rng.integers(0, 4, (T, E)) * 2.0 ** -10).astype(
            np.float32)
    return _bf16_values(x)


@pytest.mark.parametrize("E,k", [(64, 6), (8, 2), (4, 2)])
@pytest.mark.parametrize("kind", ["random", "few_levels", "all_equal",
                                  "bf16_rounded"])
def test_route_indices_exact(kind, E, k):
    logits = _route_logits(kind, 96, E, seed=E + k)
    jw, jidx, jaux = jmoe._route(jnp.asarray(logits, jnp.bfloat16), k)
    tw, tidx, taux = tmoe._route(_t(logits).to(torch.bfloat16), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-5)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)


def _dispatch_oracle(idx, E, capacity):
    """Slots by counting earlier routes to each expert, token-major."""
    seen = np.zeros(E, np.int64)
    slot, keep = [], []
    for e in idx.reshape(-1):
        keep.append(seen[e] < capacity)
        slot.append(seen[e] if seen[e] < capacity else capacity - 1)
        seen[e] += 1
    return np.array(slot), np.array(keep)


def _moe_params(d, f, m, gated, seed):
    rng = _rng(seed)
    E = m.num_experts
    p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "ew1": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "ew2": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    if gated:
        p["ew3"] = rng.standard_normal((E, d, f)) / np.sqrt(d)
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        p["shared"] = {"w1": rng.standard_normal((d, fs)) / np.sqrt(d),
                       "w2": rng.standard_normal((fs, d)) / np.sqrt(fs)}
        if gated:
            p["shared"]["w3"] = rng.standard_normal((d, fs)) / np.sqrt(d)
    return jax.tree_util.tree_map(lambda a: a.astype(np.float32), p)


@pytest.mark.parametrize("E,k,shared,gated,capacity", [
    (4, 2, 0, True, 8),         # 128 routes into 4 x 8 slots: most drop
    (8, 2, 1, True, 0),         # capacity from the factor (1.25)
    (16, 6, 2, False, 16),      # GELU experts, shared experts, drops
])
def test_moe_tokens_dispatch(E, k, shared, gated, capacity):
    d, f, T = 32, 24, 64
    m = tcfg.MoEConfig(num_experts=E, num_shared_experts=shared, top_k=k,
                       capacity_factor=1.25)
    jm = jcfg.MoEConfig(num_experts=E, num_shared_experts=shared, top_k=k,
                        capacity_factor=1.25)
    p = _moe_params(d, f, m, gated, seed=E)
    xf = _rng(E + 1).standard_normal((T, d)).astype(np.float32)
    tp = lm_params_from_reference(p, device="cpu")
    cap = capacity or tmoe.capacity_of(T, m)
    _, idx, _ = tmoe._route(_t(xf) @ tp["router"], k)
    flat, slot, keep = tmoe._dispatch(idx, E, cap)
    want_slot, want_keep = _dispatch_oracle(idx.numpy(), E, cap)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert int((~keep).sum()) == int((~want_keep).sum())
    if capacity:
        assert int((~keep).sum()) > 0          # the overflow case drops
    jout, jaux = jmoe._moe_tokens(p, jnp.asarray(xf), jm, gated, capacity)
    tout, taux = tmoe._moe_tokens(tp, _t(xf), m, gated, capacity)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)


@pytest.mark.parametrize("S,per_worker", [(32, True), (16, False)])
def test_moe_data_parallel_dispatch(S, per_worker):
    """``moe_forward`` with ``dp=(None, 4)``: with T/W ≥ 64
    each worker's rows dispatch on their own (capacity from T/W) and the
    aux term is the workers' mean, the reference's ``shard_map`` branch
    (``_moe_tokens`` per shard, ``pmean``); below 64 every token
    dispatches together. ``dp=None``: one dispatch."""
    W, B, d, f = 4, 8, 32, 24
    m = tcfg.MoEConfig(num_experts=4, top_k=2, capacity_factor=1.25)
    jm = jcfg.MoEConfig(num_experts=4, top_k=2, capacity_factor=1.25)
    p = _moe_params(d, f, m, True, seed=3)
    x = _rng(4).standard_normal((B, S, d)).astype(np.float32)
    tp = lm_params_from_reference(p, device="cpu")
    xf = x.reshape(-1, d)
    if per_worker:
        parts = [jmoe._moe_tokens(p, jnp.asarray(blk), jm, True, 0)
                 for blk in np.split(xf, W)]
        jout = np.concatenate([np.asarray(o) for o, _ in parts])
        jaux = np.mean([float(a) for _, a in parts])
    else:
        jout, jaux = jmoe._moe_tokens(p, jnp.asarray(xf), jm, True, 0)
    tout, taux = tmoe.moe_forward(tp, _t(x), m, dp=(None, W))
    np.testing.assert_allclose(tout.numpy().reshape(-1, d), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)
    one, _ = tmoe._moe_tokens(tp, _t(xf), m, True, 0)
    got, _ = tmoe.moe_forward(tp, _t(x), m)
    assert torch.equal(got.reshape(-1, d), one)


# --- attention decode --------------------------------------------------------

def _gqa_inputs(seed, B=2, S=64, d=32, H=4, KV=2, hd=16):
    rng = _rng(seed)
    p = {"wq": rng.standard_normal((d, H, hd)) / np.sqrt(d),
         "wk": rng.standard_normal((d, KV, hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, KV, hd)) / np.sqrt(d),
         "wo": rng.standard_normal((H, hd, d)) / np.sqrt(H * hd)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((B, 1, d)).astype(np.float32)
    ck = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    cv = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    return p, x, ck, cv


@pytest.mark.parametrize("chunks", [0, 1, 4, 16])
@pytest.mark.parametrize("window,is_global", [(0, None), (16, False),
                                              (16, True)])
def test_gqa_decode_matches_reference(window, is_global, chunks):
    p, x, ck, cv = _gqa_inputs(seed=chunks + window)
    a = tcfg.AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16,
                             window=window, logit_softcap=5.0)
    ja = jcfg.AttentionConfig(**dataclasses.asdict(a))
    for pos in (0, 37, 63):
        jo, jk, jv = jattn.gqa_decode(
            p, jnp.asarray(x), ja, cache_k=jnp.asarray(ck),
            cache_v=jnp.asarray(cv), pos=jnp.int32(pos),
            is_global=None if is_global is None else jnp.asarray(is_global),
            sharded_cache_chunks=chunks)
        tk, tv = _t(ck), _t(cv)
        to, tk2, tv2 = tattn.gqa_decode(
            {k: _t(v) for k, v in p.items()}, _t(x), a, cache_k=tk,
            cache_v=tv, pos=pos, is_global=is_global,
            sharded_cache_chunks=chunks)
        assert tk2 is tk and tv2 is tv                # written in place
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n_chunks", [1, 4, 16, 48])
@pytest.mark.parametrize("window,is_global", [(None, None), (8, False),
                                              (8, True)])
def test_decode_attention_sharded(n_chunks, window, is_global):
    """Also against the unsplit softmax (``_block_attend``): the split
    is arithmetic only. 48 chunks of a 64-long cache halve to 16."""
    rng = _rng(n_chunks)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    for pos in (0, 20, 63):
        kw = dict(scale=0.25, window=window, cap=3.0, n_chunks=n_chunks)
        want = jattn.decode_attention_sharded(
            q, k, v, jnp.int32(pos),
            is_global=None if is_global is None else jnp.asarray(is_global),
            **kw)
        got = tattn.decode_attention_sharded(_t(q), _t(k), _t(v), pos,
                                             is_global=is_global, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        plain = tattn._block_attend(
            _t(q), _t(k), _t(v), torch.tensor([pos]), torch.arange(64),
            scale=0.25, causal=True, window=window, is_global=is_global,
            cap=3.0)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-lite-16b"])
def test_mla_matches_reference(arch):
    """``mla_forward`` (materialised K) and ``mla_decode`` (absorbed
    latent), q_lora on (minicpm3) and off (deepseek), on the reference's
    layer-0 weights."""
    jc = jcfg.scaled(jcfg.get_smoke_config(arch), dtype="float32")
    tc = tcfg.scaled(tcfg.get_smoke_config(arch), dtype="float32")
    a, ja = tc.attention, jc.attention
    jp = jbuild(jc).init(jax.random.PRNGKey(0))
    jl = jax.tree_util.tree_map(lambda v: np.asarray(v[0]),
                                jp["layers"]["attn"])
    tl = lm_params_from_reference(jl, device="cpu")
    rng = _rng(5)
    B, S = 2, 24
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jo, (jc_kv, jkr) = jattn.mla_forward(jl, jnp.asarray(x), ja,
                                         positions=jnp.asarray(pos))
    to, (tc_kv, tkr) = tattn.mla_forward(tl, _t(x), a, positions=_t(pos))
    for got, want in ((to, jo), (tc_kv, jc_kv), (tkr, jkr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    ckv = rng.standard_normal((B, S, a.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, S, a.qk_rope_dim)).astype(np.float32)
    for p in (0, 11, S - 1):
        x1 = x[:, p:p + 1]
        jo, jckv, jkr = jattn.mla_decode(jl, jnp.asarray(x1), ja,
                                         cache_ckv=jnp.asarray(ckv),
                                         cache_kr=jnp.asarray(kr),
                                         pos=jnp.int32(p))
        tckv, tkr = _t(ckv), _t(kr)
        to, _, _ = tattn.mla_decode(tl, _t(x1), a, cache_ckv=tckv,
                                    cache_kr=tkr, pos=p)
        for got, want in ((to, jo), (tckv, jckv), (tkr, jkr)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


# --- the cache, prefill and decode_step --------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS + NEW_ARCHS)
def test_init_lm_cache_leaves(arch):
    """Leaf names, shapes, dtypes and order equal the reference's, at
    smoke size and (on the meta device) at full width."""
    for get_t, get_j in ((tcfg.get_smoke_config, jcfg.get_smoke_config),
                         (tcfg.get_config, jcfg.get_config)):
        tc, jc = get_t(arch), get_j(arch)
        got = tbuild(tc).init_cache(3, 40, "meta")
        want = jax.eval_shape(lambda: jbuild(jc).init_cache(3, 40))
        g = [(p, tuple(v.shape), str(v.dtype).split(".")[-1])
             for p, v in tree.flatten_with_paths(got)[0]]
        w = [(jax.tree_util.keystr(p), tuple(v.shape), str(v.dtype))
             for p, v in jax.tree_util.tree_leaves_with_path(want)]
        assert g == w


def _pair(arch, dtype="float32", **cfg_kw):
    jc = jcfg.scaled(jcfg.get_smoke_config(arch), dtype=dtype)
    tc = tcfg.scaled(tcfg.get_smoke_config(arch), dtype=dtype)
    if cfg_kw:
        jc = dataclasses.replace(jc, **cfg_kw)
        tc = dataclasses.replace(tc, **cfg_kw)
    jm, tm = jbuild(jc), tbuild(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = lm_params_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    return jm, tm, jp, tp


def _stub(cfg, B, seed):
    """A VLM's image embeddings or an audio model's frames (random f32
    NumPy; each package casts them to the model's dtype)."""
    rng = _rng(seed + 100)
    n = {"vlm": cfg.num_image_tokens, "audio": cfg.encoder_seq_len}.get(
        cfg.family)
    if n is None:
        return {}
    name = "image_embeds" if cfg.family == "vlm" else "frames"
    return {name: (rng.standard_normal((B, n, cfg.d_model)) * 0.5
                   ).astype(np.float32)}


def _batches(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


def _check_cache(tcache, jcache, tol):
    jl = jax.tree_util.tree_leaves_with_path(jcache)
    tl = tree.flatten_with_paths(lm_params_to_numpy(tcache))[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (path, want), (_, got) in zip(jl, tl):
        _close_to_max(got, want, tol, jax.tree_util.keystr(path))
    return [got for _, got in tl]


@pytest.mark.parametrize("arch", LM_ARCHS + ["internvl2-1b"])
def test_prefill_and_seeded_cache(arch):
    """``prefill``'s logits and stacked seeds, then the seeded cache and
    its offset (the image's N positions, then the prompt's), against the
    reference's, in f32."""
    jm, tm, jp, tp = _pair(arch)
    tok = _rng(2).integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    jb, tb = _batches({"tokens": tok, **_stub(tm.cfg, 2, seed=2)})
    off = 12 + (tm.cfg.num_image_tokens if "image_embeds" in tb else 0)
    jlogits, jseeds = jax.jit(jm.prefill)(jp, jb)
    tlogits, tseeds = tm.prefill(tp, tb)
    _close_to_max(tlogits, jlogits, 1e-5, "logits")
    assert len(tseeds) == len(jseeds) == 2
    for got, want in zip(tseeds, jseeds):
        _close_to_max(got, want, 1e-5, "seed")
    _, jcache, joff = jseeded_prefill(jm, off + 8)(jp, jb)
    _, tcache, toff = make_seeded_prefill(tm, off + 8)(tp, tb)
    assert toff == joff == off
    for got in _check_cache(tcache, jcache, 1e-5):
        assert not got[:, :, off:].any()                    # unseeded


def test_seeded_prefill_image_only():
    """A VLM prefix with no prompt tokens: the cache holds the N image
    positions, the offset is N, and decoding the text from there matches
    the reference's (f32, 1e-5 of the max)."""
    jm, tm, jp, tp = _pair("internvl2-1b")
    N = tm.cfg.num_image_tokens
    img = _stub(tm.cfg, 2, seed=3)["image_embeds"]
    tok = _rng(3).integers(0, tm.cfg.vocab_size, (2, 4)).astype(np.int32)
    empty = np.zeros((2, 0), np.int32)
    jb, tb = _batches({"tokens": empty, "image_embeds": img})
    jlogits, jcache, joff = jseeded_prefill(jm, N + 4)(jp, jb)
    tlogits, tcache, toff = make_seeded_prefill(tm, N + 4)(tp, tb)
    assert toff == joff == N
    _close_to_max(tlogits, jlogits, 1e-5, "logits")
    _check_cache(tcache, jcache, 1e-5)
    jdec = jax.jit(jm.decode_step)
    for i in range(4):
        t = tok[:, i:i + 1]
        jl, jcache = jdec(jp, jcache, jnp.asarray(t), jnp.int32(N + i))
        tl, tcache = tm.decode_step(tp, tcache, _t(t), N + i)
        _close_to_max(tl, jl, 1e-5, f"logits at {N + i}")
    _check_cache(tcache, jcache, 1e-5)


@pytest.mark.parametrize("arch", RECURRENT + ["whisper-base"])
def test_prefill_recurrent_families(arch):
    """The SSM and hybrid prefill's stacked seeds ((conv, ssm) and
    (conv, ssm, k, v)) and the audio prefill's cache against the
    reference's (f32, 1e-5 of the max); ``make_seeded_prefill`` refuses
    all three in both packages: their state has no positional slot."""
    jm, tm, jp, tp = _pair(arch)
    tok = _rng(4).integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    jb, tb = _batches({"tokens": tok, **_stub(tm.cfg, 2, seed=4)})
    jlogits, jseeds = jax.jit(jm.prefill)(jp, jb)
    tlogits, tseeds = tm.prefill(tp, tb)
    _close_to_max(tlogits, jlogits, 1e-5, "logits")
    if arch == "whisper-base":
        _check_cache(tseeds, jseeds, 1e-5)
    else:
        assert len(tseeds) == len(jseeds) == (2 if arch == RECURRENT[0]
                                               else 4)
        for got, want in zip(tseeds, jseeds):
            assert got.dtype == (torch.float32 if got.ndim == 5
                                 and got.shape[2] != 12 else got.dtype)
            _close_to_max(got, want, 1e-5, "seed")
    with pytest.raises(NotImplementedError, match="positional"):
        jseeded_prefill(jm, 20)(jp, jb)
    with pytest.raises(NotImplementedError, match="positional"):
        make_seeded_prefill(tm, 20)(tp, tb)


DECODE_CASES = ([(a, "float32", 0) for a in LM_ARCHS + NEW_ARCHS]
                + [(a, "bfloat16", 0) for a in LM_ARCHS + NEW_ARCHS]
                + [("gemma2-2b", "float32", 4), ("mixtral-8x22b",
                                                 "float32", 4)])


def _reference_cache(jm, jp, tok, P, total, stub):
    """The reference's cache after a P-token prompt, and the position
    decoding continues at: seeded from a prefill for the attention
    families (a VLM's image first); stepped token by token for the SSM,
    hybrid and audio families (audio after ``seed_cross_cache``)."""
    cfg = jm.cfg
    if cfg.family in ("dense", "moe", "vlm"):
        jb, _ = _batches({"tokens": tok[:, :P], **stub})
        _, cache, off = jseeded_prefill(jm, total)(jp, jb)
        return cache, off
    cache = jm.init_cache(tok.shape[0], total)
    if cfg.family == "audio":
        cache = jenc.seed_cross_cache(
            jp, cfg, cache, jenc.encode(jp, cfg, jnp.asarray(stub["frames"])))
    jdec = jax.jit(jm.decode_step)
    for pos in range(P):
        _, cache = jdec(jp, cache, jnp.asarray(tok[:, pos:pos + 1]),
                        jnp.int32(pos))
    return cache, P


@pytest.mark.parametrize("arch,dtype,chunks", DECODE_CASES)
def test_decode_steps_match_reference(arch, dtype, chunks):
    """The reference builds its cache from an 8-token prompt
    (``_reference_cache``); the port takes that cache and the weights
    through ``convert`` and both decode 6 more tokens step by step. f32:
    logits and every cache leaf within 1e-5 of their max; bf16: logits
    within 3e-2 of their max."""
    kw = {"decode_sharded_chunks": chunks} if chunks else {}
    jm, tm, jp, tp = _pair(arch, dtype, **kw)
    P, G = 8, 6
    tok = _rng(3).integers(0, tm.cfg.vocab_size, (2, P + G)).astype(np.int32)
    stub = _stub(tm.cfg, 2, seed=3)
    n_img = tm.cfg.num_image_tokens if tm.cfg.family == "vlm" else 0
    jcache, off = _reference_cache(jm, jp, tok, P, n_img + P + G, stub)
    assert off == n_img + P
    tcache = lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, jcache), device="cpu")
    jdec = jax.jit(jm.decode_step)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for i in range(G):
        pos, t = off + i, tok[:, P + i:P + i + 1]
        jlogits, jcache = jdec(jp, jcache, jnp.asarray(t), jnp.int32(pos))
        tlogits, tcache = tm.decode_step(tp, tcache, _t(t), pos)
        assert tlogits.shape == (2, 1, tm.cfg.vocab_size)
        _close_to_max(tlogits, jlogits, tol, f"logits at {pos}")
        if dtype == "float32":
            for name, want in jcache.items():
                _close_to_max(tcache[name], want, tol, f"{name} at {pos}")
    if "ssm" in tcache:     # the state stays f32 in a bf16 model too
        assert tcache["ssm"].dtype == torch.float32


@pytest.mark.parametrize("arch", LM_ARCHS + NEW_ARCHS)
def test_decode_matches_forward(arch):
    """The port's own decode ≡ forward, mirroring
    tests/test_decode_consistency.py: f32, ``capacity_factor = 8`` (no
    drop in either), B = 2, S = 16 text tokens stepped from an empty cache
    against the full forward's logits. The VLM's cache is seeded from its
    image alone (zero prompt tokens) and its forward sliced to the text;
    the audio decoder is stepped from the seeded cross cache against
    ``decode_full``. The SSM smoke models run S = 48: two SSD chunks of
    32, halved to 16 (48 % 32 ≠ 0), so the inter-chunk recurrence is
    used. The hybrid's decoded k/v rows equal its prefill seeds."""
    cfg = tcfg.scaled(tcfg.get_smoke_config(arch), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    model = tbuild(cfg)
    params = model.init(0, device="cpu")
    B = 2
    S = 48 if cfg.family in RECURRENT_FAMILIES else 16
    tokens = _t(_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    stub = {k: _t(v) for k, v in _stub(cfg, B, seed=1).items()}
    with torch.no_grad():
        full = model.forward(params, {"tokens": tokens, **stub}, remat=False)
    start = 0
    if cfg.family == "vlm":
        start = cfg.num_image_tokens
        full = full[:, start:]
        _, cache, off = make_seeded_prefill(model, start + S)(
            params, {"tokens": tokens[:, :0], **stub})
        assert off == start
    elif cfg.family == "audio":
        cache = tenc.seed_cross_cache(
            params, cfg, model.init_cache(B, S, "cpu"),
            tenc.encode(params, cfg, stub["frames"]))
    else:
        cache = model.init_cache(B, S, "cpu")
    outs = []
    for pos in range(S):
        logits, cache = model.decode_step(params, cache,
                                          tokens[:, pos:pos + 1], start + pos)
        outs.append(logits[:, 0])
    a, d = full.numpy(), torch.stack(outs, dim=1).numpy()
    np.testing.assert_array_equal(a.argmax(-1), d.argmax(-1))
    np.testing.assert_allclose(a, d, rtol=2e-2, atol=2e-2)
    if cfg.family == "hybrid":
        _, seeds = model.prefill(params, {"tokens": tokens})
        attn = ttr.layer_flags(cfg)["apply_attn"]
        assert attn.any() and not attn.all()
        for name, seed in zip(("k", "v"), seeds[2:]):
            _close_to_max(cache[name][attn], seed[attn], 1e-5, name)
            assert not cache[name][~attn].any()
            assert not seed[~attn].any()


# --- the decode demo ---------------------------------------------------------

def _reference_loop(jm, jp, prompts, gen):
    """The reference demo's loop (src/repro/launch/decode_demo.py), greedy."""
    B, P = prompts.shape
    total = P + gen
    decode = jax.jit(jm.decode_step)
    cache = jm.init_cache(B, total)
    tok = prompts[:, :1]
    out = [tok]
    for pos in range(total - 1):
        logits, cache = decode(jp, cache, tok, jnp.int32(pos))
        if pos + 1 < P:
            nxt = prompts[:, pos + 1:pos + 2]
        else:
            nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(
                jnp.int32)
            out.append(nxt)
        tok = nxt
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v2-lite-16b",
                                  "mamba2-2.7b", "zamba2-7b"])
def test_generate_matches_reference_loop(arch):
    jm, tm, jp, tp = _pair(arch)
    prompts = _rng(0).integers(0, tm.cfg.vocab_size, (3, 6)).astype(np.int32)
    want = _reference_loop(jm, jp, jnp.asarray(prompts), 5)
    got, secs = generate(tm, tp, _t(prompts), 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert secs > 0
    gen = torch.Generator().manual_seed(0)
    drawn, _ = generate(tm, tp, _t(prompts), 5, temperature=0.8,
                        generator=gen)
    again, _ = generate(tm, tp, _t(prompts), 5, temperature=0.8,
                        generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (3, 6) and torch.equal(drawn, again)
    assert int(drawn.min()) >= 0 and int(drawn.max()) < tm.cfg.vocab_size


def test_decode_demo_cli_subprocess():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.decode_demo", "--device",
         "cpu", "--smoke", "--arch", "deepseek-v2-lite-16b", "--batch", "2",
         "--prompt-len", "4", "--gen", "3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "generated 3 tokens x batch 2" in r.stdout
    assert "tok/s" in r.stdout


def test_decode_demo_cli_recurrent(capsys):
    """The demo's CLI on the SSM smoke model, in process."""
    from repro_torch.launch.decode_demo import main
    main(["--device", "cpu", "--smoke", "--arch", "mamba2-2.7b",
          "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    out = capsys.readouterr().out
    assert "mamba2-smoke on cpu: generated 3 tokens x batch 2" in out


def test_serve_shim_warns():
    sys.modules.pop("repro_torch.launch.serve", None)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        from repro_torch.launch import serve
    assert serve.main is not None
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
