"""The port's configs and models (dense and MoE, GQA and MLA, SSM, the
hybrid with its shared block, the VLM's image prefix, the audio
encoder-decoder; ``repro_torch.configs``, ``repro_torch.models``) against
``repro`` on the same NumPy inputs: the reference's weights go in through
``repro_torch.convert``, and a VLM's image embeddings or an audio model's
frames are the same random NumPy arrays in both.

Tolerances:
- exact: every config field and ``param_count``, the leaf names, shapes
  and flatten order, ``layer_flags``, ``token_stream``, and remat
  (``off`` ≡ ``full`` ≡ ``dots`` ≡ ``dots_no_batch``, bit for bit: the
  recomputed forward is the same arithmetic on the CPU).
- elementwise layers in f32: rtol 1e-6 (rmsnorm, softcap, RoPE, gelu).
- the model in f32 (``scaled(cfg, dtype="float32")``): loss rtol 1e-5,
  logits max-abs ≤ 1e-5·max|logits|, every gradient leaf max-abs ≤
  1e-4·max|g| (f32 sums in another order; about 2e-6 seen, 1.04e-5 on
  zamba2's ``A_log``, whose gradient sums products of decays over every
  position and chunk).
- the model in its own bf16: loss rtol 1e-3, logits ≤ 3e-2·max|logits|,
  every gradient leaf ≤ 5e-2·max|g| (bf16 keeps 8 bits: one rounding of
  an activation is 4e-3 relative; up to 3.8e-2 seen on the leaves),
  except the SSM's per-head ``A_log``, ``D`` and ``dt_bias``: ≤ 1e-1.
  Each of their gradients is one sum over every (batch, position, head
  dim) of bf16 products that largely cancel, rounded in another order in
  each package (6.7e-2 seen on zamba2's ``D``).
- the MoE models (mixtral, deepseek) in bf16: loss rtol 5e-3 and at least
  97% of the routes (token, rank → expert) equal in every layer. Their
  router logits are bf16, so one rounding can flip a near-tied route;
  that moves the token to another expert and shifts the capacity slots
  of later routes, so logits and gradients part far past the dense
  bounds (1.0–1.6% of the routes differ, mixtral's loss by 1.05e-3
  relative). In f32 they are held as the dense models are.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.data import token_stream as jtoken_stream
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.models.registry import build_model as jbuild
from repro_torch import configs as tcfg
from repro_torch import tree
from repro_torch.configs import TrainConfig
from repro_torch.convert import lm_params_from_reference
from repro_torch.data import token_stream
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import build_model as tbuild

LM_ARCHS = ["gemma2-2b", "gemma3-27b", "starcoder2-15b", "minicpm3-4b",
            "mixtral-8x22b", "deepseek-v2-lite-16b", "mamba2-2.7b",
            "zamba2-7b", "internvl2-1b", "whisper-base"]
# S > the smoke window of 64, so the local mask bites; S = 128 runs four
# SSD chunks of 32 in the SSM smoke models
B, S = 2, 128


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _asdict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", list(jcfg.ARCH_MODULES))
def test_configs_equal(arch):
    assert list(tcfg.ARCH_MODULES) == list(jcfg.ARCH_MODULES)
    assert tcfg.ASSIGNED_ARCHS == jcfg.ASSIGNED_ARCHS
    for get_t, get_j in ((tcfg.get_config, jcfg.get_config),
                         (tcfg.get_smoke_config, jcfg.get_smoke_config)):
        t, j = get_t(arch), get_j(arch)
        assert _asdict(t) == _asdict(j)
        assert t.param_count() == j.param_count()
        assert (t.head_dim, t.is_attention_free, t.supports_long_context) \
            == (j.head_dim, j.is_attention_free, j.supports_long_context)
        assert tcfg.dtype_of(t) == {"bfloat16": torch.bfloat16,
                                    "float32": torch.float32}[t.dtype]


def test_train_config_and_shapes_equal():
    t, j = TrainConfig(), jcfg.TrainConfig()
    assert _asdict(t) == _asdict(j) and t.remat_mode == j.remat_mode
    assert {k: _asdict(v) for k, v in tcfg.INPUT_SHAPES.items()} == \
        {k: _asdict(v) for k, v in jcfg.INPUT_SHAPES.items()}
    bad = [dict(cs_packed=True, cs_measure=100), dict(remat_policy="some"),
           dict(optimizer="lion"), dict(error_feedback=True)]
    for kw in bad:
        with pytest.raises(ValueError) as te:
            TrainConfig(**kw)
        with pytest.raises(ValueError) as je:
            jcfg.TrainConfig(**kw)
        assert str(te.value).split(" (")[0].split(" —")[0][:40] == \
            str(je.value).split(" (")[0].split(" —")[0][:40]


@pytest.mark.parametrize("arch", LM_ARCHS + ["mnist-mlp"])
def test_leaves_match_reference(arch):
    """Leaf paths, shapes and order equal the reference's init (the
    top-level ``shared_block``, ``img_pos``, ``enc_layers``, ``enc_norm``
    and ``pos_embedding`` included), at smoke size and, on the meta
    device, at full width; for the attention families their sizes sum to
    ``param_count``. (``param_count`` is the reference's analytic count:
    it has no MLP branch, so the MLP's leaves sum to the paper's D =
    50,890, and it does not match the reference's own init for the SSM,
    hybrid, VLM and audio families, e.g. it leaves out ``conv_b``.)"""
    for get in (tcfg.get_smoke_config, tcfg.get_config):
        cfg = get(arch)
        params = tbuild(cfg).init(0, device="meta")
        leaves = tree.flatten_with_paths(params)[0]
        if cfg.family in ("dense", "moe", "mlp"):
            assert sum(p.numel() for _, p in leaves) == (
                50890 if cfg.family == "mlp" else cfg.param_count())
        jcfg_ = (jcfg.get_smoke_config if get is tcfg.get_smoke_config
                 else jcfg.get_config)(arch)
        jshapes = jax.eval_shape(jbuild(jcfg_).init, jax.random.PRNGKey(0))
        want = [(jax.tree_util.keystr(p), tuple(v.shape)) for p, v in
                jax.tree_util.tree_leaves_with_path(jshapes)]
        assert [(p, tuple(v.shape)) for p, v in leaves] == want


@pytest.mark.parametrize("arch", [a for a in jcfg.ARCH_MODULES
                                  if a != "mnist-mlp"])
def test_layer_flags_exact(arch):
    for cfg in (jcfg.get_config(arch), jcfg.get_smoke_config(arch)):
        j = jtr.layer_flags(cfg)
        t = ttr.layer_flags(cfg)
        for k in ("is_global", "apply_attn"):
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


@pytest.mark.parametrize("seed", [0, 3])
def test_token_stream_exact(seed):
    for a, b in zip(token_stream(3, 129, 512, seed=seed),
                    jtoken_stream(3, 129, 512, seed=seed)):
        np.testing.assert_array_equal(a, b)


def test_elementwise_layers():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 64)).astype(np.float32) * 3
    w = rng.standard_normal((64,)).astype(np.float32) * 0.1
    pos = np.arange(9, dtype=np.int32)
    pairs = [
        (tlayers.rmsnorm(_t(x), _t(w)), jlayers.rmsnorm(x, w)),
        (tlayers.softcap(_t(x), 2.5), jlayers.softcap(x, 2.5)),
        (tlayers.apply_rope(_t(x), _t(pos), 10_000.0),
         jlayers.apply_rope(x, pos, 10_000.0)),
        (tlayers.rope_freqs(64, 1e6), jlayers.rope_freqs(64, 1e6)),
        (tlayers.sinusoidal_positions(16, 32),
         jlayers.sinusoidal_positions(16, 32)),
        (torch.nn.functional.gelu(_t(x), approximate="tanh"),
         jax.nn.gelu(x)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    assert torch.equal(tlayers.softcap(_t(x), 0.0), _t(x))


@pytest.mark.parametrize("window,is_global", [(None, None), (16, False),
                                              (16, True)])
def test_blockwise_attention_blocks(window, is_global):
    """Four checkpointed query blocks of 32 against the reference's
    scanned blocks and against one block (f32, rtol 1e-5)."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 128, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 128, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 128, 2, 16)).astype(np.float32)
    pos = np.arange(128, dtype=np.int32)
    kw = dict(scale=0.25, window=window, cap=5.0)
    want = jattn.blockwise_attention(
        q, k, v, pos, pos, block_size=32,
        is_global=None if is_global is None else jnp.asarray(is_global),
        **kw)
    got = tattn.blockwise_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                                    block_size=32, is_global=is_global, **kw)
    one = tattn.blockwise_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                                    block_size=128, is_global=is_global,
                                    **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, one)


def test_chunked_cross_entropy_chunks():
    """Four checkpointed sequence chunks equal one chunk and the
    reference's scan, value and gradient (f32, rtol 1e-6)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    emb = rng.standard_normal((100, 32)).astype(np.float32) * 0.2
    tg = rng.integers(0, 100, (2, 64)).astype(np.int32)
    want, jg = jax.value_and_grad(
        lambda e: jlayers.chunked_cross_entropy(
            x, tg, embedding=e, final_softcap=3.0, seq_chunk=16))(emb)
    out = []
    for chunk in (16, 64):
        e = _t(emb).requires_grad_()
        loss = tlayers.chunked_cross_entropy(_t(x), _t(tg), embedding=e,
                                             final_softcap=3.0,
                                             seq_chunk=chunk)
        loss.backward()
        loss = loss.detach()
        out.append((loss, e.grad))
        assert float(loss) == pytest.approx(float(want), rel=1e-6)
        np.testing.assert_allclose(e.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-7)
    logits = tlayers.unembed(_t(x), embedding=_t(emb), final_softcap=3.0)
    from repro_torch.models.registry import cross_entropy
    assert float(cross_entropy(logits, _t(tg))) == pytest.approx(
        float(out[1][0]), rel=1e-6)


def _pair(arch, dtype):
    jc = jcfg.scaled(jcfg.get_smoke_config(arch), dtype=dtype)
    tc = tcfg.scaled(tcfg.get_smoke_config(arch), dtype=dtype)
    jm, tm = jbuild(jc), tbuild(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = lm_params_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    tok, tgt = token_stream(B, S, jc.vocab_size, seed=1)
    batch = {"tokens": tok, "targets": tgt}
    batch.update(stub_inputs(jc, B, seed=1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jm, tm, jp, tp, jb, tb


def stub_inputs(cfg, batch, seed):
    """A VLM's image embeddings or an audio model's frames, random f32."""
    rng = np.random.default_rng(seed + 100)
    if cfg.family == "vlm":
        return {"image_embeds": (rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model)) * 0.5
        ).astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": (rng.standard_normal(
            (batch, cfg.encoder_seq_len, cfg.d_model)) * 0.5
        ).astype(np.float32)}
    return {}


TOL = {"float32": dict(loss=1e-5, logits=1e-5, grad=1e-4),
       "bfloat16": dict(loss=1e-3, logits=3e-2, grad=5e-2)}
SSM_SCALARS_BF16 = 1e-1     # A_log, D, dt_bias: see the module's head
MOE_BF16 = dict(loss=5e-3, routes=0.97)


def _routes(jm, tm, jp, tp, jb, tb, monkeypatch):
    """Each MoE layer's expert indices (T, k) in both packages' forward,
    recorded where ``_route`` returns them."""
    jrec, trec = [], []
    jroute, troute = jmoe._route, tmoe._route

    def jwrap(logits, k):
        w, idx, aux = jroute(logits, k)
        jax.debug.callback(lambda i: jrec.append(np.asarray(i)), idx,
                           ordered=True)
        return w, idx, aux

    def twrap(logits, k):
        w, idx, aux = troute(logits, k)
        trec.append(idx.numpy().copy())
        return w, idx, aux

    monkeypatch.setattr(jmoe, "_route", jwrap)
    monkeypatch.setattr(tmoe, "_route", twrap)
    jax.block_until_ready(jax.jit(
        lambda p: jm.forward(p, jb, remat=False))(jp))
    with torch.no_grad():
        tm.forward(tp, tb, remat=False)
    assert len(jrec) == len(trec) == tm.cfg.num_layers
    return jrec, trec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_matches_reference(arch, dtype, monkeypatch):
    tol = TOL[dtype]
    jm, tm, jp, tp, jb, tb = _pair(arch, dtype)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb, remat=False)[0]))(jp)
    tloss, tgrads = loss_and_grads(tm, TrainConfig(remat_policy="off"), tp,
                                   tb)
    if dtype == "bfloat16" and tm.cfg.moe is not None:
        # a flipped bf16 route parts the logits (see the module's head)
        assert float(tloss) == pytest.approx(float(jloss),
                                             rel=MOE_BF16["loss"])
        for j, t in zip(*_routes(jm, tm, jp, tp, jb, tb, monkeypatch)):
            assert (j == t).mean() >= MOE_BF16["routes"]
        return
    jlogits = np.asarray(jax.jit(
        lambda p: jm.forward(p, jb, remat=False))(jp))
    with torch.no_grad():
        tlogits = tm.forward(tp, tb, remat=False).numpy()
    assert float(tloss) == pytest.approx(float(jloss), rel=tol["loss"])
    assert np.abs(tlogits - jlogits).max() <= \
        tol["logits"] * np.abs(jlogits).max()
    jl = jax.tree_util.tree_leaves_with_path(jgrads)
    tl = tree.flatten_with_paths(tgrads)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (path, want), (key, got) in zip(jl, tl):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        bound = tol["grad"]
        if dtype == "bfloat16" and key.endswith(
                ("['A_log']", "['D']", "['dt_bias']")):
            bound = SSM_SCALARS_BF16
        assert err <= bound * np.abs(want).max(), (path, err)


@pytest.mark.parametrize("arch", ["gemma2-2b", "starcoder2-15b",
                                  "mamba2-2.7b", "zamba2-7b",
                                  "whisper-base"])
def test_remat_bitwise(arch):
    """Remat changes what is held, never a number: the loss and every
    gradient leaf (zamba2's weight-tied ``shared_block`` included) are
    bit for bit equal under the four policies."""
    tm = tbuild(tcfg.get_smoke_config(arch))
    params = tm.init(0, device="cpu")
    tok, tgt = token_stream(B, S, tm.cfg.vocab_size, seed=2)
    batch = {"tokens": torch.from_numpy(tok),
             "targets": torch.from_numpy(tgt)}
    batch.update({k: torch.from_numpy(v)
                  for k, v in stub_inputs(tm.cfg, B, seed=2).items()})
    base = None
    for policy in ("off", "full", "dots", "dots_no_batch"):
        loss, grads = loss_and_grads(tm, TrainConfig(remat_policy=policy),
                                     params, batch)
        got = [loss] + tree.leaves(grads)
        if base is None:
            base = got
            continue
        assert all(torch.equal(a, b) for a, b in zip(base, got)), policy


def test_layer_resolver_sees_each_layer_slice():
    """The hook gets one layer's slice (no L axis) per layer, inside the
    remat boundary; the identity resolver changes no bit."""
    tm = tbuild(tcfg.get_smoke_config("gemma2-2b"))
    params = tm.init(0, device="cpu")
    tok, _ = token_stream(1, 64, tm.cfg.vocab_size, seed=4)
    batch = {"tokens": torch.from_numpy(tok)}
    seen = []

    def resolver(lp):
        seen.append(tuple(lp["mlp"]["w1"].shape))
        return lp

    with torch.no_grad():
        got = tm.forward(params, batch, remat="full",
                         layer_resolver=resolver)
        want = tm.forward(params, batch, remat="off")
    assert seen == [(256, 512)] * tm.cfg.num_layers
    assert torch.equal(got, want)


def test_mnist_mlp_model():
    cfg = jcfg.get_config("mnist-mlp")
    jm = jbuild(cfg)
    tm = tbuild(tcfg.get_config("mnist-mlp"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = lm_params_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(16, 784)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    jl = jm.loss_fn(jp, {"x": x, "y": y})[0]
    tl = tm.loss_fn(tp, {"x": _t(x), "y": _t(y)})[0]
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert tm.forward(tp, {"x": _t(x)}).shape == (16, 10)


@pytest.mark.parametrize("arch", list(jcfg.ARCH_MODULES))
def test_build_model_every_config(arch):
    """Every config builds, full width on the meta device, with the
    reference's input specs."""
    from repro_torch.models.registry import lm_input_specs
    cfg = tcfg.get_config(arch)
    m = tbuild(cfg)
    assert tree.leaves(m.init(0, device="meta"))
    if cfg.family == "mlp":
        return
    jc = jcfg.get_config(arch)
    for shape in tcfg.INPUT_SHAPES.values():
        got = lm_input_specs(cfg, shape)
        want = jbuild(jc).input_specs(jcfg.INPUT_SHAPES[shape.name])
        assert list(got) == list(want)
        for k, (shp, dt) in got.items():
            assert shp == want[k].shape
            assert str(dt).split(".")[-1] == str(want[k].dtype)


@pytest.mark.parametrize("remat", ["off", "full"])
def test_shared_block_gradient_sums_applications(remat):
    """zamba2 with its shared block after each of 3 layers: the block's
    gradient is the sum over its three applications, against the
    reference's (f32, 1e-4 of each leaf's max as above)."""
    over = dict(num_layers=3, hybrid_attn_every=1, dtype="float32")
    jc = jcfg.scaled(jcfg.get_smoke_config("zamba2-7b"), **over)
    tc = tcfg.scaled(tcfg.get_smoke_config("zamba2-7b"), **over)
    assert ttr.layer_flags(tc)["apply_attn"].tolist() == [True] * 3
    jm, tm = jbuild(jc), tbuild(tc)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = lm_params_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    tok, tgt = token_stream(B, 64, jc.vocab_size, seed=3)
    jloss, jg = jax.value_and_grad(lambda p: jm.loss_fn(
        p, {"tokens": tok, "targets": tgt}, remat=remat == "full")[0])(jp)
    tloss, tg = loss_and_grads(tm, TrainConfig(remat_policy=remat), tp,
                               {"tokens": torch.from_numpy(tok),
                                "targets": torch.from_numpy(tgt)})
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    want = jax.tree_util.tree_leaves_with_path(jg["shared_block"])
    got = tree.flatten_with_paths(tg["shared_block"])[0]
    assert len(got) == len(want) == 9
    for (path, w), (_, g) in zip(want, got):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), path


def test_decode_path_raises():
    """The paper's MLP has no decode path, as in the reference."""
    m = tbuild(tcfg.get_config("mnist-mlp"))
    jm = jbuild(jcfg.get_config("mnist-mlp"))
    for fn, jfn in ((m.prefill, jm.prefill), (m.init_cache, jm.init_cache),
                    (m.decode_step, jm.decode_step)):
        with pytest.raises(NotImplementedError, match="no decode path"):
            fn(None, None)
        with pytest.raises(NotImplementedError, match="no decode path"):
            jfn(None, None)


@pytest.mark.parametrize("init", ["he_init", "lecun_init"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inits_scale_in_place_same_bits(init, dtype):
    """The in-place scaling gives the bits of ``randn(...) * std``."""
    std = {"he_init": (2.0 / 96) ** 0.5, "lecun_init": (1.0 / 96) ** 0.5}
    got = getattr(tlayers, init)(torch.Generator().manual_seed(7),
                                 (3, 96, 40), fan_in=96, dtype=dtype)
    want = (torch.randn((3, 96, 40), generator=torch.Generator()
                        .manual_seed(7)) * std[init]).to(dtype)
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))
