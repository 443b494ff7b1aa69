"""The sharding specs of params and caches (``launch.steps.param_shardings``
and ``cache_shardings``, ``models.transformer.cache_shardings_hints``)
against ``repro.launch.steps``' on ``jax.sharding.AbstractMesh`` meshes,
and the decode with the K/V cache split over its length
(``attention.decode_attention_sharded`` over a group) at 2 gloo ranks on
the CPU, against the one-process decode and the reference's, on the CPU.

Tolerances:
- exact: every param spec of all 11 configs at full width, every cache
  spec of the 10 with a cache (B = 128, length 32,768), on the
  (16, 16), (32, 8) and (2, 2) meshes; the hints; the rows of a seeded
  prefill each rank keeps; the greedy tokens of the split decode against
  the one-process decode's and the reference's.
- logits of the split decode within 1e-5 of their max against the
  one-process decode (f32: the ranks add their partial exp-sums and
  weighted V in another order), and against the reference's decode fed
  the same tokens (f32 in two packages).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh

from _torch_dist_child import lm_decode, run_world
from repro import configs as jcfg
from repro.launch import steps as jsteps
from repro.models import encdec as jenc
from repro.models import transformer as jtr
from repro.models.registry import build_model as jbuild
from repro_torch import configs as tcfg
from repro_torch import tree
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import build_model as tbuild

MESHES = [(16, 16), (32, 8), (2, 2)]
ARCHS = sorted(jcfg.ARCH_MODULES)
B, S = 128, 32_768


def _meshes(w, m):
    return (AbstractMesh((w, m), ("data", "model")),
            tmesh.ZooMesh(("data", "model"), (w, m)))


def test_hints_and_production_mesh():
    assert ttr.cache_shardings_hints() == jtr.cache_shardings_hints()
    m = tmesh.make_production_mesh()
    assert (m.axis_names, m.axis_sizes) == (("data", "model"), (32, 8))
    m = tmesh.make_production_mesh(multi_pod=True)
    assert (m.axis_names, m.axis_sizes) == (("pod", "data", "model"),
                                            (2, 32, 8))
    assert tmesh.num_workers(m) == 64 and m.world is None


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch):
    """``param_shardings`` and ``cache_shardings`` (meta tensors and
    ``(shape, dtype)`` pairs alike) equal the reference's ``.spec``."""
    jm, tm = jbuild(jcfg.get_config(arch)), tbuild(tcfg.get_config(arch))
    jcache = None
    if jm.cfg.family != "mlp":
        jcache = jax.eval_shape(lambda: jm.init_cache(B, S))
    for w, m in MESHES:
        jmesh, tmesh_ = _meshes(w, m)
        jsh, jshapes = jsteps.param_shardings(jm, jmesh)
        tsh, tshapes = tsteps.param_shardings(tm, tmesh_)
        want = [tuple(s.spec) for s in jax.tree_util.tree_leaves(jsh)]
        got = [functools.reduce(lambda n, k: n[k], keys, tsh)
               for keys, _ in tree.flatten_with_keys(tshapes)]
        assert got == want, (w, m)
        assert [tuple(x.shape) for x in tree.leaves(tshapes)] == [
            tuple(x.shape) for x in jax.tree_util.tree_leaves(jshapes)]
        assert all(x.device.type == "meta" for x in tree.leaves(tshapes))
        if jcache is None:
            continue
        want = {k: tuple(v.spec) for k, v in
                jsteps.cache_shardings(jcache, jmesh).items()}
        shapes = {k: (tuple(v.shape), v.dtype) for k, v in jcache.items()}
        assert tsteps.cache_shardings(shapes, tmesh_) == want, (w, m)
        meta = {k: torch.empty(s, device="meta") for k, (s, _)
                in shapes.items()}
        assert tsteps.cache_shardings(meta, tmesh_) == want



# --- the decode with the K/V cache split over its length ------------------

DECODE_ARCHS = {"gemma2-2b": 60, "internvl2-1b": 8, "whisper-base": 8,
                "zamba2-7b": 8}     # prompt lengths: gemma2's passes its
G = 8                               # window of 64


def _case(arch, P, capacity_factor=None):
    """The reference's seed-0 smoke model of ``arch`` in f32 (its MoE at
    ``capacity_factor`` where given), its weights in the port's layout,
    2 x (P + G) tokens and the family's stub inputs."""
    jc = jcfg.scaled(jcfg.get_smoke_config(arch), dtype="float32")
    if capacity_factor is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, capacity_factor=capacity_factor))
    jm = jbuild(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = lm_params_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    cfg = jm.cfg
    rng = np.random.default_rng(7)
    tok = rng.integers(0, cfg.vocab_size, (2, P + G)).astype(np.int32)
    stub = {}
    if cfg.family == "vlm":
        stub["image_embeds"] = (0.5 * rng.standard_normal(
            (2, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "audio":
        stub["frames"] = (0.5 * rng.standard_normal(
            (2, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    total = -(-(n_img + P + G) // 2) * 2
    case = {"arch": arch, "params": tp, "tok": torch.from_numpy(tok),
            "stub": {k: torch.from_numpy(v) for k, v in stub.items()},
            "P": P, "G": G, "total": total}
    if capacity_factor is not None:
        case["capacity_factor"] = capacity_factor
    return jm, jp, case


def _reference_logits(jm, jp, case, tokens):
    """The reference's decode fed the port's greedy ``tokens``: the
    logits each token was drawn from."""
    cfg, P = jm.cfg, case["P"]
    tok = case["tok"].numpy()
    stub = {k: jnp.asarray(v.numpy()) for k, v in case["stub"].items()}
    jdec = jax.jit(jm.decode_step)
    if cfg.family in ("dense", "moe", "vlm"):
        lg, cache, pos = jsteps.make_seeded_prefill(jm, case["total"])(
            jp, {"tokens": jnp.asarray(tok[:, :P]), **stub})
    else:
        cache = jm.init_cache(2, case["total"])
        if cfg.family == "audio":
            cache = jenc.seed_cross_cache(
                jp, cfg, cache, jenc.encode(jp, cfg, stub["frames"]))
        for pos in range(P):
            lg, cache = jdec(jp, cache, jnp.asarray(tok[:, pos:pos + 1]),
                             jnp.int32(pos))
        pos = P
    out = []
    for i in range(G):
        out.append(np.asarray(lg[:, -1]))
        lg, cache = jdec(jp, cache, jnp.asarray(tokens[:, i:i + 1]),
                         jnp.int32(pos + i))
    return np.stack(out)


@pytest.fixture(scope="module")
def split_decode(tmp_path_factory):
    cases, refs = {}, {}
    for arch, P in DECODE_ARCHS.items():
        jm, jp, cases[arch] = _case(arch, P)
        refs[arch] = (jm, jp)
    outs = run_world("decode", 2, {"cases": cases},
                     tmp_path_factory.mktemp("decode"))
    return cases, refs, outs


def _close_to_max(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("arch", sorted(DECODE_ARCHS))
def test_split_decode_matches_one_process_and_reference(split_decode, arch):
    """Both ranks draw the same greedy tokens as the one-process decode
    (no mesh, the cache whole) and as the reference's argmax;
    their logits within 1e-5 of the max of either's. Every rank moved
    its partial softmax over the group (``all_reduce_max`` and
    ``all_reduce`` bytes), nothing of the cache."""
    cases, refs, outs = split_decode
    case = cases[arch]
    cfg = tcfg.scaled(tcfg.get_smoke_config(arch), dtype="float32")
    toks, logits = lm_decode(tbuild(cfg), case["params"], case["tok"],
                             case["stub"], case["P"], G, case["total"],
                             None)
    want = _reference_logits(*refs[arch], case, toks.numpy())
    assert (np.argmax(want, -1).T == toks.numpy()).all()
    for o in outs:
        got = o[arch]
        assert torch.equal(got["tokens"], toks)
        _close_to_max(got["logits"], logits)
        _close_to_max(got["logits"], want)
        assert set(got["bytes"]) == {"all_reduce", "all_reduce_max"}


def test_split_cache_leaves_and_seeds():
    """Each rank's cache holds its half of the k/v length, the MLA, SSM
    and cross leaves whole; a seeded prefill keeps each rank's rows of
    the one-process cache, bit for bit (the ranks emulated by a group
    stand-in of size 2)."""
    class Half:
        def __init__(self, r):
            self.r = r

    def half(r):
        """The (2, 1) mesh of rank r, its data group the stand-in."""
        return tmesh.ZooMesh(("data", "model"), (2, 1), group=Half(r))

    import repro_torch.dist.collectives as coll
    orig = (coll.axis_index, coll.axis_size)
    cfg = tcfg.scaled(tcfg.get_smoke_config("internvl2-1b"),
                      dtype="float32")
    model = tbuild(cfg)
    params = model.init(0, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 8),
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32)
    stub = {"image_embeds": 0.1 * torch.ones(2, cfg.num_image_tokens,
                                             cfg.d_model)}
    total = 40
    _, whole, _ = tsteps.make_seeded_prefill(model, total)(
        params, {"tokens": tok, **stub})
    try:
        coll.axis_index = lambda g: 0 if g is None else g.r
        coll.axis_size = lambda g: 1 if g is None else 2
        for r in range(2):
            _, part, off = tsteps.make_seeded_prefill(model, total, mesh=half(r))(
                params, {"tokens": tok, **stub})
            assert off == cfg.num_image_tokens + 8
            for name in ("k", "v"):
                assert part[name].shape[2] == total // 2
                assert torch.equal(part[name], whole[name][
                    :, :, r * total // 2:(r + 1) * total // 2])
        with pytest.raises(ValueError, match="does not split over 2"):
            model.init_cache(2, 41, "cpu", mesh=half(0))
        for arch in ("deepseek-v2-lite-16b", "zamba2-7b", "whisper-base"):
            m = tbuild(tcfg.get_smoke_config(arch))
            one, two = (m.init_cache(2, 40, "meta", mesh=g)
                        for g in (None, half(1)))
            for name, x in one.items():
                want = list(x.shape)
                if name in ("k", "v"):
                    want[2] //= 2
                assert list(two[name].shape) == want, (arch, name)
    finally:
        coll.axis_index, coll.axis_size = orig
