"""The serving path's model axis (``models/tensor_parallel.py``): prefill
and ``decode_step`` split over a (W, M) mesh of gloo ranks on the CPU
(``launch.mesh.world_mesh``), each rank holding its share of the
reference's weights (``convert.lm_params_share``) and its block of every
cache leaf as ``launch.steps.cache_shardings`` lays it out, against the
one-process port decode and the reference's jitted decode fed the same
tokens, at the smoke configs of seven families in f32.

One module-scoped world of 2 x 2 ranks runs every family; a 1 x 2 world
(the model split, the batch whole) runs minicpm3-4b and
deepseek-v2-lite-16b at ``capacity_factor`` 8 (the card's phase 15d: its
experts' hidden columns, MLA heads and latent split, the router gathered
whole) and a 2 x 1 world
(``world_mesh(1)``: the K/V length split over the data group, every
weight whole) gemma2-2b. The ranks import no JAX
(``_torch_dist_child``).

Tolerances:
- exact: the greedy tokens of every rank against the one-process
  decode's and the reference's argmax; each rank's cache leaf shapes
  against ``cache_shardings``' blocks; its parameter shapes against
  ``rules_of``'s shares, its bytes against the product rule over
  ``param_shardings``; its own seed-0 init (``init_params``) against
  its share of the whole init, bit for bit; no MoE route dropped.
- logits of the split decode, and of the split prefill over the whole
  vocabulary, within 1e-5 of their max against the one-process port and
  the reference (f32: the ranks add their partial sums in another
  order), the gates of ``tests/test_torch_shardings.py``.
"""
import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_child import lm_decode, run_world
from repro_torch import configs as tcfg
from repro_torch import tree
from repro_torch.dist.sharding import local_shape
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import tensor_parallel as ttp
from repro_torch.models.registry import build_model as tbuild
from test_torch_shardings import G, _case, _close_to_max, _reference_logits

# prompt lengths: gemma2's passes its window of 64
ARCHS = {"gemma2-2b": 60, "minicpm3-4b": 8, "deepseek-v2-lite-16b": 8,
         "mamba2-2.7b": 8, "zamba2-7b": 8, "internvl2-1b": 8,
         "whisper-base": 8}
# deepseek-v2-lite-16b at capacity_factor 8, as the card's phase 15d serves it
CF8 = "deepseek-v2-lite-16b@cf8"
WORLDS = {"2x2": ((2, 2), sorted(ARCHS)),
          "1x2": ((1, 2), ["minicpm3-4b", CF8]),
          "2x1": ((2, 1), ["gemma2-2b"])}


def _cfg(name):
    arch, _, cf = name.partition("@cf")
    cfg = tcfg.scaled(tcfg.get_smoke_config(arch), dtype="float32")
    if cf:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cf)))
    return cfg


def _cases():
    """{case name: (arch, prompt length, capacity_factor or None)}."""
    out = {a: (a, P, None) for a, P in ARCHS.items()}
    out[CF8] = ("deepseek-v2-lite-16b", ARCHS["deepseek-v2-lite-16b"], 8.0)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds' outputs by world name, run at once (threads,
    each waiting on its ranks) while this process computes the
    oracles."""
    from concurrent.futures import ThreadPoolExecutor
    cases, refs = {}, {}
    for name, (arch, P, cf) in _cases().items():
        jm, jp, cases[name] = _case(arch, P, capacity_factor=cf)
        refs[name] = (jm, jp)
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {name: pool.submit(
            run_world, "serve_split", W * M,
            {"cases": {a: cases[a] for a in archs}},
            tmp_path_factory.mktemp(name), model_parallel=M)
            for name, ((W, M), archs) in WORLDS.items()}
        want = _oracles(cases, refs)
        outs = {name: r.result() for name, r in runs.items()}
    return cases, want, outs


@pytest.fixture(scope="module")
def oracles(worlds):
    return worlds[1]


def _oracles(cases, refs):
    """Per arch: the one-process port decode (tokens, logits), the
    reference's logits fed those tokens, the reference's prefill
    logits."""
    out = {}
    for arch, case in cases.items():
        toks, logits = lm_decode(tbuild(_cfg(arch)), case["params"],
                                 case["tok"], case["stub"], case["P"], G,
                                 case["total"], None)
        jm, jp = refs[arch]
        batch = {"tokens": jnp.asarray(case["tok"][:, :case["P"]].numpy()),
                 **{k: jnp.asarray(v.numpy())
                    for k, v in case["stub"].items()}}
        out[arch] = (toks, logits, _reference_logits(jm, jp, case,
                                                     toks.numpy()),
                     np.asarray(jax.jit(jm.prefill)(jp, batch)[0]))
    return out


def _runs():
    return [(w, a) for w, (_, archs) in WORLDS.items() for a in archs]


@pytest.mark.parametrize("world,arch", _runs())
def test_split_decode_matches_one_process_and_reference(worlds, oracles,
                                                        world, arch):
    """Every rank draws the one-process decode's greedy tokens, which are
    the reference's argmax; the logits (gathered over the vocabulary)
    within 1e-5 of the max of either's; the split prefill's logits
    within 1e-5 of the reference's prefill."""
    toks, logits, ref, ref_pre = oracles[arch]
    assert (np.argmax(ref, -1).T == toks.numpy()).all()
    for o in worlds[2][world]:
        got = o[arch]
        assert torch.equal(got["tokens"], toks)
        _close_to_max(got["logits"], logits)
        _close_to_max(got["logits"], ref)
        _close_to_max(got["prefill"], ref_pre)
        assert got["dropped"] == 0


@pytest.mark.parametrize("world,arch", _runs())
def test_split_layout_and_shares(worlds, world, arch):
    """Each rank's cache leaves are its ``cache_shardings`` blocks (the
    MLA latents and the SSM state split too, where the spec splits them);
    its parameters are ``rules_of``'s shares, 1/M of every leaf
    ``param_shardings`` splits (the product rule's bytes), and its own
    seed-0 init is its slice of the whole init, bit for bit. The
    collectives ran over the model group (and over the data group where
    W > 1)."""
    (W, M), _ = WORLDS[world]
    cases = worlds[0]
    cfg = _cfg(arch)
    model = tbuild(cfg)
    mesh = tmesh.ZooMesh(("data", "model"), (W, M))
    whole = model.init_cache(2, cases[arch]["total"], "meta")
    specs = tsteps.cache_shardings(whole, mesh)
    if M == 1:      # the length split alone: only k/v's length splits
        specs = {k: ((None, None, "data") if k in ("k", "v") else ())
                 for k in specs}
    want_cache = {k: local_shape(v.shape, specs[k], mesh)
                  for k, v in whole.items()}
    if M > 1 and W > 1:
        split = {"ckv": (1, 3), "kr": (1,), "conv": (1, 3), "ssm": (1, 2),
                 "k": (2, 3), "v": (2, 3), "cross_k": (2, 3),
                 "cross_v": (2, 3)}
        for k, dims in split.items():
            if k in whole:
                assert all(want_cache[k][i] < whole[k].shape[i]
                           for i in dims), (k, specs[k])
    shapes = model.init(0, device="meta")
    pspecs, _ = tsteps.param_shardings(model, mesh)
    rules = ttp.rules_of(cfg, M) if M > 1 else {}
    want_params = []
    for keys, x in tree.flatten_with_keys(shapes):
        s = list(x.shape)
        r = rules.get(tuple(keys))
        if r is not None:
            s[r.dim] //= M
        want_params.append(tuple(s))
    bytes_rule = dryrun.spec_bytes(
        shapes, [dryrun._leaf(pspecs, k) for k, _ in
                 tree.flatten_with_keys(shapes)], mesh) if M > 1 else \
        sum(x.numel() * 4 for x in tree.leaves(shapes))
    for o in worlds[2][world]:
        got = o[arch]
        assert got["cache"] == want_cache
        assert got["param_shapes"] == want_params
        assert got["param_bytes"] == bytes_rule
        assert got["init_equal"]
        groups = set(got["by_group"])
        assert ("model" in groups) == (M > 1)
        assert ("data" in groups) == (W > 1)


def test_share_cuts_and_own_channels():
    """``shard_params``: the M shares of each leaf put back together give
    the whole leaf (blocks in rank order; Mamba2's ``in_proj`` and conv
    columns by their own-channel indices, which cover every channel
    once); 2 ranks on 4 heads of gemma2 take 2 each."""
    for arch in ("gemma2-2b", "mamba2-2.7b", "deepseek-v2-lite-16b"):
        cfg = _cfg(arch)
        params = tbuild(cfg).init(0, device="cpu")
        shares = [ttp.shard_params(params, cfg, 2, m) for m in range(2)]
        rules = ttp.rules_of(cfg, 2)
        for (keys, x), a, b in zip(tree.flatten_with_keys(params),
                                   *map(tree.leaves, shares)):
            r = rules.get(tuple(keys))
            if r is None:
                assert a is x and b is x
            elif r.kind == ttp.OWN:
                idx = torch.cat([ttp._own_index(cfg, 2, m, keys[-1], "cpu")
                                 for m in range(2)])
                assert torch.equal(torch.sort(idx).values,
                                   torch.arange(x.shape[-1]))
                back = torch.empty_like(x)
                back[..., idx] = torch.cat([a, b], -1)
                assert torch.equal(back, x), keys
            else:
                assert torch.equal(torch.cat([a, b], r.dim), x), keys
    g = tbuild(_cfg("gemma2-2b")).init(0, device="meta")
    share = ttp.shard_params(g, _cfg("gemma2-2b"), 2, 1)
    assert share["layers"]["attn"]["wq"].shape[-2] == 2
    assert share["layers"]["attn"]["wk"].shape[-2] == 1
    assert share["embedding"].shape[0] == 256


def test_argmax_split_ties_to_lowest():
    """``argmax_split`` over 3 emulated ranks equals ``torch.argmax`` of
    the whole row, ties across blocks to the lowest index."""
    import repro_torch.dist.collectives as coll
    rows = torch.tensor([[1., 5., 5., 0., 5., 2.],
                         [0., 0., 0., 0., 0., 0.],
                         [-1., -3., -2., 7., 1., 7.]])
    parts = rows.chunk(3, dim=-1)

    class Rank:
        def __init__(self, r):
            self.r = r

    orig = (coll.axis_index, coll.axis_size, coll._gather)
    try:
        coll.axis_index = lambda g: g.r
        coll.axis_size = lambda g: 3
        for r in range(3):
            pairs = []

            def gather(x, g, pairs=pairs):
                return pairs

            coll._gather = gather
            for q in range(3):
                n = parts[q].shape[-1]
                i = torch.argmax(parts[q], -1, keepdim=True)
                pairs.append(torch.cat([torch.gather(parts[q], -1, i),
                                        i + q * n], -1).double())
            got = coll.argmax_split(parts[r], Rank(r))
            assert torch.equal(got, torch.argmax(rows, -1))
    finally:
        coll.axis_index, coll.axis_size, coll._gather = orig


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-2.7b"])
def test_serving_leaves_no_cycle_holding_weights(arch):
    """A prefill and a decode step leave no reference cycle behind (the
    tree walks are module functions, not recursive closures): the
    weights go when their last reference does, not at the next garbage
    collection, so a rank can free a model before making the next."""
    import gc
    model = tbuild(_cfg(arch))
    params = model.init(0, device="cpu")
    tok = torch.zeros((2, 4), dtype=torch.int32)
    gc.collect()
    was = gc.get_debug()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        out = model.prefill(params, {"tokens": tok})
        cache = model.init_cache(2, 8, "cpu")
        out = model.decode_step(params, cache, tok[:, :1], 0)
        del out, cache
        assert gc.collect() == 0, [type(x) for x in gc.garbage][:10]
    finally:
        gc.set_debug(was)
        gc.garbage.clear()


STAGED = ("deepseek-v2-lite-16b", "gemma2-2b", "mamba2-2.7b")


@pytest.mark.parametrize("arch", STAGED)
def test_staged_init_is_the_slice_of_the_whole(arch, monkeypatch):
    """The staged init (``draw_staged``: every share made on the host as
    its weight is drawn; ``unstage``: moved to the device after the last
    draw) is rank m's slice of the whole seed-0 init,
    ``shard_params(model.init(0))``, bit for bit, for every m of M = 2;
    so is the unstaged ``init_params``, and the small blocks
    ``stage_share`` cuts a leaf's whole in give the same shares as one
    block."""
    from types import SimpleNamespace
    cfg = _cfg(arch)
    model = tbuild(cfg)
    whole = model.init(0, device="cpu")
    rules = ttp.rules_of(cfg, 2)
    for m in range(2):
        want = ttp.shard_params(whole, cfg, 2, m)
        got = ttp.unstage(ttp.draw_staged(model, 0, 2, m, "cpu", 1), "cpu")
        # init_params as rank m of a model group of 2 sees it
        monkeypatch.setattr(ttp, "split_of", lambda c, mesh: SimpleNamespace(
            M=2, m=m, rules=rules))
        plain = ttp.init_params(model, 0, None, "cpu")
        monkeypatch.setattr(ttp, "STAGE_BLOCK_BYTES", 1)
        small = [ttp.stage_share(x, rules.get(tuple(k)), cfg, 2, m, k[-1])
                 for k, x in tree.flatten_with_keys(whole)]
        monkeypatch.undo()
        for w, g, p, s in zip(tree.leaves(want), tree.leaves(got),
                              tree.leaves(plain), small):
            assert g.device.type == "cpu" and g.is_contiguous()
            assert torch.equal(g, w) and torch.equal(p, w)
            assert torch.equal(s, w)
    assert ttp.share_bytes(cfg, 2) == sum(
        x.numel() * x.element_size() for x in tree.leaves(want))


@pytest.mark.parametrize("arch", STAGED)
def test_staged_init_keeps_no_share_on_the_device(arch, monkeypatch):
    """The property that bounds the card's peak during a staged init: at
    every draw of ``draw_staged``, each share cut so far already sits on
    the stage (here ``meta``, so that it differs from the init's ``cpu``)
    and every whole weight drawn before has been freed; the init draws
    each weight of ``_draw_order`` once, and returns every leaf on the
    stage."""
    from repro_torch.models import layers
    cfg = _cfg(arch)
    model = tbuild(cfg)
    made, wholes, draws = [], [], []
    real, stage = layers._drawn, ttp.stage_share

    def spy(w):
        if w.device.type == "cpu":      # not the shape-only inits on meta
            draws.append(({s.device.type for s in made},
                          sum(r() is not None for r in wholes)))
            wholes.append(weakref.ref(w))
        return real(w)

    def cut(*a):
        made.append(stage(*a))
        return made[-1]

    monkeypatch.setattr(layers, "_drawn", spy)
    monkeypatch.setattr(ttp, "stage_share", cut)
    monkeypatch.setattr(ttp, "STAGE", torch.device("meta"))
    out = ttp.draw_staged(model, 0, 2, 1, "cpu", 1)
    n = sum(k is not None for k in layers._draw_order(cfg))
    assert len(draws) == n and n > 0
    for i, (devices, alive) in enumerate(draws):
        assert devices <= {"meta"}, (i, devices)
        assert alive == 0, i
    assert len(made) == len(tree.leaves(out))
    assert all(x.device.type == "meta" for x in tree.leaves(out))


def test_staged_init_refuses_a_short_host(monkeypatch):
    """A staged init that the host cannot hold for all the ranks staging
    on it fails before it draws, with the bytes it needs."""
    cfg = _cfg("gemma2-2b")
    need = ttp.share_bytes(cfg, 2)
    monkeypatch.setattr(ttp, "host_available", lambda: 2 * need - 1)
    drawn = []
    monkeypatch.setattr(ttp, "init_cut", lambda *a, **k: drawn.append(1))
    with pytest.raises(RuntimeError, match="MemAvailable"):
        ttp.draw_staged(tbuild(cfg), 0, 2, 0, "cpu", 2)
    assert not drawn
    ttp.draw_staged(tbuild(cfg), 0, 2, 0, "cpu", 1)
    assert drawn == [1]
