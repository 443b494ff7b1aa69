"""The dry run (``repro_torch.launch.dryrun``): one rank's step of the
port's program on the meta device inside a "fake" process group, on the
CPU. The reference's ``repro.launch.dryrun`` is never imported (it sets
``XLA_FLAGS`` for 512 host devices when imported); its specs come from
``repro.launch.steps``.

Tolerances:
- exact: per-card parameter bytes, the product rule over the
  reference's param specs on the (32, 8) and (2, 32, 8) meshes, for
  every config and in a zoo-train and a split ``mean`` train result; the zoo-train round's
  collective bytes by kind against the counters of a live 2 x 2 gloo
  world running the same round, and so the split prefill's and split
  decode step's, with the parameter and cache bytes a rank holds; the
  long_500k skip and its reason; the decode's cache split.
- ``cost.flops`` of a dense train step (gemma2-2b at full width, remat
  off, one sequence of 512 a card) within 10% of 6·N·T.
"""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from _torch_dist_child import run_world
from repro import configs as jcfg
from repro.launch import steps as jsteps
from repro.models.registry import build_model as jbuild
from repro_torch import configs as tcfg
from repro_torch import tree
from repro_torch.configs import InputShape, TrainConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models.registry import build_model as tbuild
from test_torch_zoo_train import PARITY_OB

#: the reference's reason (``repro/launch/dryrun.py``)
LONG_REASON = ("full-attention arch: long_500k requires sub-quadratic "
               "attention (DESIGN.md §5)")


def _ref_param_bytes(arch, shape, names):
    """Σ bytes / Π axis sizes over the reference's param specs."""
    jm = jbuild(jcfg.get_config(arch))
    mesh = AbstractMesh(shape, names)
    sh, shapes = jsteps.param_shardings(jm, mesh)
    sizes = dict(zip(names, shape))
    total = 0
    for s, x in zip(jax.tree_util.tree_leaves(sh),
                    jax.tree_util.tree_leaves(shapes)):
        div = 1
        for part in s.spec:
            for ax in ((part,) if isinstance(part, str) else part or ()):
                div *= sizes[ax]
        total += math.prod(x.shape) * x.dtype.itemsize // div
    return total


@pytest.mark.parametrize("arch", sorted(jcfg.ARCH_MODULES))
def test_param_bytes_product_rule(arch):
    for multi in (False, True):
        m = tmesh.make_production_mesh(multi_pod=multi)
        specs, shapes = tsteps.param_shardings(tbuild(tcfg.get_config(arch)),
                                               m)
        leaves = [dryrun._leaf(specs, keys)
                  for keys, _ in tree.flatten_with_keys(shapes)]
        assert dryrun.spec_bytes(shapes, leaves, m) == _ref_param_bytes(
            arch, m.axis_sizes, m.axis_names)


def test_zoo_train_result_and_cli(tmp_path, monkeypatch, capsys):
    """On the (32, 8) mesh: gemma2-2b's train step (32 sequences of 64,
    to keep the test short) is the zoo-train round with the model axis
    split, its param bytes the product rule; whisper-base through the
    CLI: decode_32k splits k/v over the 32 data ranks and keeps the
    cross leaves whole, and long_500k is skipped with the reference's
    reason; results land as JSON under the results directory."""
    cfg = tcfg.get_config("gemma2-2b")
    train = dryrun.measure(cfg, InputShape("t64", 64, 32, "train"),
                           (32, 8), ("data", "model"))
    assert train["model_axis"] == "split"
    assert train["memory"]["params"] == _ref_param_bytes(
        "gemma2-2b", (32, 8), ("data", "model"))
    assert train["rows_per_card"] == 1
    assert train["cost"]["flops"] > 0 and train["memory"]["step_peak"] > 0
    assert set(train["collectives"]["bytes"]) == {"all_gather",
                                                  "all_reduce"}
    assert train["param_count"] == sum(
        x.numel() for x in tree.leaves(tbuild(cfg).init(0, device="meta")))
    assert train["fits"] == (train["memory"]["total"]
                             <= dryrun.H100_80GB_BYTES)
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    assert dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k",
                        "--mesh", "single"]) == 0
    assert capsys.readouterr().out.startswith("[ok     ] whisper-base")
    dec = dryrun.run_combo("whisper-base", "decode_32k", False)
    assert dec["mesh"] == "32x8" and dec["n_devices"] == 256
    assert dec["cache_shapes"]["k"][2] == 32_768 // 32
    assert dec["cache_shapes"]["cross_k"][2] == tcfg.get_config(
        "whisper-base").encoder_seq_len
    assert dec["cache_split"]["k"][2] == "data"
    assert dec["model_axis"] == "split"
    # the k/v partial softmaxes over the data group; the heads' and
    # hidden columns' sums and the norms' and odd vocabulary's gathers
    # over the model group
    assert set(dec["collectives"]["bytes"]) == {"all_gather", "all_reduce",
                                                "all_reduce_max"}
    assert dryrun.main(["--arch", "whisper-base", "--shape", "long_500k",
                        "--mesh", "both"]) == 0
    assert capsys.readouterr().out.count("[skipped]") == 2
    skip = dryrun.run_combo("whisper-base", "long_500k", False)
    assert skip == {"status": "skipped", "reason": LONG_REASON}
    assert len(list(tmp_path.glob("*.json"))) == 3


def test_dense_train_flops_near_6nt():
    cfg = tcfg.get_config("gemma2-2b")
    res = dryrun.measure(cfg, InputShape("t512", 512, 4, "train"), (4, 1),
                         ("data", "model"), agg="mean",
                         tcfg=TrainConfig(aggregation="mean",
                                          remat_policy="off"))
    assert res["model_axis"] == "replicated" and res["rows_per_card"] == 1
    want = 6 * res["param_count"] * 512
    assert abs(res["cost"]["flops"] - want) <= 0.1 * want, (
        res["cost"]["flops"], want)
    assert res["collectives"]["bytes"]["all_reduce"] >= 4 * res[
        "param_count"]


@pytest.mark.parametrize("shape,names", [((32, 8), ("data", "model")),
                                         ((2, 32, 8),
                                          ("pod", "data", "model"))])
def test_mean_train_split_product_rule(shape, names):
    """gemma2-2b's ``mean`` train row (64 sequences of 64, to keep the
    test short) with a model axis is the split train step: ``"model_axis":
    "split"``, its parameter bytes the product rule over the reference's
    param specs on the mesh, the optimizer state (SGD) empty, and its
    collectives the layers' gathers and the gradient shares' sum (their
    bytes against a live world: ``test_torch_train_model_axis.py``)."""
    res = dryrun.measure(tcfg.get_config("gemma2-2b"),
                         InputShape("t64", 64, 64, "train"), shape, names,
                         agg="mean")
    assert res["model_axis"] == "split"
    assert res["rows_per_card"] == 64 // math.prod(shape[:-1])
    assert res["memory"]["params"] == _ref_param_bytes("gemma2-2b", shape,
                                                       names)
    assert res["memory"]["optimizer"] == 0
    assert set(res["collectives"]["bytes"]) == {"all_gather", "all_reduce"}
    # every gradient share summed once, and the loss
    assert res["collectives"]["bytes"]["all_reduce"] == res["memory"][
        "params"] + 4


def test_zoo_train_bytes_match_live_world(tmp_path):
    """One zoo-train round of gemma2's smoke model on 2 x 2: the bytes
    the dry run's fake world counts, by kind, equal what every rank of a
    live gloo world counted."""
    arch = "gemma2-2b"
    cfg = tcfg.scaled(tcfg.get_smoke_config(arch), dtype="float32")
    model = tbuild(cfg)
    tc = TrainConfig(aggregation="obcsaa", cs_chunk=PARITY_OB["chunk"],
                     cs_measure=PARITY_OB["measure"],
                     cs_topk=PARITY_OB["topk"], cs_packed=True,
                     compute_dtype="float32")
    res = dryrun.measure(cfg, InputShape("t", 32, 4, "train"), (2, 2),
                         ("data", "model"), agg="obcsaa", tcfg=tc)
    zr = tsteps.make_zoo_train_round(model, tc, tmesh.make_zoo_mesh(2, 2),
                                     device="cpu",
                                     compute_dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, (2, 2, 32), generator=g,
                        dtype=torch.int32)
    draws = zr.draws(1)(0)
    outs = run_world("zoo_train", 4, {"args": (1e-4, 10.0, 0.05),
                                      "dir": str(tmp_path), "cases": {
        "c": {"arch": arch, "ob": PARITY_OB, "phi": zr.phi, "opt": "sgd",
              "ef": False, "state": tuple(zr.init_state(
                  zr.chunk_params(model.init(0, device="cpu")))),
              "batch": {"tokens": tok, "targets": tok.roll(-1, -1)},
              "draws": [tuple(draws)]}}}, tmp_path, model_parallel=2)
    for o in outs:
        assert o["c"]["bytes"][0] == res["collectives"]["bytes"]
    assert res["zoo"]["n_local"] == zr.n_local
    assert res["memory"]["master"] == zr.n_local * zr.ob.chunk * 4
    np.testing.assert_equal(res["memory"]["params"], _port_param_bytes(
        model, tmesh.ZooMesh(("data", "model"), (2, 2))))


def _port_param_bytes(model, mesh):
    specs, shapes = tsteps.param_shardings(model, mesh)
    return dryrun.spec_bytes(shapes, [dryrun._leaf(specs, k) for k, _ in
                                      tree.flatten_with_keys(shapes)], mesh)


def test_serve_bytes_match_live_world(tmp_path):
    """The split prefill (gemma2's smoke model, 2 sequences of 32 a card)
    and the split decode step (minicpm3's, MLA, a 4 x 32 cache) on 2 x 2:
    the dry run records ``"model_axis": "split"``, and the bytes its fake
    world counts by kind, the parameter bytes (the product rule) and the
    cache bytes equal what every rank of a live gloo world counted and
    held."""
    cases = {"prefill": ("gemma2-2b", InputShape("p32", 32, 4, "prefill")),
             "decode": ("minicpm3-4b", InputShape("d32", 32, 4, "decode"))}
    res = {k: dryrun.measure(tcfg.scaled(tcfg.get_smoke_config(a),
                                         dtype="float32"), shape, (2, 2),
                             ("data", "model"))
           for k, (a, shape) in cases.items()}
    outs = run_world("serve_bytes", 4, {"cases": {
        k: {"arch": a, "seq": shape.seq_len, "rows": shape.global_batch // 2,
            "batch": shape.global_batch} for k, (a, shape) in cases.items()}},
        tmp_path, model_parallel=2)
    for kind, (arch, _) in cases.items():
        r = res[kind]
        assert r["model_axis"] == "split"
        model = tbuild(tcfg.scaled(tcfg.get_smoke_config(arch),
                                   dtype="float32"))
        assert r["memory"]["params"] == _port_param_bytes(
            model, tmesh.ZooMesh(("data", "model"), (2, 2)))
        for o in outs:
            assert o[kind][kind] == r["collectives"]["bytes"], kind
            assert o[kind]["params"] == r["memory"]["params"]
            if kind == "decode":
                assert o[kind]["cache"] == r["memory"]["cache"]
    assert res["decode"]["cache_shapes"]["ckv"] == [2, 2, 32, 32]


@pytest.mark.parametrize("agg", ["mean", "obcsaa"])
def test_variant_opt_rows(agg, tmp_path, monkeypatch, capsys):
    """``--variant opt`` on gemma2's smoke model (small shapes under the
    production names, so that the reference's rule reads them): the opt
    rows go to files suffixed ``__opt`` with ``"variant": "opt"``; they
    differ from the baseline's only where the rule changes what the
    row's program reads (``decode_sharded_chunks=16`` at decode_32k and
    long_500k, recorded in ``"changed"``). The train rows get
    ``cs_shard_aligned`` as the reference's do, but neither the ``mean``
    step nor the zoo-train round (``obcsaa`` on the production mesh's
    model axis) reads it: their ``"changed"`` is empty and they equal
    the baseline's but for their time, as the prefill row does; only
    the ``obcsaa`` train step, without a model axis, records it. The
    baseline files stay as they were."""
    import json
    smoke = tcfg.get_smoke_config("gemma2-2b")
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    monkeypatch.setattr(dryrun, "get_config", lambda arch: smoke)
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", {
        "train_4k": InputShape("train_4k", 32, 32, "train"),
        "prefill_32k": InputShape("prefill_32k", 64, 32, "prefill"),
        "decode_32k": InputShape("decode_32k", 1024, 32, "decode"),
        "long_500k": InputShape("long_500k", 2048, 1, "decode")})
    seen = []
    measure = dryrun.measure

    def spy(cfg, shape, *a, tcfg=None, **k):
        seen.append((shape.name, cfg.decode_sharded_chunks,
                     tcfg.cs_shard_aligned))
        return measure(cfg, shape, *a, tcfg=tcfg, **k)

    monkeypatch.setattr(dryrun, "measure", spy)
    args = ["--arch", "gemma2-2b", "--mesh", "single", "--agg", agg]
    assert dryrun.main(args) == 0
    base = {p.name: p.read_text() for p in tmp_path.glob("*.json")}
    assert len(base) == 4 and not any("__opt" in n for n in base)
    assert dryrun.main(args + ["--variant", "opt"]) == 0
    out = capsys.readouterr().out
    assert out.count("[ok     ]") == 8 and out.count(" opt ") == 4
    assert {p.name: p.read_text() for p in tmp_path.glob("*.json")
            if "__opt" not in p.name} == base
    assert seen == [
        ("train_4k", 0, False), ("prefill_32k", 0, False),
        ("decode_32k", 0, False), ("long_500k", 0, False),
        ("train_4k", 0, True), ("prefill_32k", 0, False),
        ("decode_32k", 16, False), ("long_500k", 16, False)]
    want = {"train_4k": {}, "prefill_32k": {},
            "decode_32k": {"decode_sharded_chunks": 16},
            "long_500k": {"decode_sharded_chunks": 16}}
    for shape, changed in want.items():
        name = f"gemma2-2b__{shape}__single__{agg}"
        b = json.loads(base[name + ".json"])
        o = json.loads((tmp_path / (name + "__opt.json")).read_text())
        assert "variant" not in b and "changed" not in b
        assert o.pop("variant") == "opt" and o.pop("changed") == changed
        for r in (b, o):
            r.pop("run_s")
        if not changed:
            assert o == b
        else:
            assert o["memory"]["params"] == b["memory"]["params"]
    # the flash-decoding chunks change the decode step's own tensors
    o, b = (json.loads((tmp_path / f"gemma2-2b__decode_32k__single__{agg}"
                                   f"{s}.json").read_text())
            for s in ("__opt", ""))
    assert o["memory"]["step_peak"] != b["memory"]["step_peak"]
    # the obcsaa train step (no model axis) is the one program that reads
    # cs_shard_aligned
    for M, rec in ((1, agg == "obcsaa"), (8, False)):
        _, tc, changed = dryrun.variant_config(smoke, "train_4k", agg,
                                               "opt", M)
        assert tc.cs_shard_aligned
        assert changed == ({"cs_shard_aligned": True} if rec else {})
