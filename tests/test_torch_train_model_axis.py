"""The train step with the model axis split (``launch.steps.
make_train_step`` on a mesh with a model group) on a 2 x 2 gloo world on
the CPU: rank d·2 + m holds model shard m of worker d's weights
(``dist.shares``). The smoke configs in f32 of gemma2 (dense, a tied
embedding, soft-caps), mixtral (MoE, the experts' leaves split), mamba2
(stacked SSM leaves) and internvl2 (the VLM prefix), one sequence of 32
a worker, the CS geometry of ``tests/test_torch_workers.py`` (chunks of
1024, S_c 256, κ_c 64, BIHT 3), 2 steps of ``mean`` and ``obcsaa``
each. The ranks import no JAX (``_torch_dist_child``).

Tolerances:
- (a) against the same W = 2 workers over processes at M = 1 (every
  model column runs it over its worker group, in the same launch): bit
  for bit, every rank's shares after each step, the losses, and under
  ``obcsaa`` every decoded leaf. ``mean`` is the M = 1 arithmetic on
  blocks: the gathered forward computes the whole weights' forward, a
  leaf's gradient is its block of the whole gradient, and the sum over
  two workers is exact in any order. ``obcsaa`` compresses and decodes
  1/M of a leaf's chunk rows a rank; rows are independent, and the
  CPU's GEMMs round a row alike whatever the rows beside it here.
- (b) against the reference's own functions from the same weights
  (``test_torch_workers._ref_step`` and ``_simulate_injected`` at W = 2,
  the reference's Φ and AWGN injected), step 0, at that file's bounds:
  the loss rtol 1e-5, each decoded leaf by NMSE and support with ≤ 1%
  of its 1024-chunks parted, the parameters within 1e-4 of their
  movement or with ≤ 1% of its chunks parted.
- (c) ``cs_shard_aligned=True`` at M = 2, step 0, against the
  reference's per-leaf oracle with each leaf permuted by
  ``repro.launch.steps._shard_aligned_perm`` of the reference's
  ``infer_param_sharding`` on ``AbstractMesh((2, 2))`` (no
  ``jax.set_mesh``: ROADMAP Queue 3), at (b)'s bounds.
- exact: the split carry (Adam) saved at M = 2 and restored at M = 1 and
  at M = 2, and an M = 1 carry restored at M = 2 as each rank's shares;
  the dry run's ``mean`` row at (2, 2): ``"model_axis": "split"``, its
  parameter bytes the product rule, its collective bytes by kind the
  live world's; the CLI's ``--resume`` under ``--model-parallel 2``
  against its uninterrupted run, stepped and with ``--scan-rounds 2``.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import test_torch_workers as tw
from _torch_dist_child import run_world
from repro import configs as jcfg
from repro.core import channel as jchan
from repro.launch import steps as jsteps
from repro_torch import configs as tcfg
from repro_torch import tree
from repro_torch.configs import InputShape, TrainConfig
from repro_torch.convert import lm_params_from_reference
from repro_torch.data import token_stream
from repro_torch.dist.shares import ModelAxis
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import ZooMesh
from repro_torch.models.layers import init_cut
from repro_torch.models.registry import build_model as tbuild

W, M, SEQ = 2, 2, 32
CS = dict(tw.CS)
ARCHS = {"gemma2": "gemma2-2b", "mixtral": "mixtral-8x22b",
         "mamba2": "mamba2-2.7b", "internvl2": "internvl2-1b"}
#: per step: (β, b_t)
SCHED = [((1, 1), 1.5), ((0, 1), 2.0)]
LOGICAL = ZooMesh(("data", "model"), (W, M))


def _np(a):
    return np.array(a, copy=True)


def _t(a):
    return torch.from_numpy(_np(a))


def _batch(jc) -> dict:
    tok, tgt = token_stream(W, SEQ, jc.vocab_size, seed=0)
    b = {"tokens": tok, "targets": tgt}
    if jc.family == "vlm":
        b["image_embeds"] = 0.1 * np.ones(
            (W, jc.num_image_tokens, jc.d_model), np.float32)
    return b


def _ctxs(jp, jo, steps: int) -> list:
    """Per step: β, b_t, the reference's Φ and leaf i's AWGN
    ``fold_in(PRNGKey(20 + t), i)``."""
    out = []
    for t in range(steps):
        beta, b_t = SCHED[t]
        key = jax.random.PRNGKey(20 + t)
        out.append({"beta": torch.tensor(beta, dtype=torch.float32),
                    "b_t": torch.tensor(b_t), "phi": _t(jo.phi()),
                    "noise": [_t(jchan.draw_noise(
                        jax.random.fold_in(key, i),
                        (-(-leaf.size // 1024), 256), jo.noise_var))
                        for i, leaf in enumerate(
                            jax.tree_util.tree_leaves(jp))]})
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    jo = jsteps.obcsaa_config(jcfg.TrainConfig(aggregation="obcsaa", **CS))
    cases, refs = {}, {}
    for short, arch in ARCHS.items():
        jc, jm, jp = tw._ref_model(arch)
        b = _batch(jc)
        refs[short] = (jm, jp, {k: jnp.asarray(v) for k, v in b.items()})
        common = {"arch": arch, "batch": {k: torch.from_numpy(v)
                                          for k, v in b.items()},
                  "params": lm_params_from_reference(
                      jax.tree_util.tree_map(np.asarray, jp),
                      device="cpu")}
        cases[f"{short}_mean"] = dict(common, agg="mean", m1=True,
                                      ctxs=[{}, {}])
        cases[f"{short}_obcsaa"] = dict(common, agg="obcsaa", m1=True,
                                        ctxs=_ctxs(jp, jo, 2))
        cases[f"{short}_aligned"] = dict(common, agg="obcsaa", aligned=True,
                                         ctxs=_ctxs(jp, jo, 1))
    cases["gemma2_adam"] = dict(cases["gemma2_mean"], opt="adam",
                                ckpt=True)
    tmp = tmp_path_factory.mktemp("train_split")
    outs = run_world("train_split", W * M, {"cases": cases, "cs": CS,
                                            "dir": str(tmp)}, tmp,
                     model_parallel=M)
    return jo, cases, refs, outs, str(tmp)


def _model(arch):
    return tbuild(tcfg.scaled(tcfg.get_smoke_config(arch), dtype="float32"))


def _axes(arch) -> list:
    shapes = _model(arch).init(0, device="meta")
    return [ModelAxis(shapes, LOGICAL, m=m) for m in range(M)]


def _whole(axes, parts) -> list:
    """The whole leaves from model shards 0..M-1's shares."""
    ax = axes[0]
    return [torch.cat([p[i] for p in parts], ax.dims[i]) if ax.split(i)
            else parts[0][i] for i in range(len(ax.shapes))]


def _one_row(shape) -> bool:
    """Whether a leaf of ``shape`` has more than one 1024-chunk and a
    model shard's block of them (``steps._row_block``) is a single row:
    the CPU multiplies one row by Φ as a matrix-vector product, which
    rounds otherwise than that row of a larger product."""
    n = -(-int(np.prod(shape)) // 1024)
    return n > 1 and any(b - a == 1 for a, b in
                         (tsteps._row_block(n, M, m) for m in range(M)))


@pytest.mark.parametrize("name", [f"{a}_{k}" for a in ARCHS
                                  for k in ("mean", "obcsaa")])
def test_split_matches_m1_processes(trained, name):
    """(a): every rank's shares after each step are its blocks of the
    M = 1 process path's parameters, bit for bit, and ``whole_tree`` of
    them its whole parameters; the losses and the decoded leaves equal. Under ``obcsaa`` a leaf of two chunks (mixtral's
    router, mamba2's ``conv_b``) is a one-row block on each rank, which
    the CPU rounds otherwise (``_one_row``): there step 0 holds every
    other leaf bit for bit and that one within the chunk gates, and step
    1, from carries that far apart, is held as ``test_torch_workers``
    holds the process group against the in-turn path."""
    _, cases, _, outs, _ = trained
    axes = _axes(cases[name]["arch"])
    one_row = [_one_row(s) for s in axes[0].shapes]
    exact = cases[name]["agg"] == "mean" or not any(one_row)
    assert exact == (name not in ("mixtral_obcsaa", "mamba2_obcsaa"))
    ref = outs[0][name]["m1"]
    for o in outs[1:]:      # every column ran the M = 1 path alike
        assert all(torch.equal(a, b) for a, b in
                   zip(o[name]["m1"]["params"][-1], ref["params"][-1]))
    for r, o in enumerate(outs):
        got, m = o[name], r % M
        # whole_tree: every rank gathers the same whole parameters
        for a, b in zip(got["whole"], outs[0][name]["whole"]):
            assert torch.equal(a, b)
        if exact:
            for a, b in zip(got["whole"], ref["params"][-1]):
                assert torch.equal(a, b)
        steps = range(len(ref["params"]) if exact else 1)
        for t in steps:
            assert got["losses"][t] == ref["losses"][t]
            for i, (a, b) in enumerate(zip(got["params"][t],
                                           ref["params"][t])):
                if exact or not one_row[i]:
                    assert torch.equal(a, axes[m].share_leaf(b, i)), (t, i)
            assert len(got["decoded"][t]) == len(ref["decoded"][t])
            for i, (a, b) in enumerate(zip(got["decoded"][t],
                                           ref["decoded"][t])):
                if exact or not one_row[i]:
                    assert torch.equal(a, b), (t, i)
                else:
                    tw._gate(a.numpy(), b.numpy(), (name, t, i),
                             parted=True)
        if exact:
            continue
        assert got["losses"][1] == pytest.approx(ref["losses"][1], rel=1e-5)
        for i, (a, b) in enumerate(zip(got["decoded"][1],
                                       ref["decoded"][1])):
            tw._gate(a.numpy(), b.numpy(), (name, 1, i), parted=True)
        start = [axes[m].share_leaf(x, i) for i, x in
                 enumerate(tree.leaves(cases[name]["params"]))]
        tw._movement_gate(got["params"][1], [
            axes[m].share_leaf(x, i) for i, x in
            enumerate(ref["params"][1])], start, 1e-4, name)
    assert cases[name]["agg"] == "mean" or len(ref["decoded"][0]) == len(
        axes[0].shapes)


@pytest.mark.parametrize("name", [f"{a}_{k}" for a in ARCHS
                                  for k in ("mean", "obcsaa")])
def test_split_matches_reference(trained, monkeypatch, name):
    """(b): step 0 against the reference's per-worker gradients through
    its own ``simulate_round`` body per leaf (``obcsaa``) or its mean
    gradient (``mean``), and SGD."""
    jo, cases, refs, outs, _ = trained
    short, agg = name.rsplit("_", 1)
    jm, jp, jb = refs[short]
    monkeypatch.setattr(tw, "U", W)
    lval, new, ghat = tw._ref_step(jo, jm, jp, jb, agg,
                                   cases[name]["ctxs"][0], per_shard=False)
    got = outs[0][name]
    assert got["losses"][0] == pytest.approx(lval, rel=1e-5)
    if ghat is not None:
        for i, (g, w) in enumerate(zip(got["decoded"][0], ghat)):
            tw._gate(g.numpy()[:w.size], _np(w).ravel(), (name, i),
                     parted=True)
    axes = _axes(cases[name]["arch"])
    params = _whole(axes, [outs[m][name]["params"][0] for m in range(M)])
    tw._movement_gate(params, jax.tree_util.tree_leaves(new),
                      jax.tree_util.tree_leaves(jp), 1e-4, name)


@pytest.mark.parametrize("short", list(ARCHS))
def test_shard_aligned_matches_reference(trained, short):
    """(c): ``cs_shard_aligned`` at M = 2: each leaf chunked along its
    model-sharded dim first, with the reference's perms on the (2, 2)
    mesh, against the reference's per-leaf oracle."""
    jo, cases, refs, outs, _ = trained
    name = f"{short}_aligned"
    jm, jp, jb = refs[short]
    ctx = cases[name]["ctxs"][0]
    specs = jax.tree_util.tree_leaves(
        jsteps.param_shardings(jm, AbstractMesh((W, M),
                                                ("data", "model")))[0])
    leaves = jax.tree_util.tree_leaves(jp)
    perms = [jsteps._shard_aligned_perm(x.shape, s.spec)
             for x, s in zip(leaves, specs)]
    assert any(p is not None and list(p) != sorted(p) for p in perms)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, remat=False)[0]))
    lg = [vg(jp, {k: v[u:u + 1] for k, v in jb.items()}) for u in range(W)]
    got = outs[0][name]
    assert got["losses"][0] == pytest.approx(
        np.mean([float(v) for v, _ in lg]), rel=1e-5)
    grads = [jax.tree_util.tree_leaves(g) for _, g in lg]
    new = []
    for i, (leaf, perm) in enumerate(zip(leaves, perms)):
        flat = jnp.stack([(g[i] if perm is None else g[i].transpose(perm))
                          .reshape(-1) for g in grads])
        gh = tw._simulate_injected(
            jo, flat, jnp.ones((W,), jnp.float32),
            jnp.asarray(ctx["beta"].numpy()), jnp.float32(ctx["b_t"]),
            jnp.asarray(ctx["noise"][i].numpy()))
        tw._gate(got["decoded"][0][i].numpy()[:leaf.size], _np(gh),
                 (name, i), parted=True)
        shape = leaf.shape if perm is None else tuple(leaf.shape[j]
                                                      for j in perm)
        gh = gh.reshape(shape)
        if perm is not None:
            gh = gh.transpose(tuple(int(j) for j in np.argsort(perm)))
        new.append(leaf - CS["learning_rate"] * gh)
    axes = _axes(cases[name]["arch"])
    params = _whole(axes, [outs[m][name]["params"][0] for m in range(M)])
    tw._movement_gate(params, new, leaves, 1e-4, name)


def test_checkpoints_across_model_axis(trained):
    """The split Adam carry saved at M = 2 (rank 0 writing whole leaves)
    restores at M = 1 as the whole carry, bit for bit, and at M = 2 as
    each rank's shares; the M = 1 carry restores at M = 2 as each rank's
    shares."""
    _, cases, _, outs, tmp = trained
    name = "gemma2_adam"
    arch = cases[name]["arch"]
    for o in outs:
        assert o[name]["restored_m2"] and o[name]["restored_m1"]
    model = _model(arch)
    tt = TrainConfig(aggregation="mean", optimizer="adam", **CS)
    p, o, step = tsteps.restore_train_state(os.path.join(tmp, name, "m2"),
                                            model, tt, "cpu")
    assert step == 2
    oshapes = tsteps.make_optimizer(tt).init(model.init(0, device="meta"))
    oaxes = [ModelAxis(oshapes, LOGICAL, m=m) for m in range(M)]
    whole = (_whole(_axes(arch), [outs[m][name]["params"][-1]
                                  for m in range(M)])
             + _whole(oaxes, [outs[m][name]["opt"] for m in range(M)]))
    assert len(whole) == len(tree.leaves((p, o)))
    for a, b in zip(tree.leaves((p, o)), whole):
        assert torch.equal(a, b)
    m1 = outs[0][name]["m1"]
    for a, b in zip(tree.leaves((p, o)), m1["params"][-1] + m1["opt"]):
        assert torch.equal(a, b)


def test_dryrun_mean_split_matches_live_world(trained):
    """The dry run's ``mean`` train row at (2, 2) is the split step:
    ``"model_axis": "split"``, rank (0, 0)'s parameter bytes the product
    rule over ``param_shardings`` (the shares the live ranks held), and
    its collective bytes by kind those every live rank counted in one
    step of the same shapes."""
    _, cases, _, outs, _ = trained
    arch = cases["gemma2_mean"]["arch"]
    cfg = tcfg.scaled(tcfg.get_smoke_config(arch), dtype="float32")
    res = dryrun.measure(cfg, InputShape("t", SEQ, W, "train"), (W, M),
                         ("data", "model"), agg="mean",
                         tcfg=TrainConfig(aggregation="mean", **CS))
    assert res["model_axis"] == "split" and res["rows_per_card"] == 1
    model = _model(arch)
    specs, shapes = tsteps.param_shardings(model, LOGICAL)
    rule = dryrun.spec_bytes(shapes, [dryrun._leaf(specs, k) for k, _ in
                                      tree.flatten_with_keys(shapes)],
                             LOGICAL)
    assert res["memory"]["params"] == rule
    for o in outs:
        held = o["gemma2_mean"]["params"][0]
        assert sum(x.numel() * x.element_size() for x in held) == rule
        assert o["gemma2_mean"]["bytes"][0] == res["collectives"]["bytes"]


def _ckpt_arrays(path, step):
    return np.load(os.path.join(path, f"step_{step:08d}", "arrays.npz"))


def test_cli_resume_under_model_parallel(tmp_path):
    """``--model-parallel 2`` on 4 ranks: ``mean`` with Adam stepped,
    rounds 0-2 uninterrupted and 0-1 then ``--resume`` to 3; ``obcsaa``
    with ``--scan-rounds 2``, 4 rounds uninterrupted and 2 then
    ``--resume`` to 4: the final checkpoints equal leaf for leaf, and
    the replicas' shares equal."""
    ck = {k: str(tmp_path / k) for k in "abcd"}
    base = ["--model-parallel", "2", "--device", "cpu", "--smoke",
            "--batch", "2", "--seq", "16", "--cs-measure", "64",
            "--cs-topk", "16", "--check-replicas"]
    mean = base + ["--agg", "mean", "--optimizer", "adam"]
    scan = base + ["--agg", "obcsaa", "--scan-rounds", "2"]
    outs = run_world("zoo_cli", W * M, {"argvs": [
        mean + ["--steps", "3", "--ckpt-dir", ck["a"]],
        mean + ["--steps", "2", "--ckpt-dir", ck["b"]],
        mean + ["--steps", "3", "--ckpt-dir", ck["b"], "--resume"],
        scan + ["--steps", "4", "--ckpt-dir", ck["c"]],
        scan + ["--steps", "2", "--ckpt-dir", ck["d"]],
        scan + ["--steps", "4", "--ckpt-dir", ck["d"], "--resume"]]},
        tmp_path)
    logs = outs[0]["logs"]
    assert all("world: 2 x 2 ranks over gloo (the model split over 2 "
               "ranks), batch 2 = 2 x 1" in log for log in logs)
    assert all("replicas: parameter shares bit-identical on the 2 ranks "
               "of each worker group" in log for log in logs)
    assert all("the product rule over param_shardings" in log
               for log in logs)
    assert "resumed from step 2" in logs[2] and "resumed from step 2" in \
        logs[5]
    assert sum(ln.startswith("step ") for ln in logs[0].splitlines()) == 3
    assert sum(ln.startswith("rounds ") for ln in logs[3].splitlines()) == 2
    assert all(o["logs"] == [""] * 6 for o in outs[1:])
    for x, y, step in (("a", "b", 3), ("c", "d", 4)):
        got, want = _ckpt_arrays(ck[y], step), _ckpt_arrays(ck[x], step)
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("argv", [[], ["--zoo-train"]])
def test_model_parallel_needs_torchrun(monkeypatch, argv):
    """Outside ``torchrun`` ``--model-parallel 2`` refuses, saying that
    the split needs its world."""
    from repro_torch.launch import train as ttrain
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="the ranks of torchrun's world: "
                       "run it under torchrun"):
        ttrain.main(["--device", "cpu", "--smoke", "--model-parallel", "2"]
                    + argv)


@pytest.mark.parametrize("short", list(ARCHS))
def test_init_shares_are_slices_of_the_init(short):
    """Each model shard's init (``layers.init_cut`` with the shard's
    ``ModelAxis.cut``), every weight cut as it is drawn, is its slice of
    the whole seed-0 init bit for bit, 1/M of every split leaf."""
    model = _model(ARCHS[short])
    whole = model.init(0, device="cpu")
    for ax in _axes(ARCHS[short]):
        got = init_cut(model, 0, ax.cut, device="cpu")
        want = ax.shard_tree(whole)
        for i, (a, b) in enumerate(zip(tree.leaves(got), tree.leaves(want))):
            assert torch.equal(a, b), i
            assert a.numel() * (M if ax.split(i) else 1) == \
                math.prod(ax.shapes[i])
