"""The zoo's layout index math (``repro_torch.dist``, ``launch.mesh``)
against ``repro.dist`` on ``jax.sharding.AbstractMesh`` meshes, on the
CPU.

Exact throughout: ``param_shard_dims``, ``best_spec`` and
``infer_param_sharding`` specs for every
config's smoke model at meshes 1 x 1, 4 x 2 and 2 x 4 (and a 3-axis
``pod`` mesh for ``best_spec``); ``FlatShardLayout``'s slots, offsets
and ``tree_to_master`` bit for bit for the gemma2-2b and mamba2-2.7b
smoke models at mp = 1, 2, 4 on the reference's seed-0 weights, its
round trips, and its error messages; ``launch.steps._shard_aligned_perm``
on those specs.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_MODULES
from repro.configs import get_smoke_config as jsmoke
from repro.dist import flat_layout as jfl
from repro.dist import sharding as jsh
from repro.launch import steps as jsteps
from repro.models.registry import build_model as jbuild
from repro_torch import tree
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.convert import lm_params_from_reference
from repro_torch.dist import flat_layout as tfl
from repro_torch.dist import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models.registry import build_model as tbuild

MESHES = [(1, 1), (4, 2), (2, 4)]
ARCHS = sorted(ARCH_MODULES)


def _meshes(w, m):
    return (AbstractMesh((w, m), ("data", "model")),
            tmesh.make_zoo_mesh(w, m))


def _shapes(arch):
    j = jax.eval_shape(jbuild(jsmoke(arch)).init, jax.random.PRNGKey(0))
    t = tbuild(tsmoke(arch)).init(0, device="meta")
    return j, t


def _ref_specs(shardings):
    return [tuple(s.spec) for s in jax.tree_util.tree_leaves(shardings)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference(arch):
    """Every leaf's model dim and spec, at three meshes, for every config;
    the spec tree places each spec at its leaf."""
    js, ts = _shapes(arch)
    for w, m in MESHES:
        jm, tm = _meshes(w, m)
        assert tree.leaves(tsh.param_shard_dims(ts, tm)) == \
            jax.tree_util.tree_leaves(jsh.param_shard_dims(js, jm))
        want = _ref_specs(jsh.infer_param_sharding(js, jm))
        assert tsh.infer_param_specs(ts, tm) == want
        got = tsh.infer_param_sharding(ts, tm)
        for (keys, _), spec in zip(tree.flatten_with_keys(ts), want):
            node = got
            for k in keys:
                node = node[k]
            assert node == spec


@pytest.mark.parametrize("shape,hints", [
    ((8, 6), ["data", "model"]), ((6, 8), [["model", "data"], None]),
    ((3, 4, 16), [None, "model", "data"]), ((4,), [("data", "model")]),
    ((12, 2), ["model", "model"]), ((), []), ((16, 16), [None, None])])
def test_best_spec_matches_reference(shape, hints):
    meshes = [(AbstractMesh((4, 2), ("data", "model")),
               tmesh.ZooMesh(("data", "model"), (4, 2))),
              (AbstractMesh((2, 2, 2), ("pod", "data", "model")),
               tmesh.ZooMesh(("pod", "data", "model"), (2, 2, 2)))]
    for jm, tm in meshes:
        assert tsh.best_spec(shape, hints, tm) == \
            tuple(jsh.best_spec(shape, hints, jm))


def test_stacked_paths_and_model_dim():
    assert tsh._path_is_stacked(("layers", "mlp", "w1"), tsh.STACKED_KEYS)
    assert tsh._path_is_stacked(("enc_layers", 0), tsh.STACKED_KEYS)
    assert not tsh._path_is_stacked(("embedding",), tsh.STACKED_KEYS)
    for shape, m, skip in [((4, 8, 8), 2, True), ((4, 8, 8), 2, False),
                           ((6, 3), 3, False), ((5,), 2, False), ((), 2,
                                                                  False),
                           ((8, 8), 1, False), ((1, 4), 4, False)]:
        assert tsh._best_model_dim(shape, m, skip_leading=skip) == \
            jsh._best_model_dim(shape, m, skip_leading=skip)
    x = torch.ones(3)
    assert tsh.constrain(x, ("model",)) is x


def test_mesh_helpers():
    m = tmesh.make_zoo_mesh()
    assert m.shape == {"data": 1, "model": 1}          # no card: 1 x 1
    assert tmesh.make_host_mesh().shape == {"data": 1, "model": 1}
    m = tmesh.make_zoo_mesh(4, 2)
    assert m.axis_names == ("data", "model") and m.axis_sizes == (4, 2)
    assert tmesh.worker_axes(m) == ("data",) and tmesh.num_workers(m) == 4
    p = tmesh.ZooMesh(("pod", "data", "model"), (2, 3, 2))
    assert tmesh.worker_axes(p) == ("pod", "data")
    assert tmesh.num_workers(p) == 6
    assert tmesh.make_zoo_mesh(3, 0).shape == {"data": 3, "model": 1}
    with pytest.raises(ValueError, match="positive"):
        tmesh.ZooMesh(("data",), (0,))


def _ref_params(arch):
    return jbuild(jsmoke(arch)).init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-2.7b"])
def test_flat_layout_matches_reference(arch):
    """Slots and offsets, ``tree_to_master`` bit for bit, and the round
    trips, at mp = 1, 2, 4 with 4 workers."""
    jp = _ref_params(arch)
    tp = lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    js = jax.eval_shape(lambda: jp)
    for mp in (1, 2, 4):
        jm, tm = _meshes(4, mp)
        jl = jfl.FlatShardLayout.build(js, jm, chunk=256, gran=4 * 8)
        tl = tfl.FlatShardLayout.build(tp, tm, chunk=256, gran=4 * 8)
        assert (tl.n_half, tl.n_chunks, tl.D, tl.D_pad, tl.sec_elems) == \
            (jl.n_half, jl.n_chunks, jl.D, jl.D_pad, jl.sec_elems)
        for a, b in zip(tl.slots, jl.slots):
            assert (a.name, a.shape, a.dim, a.offset, a.m_size) == \
                (b.name, b.shape, b.dim, b.offset, b.m_size)
            assert tl.shard_shape(a) == jl.shard_shape(b)
        master = tl.tree_to_master(tp)
        np.testing.assert_array_equal(master.numpy(),
                                      np.asarray(jl.tree_to_master(jp)))
        back = tl.master_to_tree(master)
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(back),
                                                     tree.leaves(tp)))
        bf = tl.master_to_tree(master, dtype=torch.bfloat16)
        assert all(a.dtype == torch.bfloat16 and torch.equal(
            a, b.to(torch.bfloat16)) for a, b in zip(tree.leaves(bf),
                                                     tree.leaves(tp)))
        sect = master.view(mp, tl.n_half, tl.chunk)[mp - 1]
        np.testing.assert_array_equal(
            tl.tree_to_section(tl.section_to_tree(sect)).numpy(),
            sect.numpy())
        jsect = jl.tree_to_section(jl.section_to_tree(
            np.asarray(jl.tree_to_master(jp)).reshape(
                mp, jl.n_half, jl.chunk)[mp - 1]))
        np.testing.assert_array_equal(np.asarray(jsect), sect.numpy())


def test_flat_layout_error_messages():
    """A leaf with no dim divisible by the model axis: the reference's
    message, word for word."""
    js, ts = _shapes("gemma2-2b")
    for w, m in [(1, 3), (2, 7)]:
        jm, tm = _meshes(w, m)
        with pytest.raises(ValueError) as je:
            jfl.FlatShardLayout.build(js, jm, chunk=256)
        with pytest.raises(ValueError) as te:
            tfl.FlatShardLayout.build(ts, tm, chunk=256)
        assert str(te.value) == str(je.value)
        assert "has no dim divisible by the model-axis size" in \
            str(te.value)


@pytest.mark.parametrize("w,m", MESHES)
def test_shard_aligned_perm_matches_reference(w, m):
    """The per-leaf permutations of the shard-aligned chunking, from each
    package's specs on the same mesh; None everywhere on 1 x 1."""
    js, ts = _shapes("gemma2-2b")
    jm, tm = _meshes(w, m)
    jspecs = _ref_specs(jsh.infer_param_sharding(js, jm))
    tspecs = tsh.infer_param_specs(ts, tm)
    jl = jax.tree_util.tree_leaves(js)
    got = [tsteps._shard_aligned_perm(x.shape, s)
           for x, s in zip(tree.leaves(ts), tspecs)]
    want = [jsteps._shard_aligned_perm(x.shape, jax.sharding.PartitionSpec(
        *s)) for x, s in zip(jl, jspecs)]
    assert got == want
    if m == 1:
        assert all(p is None for p in got)
    else:
        assert any(p is not None for p in got)
