"""The zoo's entry points in ``repro_torch.launch`` on the CPU:
``python -m repro_torch.launch.train --zoo-train`` (token shards, Adam
and EF, checkpoints with ``--resume``, ``--arms``), ``make_zoo_batch``
against the reference's, and ``TrainConfig(cs_shard_aligned=True)``.

Exact throughout: ``make_zoo_batch`` against ``repro.launch.train``'s;
a resumed ``--zoo-train`` run equals the uninterrupted one in every
checkpoint leaf (the round's draws and the token windows are keyed by
the absolute round); the shard-aligned step on a 1 x 1 mesh equals the
unaligned step bit for bit (no leaf is sharded, every permutation is
None).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import torch

from repro import configs as jcfg
from repro.launch import train as jtrain
from repro.models.registry import build_model as jbuild
from repro_torch import checkpoint as ck
from repro_torch import configs as tcfg
from repro_torch import tree
from repro_torch.convert import lm_params_from_reference
from repro_torch.data import token_stream
from repro_torch.data.tokens import write_token_shards
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.registry import build_model as tbuild

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_make_zoo_batch_matches_reference():
    """(U, B, S) per-worker token streams, seed ``rng_seed * 1000 + u``;
    a VLM's stub image embeddings stacked the same way."""
    for arch in ("gemma2-2b", "internvl2-1b"):
        want = jtrain.make_zoo_batch(jcfg.get_smoke_config(arch), 3, 2, 16,
                                     rng_seed=4)
        got = ttrain.make_zoo_batch(tcfg.get_smoke_config(arch), 3, 2, 16,
                                    rng_seed=4, device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(want[k], np.float32))


def _final_arrays(ckpt, steps):
    step = ck.latest_step(ckpt)
    assert step == steps
    with np.load(os.path.join(ck.step_dir(ckpt, step), "arrays.npz")) as f:
        return {k: f[k] for k in f.files}


def test_cli_zoo_train_subprocess(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --zoo-train
    --smoke`` on token shards with Adam and EF, checkpointing the full
    carry (as ``tests/test_data_tokens.py`` runs the reference's)."""
    tok, _ = token_stream(4, 700, 512, seed=3)
    d = write_token_shards(str(tmp_path / "toks"), list(tok))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--zoo-train", "--smoke", "--steps", "2", "--batch", "2", "--seq",
         "32", "--optimizer", "adam", "--error-feedback", "--data", d,
         "--ckpt-dir", str(tmp_path / "c")],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    rounds = [ln for ln in r.stdout.splitlines() if ln.startswith("round")]
    assert len(rounds) == 2 and "optimizer=adam ef=True" in r.stdout
    assert "data: 4 token shards, 2,800 tokens" in r.stdout
    # master, Adam's m, t and v, the EF residual, t_next
    assert len(_final_arrays(str(tmp_path / "c"), 2)) == 6


def test_cli_zoo_train_resume_and_arms(tmp_path, capsys):
    """--resume continues the zoo-train carry bit for bit, and --arms runs
    the sweep."""
    tok, _ = token_stream(3, 500, 512, seed=1)
    d = write_token_shards(str(tmp_path / "toks"), list(tok))
    base = ["--device", "cpu", "--zoo-train", "--smoke", "--batch", "1",
            "--seq", "16", "--optimizer", "momentum", "--error-feedback",
            "--data", d]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert ttrain.main(base + ["--steps", "2", "--ckpt-dir", a]) == 0
    assert ttrain.main(base + ["--steps", "1", "--ckpt-dir", b]) == 0
    assert ttrain.main(base + ["--steps", "2", "--ckpt-dir", b,
                               "--resume"]) == 0
    assert "resumed zoo-train at round 1" in capsys.readouterr().out
    x, y = _final_arrays(a, 2), _final_arrays(b, 2)
    assert x.keys() == y.keys()
    assert all(np.array_equal(x[k], y[k]) for k in x)
    assert ttrain.main(["--device", "cpu", "--zoo-train", "--smoke",
                        "--batch", "1", "--seq", "16", "--steps", "1",
                        "--arms", "2"]) == 0
    out = capsys.readouterr().out
    assert sum(ln.startswith("arm ") for ln in out.splitlines()) == 2
    assert "2 arms x 1 rounds" in out


def test_shard_aligned_train_step():
    """``TrainConfig(cs_shard_aligned=True)`` builds: on a 1 x 1 mesh the
    step equals the unaligned one bit for bit; on a 1 x 2 mesh the specs
    put the model dim of some leaves first."""
    jc = jcfg.scaled(jcfg.get_smoke_config("gemma2-2b"), dtype="float32")
    tc = tcfg.scaled(tcfg.get_smoke_config("gemma2-2b"), dtype="float32")
    jp = jbuild(jc).init(jax.random.PRNGKey(0))
    tm = tbuild(tc)
    tp = lm_params_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    tok, tgt = token_stream(2, 32, tc.vocab_size, seed=0)
    batch = {"tokens": torch.from_numpy(tok),
             "targets": torch.from_numpy(tgt)}
    cs = dict(cs_chunk=1024, cs_measure=256, cs_topk=64, biht_iters=10,
              learning_rate=3e-2, aggregation="obcsaa")
    outs = []
    for aligned in (False, True):
        step = tsteps.make_train_step(
            tm, tcfg.TrainConfig(cs_shard_aligned=aligned, **cs),
            tmesh.make_zoo_mesh(1, 1))
        ctx = tsteps.default_round_ctx(seed=0, device="cpu")
        p, _, _ = step(tree.tree_map(torch.clone, tp), (), batch, ctx)
        outs.append(tree.leaves(p))
    assert all(torch.equal(x, y) for x, y in zip(*outs))
    from repro_torch.dist.sharding import infer_param_specs
    specs = infer_param_specs(tm.init(0, device="meta"),
                              tmesh.make_zoo_mesh(1, 2))
    perms = [tsteps._shard_aligned_perm(x.shape, s) for x, s in
             zip(tree.leaves(tm.init(0, device="meta")), specs)]
    assert any(p is not None and p[0] != 0 for p in perms)
