"""The port's checkpoints (``repro_torch.checkpoint``) and the sweep's
resume (``run_sweep(ckpt_dir=..., resume=True)``), on the CPU, against
``repro.checkpoint``.

Exact throughout: the on-disk format is the reference's, so a checkpoint
the port writes restores in the reference and the other way round, leaf
for leaf bit for bit; the port's meta bytes are ``msgpack.packb(meta)``'s
(its own encoder, since the card's machine has no ``msgpack``); the error
messages carry the reference's words; a resumed sweep equals the
uninterrupted one bit for bit (parameters, optimizer state, fade,
previous β, decoder warm start, EF residuals, generator state, stats).
"""
import ast
import os
import shutil
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro_torch import checkpoint as ck
from repro_torch import tree
from repro_torch.checkpoint import msgpack_meta
from repro_torch.core.obcsaa import OBCSAAConfig
from repro_torch.engine import EngineRun, FLConfig, make_arms, run_sweep
from repro_torch.engine.state import with_generator_state
from repro_torch.optim import make

ROOT = os.path.join(os.path.dirname(__file__), "..")


class Moments(NamedTuple):
    m: object
    v: object
    t: object


# --- io primitives ---------------------------------------------------------------

def _tree():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones((4,), dtype=torch.bfloat16) * 1.5,
            "n": (torch.tensor(7, dtype=torch.int32),
                  {"deep": torch.zeros((2, 2), dtype=torch.float64)}),
            "z": torch.tensor([1 + 2j, -3j], dtype=torch.complex64),
            "g": torch.Generator().manual_seed(3).get_state(),
            "none": None}


def _meta_like(t):
    return tree.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                               device="meta"), t)


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    t = _tree()
    path = ck.save(d, 3, t)
    assert path.endswith("step_00000003") and os.path.isdir(path)
    assert ck.latest_step(d) == 3
    for like in (t, _meta_like(t)):
        out = ck.restore(d, 3, like)
        assert out["none"] is None and isinstance(out["n"], tuple)
        for a, b in zip(tree.leaves(t), tree.leaves(out)):
            assert a.dtype == b.dtype and b.device.type == "cpu"
            assert torch.equal(a, b)
    ck.save(d, 3, t)        # overwriting a step is atomic, in place
    ck.save(d, 10, t)
    assert ck.latest_step(d) == 10
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000010"]
    assert ck.latest_step(str(tmp_path / "nowhere")) is None


def test_restore_validation_errors(tmp_path):
    d = str(tmp_path / "ck")
    ck.save(d, 2, _tree())
    with pytest.raises(FileNotFoundError, match="available steps.*2"):
        ck.restore(d, 5, _tree())
    with pytest.raises(FileNotFoundError, match="none"):
        ck.restore(str(tmp_path / "nowhere"), 0, _tree())
    with pytest.raises(ValueError, match="leaves, template has"):
        ck.restore(d, 2, {"only": torch.zeros(3)})
    bad = _tree()
    bad["w"] = torch.zeros((9, 9))
    with pytest.raises(ValueError, match="geometry"):
        ck.restore(d, 2, bad)


@pytest.mark.parametrize("want,match", [
    (torch.float16, r"has dtype float32, template expects float16.*"
                    r"dtype-strict"),
    (torch.int32, r"expects int32"), (torch.float64, r"expects float64")])
def test_restore_dtype_strict_message(tmp_path, want, match):
    """A float32 leaf restores only into a float32 template; bfloat16 is
    the one aliasing (stored as float32), as in the reference."""
    d = str(tmp_path / "ck")
    ck.save(d, 1, {"m": torch.zeros((3,), dtype=torch.float32)})
    with pytest.raises(ValueError, match=match):
        ck.restore(d, 1, {"m": torch.empty(3, dtype=want, device="meta")})
    out = ck.restore(d, 1, {"m": torch.empty(3, dtype=torch.bfloat16,
                                             device="meta")})
    assert out["m"].dtype == torch.bfloat16


@pytest.mark.parametrize("victim", ["tree.msgpack", "arrays.npz"])
def test_corrupt_checkpoint_errors(tmp_path, victim):
    d = str(tmp_path / "ck")
    ck.save(d, 1, _tree())
    p = os.path.join(ck.step_dir(d, 1), victim)
    blob = open(p, "rb").read()
    with open(p, "wb") as f:       # truncate to a prefix
        f.write(blob[:max(1, len(blob) // 3)])
    with pytest.raises(ValueError) as ei:
        ck.restore(d, 1, _tree())
    msg = str(ei.value)
    assert "corrupt or truncated" in msg and victim in msg
    assert "resume from an earlier step" in msg


# --- the format against the reference ---------------------------------------------

def _cross_trees():
    rng = np.random.default_rng(0)
    params = {"w1": rng.normal(size=(5, 3)).astype(np.float32),
              "b1": rng.normal(size=(3,)).astype(np.float32)}
    mom = Moments(m={k: v * 0.5 for k, v in params.items()},
                  v={k: v ** 2 for k, v in params.items()},
                  t=np.int32(4))
    fade = (rng.normal(size=4) + 1j * rng.normal(size=4)).astype(
        np.complex64)
    return {"params": params, "opt": mom, "fade": fade,
            "steps": np.arange(3, dtype=np.int32),
            "bytes": np.arange(16, dtype=np.uint8)}


def _to_torch(t):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  t)


def _to_jax(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def test_port_checkpoint_restores_in_reference(tmp_path):
    t = _cross_trees()
    d = str(tmp_path / "ck")
    ck.save(d, 7, _to_torch(t))
    assert jck.latest_step(d) == 7
    out = jck.restore(d, 7, _to_jax(t))
    for a, b in zip(jax.tree_util.tree_leaves(t),
                    jax.tree_util.tree_leaves(out)):
        assert np.asarray(b).dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(np.asarray(b), a)


def test_reference_checkpoint_restores_in_port(tmp_path):
    t = _cross_trees()
    d = str(tmp_path / "ck")
    jck.save(d, 2, _to_jax(t))
    assert ck.latest_step(d) == 2
    out = ck.restore(d, 2, _meta_like(_to_torch(t)))
    assert isinstance(out["opt"], Moments)
    for a, b in zip(jax.tree_util.tree_leaves(t), tree.leaves(out)):
        assert b.numpy().dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b.numpy(), a)


def test_meta_bytes_and_leaf_order_match_reference(tmp_path):
    t = _cross_trees()
    dp, dj = str(tmp_path / "port"), str(tmp_path / "ref")
    ck.save(dp, 1, _to_torch(t))
    jck.save(dj, 1, _to_jax(t))
    got = open(os.path.join(ck.step_dir(dp, 1), "tree.msgpack"), "rb").read()
    want = open(os.path.join(ck.step_dir(dj, 1), "tree.msgpack"),
                "rb").read()
    assert got == want
    assert got == msgpack.packb(msgpack.unpackb(got))
    keys = [p for p, _ in tree.flatten_with_paths(_to_torch(t))[0]]
    assert keys == [jax.tree_util.keystr(p) for p, _ in
                    jax.tree_util.tree_flatten_with_path(t)[0]]


@pytest.mark.parametrize("obj", [
    {}, {"step": 0}, {"step": 127}, {"step": 128}, {"step": 255},
    {"step": 256}, {"step": 65535}, {"step": 65536}, {"step": 2 ** 32 - 1},
    {"keys": ["a" * n for n in (0, 1, 31, 32, 255, 256, 65535)]},
    {"shapes": [[]] + [[i, i + 300] for i in range(20)]},
    {f"k{i}": i for i in range(20)},
    {"keys": ["['w']", ".state.params['ω']"], "dtypes": ["float32"] * 65535,
     "shapes": [[3, 4]], "step": 12}])
def test_meta_encoder_matches_msgpack(obj):
    b = msgpack_meta.packb(obj)
    assert b == msgpack.packb(obj)
    assert msgpack_meta.unpackb(b) == msgpack.unpackb(b) == obj


@pytest.mark.parametrize("obj", [{"keys": ["a" * 65536]},
                                 {"dtypes": [1] * 65536}, {"step": 2 ** 32},
                                 {"step": -1}, {"step": 1.5},
                                 {"step": None}, {"step": True}])
def test_meta_encoder_rejects_what_is_outside_its_subset(obj):
    with pytest.raises(ValueError, match="msgpack_meta"):
        msgpack_meta.packb(obj)


@pytest.mark.parametrize("blob", [b"", b"\x81", b"\x91\xcc", b"\xc0",
                                  b"\x93\x01\x02", b"\xa3ab", b"\x01\x02",
                                  b"\xcb" + bytes(8)])
def test_meta_decoder_rejects_what_it_cannot_read(blob):
    with pytest.raises(ValueError, match="msgpack_meta"):
        msgpack_meta.unpackb(blob)


def test_checkpoints_work_without_msgpack(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError):
        import msgpack as _  # noqa: F401
    d = str(tmp_path / "ck")
    ck.save(d, 1, _tree())
    for a, b in zip(tree.leaves(_tree()), tree.leaves(ck.restore(d, 1,
                                                                 _tree()))):
        assert torch.equal(a, b)


def test_port_never_imports_msgpack():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src",
                                                  "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(open(f).read(), f)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [(f, n) for n in names if n.split(".")[0] == "msgpack"]
    assert not bad, bad


# --- the sweep's resume -------------------------------------------------------------

def _sweep(ckpt_dir=None, *, resume=None, seeds=(0, 1), rounds=8, every=3,
           opt="adam", scheduler="greedy_batched"):
    """tests/test_checkpoint.py's engine fixture on the port, with Adam
    and the greedy scheduler: EF + warm-start IHT, 8 rounds in chunks cut
    at rounds 0, 3, 6 and 7."""
    U, D = 4, 1200
    cfg = FLConfig(aggregator="obcsaa", scheduler=scheduler, rounds=rounds,
                   eval_every=every, error_feedback=True,
                   obcsaa=OBCSAAConfig(chunk=256, measure=64, topk=16,
                                       biht_iters=3, warm_start=True,
                                       recon_alg="iht", recon_tau=0.25))
    params0 = {"w": torch.linspace(-1.0, 1.0, D)}
    data = {"c": torch.randn((U, D), generator=torch.Generator()
                             .manual_seed(3))}

    def loss(p, d):
        return 0.5 * torch.sum((p["w"] - d["c"]) ** 2, dim=-1)

    def ev(p):
        return torch.sum(p["w"] ** 2), torch.tensor(0.0)

    return run_sweep(cfg, loss, params0, data, np.ones(U), eval_fn=ev,
                     optimizer=make(opt), seeds=list(seeds), device="cpu",
                     ckpt_dir=ckpt_dir, resume=resume)


def _trim(ckpt_dir, keep_to):
    for sub in os.listdir(ckpt_dir):
        if int(sub.split("_")[1]) > keep_to:
            shutil.rmtree(os.path.join(ckpt_dir, sub))


def _assert_carry_equal(a, b):
    fa, fb = (tree.leaves(with_generator_state(s)) for s in (a, b))
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("opt", ["adam", "momentum", "sgd"])
def test_engine_resume_bitwise(tmp_path, opt):
    d = str(tmp_path / "ck")
    full = _sweep(d, opt=opt)
    assert sorted(os.listdir(d)) == [f"step_{s:08d}" for s in (1, 4, 7, 8)]
    _trim(d, 4)
    res = _sweep(d, resume=True, opt=opt)
    assert res["t_start"] == 4 and full["t_start"] == 0
    for a in range(2):
        _assert_carry_equal(res["state"][a], full["state"][a])
    for k in ("n_scheduled", "b_t", "rt_bound", "loss"):
        np.testing.assert_array_equal(res[k], full[k][:, -res[k].shape[1]:])
    assert res["n_scheduled"].shape == (2, 4)
    np.testing.assert_array_equal(res["eval_rounds"], [6, 7])
    st = full["state"][0]
    assert st.residual.abs().sum() > 0 and st.decode_x0.abs().sum() > 0
    # resuming a finished sweep runs nothing and returns its carry
    done = _sweep(str(tmp_path / "ck2"), opt=opt)
    again = _sweep(str(tmp_path / "ck2"), resume=True, opt=opt)
    assert again["t_start"] == 8 and again["n_scheduled"].shape == (2, 0)
    _assert_carry_equal(again["state"][1], done["state"][1])


def test_engine_resume_rejects_different_arms(tmp_path):
    d = str(tmp_path / "ck")
    _sweep(d, rounds=4)
    with pytest.raises(ValueError, match="different arms"):
        _sweep(d, resume=True, rounds=4, seeds=(0, 2))


def test_engine_resume_requires_ckpt_dir():
    with pytest.raises(ValueError, match="ckpt_dir"):
        _sweep(None, resume=True, rounds=2)


def test_engine_resume_rejects_off_cadence_step(tmp_path):
    d = str(tmp_path / "ck")
    _sweep(d, rounds=8, every=3)
    _trim(d, 4)
    with pytest.raises(ValueError, match="chunk boundary"):
        _sweep(d, resume=True, rounds=8, every=2)


def test_sweep_template_matches_saved_tree(tmp_path):
    """The restore template allocates nothing (``meta`` tensors) and has
    the saved tree's key paths, shapes and dtypes."""
    d = str(tmp_path / "ck")
    _sweep(d, rounds=2, every=1)
    cfg = FLConfig(aggregator="obcsaa", error_feedback=True,
                   obcsaa=OBCSAAConfig(chunk=256, measure=64, topk=16,
                                       warm_start=True, recon_alg="iht"))
    run = EngineRun(cfg, lambda p, x: p["w"].sum(-1), {"w": torch.zeros(
        1200)}, {"c": torch.zeros(4, 1200)}, np.ones(4),
        optimizer=make("adam"), device="cpu")
    tmpl = run.sweep_template(make_arms(cfg, seeds=[0, 1]))
    flat, _ = tree.flatten_with_paths(tmpl)
    import msgpack as mp
    meta = mp.unpackb(open(os.path.join(ck.step_dir(d, 2), "tree.msgpack"),
                           "rb").read())
    assert [p for p, _ in flat] == meta["keys"]
    assert [list(x.shape) for _, x in flat] == meta["shapes"]
    assert all(x.device.type in ("meta", "cpu") for _, x in flat)
    assert ".state.generator" in meta["keys"]
