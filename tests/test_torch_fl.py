"""The port's task, trainer and slice against ``repro``, plus the port's
own rules: it imports neither JAX nor the JAX package, and it never runs
on the CPU unless asked to.

Tolerances:
- exact: parameter round trip through NumPy, flatten order, the synthetic
  data arrays and worker partitions (copies of the same NumPy code).
- MLP loss: rtol 1e-6; flattened per-worker gradients: rtol 1e-5,
  atol 1e-7 (f32 matmuls and means summed in another order).
- slice trajectory, 3 rounds with the reference's Φ, fades and AWGN
  injected: each parameter's distance to the reference, relative to how
  far the reference moved, ≤ 1e-4. Sums in another order move the
  parameters by ~1e-6 of that; a borderline sign flip would show as a
  larger drift, and a fault far larger. β equal every round (with the
  greedy scheduler too); h and b_t within rtol 1e-6, since |g| of the
  complex fade is computed by two libraries and may differ in its last
  bit, and b_t is the h of a scheduled worker.
"""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jchan
from repro.core import sparsify as jsp
from repro.core.obcsaa import OBCSAAConfig as JOB
from repro.data import synthetic as jsyn
from repro.data.mnist import partition_workers as jpartition
from repro.fl import FederatedTrainer as JTrainer
from repro.fl import FLConfig as JFL
from repro.sched import SchedConfig as JSC
from repro.fl.worker import stacked_local_gradients as jgrads
from repro.models import mlp_mnist as jm
from repro_torch import convert
from repro_torch.core import channel as tchan
from repro_torch.core.obcsaa import OBCSAAConfig as TOB
from repro_torch.core.sparsify import flatten_pytree
from repro_torch.data import synthetic as tsyn
from repro_torch.data.mnist import partition_workers as tpartition
from repro_torch.engine import FLConfig as TFL
from repro_torch.fl import FederatedTrainer as TTrainer
from repro_torch.fl.worker import local_gradient
from repro_torch.fl.worker import stacked_local_gradients as tgrads
from repro_torch.models import mlp_mnist as tm
from repro_torch.sched import SchedConfig as TSC

ROOT = os.path.join(os.path.dirname(__file__), "..")
U, SAMPLES, HIDDEN = 4, 100, 8          # D = 784*8 + 8 + 8*10 + 10 = 6370


def _np_params(p):
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def task():
    xtr, ytr, xte, yte = jsyn.synthetic_mnist(n_train=1000, n_test=200,
                                              seed=0)
    wx, wy = jpartition(xtr, ytr, U, SAMPLES, seed=0)
    p0 = _np_params(jm.init_mlp_mnist(jax.random.PRNGKey(0),
                                      d_hidden=HIDDEN))
    return dict(wx=wx, wy=wy, xte=xte, yte=yte, p0=p0)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src",
                                                  "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 20
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, bad


def test_default_device_needs_cuda(monkeypatch, task):
    """``device=None`` means CUDA; without a card that raises, never a
    silent run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = convert.params_from_reference(task["p0"], device="cpu")
    data = {"x": torch.from_numpy(task["wx"]),
            "y": torch.from_numpy(task["wy"])}
    with pytest.raises(RuntimeError, match="CUDA"):
        TTrainer(TFL(obcsaa=TOB(chunk=1024, measure=256, topk=32)),
                 lambda p, d: tm.mlp_mnist_loss(p, d["x"], d["y"]), params,
                 data, np.full(U, float(SAMPLES)))
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_mlp_mnist()
    with pytest.raises(RuntimeError, match="CUDA"):
        TOB().phi()
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_reference(task["p0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tchan.draw_noise(None, (2, 3), 1e-4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tchan.draw_fades(None, (3,))
    gen = torch.Generator().manual_seed(0)     # a CPU generator draws there
    assert tchan.draw_noise(gen, (2, 3), 1e-4).device.type == "cpu"
    assert tchan.draw_fades(gen, (3,))[0].device.type == "cpu"


def test_params_round_trip_exact(task):
    params = convert.params_from_reference(task["p0"], device="cpu")
    assert params["w1"].shape == (784, HIDDEN)   # JAX's x @ w1 layout
    back = convert.params_to_numpy(params)
    assert sorted(back) == sorted(task["p0"])
    for k, v in task["p0"].items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


def test_flatten_order_is_jax_pytree_order(task):
    params = convert.params_from_reference(task["p0"], device="cpu")
    flat, unflatten = flatten_pytree(params)
    want, _ = jsp.flatten_pytree({k: jnp.asarray(v)
                                  for k, v in task["p0"].items()})
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = unflatten(flat)
    assert list(back) == ["b1", "b2", "w1", "w2"]
    for k in back:
        assert torch.equal(back[k], params[k])


def test_loss_and_gradients_match(task):
    params = convert.params_from_reference(task["p0"], device="cpu")
    jp = {k: jnp.asarray(v) for k, v in task["p0"].items()}
    x, y = task["wx"][0], task["wy"][0]
    np.testing.assert_allclose(
        float(tm.mlp_mnist_loss(params, torch.from_numpy(x),
                                torch.from_numpy(y))),
        float(jm.mlp_mnist_loss(jp, jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-6)
    assert tm.param_dim(params) == jm.param_dim(jp) == 6370
    data_t = {"x": torch.from_numpy(task["wx"]),
              "y": torch.from_numpy(task["wy"])}
    got = tgrads(lambda p, d: tm.mlp_mnist_loss(p, d["x"], d["y"]), params,
                 data_t).numpy()
    want = np.asarray(jgrads(
        lambda p, d: jm.mlp_mnist_loss(p, d["x"], d["y"]), jp,
        {"x": jnp.asarray(task["wx"]), "y": jnp.asarray(task["wy"])}))
    assert got.shape == want.shape == (U, 6370)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    one = flatten_pytree(local_gradient(
        lambda p, d: tm.mlp_mnist_loss(p, d["x"], d["y"]), params,
        {"x": data_t["x"][1], "y": data_t["y"][1]}))[0].numpy()
    np.testing.assert_allclose(one, want[1], rtol=1e-5, atol=1e-7)


def test_data_copies_exact():
    want = jsyn.synthetic_mnist(n_train=300, n_test=50, seed=3)
    got = tsyn.synthetic_mnist(n_train=300, n_test=50, seed=3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for iid in (True, False):
        for g, w in zip(tpartition(want[0], want[1], 3, 20, iid=iid, seed=1),
                        jpartition(want[0], want[1], 3, 20, iid=iid,
                                   seed=1)):
            np.testing.assert_array_equal(g, w)


def _trainers(task, aggregator, rounds, scheduler="all", packed=False):
    kw = dict(chunk=1024, measure=256, topk=32, biht_iters=5,
              use_kernels=True, packed=packed)
    sched = dict(scheduler=scheduler)
    if scheduler == "greedy_batched":
        sched["sched_cfg"] = JSC(use_kernel=True, interpret=True)
    job = JOB(**kw)
    jt = JTrainer(JFL(aggregator=aggregator, learning_rate=0.1,
                      rounds=rounds, obcsaa=job, mode="host", **sched),
                  lambda p, d: jm.mlp_mnist_loss(p, d["x"], d["y"]),
                  {k: jnp.asarray(v) for k, v in task["p0"].items()},
                  {"x": jnp.asarray(task["wx"]),
                   "y": jnp.asarray(task["wy"])},
                  np.full(U, float(SAMPLES)))
    phi, = convert.arrays_from_reference(np.asarray(job.phi()), device="cpu")
    if scheduler == "greedy_batched":
        sched["sched_cfg"] = TSC(use_kernel=True)
    tt = TTrainer(TFL(aggregator=aggregator, learning_rate=0.1,
                      rounds=rounds, obcsaa=TOB(**kw), **sched),
                  lambda p, d: tm.mlp_mnist_loss(p, d["x"], d["y"]),
                  convert.params_from_reference(task["p0"], device="cpu"),
                  {"x": torch.from_numpy(task["wx"]),
                   "y": torch.from_numpy(task["wy"])},
                  np.full(U, float(SAMPLES)), phi=phi, device="cpu")
    return jt, tt


@pytest.mark.parametrize("aggregator,scheduler,packed", [
    pytest.param("obcsaa", "all", False, id="obcsaa"),
    pytest.param("perfect", "all", False, id="perfect"),
    pytest.param("obcsaa", "greedy_batched", True,
                 id="obcsaa-greedy_batched-packed")])
def test_slice_trajectory(task, aggregator, scheduler, packed):
    """Three rounds of the §V round at small width (U=4, D=6370, chunk
    1024, S=256, κ=32, 5 BIHT iterations, kernels on): the reference's
    per-round draws — fold_in(key, t) → 0 for the fade, → 1 for the AWGN
    (engine/core.py) — are replayed into the port. The greedy case runs
    the prefix sweep through the kernel's route in both packages (interpret
    mode in JAX) and the packed sign codec; β is equal every round."""
    rounds = 3
    jt, tt = _trainers(task, aggregator, rounds, scheduler, packed)
    key = jax.random.PRNGKey(0)
    n_chunks = -(-6370 // 1024)
    for t in range(rounds):
        k_t = jax.random.fold_in(key, t)
        w = np.asarray(jchan.draw_cn(jax.random.fold_in(k_t, 0), (U,)))
        z = np.asarray(jchan.draw_noise(jax.random.fold_in(k_t, 1),
                                        (n_chunks, 256), 1e-4))
        jinfo = jt.run_round(t)
        fade_w, noise = convert.arrays_from_reference(w, z, device="cpu")
        tinfo = tt.run_round(t, fade_w=fade_w, noise=noise)
        np.testing.assert_allclose(tinfo["h"].numpy(), jinfo["h"],
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tinfo["b_t"]), jinfo["b_t"],
                                   rtol=1e-6)
        np.testing.assert_array_equal(tinfo["beta"].numpy(), jinfo["beta"])
    assert ([s.n_scheduled for s in tt.sched_logs]
            == [s.n_scheduled for s in jt.sched_logs])
    if scheduler == "all":
        assert [s.n_scheduled for s in tt.sched_logs] == [U] * rounds
    jp = _np_params(jt.params)
    tp = convert.params_to_numpy(tt.params)
    for k in sorted(jp):
        moved = np.linalg.norm(jp[k] - task["p0"][k])
        assert moved > 0
        assert np.linalg.norm(tp[k] - jp[k]) <= 1e-4 * moved, k


def test_trainer_eval_cadence(task):
    xe = torch.from_numpy(task["xte"])
    ye = torch.from_numpy(task["yte"])
    _, tt = _trainers(task, "perfect", 5)
    tt.cfg.eval_every = 2
    tt.eval_fn = lambda p: (tm.mlp_mnist_loss(p, xe, ye),
                            tm.mlp_mnist_accuracy(p, xe, ye))
    logs = tt.run(5)
    assert [l.round for l in logs] == [0, 2, 4]
    assert logs[-1].loss < logs[0].loss
    assert all(0.0 <= l.accuracy <= 1.0 for l in logs)
