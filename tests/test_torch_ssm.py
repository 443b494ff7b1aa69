"""The port's Mamba2 / SSD block (``repro_torch.models.ssm``) against
``repro.models.ssm`` on the same NumPy inputs; the reference's weights
come in through ``repro_torch.convert``.

Tolerances (each against the max |value| of the reference's output):
- ``_segsum``: rtol 1e-6 below the diagonal, −inf above it exactly; its
  gradient through the masked ``exp`` is finite and within 1e-5.
- f32: 1e-5 (the four-operand einsums contract in another order: up to
  5.8e-6 seen, on ``ssd_chunked``'s y).
- bf16: 3e-2 (one bf16 rounding of C·Bᵀ or of the conv output is 4e-3
  relative and moves later roundings: up to 9.5e-3 seen on an output),
  the f32 SSM state included, which is built from the bf16 conv outputs
  (8.9e-3 seen). The conv state is the input's own rows: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import ssm as jssm
from repro_torch import configs as tcfg
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import ssm as tssm

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _rng(seed):
    return np.random.default_rng(seed)


def _in(a, dtype):
    """The same values in both packages: NumPy f32 rounded to ``dtype``."""
    jd, td = DTYPES[dtype]
    t = torch.from_numpy(np.asarray(a, np.float32)).to(td)
    return jnp.asarray(t.float().numpy()).astype(jd), t


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(dtype, with_state):
    rng = _rng(1)
    jx, tx = _in(rng.standard_normal((2, 7, 24)), dtype)
    jw, tw = _in(rng.standard_normal((4, 24)) * 0.5, dtype)
    jb, tb = _in(rng.standard_normal((24,)) * 0.1, dtype)
    js = ts = None
    if with_state:
        js, ts = _in(rng.standard_normal((2, 3, 24)), "float32")
    jout, jst = jssm._causal_conv(jx, jw, jb, js)
    tout, tst = tssm._causal_conv(tx, tw, tb, ts)
    _close(tout, jout, TOL[dtype], "out")
    assert tout.dtype == tx.dtype and tst.dtype == tx.dtype
    np.testing.assert_array_equal(tst.float().numpy(),
                                  np.asarray(jst.astype(jnp.float32)))


def test_segsum_and_its_gradient():
    x = _rng(2).standard_normal((3, 2, 16)).astype(np.float32)
    want = np.asarray(jssm._segsum(x))
    got = tssm._segsum(torch.from_numpy(x)).numpy()
    below = np.tril(np.ones((16, 16), bool))
    assert np.isneginf(got[..., ~below]).all()
    np.testing.assert_allclose(got[..., below], want[..., below], rtol=1e-6,
                               atol=1e-6)
    w = _rng(3).standard_normal((3, 2, 16, 16)).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(jnp.exp(jssm._segsum(v)) * w))(x)
    t = torch.from_numpy(x).requires_grad_()
    torch.sum(torch.exp(tssm._segsum(t)) * torch.from_numpy(w)).backward()
    assert torch.isfinite(t.grad).all()
    _close(t.grad, jg, 1e-5, "grad")


def _ssd_inputs(seed, b=2, s=64, h=8, p=16, g=2, n=8):
    rng = _rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2.0))
    A = np.log(np.linspace(1.0, 16.0, h))
    B = rng.standard_normal((b, s, g, n))
    C = rng.standard_normal((b, s, g, n))
    st = rng.standard_normal((b, h, p, n)) * 0.5
    return [np.asarray(a, np.float32) for a in (x, dt, A, B, C, st)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunk,with_state", [(16, False), (16, True),
                                              (64, True), (8, False)])
def test_ssd_chunked(dtype, chunk, with_state):
    """One chunk, and 4 and 8 chunks (the recurrence across them), from
    zero and from a given state."""
    x, dt, A, B, C, st = _ssd_inputs(chunk)
    jx, tx = _in(x, dtype)
    jB, tB = _in(B, dtype)
    jC, tC = _in(C, dtype)
    init = (st, torch.from_numpy(st)) if with_state else (None, None)
    jy, jfin = jssm.ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                                chunk, init_state=init[0])
    ty, tfin = tssm.ssd_chunked(tx, torch.from_numpy(dt),
                                torch.from_numpy(A), tB, tC, chunk,
                                init_state=init[1])
    assert ty.dtype == tx.dtype and tfin.dtype == torch.float32
    _close(ty, jy, TOL[dtype], "y")
    _close(tfin, jfin, TOL[dtype], "state")


def _block(dtype, seed=0):
    cfg = jcfg.get_smoke_config("mamba2-2.7b")
    jp = jssm.init_mamba2(jax.random.PRNGKey(seed), cfg.d_model, cfg.ssm)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    # nonzero conv bias and gate scale, so both are exercised
    rng = _rng(seed + 10)
    jp["conv_b"] = (rng.standard_normal(jp["conv_b"].shape) * 0.1
                    ).astype(np.float32)
    jp["gate_norm"] = (rng.standard_normal(jp["gate_norm"].shape) * 0.1
                       ).astype(np.float32)
    return cfg, tcfg.get_smoke_config("mamba2-2.7b").ssm, jp, \
        lm_params_from_reference(jp, device="cpu")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,with_state", [(64, False), (48, True),
                                          (96, False)])
def test_mamba2_forward(dtype, S, with_state):
    """S = 64: two chunks of 32; S = 48: min(32, 48) = 32 halved to 16, from
    a cache's conv and ssm state; S = 96: three chunks."""
    cfg, ts, jp, tp = _block(dtype, seed=S)
    rng = _rng(S)
    jx, tx = _in(rng.standard_normal((2, S, cfg.d_model)), dtype)
    kw_j, kw_t = {}, {}
    if with_state:
        _, n_heads, conv_dim = jssm.ssm_dims(cfg.d_model, cfg.ssm)
        jc, tc = _in(rng.standard_normal((2, cfg.ssm.conv_width - 1,
                                          conv_dim)), dtype)
        s0 = (rng.standard_normal((2, n_heads, cfg.ssm.head_dim,
                                   cfg.ssm.d_state)) * 0.5).astype(np.float32)
        kw_j = dict(init_conv=jc, init_ssm=jnp.asarray(s0))
        kw_t = dict(init_conv=tc, init_ssm=torch.from_numpy(s0))
    jout, (jconv, jst) = jssm.mamba2_forward(jp, jx, cfg.ssm, **kw_j)
    tout, (tconv, tst) = tssm.mamba2_forward(tp, tx, ts, **kw_t)
    assert tout.dtype == tx.dtype and tst.dtype == torch.float32
    _close(tout, jout, TOL[dtype], "out")
    _close(tconv, jconv, TOL[dtype], "conv")
    _close(tst, jst, TOL[dtype], "ssm")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba2_decode(dtype):
    """Four recurrent steps from a random conv and ssm state, each step's
    output and both states."""
    cfg, ts, jp, tp = _block(dtype, seed=3)
    rng = _rng(4)
    _, n_heads, conv_dim = jssm.ssm_dims(cfg.d_model, cfg.ssm)
    jc, tc = _in(rng.standard_normal((2, cfg.ssm.conv_width - 1, conv_dim)),
                 dtype)
    s0 = (rng.standard_normal((2, n_heads, cfg.ssm.head_dim,
                               cfg.ssm.d_state)) * 0.5).astype(np.float32)
    js, tst = jnp.asarray(s0), torch.from_numpy(s0)
    for step in range(4):
        jx, tx = _in(rng.standard_normal((2, 1, cfg.d_model)), dtype)
        jout, (jc, js) = jssm.mamba2_decode(jp, jx, cfg.ssm, conv_state=jc,
                                            ssm_state=js)
        tout, (tc, tst) = tssm.mamba2_decode(tp, tx, ts, conv_state=tc,
                                             ssm_state=tst)
        assert tst.dtype == torch.float32
        _close(tout, jout, TOL[dtype], f"out {step}")
        _close(tc, jc, TOL[dtype], f"conv {step}")
        _close(tst, js, TOL[dtype], f"ssm {step}")


def test_decode_steps_equal_forward():
    """Within the port: S single-token steps from a zero state give the
    chunked forward's outputs and final states (f32, 1e-5 of the max)."""
    cfg, ts, _, tp = _block("float32", seed=5)
    x = torch.from_numpy(_rng(6).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    full, (conv, st) = tssm.mamba2_forward(tp, x, ts)
    _, n_heads, conv_dim = tssm.ssm_dims(cfg.d_model, ts)
    c = torch.zeros((2, ts.conv_width - 1, conv_dim))
    s = torch.zeros((2, n_heads, ts.head_dim, ts.d_state))
    outs = []
    for i in range(40):
        o, (c, s) = tssm.mamba2_decode(tp, x[:, i:i + 1], ts, conv_state=c,
                                       ssm_state=s)
        outs.append(o)
    _close(torch.cat(outs, dim=1), full.numpy(), 1e-5, "out")
    _close(c, conv.numpy(), 1e-6, "conv")
    _close(s, st.numpy(), 1e-5, "ssm")


@pytest.mark.parametrize("lead", [(), (3,)])
def test_init_mamba2_leaves(lead):
    """Leaf names, shapes and order equal the reference's; A_log, D and
    the zero leaves equal its values; dt = softplus(dt_bias) lies in
    [1e-3, 1e-1]."""
    cfg = jcfg.get_smoke_config("mamba2-2.7b")
    ts = tcfg.get_smoke_config("mamba2-2.7b").ssm
    want = jssm.init_mamba2(jax.random.PRNGKey(0), cfg.d_model, cfg.ssm)
    got = tssm.init_mamba2(torch.Generator().manual_seed(0), cfg.d_model,
                           ts, lead=lead)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(lead) + want[k].shape, k
    for k in ("A_log", "D", "conv_b", "gate_norm"):
        np.testing.assert_allclose(got[k].reshape((-1,) + want[k].shape)
                                   .numpy()[0], np.asarray(want[k]),
                                   rtol=1e-6)
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
