"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060]; port of
``repro/models/ssm.py``.

Training and prefill run the chunked SSD algorithm: an attention-like
quadratic term inside each chunk plus a state recurrence across chunks (a
loop over the chunks, where the reference scans). Decode is the O(1)
recurrent update.

Dtypes follow the reference's promotion step by step, since ``torch.einsum``
does not promote: the projections, the conv and C·Bᵀ run in x's dtype; dt,
the decays and everything after C·Bᵀ is scaled by them are f32; the result
is cast back to x's dtype. The SSM state is f32 in ``mamba2_forward`` and
``mamba2_decode`` alike.

Tensor-parallel serving (``models/tensor_parallel.py``) passes the model
``group`` and this rank's share of the weights: its heads (``A_log``,
``D``, ``dt_bias``, the ``gate_norm`` and ``out_proj`` rows of their
channels) and, in ``in_proj`` and the conv, its own channels [z | x | B |
C | dt] and [x | B | C], taken by head and by group of B/C (the heads
of a group stay on one rank). The dims are read off the weights; the
gated norm's mean square over d_inner is summed over the group and the
output after ``out_proj`` too. The conv state then holds this rank's
channels and the SSM state its heads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.dist import collectives as coll
from repro_torch.models.layers import he_init, rmsnorm


def ssm_dims(d_model: int, s: SSMConfig):
    d_inner = s.expand * d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim


def init_mamba2(generator, d_model: int, s: SSMConfig, lead=(), device=None,
                dtype=torch.float32):
    """The reference's Mamba2 leaves; ``lead`` prepends stacked axes (the
    layer axis L). Fan-ins are those of one layer."""
    lead = tuple(lead)
    d_inner, n_heads, conv_dim = ssm_dims(d_model, s)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads

    def const(values):
        return values.to(device=device, dtype=dtype).expand(
            lead + values.shape).contiguous()

    # dt_bias = softplus⁻¹(dt), dt log-uniform in [1e-3, 1e-1]
    u = torch.rand(lead + (n_heads,), generator=generator, device=device)
    log_dt = u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3)
    return {
        "in_proj": he_init(generator, lead + (d_model, d_in_proj),
                           fan_in=d_model, device=device, dtype=dtype),
        "conv_w": torch.randn(lead + (s.conv_width, conv_dim),
                              generator=generator, device=device
                              ).mul_(1.0 / math.sqrt(s.conv_width)).to(dtype),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=device),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, n_heads))),
        "D": torch.ones(lead + (n_heads,), dtype=dtype, device=device),
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))).to(dtype),
        "gate_norm": torch.zeros(lead + (d_inner,), dtype=dtype,
                                 device=device),
        "out_proj": he_init(generator, lead + (d_inner, d_model),
                            fan_in=d_inner, device=device, dtype=dtype),
    }


def _split_proj(zxbcdt, d_inner, n_groups, d_state, n_heads):
    """(z, x, B, C, dt) along the last axis."""
    gs = n_groups * d_state
    return torch.split(zxbcdt, [d_inner, d_inner, gs, gs, n_heads], dim=-1)


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv of width W over xbc (B, S, conv_dim).

    ``conv_state`` (B, W − 1, conv_dim) is the history for decode and
    chunked prefill, cast to xbc's dtype. Returns (silu(conv + b), the
    last W − 1 rows as the new state)."""
    W = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], W - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xpad = torch.cat([pad, xbc], dim=1)
    S = xbc.shape[1]
    out = sum(xpad[:, i:i + S] * conv_w[i] for i in range(W))
    new_state = xpad[:, -(W - 1):] if W > 1 else pad
    return F.silu(out + conv_b), new_state


def _segsum(x):
    """x: (..., T) -> (..., T, T): out[i, j] = Σ_{j<k≤i} x_k below the
    diagonal (a difference of cumsums), −inf above it."""
    T = x.shape[-1]
    xc = torch.cumsum(x, dim=-1)
    d = xc[..., :, None] - xc[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """The SSD scan (Mamba2 algorithm 1, in einsum form).

    x: (b, s, h, p); dt: (b, s, h) f32; A: (h,) (A_log: dA = dt·(−exp A));
    B, C: (b, s, g, n). Returns (y (b, s, h, p) in x's dtype, the final
    state (b, h, p, n) f32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = s // chunk
    rep = h // g
    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bh = torch.repeat_interleave(B.reshape(b, nc, chunk, g, n), rep, dim=3)
    Ch = torch.repeat_interleave(C.reshape(b, nc, chunk, g, n), rep, dim=3)
    dA = dtc * (-torch.exp(A.to(f32)))                    # (b,nc,l,h) < 0
    dA_cs = torch.cumsum(dA, dim=2)                       # within a chunk
    # intra-chunk (the diagonal blocks)
    L = torch.exp(_segsum(dA.transpose(2, 3)))            # (b,nc,h,l,l)
    scores = torch.einsum("bclhn,bcshn->bchls", Ch, Bh)   # x's dtype
    scores = scores.to(f32) * L
    xdt = xc.to(f32) * dtc[..., None]                     # (b,nc,l,h,p)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xdt)
    # each chunk's end state
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (b,nc,l,h)
    states = torch.einsum("bclhn,bclhp->bchpn", Bh.to(f32),
                          xdt * decay_states[..., None])  # (b,nc,h,p,n)
    # the recurrence across chunks: the state before each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])           # (b,nc,h)
    carry = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # (b,nc,h,p,n)
    # the inter-chunk contribution
    state_decay = torch.exp(dA_cs)                        # (b,nc,l,h)
    y_off = torch.einsum("bclhn,bchpn->bclhp", Ch.to(f32), prev_states) \
        * state_decay[..., None]
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), carry


def _local_dims(p, s: SSMConfig):
    """(d_inner, heads, groups) of the given weights: the whole model's,
    or one tensor-parallel rank's share."""
    n_heads = p["A_log"].shape[-1]
    d_inner = p["out_proj"].shape[-2]
    groups = (p["conv_b"].shape[-1] - d_inner) // (2 * s.d_state)
    return d_inner, n_heads, groups


def mamba2_forward(p, x, s: SSMConfig, *, init_conv=None, init_ssm=None,
                   eps=1e-6, group=None):
    """x: (B, S, d). Returns (out, (conv_state, ssm_state)); ``init_conv``
    and ``init_ssm`` continue from a cache. The chunk is
    ``min(chunk_size, S)``, halved until it divides S. ``group``: tensor
    parallel (module docstring)."""
    d_inner, n_heads, n_groups = _local_dims(p, s)
    gs = n_groups * s.d_state
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xs, B, C, dt = _split_proj(zxbcdt, d_inner, n_groups, s.d_state,
                                  n_heads)
    xbc = torch.cat([xs, B, C], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"].to(x.dtype),
                                   p["conv_b"].to(x.dtype), init_conv)
    xs, B, C = torch.split(xbc, [d_inner, gs, gs], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    bsz, S = x.shape[0], x.shape[1]
    xh = xs.reshape(bsz, S, n_heads, s.head_dim)
    Bg = B.reshape(bsz, S, n_groups, s.d_state)
    Cg = C.reshape(bsz, S, n_groups, s.d_state)
    chunk = min(s.chunk_size, S)
    while S % chunk:
        chunk //= 2
    y, ssm_state = ssd_chunked(xh, dt, p["A_log"].to(torch.float32), Bg, Cg,
                               chunk, init_state=init_ssm)
    y = y + xh * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, S, d_inner)
    y = rmsnorm(y * F.silu(z), p["gate_norm"], eps, group)
    return (coll.psum_(y @ p["out_proj"].to(x.dtype), group),
            (conv_state, ssm_state))


def mamba2_decode(p, x, s: SSMConfig, *, conv_state, ssm_state, eps=1e-6,
                  group=None):
    """One token's recurrent step. x: (B, 1, d); conv_state: (B, W − 1,
    conv_dim); ssm_state: (B, h, p, n) f32. Returns (out, (conv_state,
    ssm_state)), new tensors. ``group``: tensor parallel (module
    docstring)."""
    d_inner, n_heads, n_groups = _local_dims(p, s)
    gs = n_groups * s.d_state
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xs, B, C, dt = _split_proj(zxbcdt, d_inner, n_groups, s.d_state,
                                  n_heads)
    xbc = torch.cat([xs, B, C], dim=-1)                   # (B,1,conv_dim)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"].to(x.dtype),
                                   p["conv_b"].to(x.dtype), conv_state)
    xs, B, C = torch.split(xbc, [d_inner, gs, gs], dim=-1)
    f32 = torch.float32
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))[:, 0]     # (B,h)
    A = -torch.exp(p["A_log"].to(f32))                    # (h,)
    rep = n_heads // n_groups
    xh = xs[:, 0].reshape(-1, n_heads, s.head_dim).to(f32)
    Bh = torch.repeat_interleave(
        B[:, 0].reshape(-1, n_groups, s.d_state).to(f32), rep, dim=1)
    Ch = torch.repeat_interleave(
        C[:, 0].reshape(-1, n_groups, s.d_state).to(f32), rep, dim=1)
    decay = torch.exp(dt * A[None])                       # (B,h)
    ssm_state = (ssm_state * decay[..., None, None]
                 + (dt[..., None] * xh)[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", ssm_state, Ch)
    y = y + xh * p["D"].to(f32)[None, :, None]
    y = y.reshape(x.shape[0], 1, d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["gate_norm"], eps, group)
    return (coll.psum_(y @ p["out_proj"].to(x.dtype), group),
            (conv_state, ssm_state))
