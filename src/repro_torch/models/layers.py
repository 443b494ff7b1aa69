"""Shared building blocks: norms, inits, RoPE, MLPs, embeddings; port of
``repro/models/layers.py``.

Weights are f32 and every one is cast to the activations' dtype where it
is used, as in the reference; ``rmsnorm`` and the attention scores compute
in f32 whatever that dtype. Weights keep JAX's ``x @ w`` layout (inputs on
the first axis), so a reference parameter dict carries over leaf for leaf.

Tensor-parallel serving (``models/tensor_parallel.py``) passes a model
``group``: ``rmsnorm`` then normalises a row whose columns are split over
it (the sum of squares summed over the group), and ``embed`` looks up in
a table whose vocabulary rows are (a masked lookup, then a sum). ``mlp``
computes with whatever share of ``w1``/``w3`` columns and ``w2`` rows it
is given; its caller sums the partial output. ``unembed`` against a
vocabulary-split table gives this rank's columns of the logits (the
soft-cap is per element).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.dist import collectives as coll


_DRAWN: contextvars.ContextVar = contextvars.ContextVar("drawn",
                                                         default=None)


@contextlib.contextmanager
def weights_drawn_to(keep: Callable[[torch.Tensor], torch.Tensor]):
    """Within: each weight ``he_init`` or ``lecun_init`` draws is handed
    to ``keep`` as soon as it is made, and the init holds what ``keep``
    returns (``init_cut`` keeps a rank's share). The generator runs as it
    does without."""
    token = _DRAWN.set(keep)
    try:
        yield
    finally:
        _DRAWN.reset(token)


def _drawn(w: torch.Tensor) -> torch.Tensor:
    keep = _DRAWN.get()
    return w if keep is None else keep(w)


@functools.lru_cache(maxsize=32)
def _draw_order(cfg) -> Tuple[Optional[tuple], ...]:
    """The key path of each weight ``he_init``/``lecun_init`` draws in
    ``cfg``'s init, in the order it draws them (None for a draw that is
    not a leaf)."""
    from repro_torch.models.registry import build_model
    drawn = []
    with weights_drawn_to(lambda w: drawn.append(w) or w):
        whole = build_model(cfg).init(0, device="meta")
    at = {id(leaf): tuple(k) for k, leaf in tree.flatten_with_keys(whole)}
    return tuple(at.get(id(w)) for w in drawn)


def init_cut(model, seed: int, cut: Callable, device=None):
    """``model.init(seed)`` with each leaf replaced by ``cut(key, w)``, its
    key path and the whole leaf (a rank's share of it, or ``w`` itself):
    a weight the init draws is cut as soon as it is made, and the leaves
    made otherwise are cut after. The generator runs on ``device`` as it
    does for the whole init, so the result is the cut of
    ``model.init(seed)`` bit for bit. A process holds the cut leaves and
    at most one whole weight: on ``device``, or, where ``cut`` makes each
    share on the host (``tensor_parallel.draw_staged``), the host holds
    the shares and ``device`` only the weight being drawn."""
    order, drawn = iter(_draw_order(model.cfg)), set()

    def keep(w):
        k = next(order)
        if k is None:
            return w
        drawn.add(k)
        return cut(k, w)

    with weights_drawn_to(keep):
        params = model.init(seed, device=device)
    flat, treedef = tree.flatten(params)
    keys = [tuple(k) for k, _ in tree.flatten_with_keys(params)]
    return tree.unflatten(treedef, [leaf if k in drawn else cut(k, leaf)
                                    for k, leaf in zip(keys, flat)])


def he_init(generator: Optional[torch.Generator], shape, fan_in=None,
            device=None, dtype=torch.float32) -> torch.Tensor:
    """N(0, 2/fan_in) weights; ``fan_in`` defaults to ``shape[0]`` (the
    JAX ``x @ w`` layout: inputs on the first axis)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = math.sqrt(2.0 / max(1, fan_in))
    # scaled in place: a full-size leaf is never held twice
    return _drawn(torch.randn(shape, generator=generator, device=device
                              ).mul_(std).to(dtype))


def lecun_init(generator: Optional[torch.Generator], shape, fan_in=None,
               device=None, dtype=torch.float32) -> torch.Tensor:
    """N(0, 1/fan_in) weights."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = math.sqrt(1.0 / max(1, fan_in))
    return _drawn(torch.randn(shape, generator=generator, device=device
                              ).mul_(std).to(dtype))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            group=None) -> torch.Tensor:
    """RMS norm in f32 with the scale 1 + w (w starts at 0), cast back.
    With ``group`` the last dim is this rank's block of a row split over
    it, ``scale`` its block of the scale: the mean square is the group's
    sum over the whole row's width."""
    dt = x.dtype
    x = x.to(torch.float32)
    if group is None:
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    else:
        var = coll.psum_(torch.sum(torch.square(x), dim=-1, keepdim=True),
                         group) / (x.shape[-1] * coll.axis_size(group))
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# --- RoPE --------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S). Rotates
    the two halves of the head (not interleaved pairs), in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs   # (..., S, hd/2)
    sin = torch.sin(angles)[..., None, :]               # (..., S, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(num_pos: int, dim: int, device=None
                         ) -> torch.Tensor:
    pos = torch.arange(num_pos, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    emb = torch.zeros((num_pos, dim), dtype=torch.float32, device=device)
    emb[:, 0::2] = torch.sin(pos * div)
    emb[:, 1::2] = torch.cos(pos * div)
    return emb


# --- MLP ---------------------------------------------------------------------

def init_mlp(generator, d_model: int, d_ff: int, gated: bool, lead=(),
             device=None, dtype=torch.float32):
    """``lead`` prepends stacked axes (the layer axis L) to every weight;
    fan-ins are those of one layer."""
    lead = tuple(lead)
    p = {"w1": he_init(generator, lead + (d_model, d_ff), fan_in=d_model,
                       device=device, dtype=dtype),
         "w2": he_init(generator, lead + (d_ff, d_model), fan_in=d_ff,
                       device=device, dtype=dtype)}
    if gated:
        p["w3"] = he_init(generator, lead + (d_model, d_ff), fan_in=d_model,
                          device=device, dtype=dtype)
    return p


def mlp(params, x: torch.Tensor, gated: bool) -> torch.Tensor:
    h = x @ params["w1"].to(x.dtype)
    if gated:
        h = F.silu(h) * (x @ params["w3"].to(x.dtype))
    else:
        h = F.gelu(h, approximate="tanh")        # jax.nn.gelu's default
    return h @ params["w2"].to(x.dtype)


# --- Embedding ---------------------------------------------------------------

def init_embedding(generator, vocab: int, d_model: int, device=None,
                   dtype=torch.float32) -> torch.Tensor:
    return lecun_init(generator, (vocab, d_model), fan_in=d_model,
                      device=device, dtype=dtype)


def embed(embedding: torch.Tensor, tokens: torch.Tensor, dtype,
          group=None) -> torch.Tensor:
    """Gather the f32 rows, then cast: the gradient reaches the table in
    f32, as the reference's ``take`` then ``astype``. With ``group`` the
    table is this rank's block of rows of one split over it: each rank
    looks up the tokens in its block (zeros elsewhere) and the group sums
    the rows, exactly (one term is not zero)."""
    if group is None:
        return F.embedding(tokens.long(), embedding).to(dtype)
    n = embedding.shape[0]
    local = tokens.long() - coll.axis_index(group) * n
    mine = (local >= 0) & (local < n)
    rows = F.embedding(torch.where(mine, local, torch.zeros_like(local)),
                       embedding) * mine[..., None].to(embedding.dtype)
    return coll.psum_(rows, group).to(dtype)


def unembed(x: torch.Tensor, embedding=None, lm_head=None,
            final_softcap: float = 0.0) -> torch.Tensor:
    """Logits in f32, soft-capped. Outside autograd the cap runs in place
    (the same three ops in the same order, so the same bits): a prefill's
    (B, S, V) logits are then held once, not three times."""
    if lm_head is not None:
        logits = x @ lm_head.to(x.dtype)
    else:
        logits = x @ embedding.to(x.dtype).T
    logits = logits.to(torch.float32)
    if final_softcap and not logits.requires_grad:
        return logits.div_(final_softcap).tanh_().mul_(final_softcap)
    return softcap(logits, final_softcap)


def chunked_cross_entropy(x: torch.Tensor, targets: torch.Tensor, *,
                          embedding=None, lm_head=None,
                          final_softcap: float = 0.0, mask=None,
                          seq_chunk: int = 512) -> torch.Tensor:
    """Cross-entropy over the vocabulary without materializing (B, S, V)
    logits: a loop over sequence chunks, each chunk's logits recomputed
    in the backward pass (a checkpoint per chunk). nll = logsumexp −
    picked per position. x: (B, S, d); targets: (B, S)."""
    B, S, _ = x.shape
    cs = min(seq_chunk, S)
    while S % cs:
        cs //= 2
    nb = S // cs
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)

    def body(xb, tb, mb):
        logits = unembed(xb, embedding=embedding, lm_head=lm_head,
                         final_softcap=final_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, tb.long()[..., None])[..., 0]
        return torch.sum((lse - picked) * mb)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(nb):
        sl = slice(j * cs, (j + 1) * cs)
        args = (x[:, sl], targets[:, sl], mask[:, sl])
        total = total + (body(*args) if nb <= 1 else
                         checkpoint(body, *args, use_reentrant=False))
    return total / torch.clamp(torch.sum(mask), min=1.0)
