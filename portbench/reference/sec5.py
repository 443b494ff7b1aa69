"""Plain reference of the paper's §V round (arXiv:2103.16055, eq. 3-14).

Plain PyTorch, written from the paper and the configuration alone: it
imports nothing of the program. One round, for U workers of K samples:

1. each worker's full-batch gradient of the MLP 784-64-10 (ReLU,
   softmax cross-entropy), back-propagated by hand (eq. 3);
2. the flat gradient (leaves in name order b1, b2, w1, w2) zero-padded
   to chunks of D_c, the κ_c largest magnitudes of each chunk kept
   (eq. 6), projected by Φ and signed, sign(0) = +1 (eq. 7), each
   chunk's norm kept beside it;
3. every worker scheduled; b_t = min_i h_i √P^Max / K_i (eq. 10-11);
4. y = Σ_i K_i b_t C(g_i) + z, z ~ N(0, σ²), divided by Σ_i K_i b_t
   (eq. 12-13); the chunk norms averaged with weights K_i;
5. BIHT (eq. 43): x = H_k(yΦ / S), then ``iters`` times
   x = H_k(x + τ/S (y − sign(xΦᵀ)) Φ), H_k the k = min(4κ_c, S_c / 2)
   largest magnitudes; each chunk unit-normed and scaled to the mean
   norm;
6. p = p − α ĝ (eq. 14).

The round's fades and noise come from the arm's seed by the recipe the
configuration's draws follow: a ``torch.Generator`` seeded with the arm's
seed on the round's device draws the initial fade (two N(0, 1) vectors of
U, the real and imaginary parts of CN(0, 1)), then per round the fade
(again two of U; ρ = 0: the fade is its own draw, |h| clamped at 1e-3)
and the AWGN field (n_chunks, S_c) of N(0, 1), times σ.

Matrix products run in float32 with TF32 off; ``Precision(tf32=True)``
runs them in TF32 instead, which is the control.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterator, List, Tuple

import torch

LEAVES = ("b1", "b2", "w1", "w2")
H_MIN = 1e-3


class Precision:
    """Float32 matrix products with TF32 off (``tf32=False``) or on."""

    def __init__(self, tf32: bool = False):
        self.tf32 = bool(tf32)

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False


def flatten(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([p[k].reshape(-1) for k in LEAVES])


def unflatten(vec: torch.Tensor, like: Dict[str, torch.Tensor]):
    out, off = {}, 0
    for k in LEAVES:
        n = like[k].numel()
        out[k] = vec[off:off + n].reshape(like[k].shape)
        off += n
    return out


def worker_grads(p, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Every worker's gradient of its mean cross-entropy: x (U, K, 784),
    y (U, K) -> (U, D), leaves in ``LEAVES`` order."""
    U, K, _ = x.shape
    pre = x @ p["w1"] + p["b1"]
    h = torch.relu(pre)
    logits = h @ p["w2"] + p["b2"]
    d = torch.softmax(logits, dim=-1)
    d = d - torch.nn.functional.one_hot(y.long(), d.shape[-1]).to(d.dtype)
    d = d / K
    gw2 = h.transpose(1, 2) @ d
    gb2 = d.sum(dim=1)
    dh = (d @ p["w2"].T) * (pre > 0).to(d.dtype)
    gw1 = x.transpose(1, 2) @ dh
    gb1 = dh.sum(dim=1)
    g = {"b1": gb1, "b2": gb2, "w1": gw1, "w2": gw2}
    return torch.cat([g[k].reshape(U, -1) for k in LEAVES], dim=1)


def top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep every entry of a row whose magnitude is at least the row's
    k-th largest (ties at the k-th all kept), zero the rest."""
    a = x.abs()
    kth = torch.topk(a, k, dim=-1).values[..., -1:]
    return torch.where(a >= kth, x, torch.zeros_like(x))


def sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def biht(y: torch.Tensor, phi: torch.Tensor, k: int, iters: int,
         tau: float) -> torch.Tensor:
    s = phi.shape[0]
    x = top_k((y @ phi) / s, k)
    for _ in range(iters):
        x = top_k(x + (tau / s) * ((y - sign(x @ phi.T)) @ phi), k)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1,
                                                    keepdim=True), min=1e-12)


class ArmDraws:
    """The fades and AWGN of one arm, round after round, from its seed."""

    def __init__(self, seed: int, U: int, n_chunks: int, S: int, device):
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.U, self.shape, self.device = U, (n_chunks, S), device
        self._cn()                      # the initial fade: ρ = 0 drops it

    def _cn(self) -> torch.Tensor:
        re = torch.randn((self.U,), generator=self.gen, device=self.device)
        im = torch.randn((self.U,), generator=self.gen, device=self.device)
        return torch.complex(re, im) / math.sqrt(2.0)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        while True:
            w = self._cn()
            z = torch.randn(self.shape, generator=self.gen,
                            device=self.device)
            yield torch.clamp(w.abs().to(torch.float32), min=H_MIN), z


def b_t(h: torch.Tensor, k_weights: torch.Tensor, p_max: float):
    """Eq. 10-11 with every worker scheduled."""
    p = torch.tensor(p_max, dtype=torch.float32, device=h.device)
    return torch.min(h * torch.sqrt(p) / k_weights)


def round_step(p, x, y, k_weights, phi, h, z, noise_var: float, cfg):
    """One round from parameters ``p``: (p', b_t)."""
    U = x.shape[0]
    dc, s = cfg["chunk"], cfg["measure"]
    g = worker_grads(p, x, y)
    D = g.shape[1]
    n = -(-D // dc)
    gc = torch.nn.functional.pad(g, (0, n * dc - D)).reshape(U * n, dc)
    sparse = top_k(gc, cfg["topk"])
    signs = sign(sparse @ phi.T).reshape(U, n, s)
    mags = torch.linalg.vector_norm(sparse, dim=-1).reshape(U, n)
    bt = b_t(h, k_weights, cfg["p_max"])
    ksum = torch.sum(k_weights)
    sigma = torch.sqrt(torch.tensor(noise_var, dtype=torch.float32,
                                    device=x.device))
    yv = torch.einsum("u,ucs->cs", k_weights * bt, signs) + z * sigma
    yv = yv / torch.clamp(ksum * bt, min=1e-12)
    mbar = torch.einsum("u,uc->c", k_weights, mags) / torch.clamp(
        ksum, min=1e-12)
    k_dec = min(4 * cfg["topk"], s // 2)
    xhat = biht(yv, phi, k_dec, cfg["biht_iters"], cfg["recon_tau"])
    ghat = xhat * (mbar[:, None] / torch.clamp(
        torch.linalg.vector_norm(xhat, dim=-1, keepdim=True), min=1e-12))
    lr = torch.tensor(cfg["learning_rate"], dtype=torch.float32,
                      device=x.device)
    step = unflatten(ghat.reshape(-1)[:D], p)
    return {k: p[k] - lr * step[k] for k in LEAVES}, bt


def b_ts(seed: int, U: int, n_chunks: int, S: int, rounds: int,
         k_weights, p_max: float, device) -> List[float]:
    """b_t of every round of an arm, from its seed's draws."""
    draws = iter(ArmDraws(seed, U, n_chunks, S, device))
    return [float(b_t(next(draws)[0], k_weights, p_max))
            for _ in range(rounds)]


def follow(p, draws, x, y, k_weights, phi, noise_var: float, cfg,
           rounds: int):
    """The parameters after ``rounds`` rounds from ``p``, each round taking
    the next (fade, AWGN) of ``draws`` (an iterator over ``ArmDraws``)."""
    p = {k: v.to(x.device) for k, v in p.items()}
    for _ in range(rounds):
        h, z = next(draws)
        p = round_step(p, x, y, k_weights, phi, h, z, noise_var, cfg)[0]
    return p


def chunk_gap(p_prog, p_ref, p_start, chunk: int) -> float:
    """The median, over the chunks of D_c of the flat parameter vector, of
    ‖Δ_prog − Δ_ref‖ / ‖Δ_ref‖ for the change Δ = p − p_start of each
    side. A chunk whose decode meets a near tie (a top-k or a sign decided
    by the last bit of a sum) parts whole; the median reads the round."""
    d_prog = flatten({k: v.cpu() for k, v in p_prog.items()}).double()
    d_ref = flatten({k: v.cpu() for k, v in p_ref.items()}).double()
    start = flatten({k: v.cpu() for k, v in p_start.items()}).double()
    d_prog, d_ref = d_prog - start, d_ref - start
    gaps = [float(torch.linalg.vector_norm(d_prog[i:i + chunk]
                                           - d_ref[i:i + chunk])
                  / torch.clamp(torch.linalg.vector_norm(d_ref[i:i + chunk]),
                                min=1e-30))
            for i in range(0, d_ref.numel(), chunk)]
    return statistics.median(gaps)
