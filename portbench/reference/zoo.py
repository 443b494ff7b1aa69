"""Plain reference of the zoo round with real gradients, at InternVL2-1B's
language decoder (arXiv:2404.16821; its Qwen2-0.5B backbone at the
configuration's widths).

Plain PyTorch from the configuration alone; it imports nothing of the
program. What it computes, each step:

1. the parameters, kept as one f32 vector of chunks of D_c in the flat
   order the configuration fixes (below), cast to the compute dtype;
2. each worker's loss and gradient on its own batch: the token embedding
   (tied with the output) times √d, the image prefix (the stub frontend's
   embeddings plus a learned position marker) before the text, then per
   layer RMSNorm (f32, scale 1 + w), grouped-query attention with RoPE on
   the two halves of each head (θ from the configuration), causal
   softmax in f32, the output projection, a residual, RMSNorm and a
   SiLU-gated MLP, a residual; a final RMSNorm and the mean next-token
   cross-entropy in f32 over the text positions (the image positions
   carry no loss). Matrix products in the compute dtype;
3. each worker's gradient in the flat order, the κ_c largest magnitudes of
   each chunk kept (ties at the κ-th all kept), projected by Φ (f32, TF32
   off) and signed, sign(0) = +1; each chunk's norm kept;
4. every worker scheduled, K_i = 1: b_t = min_i h_i √P^Max;
   y = (b_t Σ_i sign_i + σ z) / (U b_t); the chunk norms' mean;
5. IHT, ``iters`` times x = H_k(x + τ (y − xΦᵀ) Φ) from x = 0,
   k = min(4κ_c, S_c / 2); each chunk scaled to the mean norm;
6. p = p − α ĝ.

The flat order: with M model shards the vector is M sections; section m
holds, leaf by leaf in name order, the m-th of M equal slices of each leaf
along its largest dimension that M divides (a stacked layer axis never;
ties to the later dimension), the section zero-padded to a whole number
of chunks rounded up to ``gran`` (the workers times the block of chunks).
This order decides which parameters share a chunk.

The departures of the configuration from the published Qwen2 block, which
the reference follows as the configuration states them: no bias on the
query, key and value projections; RMSNorm scales of the form 1 + w.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Path_ = Tuple[str, ...]


# -- the parameters and their flat order --------------------------------------

def leaf_shapes(mc: dict) -> Dict[Path_, Tuple[int, ...]]:
    L, d, ff, V = (mc["num_layers"], mc["d_model"], mc["d_ff"],
                   mc["vocab_size"])
    H, KV, hd = mc["num_heads"], mc["num_kv_heads"], mc["head_dim"]
    return dict(sorted({
        ("embedding",): (V, d),
        ("final_norm",): (d,),
        ("img_pos",): (mc["num_image_tokens"], d),
        ("layers", "attn", "wk"): (L, d, KV, hd),
        ("layers", "attn", "wo"): (L, H, hd, d),
        ("layers", "attn", "wq"): (L, d, H, hd),
        ("layers", "attn", "wv"): (L, d, KV, hd),
        ("layers", "attn_norm"): (L, d),
        ("layers", "ffn_norm"): (L, d),
        ("layers", "mlp", "w1"): (L, d, ff),
        ("layers", "mlp", "w2"): (L, ff, d),
        ("layers", "mlp", "w3"): (L, d, ff),
    }.items()))


def init_std(path: Path_, shape, mc: dict) -> float:
    """The scale each leaf is drawn at: N(0, 1/d) for the embedding,
    0.02 for the image positions, N(0, 2/fan_in) for the projections,
    zero for the norms."""
    name = path[-1]
    if name.endswith("norm"):
        return 0.0
    if name == "embedding":
        return math.sqrt(1.0 / mc["d_model"])
    if name == "img_pos":
        return 0.02
    fan_in = {"wo": mc["num_heads"] * mc["head_dim"], "w2": mc["d_ff"]}.get(
        name, mc["d_model"])
    return math.sqrt(2.0 / fan_in)


def make_params(mc: dict, generator: torch.Generator, device
                ) -> Dict[Path_, torch.Tensor]:
    """Every leaf drawn from ``generator`` in name order, f32."""
    out = {}
    for path, shape in leaf_shapes(mc).items():
        std = init_std(path, shape, mc)
        out[path] = (torch.randn(shape, generator=generator, device=device)
                     .mul_(std) if std else
                     torch.zeros(shape, device=device))
    return out


def nested(flat: Dict[Path_, torch.Tensor]) -> dict:
    """{path: leaf} -> nested dicts."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def shard_dim(path: Path_, shape, mp: int) -> int:
    if mp <= 1:
        return -1
    best = None
    for i, n in enumerate(shape):
        if path[0] == "layers" and i == 0:
            continue
        if n > 1 and n % mp == 0 and (best is None or n >= shape[best]):
            best = i
    return -1 if best is None else best


class Layout:
    """The flat order of the module docstring."""

    def __init__(self, mc: dict, mp: int, chunk: int, gran: int):
        self.mp, self.chunk = mp, chunk
        self.slots = []
        off = 0
        for path, shape in leaf_shapes(mc).items():
            n = math.prod(shape)
            dim = shard_dim(path, shape, mp)
            if mp > 1 and dim < 0:
                raise ValueError(f"{path} does not split over {mp}")
            self.slots.append((path, shape, dim, off, n // mp))
            off += n // mp
        self.sec = off
        n_half = -(-off // chunk)
        self.n_half = -(-n_half // gran) * gran
        self.n_chunks = mp * self.n_half
        self.D = off * mp

    def _part(self, leaf, dim, m):
        if self.mp == 1:
            return leaf
        k = leaf.shape[dim] // self.mp
        return leaf.narrow(dim, m * k, k)

    def to_master(self, params, dtype=torch.float32) -> torch.Tensor:
        dev = next(iter(params.values())).device
        out = torch.zeros((self.n_chunks, self.chunk), dtype=dtype,
                          device=dev)
        flat = out.view(self.mp, -1)
        for m in range(self.mp):
            for path, _, dim, off, n in self.slots:
                flat[m, off:off + n] = self._part(params[path], dim,
                                                  m).reshape(-1)
        return out

    def to_params(self, master: torch.Tensor, dtype=None):
        flat = master.reshape(self.mp, -1)
        out = {}
        for path, shape, dim, off, n in self.slots:
            parts = []
            for m in range(self.mp):
                s = list(shape)
                if self.mp > 1:
                    s[dim] //= self.mp
                parts.append(flat[m, off:off + n].reshape(s))
            x = parts[0] if self.mp == 1 else torch.cat(parts, dim=dim)
            out[path] = x if dtype is None else x.to(dtype)
        return out

    def leaf_norms(self, master: torch.Tensor) -> Dict[Path_, float]:
        """Each leaf's f32 norm, read from the flat vector."""
        flat = master.reshape(self.mp, -1)
        return {path: float(torch.linalg.vector_norm(
            flat[:, off:off + n].double()))
            for path, _, _, off, n in self.slots}


# -- the model ------------------------------------------------------------------

def fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with a per-tensor scale (the control); the
    gradient passes the rounding as it is."""
    with torch.no_grad():
        s = 448.0 / torch.clamp(t.abs().amax().float(), min=1e-30)
        r = ((t.float() * s).to(torch.float8_e4m3fn).float() / s).to(t.dtype)
    return t + (r - t).detach()


def rmsnorm(x, w, eps):
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * (1.0 + w.float())).to(x.dtype)


def rope(x, pos, theta):
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                  device=x.device) / hd)
    ang = pos[:, None].float() * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x.float().chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, a * sin + b * cos], -1).to(x.dtype)


def loss(P, batch, mc: dict, low: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of one worker's batch; ``low`` rounds
    every operand of the compute-dtype products to float8 (the control)."""
    q8 = fp8 if low else (lambda t: t)
    mm = lambda a, b: q8(a) @ q8(b)
    d, eps = mc["d_model"], mc["norm_eps"]
    H, KV, hd = mc["num_heads"], mc["num_kv_heads"], mc["head_dim"]
    emb = P[("embedding",)]
    x = F.embedding(batch["tokens"].long(), emb) * math.sqrt(d)
    img = batch["image_embeds"].to(x.dtype) + P[("img_pos",)][None]
    x = torch.cat([img, x], dim=1)
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    lay = lambda name, i: P[("layers",) + name][i]
    for i in range(mc["num_layers"]):
        h = rmsnorm(x, lay(("attn_norm",), i), eps)
        q = mm(h, lay(("attn", "wq"), i).reshape(d, H * hd)).view(B, S, H, hd)
        k = mm(h, lay(("attn", "wk"), i).reshape(d, KV * hd)).view(B, S, KV, hd)
        v = mm(h, lay(("attn", "wv"), i).reshape(d, KV * hd)).view(B, S, KV, hd)
        q, k = rope(q, pos, mc["rope_theta"]), rope(k, pos, mc["rope_theta"])
        qg = q.view(B, S, KV, H // KV, hd).float()
        sc = torch.einsum("bqgrh,bsgh->bgrqs", qg, k.float()) / math.sqrt(hd)
        sc = sc.masked_fill(~causal, float("-inf"))
        w = torch.softmax(sc, dim=-1).to(x.dtype)
        o = torch.einsum("bgrqs,bsgh->bqgrh", w, v).reshape(B, S, H * hd)
        x = x + mm(o, lay(("attn", "wo"), i).reshape(H * hd, d))
        h = rmsnorm(x, lay(("ffn_norm",), i), eps)
        g = F.silu(mm(h, lay(("mlp", "w1"), i))) * mm(h, lay(("mlp", "w3"), i))
        x = x + mm(g, lay(("mlp", "w2"), i))
    n_img = mc["num_image_tokens"]
    x = rmsnorm(x[:, n_img:], P[("final_norm",)], eps)
    logits = mm(x, emb.T).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch["targets"].reshape(-1).long())


# -- the round ------------------------------------------------------------------

def top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    a = x.abs()
    kth = torch.topk(a, k, dim=-1).values[..., -1:]
    return torch.where(a >= kth, x, torch.zeros_like(x))


def sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


class Round:
    """The reference's rounds on a flat f32 master."""

    def __init__(self, mc: dict, layout: Layout, phi: torch.Tensor,
                 block: int = 4096, part: int = 2):
        self.mc, self.lay, self.phi, self.block = mc, layout, phi, block
        self.part = part
        self.dtype = getattr(torch, mc["compute_dtype"])

    def grads(self, P, batch, low: bool):
        """(one worker's gradient in the flat order, in the compute dtype;
        its loss): the mean over its sequences, taken ``part`` sequences at
        a time and summed in f32, so that the activations fit."""
        n = batch["tokens"].shape[0]
        part = min(self.part, n)
        acc, lsum = None, 0.0
        for i in range(0, n, part):
            sub = {k: v[i:i + part] for k, v in batch.items()}
            w = sub["tokens"].shape[0] / n
            req = {k: v.detach().requires_grad_() for k, v in P.items()}
            with torch.enable_grad():
                lv = loss(req, sub, self.mc, low)
                gr = torch.autograd.grad(lv, list(req.values()))
            lsum += float(lv.detach()) * w
            flat = self.lay.to_master(dict(zip(req.keys(), gr)),
                                      torch.float32).mul_(w)
            acc = flat if acc is None else acc.add_(flat)
            del gr, req, flat
        return acc.to(self.dtype), lsum

    def step(self, master, batches, h, z, low: bool = False):
        """One round in place on ``master``; returns (the workers' mean
        loss, each leaf's norm of the workers' mean gradient, the MAC's
        sums of the workers' signs (n_chunks, S_c) before the power
        scaling and the noise)."""
        mc, lay, phi = self.mc, self.lay, self.phi
        n, dc = master.shape
        U = len(batches)
        y = torch.zeros((n, phi.shape[0]), device=master.device)
        mags = torch.zeros((n,), device=master.device)
        gmean = torch.zeros_like(master)
        losses = []
        P = lay.to_params(master, self.dtype)
        for b in batches:
            g, lv = self.grads(P, b, low)
            losses.append(lv)
            for a in range(0, n, self.block):
                rows = g[a:a + self.block].float()
                gmean[a:a + self.block] += rows / U
                sp = top_k(rows, mc["topk"])
                y[a:a + self.block] += sign(sp @ phi.T)
                mags[a:a + self.block] += torch.linalg.vector_norm(sp, dim=-1)
            del g
        del P
        signs = y.clone()
        bt = torch.min(h * torch.sqrt(torch.tensor(
            mc["p_max"], dtype=torch.float32, device=h.device)))
        sigma = torch.sqrt(torch.tensor(mc["noise_var"], dtype=torch.float32,
                                        device=y.device))
        y = (y * bt + z * sigma) / (U * bt)
        mbar = mags / U
        k_dec = min(4 * mc["topk"], phi.shape[0] // 2)
        lr = torch.tensor(mc["learning_rate"], dtype=torch.float32)
        for a in range(0, n, self.block):
            yb = y[a:a + self.block]
            x = torch.zeros((yb.shape[0], dc), device=master.device)
            for _ in range(mc["iht_iters"]):
                x = top_k(x + mc["recon_tau"] * ((yb - x @ phi.T) @ phi),
                          k_dec)
            nrm = torch.clamp(torch.linalg.vector_norm(x, dim=-1,
                                                       keepdim=True),
                              min=1e-12)
            ghat = x * (mbar[a:a + self.block, None] / nrm)
            master[a:a + self.block] -= lr.to(master.device) * ghat
        return sum(losses) / U, lay.leaf_norms(gmean), signs


def norm_gaps(prog: Dict[Path_, float], ref: Dict[Path_, float],
              keep) -> Dict[Path_, float]:
    """Per leaf of ``keep``: |‖prog‖ − ‖ref‖| over the larger of ‖ref‖ and
    the median leaf's ‖ref‖."""
    med = statistics.median(ref[p] for p in keep)
    return {p: abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30)
            for p in keep}


def kept_leaves(grad_norms: Dict[Path_, float]) -> List[Path_]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move by round-off alone."""
    med = statistics.median(grad_norms.values())
    return [p for p, g in grad_norms.items() if g >= 1e-3 * med]
