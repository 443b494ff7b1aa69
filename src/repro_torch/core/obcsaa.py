"""OBCSAA — One-Bit Compressive-Sensing Analog Aggregation (paper §II).

Port of ``repro/core/obcsaa.py``, simulation mode (the paper's §V): per
worker C(g) = sign(Φ · sparse_κ(g)) (eq. 7) on chunks of D_c, the
power-controlled MAC superposition plus AWGN (eq. 8-12), post-processing
(eq. 13), 1-bit CS decode through the ``repro_torch.decode`` registry
(eq. 43).

The production mode (``shardmap_compress``, ``shardmap_mac``,
``shardmap_reconstruct``, ``shardmap_aggregate``) runs in each FL worker's
process: the over-the-air sum is the all-reduce over the worker
``group`` (``dist/collectives``), the exact int32 lane sums with the
packed codec, the f32 (or ``wire_dtype``) symbols otherwise. ``group=None``
is the one-worker federation: the sum is that worker's own power-scaled
symbols and ``ksum = K·β``.

With ``use_kernels=True`` one round launches the CUDA kernels as one
batch: every worker's chunks (U·n_chunks rows) go through ONE
``topk_select`` and ONE sign projection, where JAX ``vmap``s over workers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core import channel as chan
from repro_torch.core.measurement import make_phi
from repro_torch.core.quantize import PACK, pack_signs, sign_pm1, unpack_signs
from repro_torch.core.sparsify import topk_sparsify, topk_sparsify_bisect
from repro_torch.decode import DecodeConfig
from repro_torch.decode import decode as cs_decode
from repro_torch.dist import collectives as coll


@dataclass(frozen=True)
class OBCSAAConfig:
    chunk: int = 4096            # D_c
    measure: int = 1024          # S_c
    topk: int = 409              # κ_c
    # Decode-side sparsity; 0 -> heuristic min(4κ, S/2)
    recon_topk: int = 0
    biht_iters: int = 30
    recon_alg: str = "biht"      # BIHT (paper §V); "iht" also available
    recon_tau: float = 1.0
    decoder: str = ""            # registry name; "" keeps recon_alg
    warm_start: bool = False
    noise_var: float = 1e-4      # σ² (mW)
    p_max: float = 10.0          # P^Max (mW)
    phi_seed: int = 42
    magnitude_tracking: bool = True
    spmd_topk: bool = False      # bisection top-k on the plain path
    bisect_iters: int = 40
    use_kernels: bool = False    # the hand-written CUDA kernels
    packed: bool = False         # packed 1-bit codec on the wire
    decode_validate: str = "off"

    def __post_init__(self):
        if self.packed and self.measure % PACK:
            raise ValueError(
                f"OBCSAAConfig(packed=True) needs measure (S_c) to be a "
                f"multiple of {PACK}; got {self.measure}")

    def phi(self, device=None, generator=None,
            dtype=torch.float32) -> torch.Tensor:
        return make_phi(self.phi_seed, self.measure, self.chunk, device,
                        generator, dtype)

    @property
    def decode_k(self) -> int:
        return self.recon_topk or min(4 * self.topk, self.measure // 2)

    def decode_cfg(self) -> DecodeConfig:
        """Map the aggregation knobs onto a registry ``DecodeConfig``;
        warm start swaps ``iht`` for its warm-capable alias and rejects
        decoders that would drop the carried state."""
        alg = self.decoder or self.recon_alg
        if self.warm_start:
            if alg == "iht":
                alg = "iht_warm"
            from repro_torch.decode import get_decoder
            if not get_decoder(alg).warm:
                raise ValueError(
                    f"warm_start=True but decoder {alg!r} is not "
                    "warm-capable (state would be silently dropped); use "
                    "iht or iht_warm")
        return DecodeConfig(algorithm=alg, iters=self.biht_iters,
                            tau=self.recon_tau, use_kernels=self.use_kernels,
                            ht="bisect" if self.spmd_topk else "sort",
                            ht_iters=self.bisect_iters,
                            validate=self.decode_validate)


# --- compression core --------------------------------------------------------

def compress_chunks(cfg: OBCSAAConfig, flat: torch.Tensor,
                    phi: torch.Tensor, presparsified: bool = False):
    """C(g) = sign(Φ sparse_κ(g)) (eq. 6-7), chunked.

    flat: (D_pad,) with D_pad % chunk == 0, or chunks (..., n, chunk):
    every row goes through one selection and one projection. Returns
    (signs (..., n, S_c), mags (..., n)); with ``cfg.packed`` the signs
    are int32 words (..., n, S_c//32) (uint32 bit patterns)."""
    if flat.ndim == 1:
        flat = flat.reshape(-1, cfg.chunk)
    lead = flat.shape[:-1]
    gc = flat.reshape(-1, cfg.chunk)
    if cfg.use_kernels:
        from repro_torch.kernels import ops as kops
        gc = gc.contiguous()
        sparse = gc if presparsified else kops.topk_select(gc, cfg.topk)[0]
        signs = (kops.cs_project_pack(phi, sparse) if cfg.packed
                 else kops.cs_project_sign(phi, sparse))
    else:
        if presparsified:
            sparse = gc
        elif cfg.spmd_topk:
            sparse, _ = topk_sparsify_bisect(gc, cfg.topk,
                                             iters=cfg.bisect_iters)
        else:
            sparse, _ = topk_sparsify(gc, cfg.topk)
        proj = sparse @ phi.T
        signs = pack_signs(proj) if cfg.packed else sign_pm1(proj)
    mags = torch.linalg.vector_norm(sparse, dim=-1)
    return signs.reshape(lead + signs.shape[-1:]), mags.reshape(lead)


def reconstruct_chunks(cfg: OBCSAAConfig, y: torch.Tensor,
                       mags: Optional[torch.Tensor], phi: torch.Tensor,
                       x0: Optional[torch.Tensor] = None,
                       return_raw: bool = False):
    """y: (n_chunks, S_c) post-processed aggregate (eq. 13) -> decoded flat
    (D_pad,) (eq. 43), rescaled to the transmitted chunk norms."""
    xhat = cs_decode(y, phi, cfg.decode_k, cfg.decode_cfg(), x0=x0)
    raw = xhat
    if cfg.magnitude_tracking and mags is not None:
        norm = torch.linalg.vector_norm(xhat, dim=-1, keepdim=True)
        xhat = xhat * (mags[:, None] / torch.clamp(norm, min=1e-12))
    flat = xhat.reshape(-1)
    return (flat, raw) if return_raw else flat


# --- simulation mode (paper §V) ----------------------------------------------

def simulate_round(cfg: OBCSAAConfig, grads_flat: torch.Tensor,
                   k_weights: torch.Tensor, beta: torch.Tensor, b_t,
                   h: torch.Tensor, *, phi: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None, decode_x0=None,
                   noise_var=None, presparsified: bool = False
                   ) -> Tuple[torch.Tensor, dict]:
    """grads_flat: (U, D) -> (g_hat (D,), diagnostics), eq. (6)-(14) with
    perfect channel inversion: y = Σ_i K_i b_t β_i C(g_i) + z (eq. 12).

    ``noise`` is the AWGN z (n_chunks, S_c); when it is not given it is
    drawn from ``generator`` at ``noise_var`` (default ``cfg.noise_var``;
    a 0-d tensor stays on the device).
    ``h`` is carried for the signature's sake: channel inversion cancels
    it, as in the reference."""
    del h
    U, D = grads_flat.shape
    pad = (-D) % cfg.chunk
    gpad = torch.nn.functional.pad(grads_flat, (0, pad))
    signs, mags = compress_chunks(cfg, gpad.reshape(U, -1, cfg.chunk), phi,
                                  presparsified=presparsified)
    symbols = unpack_signs(signs, phi.dtype) if cfg.packed else signs
    kb = k_weights * beta
    w = (kb * b_t).to(symbols.dtype)                 # (U,)
    y = torch.einsum("u,ucs->cs", w, symbols)
    if noise is None:
        nv = cfg.noise_var if noise_var is None else noise_var
        noise = chan.draw_noise(generator, y.shape, nv, device=y.device)
    y = y + noise                                    # eq. (12)
    denom = torch.clamp(torch.sum(kb) * b_t, min=1e-12)
    y = y / denom                                    # eq. (13)
    mbar = torch.einsum("u,uc->c", kb.to(mags.dtype), mags) / torch.clamp(
        torch.sum(kb), min=1e-12)
    ghat, xraw = reconstruct_chunks(
        cfg, y, mbar if cfg.magnitude_tracking else None, phi,
        x0=decode_x0, return_raw=True)
    diag = {"denom": denom, "mbar_mean": torch.mean(mbar),
            "y_rms": torch.sqrt(torch.mean(y ** 2)), "decode_xhat": xraw}
    return ghat[:D], diag


# --- production mode, a worker per process (the LM trainer) ------------------

def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def shardmap_compress(cfg: OBCSAAConfig, local_flat: torch.Tensor,
                      group=None, *, k_weight, beta_i, b_t,
                      phi: Optional[torch.Tensor] = None, wire_dtype=None):
    """Worker-side half: compress this worker's gradient (eq. 7), scale by
    the power factor (eq. 10-11) and superpose over the MAC, the sum over
    ``group`` (eq. 12). Returns ``(y, ksum, mag_sum)``, what
    ``shardmap_reconstruct`` needs; ``wire_dtype`` narrows the
    transmitted symbols (ignored when ``cfg.packed``)."""
    phi = cfg.phi(local_flat.device) if phi is None else phi
    signs, mags = compress_chunks(cfg, local_flat, phi)
    return shardmap_mac(cfg, signs, mags, group, k_weight=k_weight,
                        beta_i=beta_i, b_t=b_t, wire_dtype=wire_dtype)


def shardmap_mac(cfg: OBCSAAConfig, signs, mags, group=None, *, k_weight,
                 beta_i, b_t, wire_dtype=None):
    """MAC superposition of already-compressed symbols (eq. 12), summed
    over ``group``. With ``cfg.packed`` the words become the exact int32
    lane sums Σ β·(2·bit − 1) (``collectives.psum_bits_mac``), scaled by
    K·b_t after the sum, which assumes the worker-uniform K·b_t of the
    trainer (equal shards); otherwise the sum of the f32 (or
    ``wire_dtype``) symbols times K·β·b_t. ``ksum`` and ``mag_sum`` are
    summed the same way. Returns ``(y, ksum, mag_sum)``; ``mag_sum`` is
    None without magnitude tracking."""
    dev = signs.device
    k_weight, beta_i, b_t = (_f32(k_weight, dev), _f32(beta_i, dev),
                             _f32(b_t, dev))
    if cfg.packed:
        s_int = coll.psum_bits_mac(signs, group, beta_i=beta_i)
        y = s_int.to(torch.float32) * (k_weight * b_t)       # eq. (12)
    else:
        wd = wire_dtype or signs.dtype
        y = coll.psum(signs.to(wd) * (k_weight * beta_i * b_t).to(wd),
                      group)                                 # eq. (12)
    kb = k_weight * beta_i
    ksum = coll.psum(kb, group)
    mag_sum = (coll.psum(mags * kb.to(mags.dtype), group)
               if cfg.magnitude_tracking else None)
    return y, ksum, mag_sum


def shardmap_reconstruct(cfg: OBCSAAConfig, y: torch.Tensor, ksum,
                         mag_sum=None, *, b_t,
                         phi: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None,
                         decode_x0=None) -> torch.Tensor:
    """PS-side half: AWGN + post-processing (eq. 13) + 1-bit CS decode
    (eq. 43). ``noise`` is the AWGN (n_chunks, S_c); when it is not given
    it is drawn from ``generator`` at ``cfg.noise_var``."""
    dev = y.device
    phi = cfg.phi(dev) if phi is None else phi
    ksum, b_t = _f32(ksum, dev), _f32(b_t, dev)
    denom = torch.clamp(ksum * b_t, min=1e-12)
    if noise is None:
        noise = chan.draw_noise(generator, y.shape, cfg.noise_var,
                                device=dev)
    y = (y.to(torch.float32) + noise) / denom                 # eq. (13)
    mbar = (mag_sum / torch.clamp(ksum, min=1e-12)
            if (cfg.magnitude_tracking and mag_sum is not None) else None)
    return reconstruct_chunks(cfg, y, mbar, phi, x0=decode_x0)


def shardmap_aggregate(cfg: OBCSAAConfig, local_flat: torch.Tensor,
                       group=None, *, k_weight, beta_i, b_t,
                       n_workers: int = 1,
                       phi: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Compress, superpose over ``group`` and decode one worker's
    (D_pad,) gradient; returns the reconstructed global gradient, the
    same on every worker (each decodes the same sum with the same
    ``noise``, or the same ``generator`` state)."""
    del n_workers  # implied by group; kept for call-site stability
    phi = cfg.phi(local_flat.device) if phi is None else phi
    y, ksum, mag_sum = shardmap_compress(cfg, local_flat, group,
                                         k_weight=k_weight, beta_i=beta_i,
                                         b_t=b_t, phi=phi)
    return shardmap_reconstruct(cfg, y, ksum, mag_sum, b_t=b_t, phi=phi,
                                generator=generator, noise=noise)


def comm_stats(cfg: OBCSAAConfig, D: int) -> dict:
    """Wire statistics per worker per round (vs uncompressed analog float)."""
    n_chunks = -(-D // cfg.chunk)
    symbols = n_chunks * cfg.measure + (n_chunks if cfg.magnitude_tracking
                                        else 0)
    mag_bits = 32 * n_chunks if cfg.magnitude_tracking else 0
    bits_f32 = 32 * n_chunks * cfg.measure + mag_bits
    bits_packed = n_chunks * cfg.measure + mag_bits
    return {
        "D": D,
        "n_chunks": n_chunks,
        "symbols_per_round": symbols,
        "compression_ratio": D / symbols,
        "latency_fraction": symbols / D,
        "uplink_bits_f32": bits_f32,
        "uplink_bits_packed": bits_packed,
        "packed_wire_ratio": bits_f32 / bits_packed,
    }
