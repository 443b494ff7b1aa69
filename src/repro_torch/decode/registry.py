"""Pluggable 1-bit CS decoder registry — one entry point for eq. 43.

Port of ``repro/decode/registry.py``. Registered here:

  iht        fixed-step IHT on real measurements; through ``fused_iht``
             (K3, K4, K1) with ``use_kernels``
  niht       normalized (adaptive-step) IHT
  biht       sign-consistency BIHT (the paper's §V choice); through the
             kernels with ``use_kernels``
  iht_warm   IHT seeded with round t−1's estimate (``x0``)
  iht_fused  ``fused_iht`` unconditionally

With ``packed``, ``biht`` takes ``y`` as int32 words of 32 signs each:
through the packed loop (``decode/fused.py``) with kernels, else unpacked
and through ``biht_sign``.

``decode`` forwards ``x0`` only to decoders registered with ``warm=True``,
so cold decoders ignore whatever state the caller carries.

``DecodeConfig.validate`` guards the fixed-step decoders against the
silent divergence past τ·λ̂ ≥ 2: ``"raise"`` raises, ``"fallback"`` swaps
in ``niht``. ``resolve_validate`` makes that decision eagerly. λ̂ depends
only on (Φ, k), so a caller that decodes the same Φ every round (the
engine) resolves once and decodes with the config it returns. That eager
check is the port's counterpart of the reference's traced ``lax.cond``,
and a captured round holds one decoder and no data-dependent branch.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Callable, Dict

from repro_torch.decode.fused import fused_biht_packed, fused_iht
from repro_torch.decode.iht import (IHT_STABILITY_BOUND, biht_sign,
                                    hard_threshold, hard_threshold_bisect,
                                    iht, niht, restricted_spectral_estimate)
from repro_torch.kernels.sign import unpack_signs


@dataclass(frozen=True)
class DecodeConfig:
    """Decoder selection + knobs, consumed by ``decode``. ``ht`` picks the
    hard threshold of the plain decoders: "sort" (exact, lowest-index
    ties) or "bisect"; the kernel paths always use the bisection kernel."""
    algorithm: str = "biht"
    iters: int = 30
    tau: float = 1.0
    use_kernels: bool = False
    ht: str = "sort"
    ht_iters: int = 40
    # y arrives as int32 words of 32 signs (kernels/sign.py codec); only
    # the sign-consistency ``biht`` decodes packed symbols
    packed: bool = False
    # fixed-step stability guard: "off" | "raise" | "fallback" (to niht)
    validate: str = "off"


@dataclass(frozen=True)
class Decoder:
    """Registry entry: the decode fn + whether it consumes warm state."""
    fn: Callable
    warm: bool = False


_REGISTRY: Dict[str, Decoder] = {}


def register_decoder(name: str, *, warm: bool = False):
    """Register ``fn(y, phi, k, cfg, x0) -> xhat`` under ``name``."""
    def deco(fn):
        _REGISTRY[name] = Decoder(fn=fn, warm=warm)
        return fn
    return deco


def get_decoder(name: str) -> Decoder:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown decoder {name!r}; registered: "
                         f"{', '.join(list_decoders())}") from None


def list_decoders():
    return sorted(_REGISTRY)


def _ht_fn(cfg: DecodeConfig):
    if cfg.ht == "bisect":
        return functools.partial(hard_threshold_bisect, iters=cfg.ht_iters)
    if cfg.ht == "sort":
        return hard_threshold
    raise ValueError(f"unknown hard-threshold {cfg.ht!r} (sort|bisect)")


_FIXED_STEP = ("iht", "iht_warm", "iht_fused")
_VALIDATE_MODES = ("off", "raise", "fallback")


def resolve_validate(cfg: DecodeConfig, phi, k: int) -> DecodeConfig:
    """The ``validate`` decision, made eagerly: returns the config to
    decode with, its ``validate`` off. A fixed-step decoder at τ·λ̂ ≥ 2
    raises under ``"raise"`` and becomes ``niht`` under ``"fallback"``;
    anything else is returned as it is."""
    if cfg.validate not in _VALIDATE_MODES:
        raise ValueError(f"unknown validate mode {cfg.validate!r}; one of "
                         f"{_VALIDATE_MODES}")
    if cfg.validate == "off":
        return cfg
    out = replace(cfg, validate="off")
    if cfg.algorithm not in _FIXED_STEP:
        return out
    lam = float(restricted_spectral_estimate(phi, k))
    if lam * cfg.tau < IHT_STABILITY_BOUND:
        return out
    if cfg.validate == "raise":
        raise ValueError(
            f"decode: fixed-step IHT is unstable at tau={cfg.tau}: "
            f"tau·λ̂ = {cfg.tau * lam:.2f} ≥ {IHT_STABILITY_BOUND}, with "
            f"λ̂ = {lam:.2f} the restricted spectral estimate of Φ at "
            f"decode sparsity k={k}; the iterate diverges to NaN. Lower "
            f"tau below {IHT_STABILITY_BOUND / lam:.3f}, use "
            "validate='fallback', or the adaptive-step 'niht' decoder.")
    return replace(out, algorithm="niht")


def decode(y, phi, k: int, cfg: DecodeConfig, x0=None):
    """Decode the post-processed aggregate ŷ (eq. 13) back to the sparse
    gradient estimate (eq. 43). y: (n, S); phi: (S, D) -> (n, D). With
    ``cfg.packed``, y is instead the int32 sign words (n, S//32).
    ``cfg.validate`` is resolved on every call (``resolve_validate``)."""
    cfg = resolve_validate(cfg, phi, k)
    dec = get_decoder(cfg.algorithm)
    return dec.fn(y, phi, k, cfg, x0 if dec.warm else None)


# --- built-ins -------------------------------------------------------------------

@register_decoder("iht")
def _iht(y, phi, k, cfg, x0):
    if cfg.use_kernels:
        return fused_iht(y, phi, k, cfg.iters, cfg.tau, x0=x0)
    return iht(y, phi, k, cfg.iters, cfg.tau, ht_fn=_ht_fn(cfg), x0=x0)


@register_decoder("iht_warm", warm=True)
def _iht_warm(y, phi, k, cfg, x0):
    return _iht(y, phi, k, cfg, x0)


@register_decoder("iht_fused", warm=True)
def _iht_fused(y, phi, k, cfg, x0):
    return fused_iht(y, phi, k, cfg.iters, cfg.tau, x0=x0)


@register_decoder("niht")
def _niht(y, phi, k, cfg, x0):
    return niht(y, phi, k, cfg.iters, ht_fn=_ht_fn(cfg), x0=x0)


@register_decoder("biht")
def _biht(y, phi, k, cfg, x0):
    if cfg.packed:
        if cfg.use_kernels:
            return fused_biht_packed(y, phi, k, cfg.iters, cfg.tau)
        y = unpack_signs(y, phi.dtype)
    if cfg.use_kernels:
        from repro_torch.kernels import ops as kops
        return kops.biht(y, phi, k, cfg.iters, cfg.tau)
    return biht_sign(y, phi, k, cfg.iters, cfg.tau, ht_fn=_ht_fn(cfg),
                     x0=x0)
